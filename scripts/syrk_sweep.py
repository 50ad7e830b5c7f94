#!/usr/bin/env python3
"""Times the port's Gram kernel (global_lvba_tpu_torch/csrc/syrk.cu) alone on
one NVIDIA GPU, to split its time into a per-k-tile slope and a fixed cost
per wave of tiles.  Run from the repository root:

    python3 scripts/syrk_sweep.py

For each (N, Kr) it times syrk_kernel by itself (the tf32 split made once
beforehand) with every tile in one block and with the tile schedule the
wrapper uses (the last, partial wave's tiles split over the contraction),
in turns, and holds each gram to AᵀA in float64 (1e-4 of max |AᵀA|, as
chip_smoke.py; the two schedules sum the split tiles in another order, so
they differ in the last bits).  Then it
times the wrapper (split included) and torch.matmul(A.T, A) on operands of
the W=512 aligned evaluation's chunk sizes (4,095 and 2,049 rows x 3,072).
Device time from CUDA events over calls queued behind a spin kernel.
Prints one line per case and the card's name, power limit and SM clock;
writes chiprun_out/syrk_sweep.json.

    python3 scripts/syrk_sweep.py --f64

measures the card's fp64 mma.sync ceiling (DMMA_PEAK_SRC: products on
register operands, no loads) and times the float64 kernel (syrk_f64_kernel,
through gram.syrk_) on F64_CASES: its ptxas registers and spills, each gram
against AᵀA in float64 (1e-11 of max |AᵀA|, exactly symmetric, bitwise
repeatable), and its times in turns with torch.matmul(A.T, A) in float64;
writes chiprun_out/syrk_sweep_f64.json.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (N, Kr): Kr over 1 to 256 k-tiles at W=512's N = 3,072 (300 tiles in 2.27
# waves); then one full wave (N = 1,920: 120 tiles), 36 tiles (N = 1,024)
# and one tile (N = 128) at 128 k-tiles
CASES = [(3072, 32), (3072, 1024), (3072, 2048), (3072, 4096), (3072, 8192),
         (1920, 4096), (1024, 4096), (128, 4096)]
PAIR = (4095, 2049)
REPS = 10
TOL_GRAM_REL = 1e-4
# float64: (Kr, N) of the aligned W=512 evaluation, the corridor's largest
# chunk, and ragged operands (Kr not a multiple of 16; N odd)
F64_CASES = [(6144, 3072), (5781, 3072), (1001, 270), (1001, 45)]
# the fp64 mma.sync ceiling: blocks of `warps` warps, each lane issuing
# `acc` independent m16n8k<k> products a loop trip on register operands
DMMA_PEAK_SRC = r"""
template <int MK>
__device__ __forceinline__ void mma(double (&d)[4], const double* a,
                                    const double* b) {
  if constexpr (MK == 4) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, {%0, %1, %2, %3};"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]),
          "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]),
          "d"(b[2]), "d"(b[3]));
  }
}

template <int MK, int NACC>
__global__ void __launch_bounds__(512) dmma_peak(double* out, int iters) {
  double acc[NACC][4], a[MK / 2], b[MK / 4];
#pragma unroll
  for (int j = 0; j < NACC; ++j)
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0;
  for (int i = 0; i < MK / 2; ++i) a[i] = 1e-3 * threadIdx.x + i;
  for (int i = 0; i < MK / 4; ++i) b[i] = 1e-3 * blockIdx.x + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) mma<MK>(acc[j], a, b);
  }
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < NACC; ++j)
    for (int i = 0; i < 4; ++i) s += acc[j][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int dmma_peak_launch(int mk, int nacc, int blocks, int threads,
                                double* out, int iters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mk == 4 && nacc == 8)
    dmma_peak<4, 8><<<blocks, threads, 0, st>>>(out, iters);
  else if (mk == 16 && nacc == 8)
    dmma_peak<16, 8><<<blocks, threads, 0, st>>>(out, iters);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}
"""
# (mma k, accumulators a lane, warps a block, blocks a SM)
DMMA_PEAK_CASES = ((4, 8, 16, 1), (4, 8, 8, 1), (4, 8, 8, 4),
                   (16, 8, 16, 1), (16, 8, 8, 4))
TOL64_GRAM_REL = 1e-11


def _timed(torch, fn, reps=REPS):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _f64(torch, build, gram, card):
    """The float64 measurement (--f64, module docstring)."""
    P = ctypes.c_void_p
    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    peak_src, peak_lib = out_dir / "dmma_peak.cu", out_dir / "libdmma_peak.so"
    peak_src.write_text(DMMA_PEAK_SRC)
    peak_proc = subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", str(peak_lib), str(peak_src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    build.launcher("syrk_f64")                  # builds the port's kernels
    lines = build.build_logs()["syrk"].splitlines()
    at = [i for i, ln in enumerate(lines) if "syrk_f64_kernel" in ln]
    ptxas = list(dict.fromkeys(ln.strip() for i in at for ln in lines[i:i + 3]
                               if "registers" in ln or "spill" in ln))
    res = dict(card=card, ptxas=ptxas, cases=[], dmma_peak=[])
    print(f"syrk_f64_kernel: {ptxas}", flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = P(torch.cuda.current_stream().cuda_stream)
    log, _ = peak_proc.communicate()
    if peak_proc.returncode != 0:
        print(f"dmma_peak: nvcc failed:\n{log}", flush=True)
        return 1
    peak = ctypes.CDLL(str(peak_lib)).dmma_peak_launch
    peak.argtypes = [ctypes.c_int] * 4 + [P, ctypes.c_int, P]
    iters = 20000
    for mk, nacc, warps, per_sm in DMMA_PEAK_CASES:
        blocks, threads = sms * per_sm, 32 * warps
        out = torch.empty(blocks * threads, dtype=torch.float64, device=dev)

        def run():
            err = peak(mk, nacc, blocks, threads, P(out.data_ptr()), iters,
                       stream)
            if err:
                raise RuntimeError(f"dmma_peak: CUDA error {err}")
        ms = _timed(torch, run, reps=3)
        flops = blocks * warps * iters * nacc * 16 * 8 * mk * 2
        row = dict(mk=mk, acc=nacc, warps=warps, blocks_per_sm=per_sm,
                   ms=ms, tflops=flops / ms / 1e9)
        res["dmma_peak"].append(row)
        print(f"mma.sync m16n8k{mk}.f64 on registers, {nacc} accumulators a "
              f"lane, {warps} warps x {per_sm} blocks a SM: "
              f"{row['tflops']:.1f} TFLOP/s", flush=True)
    bad = False
    for Kr, N in F64_CASES:
        A = torch.randn(Kr, N, device=dev, dtype=torch.float64,
                        generator=gen)
        ref = A.T @ A
        G, G2 = (torch.zeros(N, N, device=dev, dtype=torch.float64)
                 for _ in range(2))
        gram.syrk_(G, A)
        gram.syrk_(G2, A)
        torch.cuda.synchronize()
        row = dict(Kr=Kr, N=N, schedule=gram.f64_schedule(Kr, N, sms),
                   rel_err=float((G - ref).abs().max() / ref.abs().max()),
                   exact=bool(torch.equal(G, G.T) and torch.equal(G, G2)),
                   ms={"syrk_f64": [], "matmul": []})
        bad |= not (row["rel_err"] <= TOL64_GRAM_REL and row["exact"])
        for key in ("syrk_f64", "matmul", "matmul", "syrk_f64"):  # in turns
            fn = ((lambda: gram.syrk_(G, A)) if key == "syrk_f64"
                  else (lambda: torch.matmul(A.T, A)))
            row["ms"][key].append(_timed(torch, fn))
        flops = Kr * N * (N + 1)
        res["cases"].append(row)
        print(f"float64 Kr={Kr} N={N} schedule {row['schedule']}: "
              + "; ".join(f"{k}: {v} ms ({flops / min(v) / 1e9:.1f} TFLOP/s)"
                          for k, v in row["ms"].items())
              + f"; rel err vs torch.matmul {row['rel_err']}, symmetric and "
              f"repeatable {row['exact']}", flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "syrk_sweep_f64.json").write_text(json.dumps(res, indent=1))
    return 1 if bad else 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("syrk_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from global_lvba_tpu_torch.kernels import build, gram

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    if "--f64" in sys.argv[1:]:
        return _f64(torch, build, gram, card)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    launch = build.launcher("syrk")
    P = ctypes.c_void_p
    gen = torch.Generator(device=dev).manual_seed(0)
    out = dict(card=card, sms=sms, cases=[])

    for N, Kr in CASES:
        A = torch.randn(Kr, N, device=dev, generator=gen)
        hi, lo = gram.tf32_split(A)
        Np, Krp = hi.shape
        nt = Np // gram.TILE
        tiles = nt * (nt + 1) // 2
        schedules = {"one block a tile": (tiles, 1),
                     "tail split": gram.tile_schedule(tiles, Krp // gram.KTILE,
                                                      sms)}

        def runner(full, splits):
            part = torch.empty(max(tiles - full, 1) * splits * gram.TILE ** 2,
                               device=dev)
            count = torch.zeros(max(tiles - full, 1), dtype=torch.int32,
                                device=dev)
            G = torch.zeros(N, N, device=dev)
            stream = P(torch.cuda.current_stream().cuda_stream)

            def run():
                build.check("syrk", launch(
                    P(hi.data_ptr()), P(lo.data_ptr()), Np, Krp, N, full,
                    splits, P(G.data_ptr()), P(part.data_ptr()),
                    P(count.data_ptr()), stream))
            return run, G

        row = dict(N=N, Kr=Kr, tiles=tiles, ktiles=Krp // gram.KTILE,
                   schedules=schedules, ms={k: [] for k in schedules},
                   rel_err={})
        ref = A.double().T @ A.double()
        for label in ("one block a tile", "tail split", "tail split",
                      "one block a tile"):                  # in turns
            run, G = runner(*schedules[label])
            run()
            torch.cuda.synchronize()
            row["rel_err"][label] = float((G.double() - ref).abs().max()
                                          / ref.abs().max())
            row["ms"][label].append(_timed(torch, run))
        out["cases"].append(row)
        flops = 3 * Kr * N * (N + 1)
        print(f"N={N} Kr={Kr} ({tiles} tiles, {Krp // gram.KTILE} k-tiles): "
              + "; ".join(f"{k} {schedules[k]} {row['ms'][k]} ms, "
                          f"{flops / min(row['ms'][k]) / 1e9:.1f} TFLOP/s TF32"
                          for k in schedules)
              + f"; rel err vs float64 {row['rel_err']}", flush=True)
        if max(row["rel_err"].values()) > TOL_GRAM_REL:
            return 1

    As = [torch.randn(kr, 3072, device=dev, generator=gen) for kr in PAIR]
    G = torch.zeros(3072, 3072, device=dev)
    pair = dict(rows=list(PAIR), syrk_ms=[], matmul_ms=[])
    for key in ("syrk_ms", "matmul_ms", "matmul_ms", "syrk_ms"):
        fn = ((lambda: [gram.syrk_(G, A) for A in As]) if key == "syrk_ms"
              else (lambda: [torch.matmul(A.T, A) for A in As]))
        pair[key].append(_timed(torch, fn))
    pair["split_ms"] = _timed(torch, lambda: [gram.tf32_split(A) for A in As])
    out["pair"] = pair
    print(f"aligned-sized pair {PAIR} x 3072: syrk_ {pair['syrk_ms']} ms "
          f"(split {pair['split_ms']:.4f} ms), torch.matmul(A.T, A) "
          f"{pair['matmul_ms']} ms", flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "syrk_sweep.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
