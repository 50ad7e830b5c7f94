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
