#!/usr/bin/env python3
"""Shows where the port's aggregation kernel (global_lvba_tpu_torch/csrc/
soa_agg.cu) spends its time, on one NVIDIA GPU.  Run from the repository
root:

    python3 scripts/agg_sweep.py

It times soa_agg_buckets, as the evaluation calls it, on the operands of
chip_smoke.py's main path: the W=512 aligned bucket (make_plane_scene(512,
2000), the (W, 12) pose table) and the W=512 corridor's five buckets
(make_corridor_scene(512, 2000), per-entry pose rows), in float32 and
float64, under these configurations:
  * "as built": the kernel as the package builds it;
  * "eigensolve off": a copy whose closing eigh3 is replaced by a few
    moves (what the eigensolve costs);
  * "rotations and eigensolve off": also R μ and R Pc (rot_mean,
    rot_scatter) replaced by sums of the loaded values, so every value is
    still loaded (what loads, shuffles and the rest cost);
  * "dead cells loaded too": μ, Pc and the pose row loaded and rotated for
    every cell, not the live ones only (what skipping dead cells saves);
  * "pose rows not loaded": the identity rotation and an offset from μ in
    place of each entry's pose row (what its three 16-byte loads a lane,
    48 or 96 B apart across a warp, cost);
  * "4 blocks a SM": __launch_bounds__(256, 4), at most 64 registers a
    thread (what occupancy buys, spills included);
  * "4 entries a thread": the package's build with agg_group replaced by
    the shape that gives each thread up to four entries (G the least power
    of two >= K / 4), which the package does not use (its corridor
    gradient rounds 1.4e-4 from the plain version's);
  * "a warp a voxel, rounds of 4 entries a thread": agg_group's G with at
    most four entries a thread, in rounds (the aligned K = 512 in four
    rounds, at 64 registers: what occupancy buys without spills).
The copies are built from the source with the package's nvcc flags into
build/agg_variants/ (ptxas' registers printed) and launched through
soa_agg_buckets with kernels.build.launcher pointed at them.  Only "as
built" (bitwise the package's build) and the two agg_group shapes compute
the function; the others are timed only.  Device ms per evaluation from CUDA
events over calls queued behind a spin kernel, the configurations timed in
order and again in reverse.  Prints one line per case and the card's name
and power limit; writes chiprun_out/agg_sweep.json.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FRAMES, PPF, VOXEL, RATIO = 512, 2000, 1.0, 0.2
REPS = 20
SPIN_CYCLES = 10_000_000

EIG_OFF = ("    eigh3(cov, lam, u, e1, e2);\n",
           "    lam[0] = cov[0]; lam[1] = cov[3]; lam[2] = cov[5];\n"
           "    u[0] = cov[1]; u[1] = cov[2]; u[2] = cov[4];\n"
           "    e1[0] = e1[1] = e1[2] = cov[0];\n"
           "    e2[0] = e2[1] = e2[2] = cov[5];\n")
ROT_OFF = ("        rot_mean(P, x, Rm1, Rm2, Rm3);\n"
           "        rot_scatter(P, x, RP);\n",
           "        Rm1 = x.m1 + P.R11 + P.R12 + P.R13;\n"
           "        Rm2 = x.m2 + P.R21 + P.R22 + P.R23;\n"
           "        Rm3 = x.m3 + P.R31 + P.R32 + P.R33;\n"
           "        RP[0] = x.P11; RP[1] = x.P12; RP[2] = x.P13;\n"
           "        RP[3] = x.P12; RP[4] = x.P22; RP[5] = x.P23;\n"
           "        RP[6] = x.P13; RP[7] = x.P23; RP[8] = x.P33;\n")
DEAD_LOADED = ("      if (en[e] > T(0.)) {\n", "      if (true) {\n")
NO_POSE = (
    "        const Pose<T> P = pose_row(pose_v + 12 * (c - row), vec);\n",
    "        const Pose<T> P = {T(1.), T(0.), T(0.), T(0.), T(1.), T(0.),\n"
    "                           T(0.), T(0.), T(1.), x.m1, x.m2, x.m3};\n")
OCC4 = ("__global__ void __launch_bounds__(kThreads)\n",
        "__global__ void __launch_bounds__(kThreads, 4)\n")
VARIANTS = {
    "as built": (),
    "eigensolve off": (EIG_OFF,),
    "rotations and eigensolve off": (EIG_OFF, ROT_OFF),
    "dead cells loaded too": (DEAD_LOADED,),
    "pose rows not loaded": (NO_POSE,),
    "4 blocks a SM": (OCC4,),
}


def _four_a_thread(K):
    """(log2 G, EPT) with up to four entries a thread: G the least power
    of two >= K / 4 up to a warp, EPT the least power of two with G·EPT
    >= K up to 16 (the launcher derives the same G from K and EPT)."""
    G = 1
    while G * 4 < K and G < 32:
        G *= 2
    ept = 1
    while G * ept < K and ept < 16:
        ept *= 2
    return G.bit_length() - 1, ept


def _rounds_of_four(K):
    """(log2 G, EPT) as agg_group's G (the least power of two >= K up to a
    warp) with at most four entries a thread: K above 128 takes rounds
    (at K = 512: four, in the 64 registers of 4 blocks a SM)."""
    G = 1
    while G < K and G < 32:
        G *= 2
    ept = 1
    while G * ept < K and ept < 4:
        ept *= 2
    return G.bit_length() - 1, ept


POLICIES = {"4 entries a thread": _four_a_thread,
            "a warp a voxel, rounds of 4 entries a thread": _rounds_of_four}


def _timed(torch, fn):
    """Device ms per call of fn(), the calls queued behind a spin kernel
    (as chip_smoke.py's _timed)."""
    fn()
    fn()
    torch.cuda.synchronize()
    spin = SPIN_CYCLES
    for _ in range(6):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        t0.record()
        for _ in range(REPS):
            fn()
        t1.record()
        ahead = not t0.query()
        torch.cuda.synchronize()
        if ahead:
            break
        spin *= 4
    return t0.elapsed_time(t1) / REPS


def _operands(torch, dev):
    """{"aligned": [(n, mu, Pc, pose12)], "corridor": [(n, mu, Pc, rows)
    per bucket]} in float32."""
    from global_lvba_tpu_torch.__main__ import slice_config
    from global_lvba_tpu_torch.factors.padding import buckets_to_device
    from global_lvba_tpu_torch.factors.plane_eigen import pose_table
    from global_lvba_tpu_torch.kernels.selection import table_select
    from global_lvba_tpu_torch.map.voxelize import build_voxel_map
    from global_lvba_tpu_torch.models.synthetic import (
        make_corridor_scene, make_plane_scene, perturb_poses)

    cfg = slice_config("float32")
    out = {}
    for name, make in (("aligned", make_plane_scene),
                       ("corridor", make_corridor_scene)):
        sc = make(FRAMES, PPF, seed=0)
        Rp, pp = perturb_poses(sc.R_true, sc.p_true, 0.003, 0.01, seed=1)
        vm = build_voxel_map(sc.points_body, sc.frame_ids, Rp, pp, VOXEL,
                             eigen_ratios=[RATIO] * 4,
                             min_ps=cfg.solver.min_ps,
                             layer_limit=cfg.solver.layer_limit)
        bs = buckets_to_device(vm, W=FRAMES, dtype=torch.float32, device=dev)
        pose12 = pose_table(
            torch.as_tensor(Rp, dtype=torch.float32, device=dev),
            torch.as_tensor(pp, dtype=torch.float32, device=dev))
        ops = []
        for fa in bs:
            if name == "aligned":
                ops.append((fa.n, fa.mu, fa.Pc, pose12))
            else:
                V, K = fa.n.shape
                rows = table_select(fa.frame.reshape(-1), pose12)
                ops.append((fa.n, fa.mu, fa.Pc, rows.reshape(V, K, 12)))
        out[name] = ops
    return out


def _registers(log):
    """{"float, EPT e" / "double, EPT e": registers} of soa_agg_kernel's
    instances from ptxas' -v report."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '\S*soa_agg_kernelI([fd])Li(\d+)E",
                      line)
        if m:
            cur = f"{'float' if m[1] == 'f' else 'double'}, EPT {m[2]}"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = int(m[1])
            cur = None
    return out


def _build_variants(build):
    """{variant: {launcher key: bound function}} and {variant: {kernel
    instance: registers}}: each VARIANTS copy of soa_agg.cu built by its own
    nvcc, all started together."""
    src = (build.CSRC / "soa_agg.cu").read_text()
    out_dir = ROOT / "build" / "agg_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the edit's target is not once "
                                   f"in soa_agg.cu:\n{old}")
            text = text.replace(old, new)
        cu = out_dir / f"soa_agg_v{i}.cu"
        cu.write_text(text)
        so = out_dir / f"libsoa_agg_v{i}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", str(so), str(cu)]
        jobs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    fns, regs = {}, {}
    for name, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs[name] = _registers(log)
        lib = ctypes.CDLL(str(so))
        fns[name] = {}
        for key in ("soa_agg", "soa_agg_f64"):
            _, cname, argtypes = build.SIGNATURES[key]
            fn = getattr(lib, cname)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[name][key] = fn
    return fns, regs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("agg_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from global_lvba_tpu_torch.kernels import build, soa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    operands = _operands(torch, dev)
    fns, regs = _build_variants(build)
    for name, r in regs.items():
        print(f"[agg_sweep] {name}: registers {r}", flush=True)
    own_launcher, own_group = build.launcher, soa.agg_group

    def run(config, ops):
        if config in POLICIES:
            soa.agg_group = POLICIES[config]
        else:
            build.launcher = fns[config].__getitem__
        try:
            return soa.soa_agg_buckets(ops)
        finally:
            build.launcher, soa.agg_group = own_launcher, own_group

    configs = [*VARIANTS, *POLICIES]
    results = []
    for dt in (torch.float32, torch.float64):
        for opname, ops32 in operands.items():
            ops = [tuple(t.to(dt) for t in o) for o in ops32]
            ref = soa.soa_agg_buckets(ops)
            ms = {c: [] for c in configs}
            for order in (configs, configs[::-1]):
                for c in order:
                    ms[c].append(_timed(torch, lambda: run(c, ops)))
            for c in configs:
                outs = run(c, ops)
                torch.cuda.synchronize()
                row = dict(dtype=str(dt).replace("torch.", ""),
                           operand=opname, config=c, ms=ms[c],
                           Ks=[int(o[0].shape[1]) for o in ops])
                note = "timed only"
                ok = True
                if c == "as built":
                    ok = all(torch.equal(a[0], b[0])
                             and torch.equal(a[1], b[1])
                             for a, b in zip(outs, ref))
                    note = f"bitwise the package's build: {ok}"
                elif c in POLICIES:
                    rel = max(float((a[0] - b[0]).abs().max())
                              / max(float(b[0].abs().max()), 1e-30)
                              for a, b in zip(outs, ref))
                    finite = all(bool(torch.isfinite(a[1]).all())
                                 for a in outs)
                    ok = finite and (dt == torch.float32 or rel <= 1e-9)
                    note = (f"residv vs the package's {rel:.2e} of max, pv "
                            f"finite {finite}")
                row["ok"] = ok
                results.append(row)
                print(f"[agg_sweep] {row['dtype']} {opname} (K "
                      f"{row['Ks']}) {c}: {ms[c][0]:.4f}, {ms[c][1]:.4f} ms; "
                      f"{note}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "agg_sweep.json").write_text(json.dumps(
        dict(card=card, registers=regs, results=results), indent=1))
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
