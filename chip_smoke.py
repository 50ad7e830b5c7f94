#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (global_lvba_tpu_torch) on one
NVIDIA GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. set-up: the card's name and power limit, TF32 off, the kernels built
     from global_lvba_tpu_torch/csrc (timed);
  2. kernels: each CUDA kernel against its plain PyTorch version on the
     card, at the shapes the main path gives it (the W=512 scene below,
     every voxel chunk of one evaluation), with the tolerance printed,
     and timed (device time per evaluation = every chunk, calls queued
     behind a spin kernel so host time between launches does not show)
     beside its plain version, the one PyTorch call that computes the same
     function where there is one, and its bound on this card;
  3. evaluation: plane_cost_grad_hess through the kernels against the same
     evaluation through the plain versions; the Hessian of two kernel
     evaluations must be bitwise equal; one evaluation under
     torch.profiler gives each kernel's own device time;
  4. slice: run_lidar_ba on 512 frames / 1.02 M points (window stage off,
     both global stages at voxel size 1.0, eigen ratio 0.2, float32) with
     the launch counts set to 0 just before and read just after; every
     kernel must have run, the ATE must fall at least 5x and land within
     10% of the same run in float64 on the CPU (the port's plain path,
     which the CPU tests hold to the JAX package at 1e-8);
  5. the JAX bench's W=512 problem (bench.py bench_w512: voxel map at the
     true poses, lm_damping_iter from the perturbed ones) on the card: the
     ATE must reach <= 1 mm (the JAX package's figure is 0.00067 m); a
     second run under torch.profiler gives the device's busy and idle share.
The line before the last lists the kernels as JSON; the last line is
{"ok": true, "device": {...}}.  A copy of the results goes to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

FRAMES = 512
PPF = 2000
VOXEL = 1.0
RATIO = 0.2
REPS = 10
LM_ITERS = 10
SPIN_CYCLES = 10_000_000   # ~5 ms at 1.98 GHz; _timed raises it as needed

# published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# flops per (voxel, frame) cell, counted from csrc/soa_agg.cu (two passes)
# and csrc/soa_chain.cu (R·μ, R·Pc and the chain); per-voxel eigensolve
AGG_FLOPS_PER_CELL = 151
AGG_FLOPS_PER_VOXEL = 250
CHAIN_FLOPS_PER_CELL = 560

# Kernel vs plain version, both float32 on the card.  λ_min (residv) and
# the cost r are compared on every voxel.  On line-like voxels (λ1 − λ0 <
# 1e-2·λ2; 26 of the 1,634 voxels of this scene) the closed-form
# eigensolve is ill-conditioned in float32, in the plain version as much
# as in the kernel: λ comes from acos(r) with r near ±1, where acos' blows
# up, so λ_min keeps only about sqrt(eps) of λ_max, and u and the B rows
# swing with the last bits of the covariance.  λ_min is held there to
# 2·sqrt(eps_f32)·λ_max (its distance to float64 is printed for both
# versions), and u, B and the g/H of the evaluation are compared on the
# other voxels, where plain float32 agrees with float64 to ~1e-6;
# finiteness and the exact zeros of padded voxels are checked on all of
# them.  B1, B2 are compared through BᵀB (B1, B2 themselves are arbitrary
# within the plane when λ1 ≈ λ2, and only BᵀB reaches H).
WELL_CONDITIONED_GAP = 1e-2
TOL_RESIDV_REL = 1e-5    # λ_min, per voxel relative to its λ_max
TOL_RESIDV_REL_LINE = 2 * 2.0 ** -11.5   # 6.9e-4, the same on line-like voxels
TOL_PV = 1e-4            # u (sign aligned) abs; BᵀB, v̄, 1/N relative
TOL_ROWS_REL = 1e-3      # factor rows A, relative to max |A|: the chain
                         # cancels (H1 − R·hat(c)); the plain version's own
                         # float32-vs-float64 departure is printed beside it
TOL_SUM_REL = 1e-3       # g, Hd: voxel sums, relative to their max |.|
TOL_GRAM_REL = 1e-4      # AᵀA over 3V = 4,095 rows, relative to max |AᵀA|
TOL_EVAL_REL = 1e-4      # r on all voxels; g, H on well-conditioned voxels
KERNEL_SYMBOLS = {"soa_agg": "soa_agg_kernel", "soa_chain": "soa_chain_kernel",
                  "syrk": "syrk_kernel"}


def _fail(msg):
    raise AssertionError(msg)


def _rel(a, b):
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / (scale if scale > 0 else 1.0)


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def _timed(torch, fn, reps=REPS):
    """Device ms per call of fn(): after two warm-up calls, `reps` calls are
    queued behind a spin kernel and CUDA events bracket them.  The host has
    queued every call before the device reaches the first, so host time
    between launches does not show; where it had not (the start event
    already passed when the host was done), the spin is made longer and
    the run repeated.  Returns (ms, queued_ahead)."""
    fn()
    fn()
    torch.cuda.synchronize()
    spin = SPIN_CYCLES
    for _ in range(4):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        ahead = not t0.query()
        torch.cuda.synchronize()
        if ahead:
            break
        spin *= 4
    return t0.elapsed_time(t1) / reps, ahead


def _times(torch, name, kernel, plain, library=None):
    """Device ms per evaluation of a kernel's wrapper, its plain version and
    the library call (None where there is none), printed."""
    out, ahead = {}, {}
    for key, fn in (("ms", kernel), ("plain_ms", plain),
                    ("library_ms", library)):
        if fn is None:
            out[key] = None
            continue
        out[key], ahead[key] = _timed(torch, fn)
    print(f"[{name}] device ms per evaluation: {out}; every call queued "
          f"ahead of the device: {ahead}", flush=True)
    out["queued_ahead"] = ahead
    return out


def _bound(nbytes, flops):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = flops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _pv_errors(torch, k, p):
    """(u abs err with signs aligned, BᵀB rel err, [v̄, 1/N] rel err)."""
    s = torch.sign((k[:, :3] * p[:, :3]).sum(1, keepdim=True))
    u = (k[:, :3] * torch.where(s == 0, torch.ones_like(s), s) - p[:, :3])

    def btb(q):
        return (q[:, 3:6, None] * q[:, None, 3:6]
                + q[:, 6:9, None] * q[:, None, 6:9])

    return (float(u.abs().max()), _rel(btb(k), btb(p)),
            _rel(k[:, 9:13], p[:, 9:13]))


def _spectrum(torch, fa, pose12):
    """((λ1 − λ0) / λ2, λ0, λ2) per voxel, in float64."""
    from global_lvba_tpu_torch.factors.plane_eigen import (
        _moment_channels, _pose_channels, _soa_agg)
    from global_lvba_tpu_torch.ops.eigh3 import eigvals3_soa

    d = torch.float64
    mu3, P6 = _moment_channels(fa.mu.to(d), fa.Pc.to(d))
    R9, p3 = _pose_channels(pose12.to(d))
    cov6 = _soa_agg(fa.n.to(d), mu3, P6, R9, p3)[-1]
    lam0, lam1, lam2 = eigvals3_soa(*cov6)
    return (lam1 - lam0) / lam2.abs().clamp(min=1e-30), lam0, lam2


def _device_ms(prof):
    """{key: (device ms summed over calls, calls)} of a torch.profiler run,
    from each key's own device time (empty if the profiler saw none)."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            out[e.key] = (us / 1e3, e.count)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import global_lvba_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2

    import numpy as np

    from global_lvba_tpu_torch import resolve_device
    from global_lvba_tpu_torch.__main__ import slice_config
    from global_lvba_tpu_torch.factors.padding import (
        buckets_to_device, picks_aligned)
    from global_lvba_tpu_torch.factors.plane_eigen import (
        PLAIN_STEPS, _cost_grad_hess, plane_cost_grad_hess, pose_table,
        voxel_chunks)
    from global_lvba_tpu_torch.kernels import (
        build, launch_counts, reset_launch_counts)
    from global_lvba_tpu_torch.kernels.gram import syrk_, syrk_plain_
    from global_lvba_tpu_torch.kernels.soa import (
        soa_agg, soa_agg_plain, soa_chain, soa_chain_plain)
    from global_lvba_tpu_torch.map.voxelize import build_voxel_map
    from global_lvba_tpu_torch.models.synthetic import (
        ate_rmse, make_plane_scene, perturb_poses)
    from global_lvba_tpu_torch.pipeline.lidar_ba import run_lidar_ba
    from global_lvba_tpu_torch.solver.dist_solve import solve_damped_cg
    from global_lvba_tpu_torch.solver.lm import LIDAR_CG_ITERS, lm_damping_iter

    results = {}

    # ---- 1. set-up ----
    card = _card_line()
    print(card, flush=True)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device {torch.cuda.get_device_name(0)}; TF32 off (matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32}); torch {torch.__version__} "
          f"CUDA {torch.version.cuda}", flush=True)
    t0 = time.time()
    for name in build.SOURCES:
        build.launcher(name)
    results["build_s"] = time.time() - t0
    print(f"[setup] kernels built in {results['build_s']:.1f} s", flush=True)
    for name, log in build.build_logs().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "(reused)" in line:
                print(f"[setup] {name}: {line.strip()}", flush=True)

    # ---- the main path's problem: the W=512 scene, stage-1 voxelization ----
    W = FRAMES
    cfg = slice_config("float32")
    scene = make_plane_scene(num_frames=W, points_per_frame=PPF, seed=0)
    Rp, pp = perturb_poses(scene.R_true, scene.p_true, 0.003, 0.01, seed=1)
    vm = build_voxel_map(
        scene.points_body, scene.frame_ids, Rp, pp, VOXEL,
        eigen_ratios=[RATIO] * 4, min_ps=cfg.solver.min_ps,
        layer_limit=cfg.solver.layer_limit,
    )
    entries = sum(int((b.n > 0).sum()) for b in vm.buckets)
    bucket_cells = sum(int(np.prod(b.n.shape)) for b in vm.buckets)
    ratio = vm.num_planes * W / bucket_cells
    if not picks_aligned(vm, W):
        _fail(f"the density gate does not pick the aligned layout ({ratio})")
    fa = buckets_to_device(vm, W=W, dtype=torch.float32, device=dev)[0]
    V = fa.n.shape[0]
    R = torch.as_tensor(Rp, dtype=torch.float32, device=dev)
    p = torch.as_tensor(pp, dtype=torch.float32, device=dev)
    pose12 = pose_table(R, p)
    chunks = voxel_chunks(V, W)
    print(f"[scene] {scene.points_body.shape[0]} points, {vm.num_planes} "
          f"planar voxels padded to V={V}, {entries} live (voxel, frame) "
          f"entries, dense/bucketed cells {ratio:.3f}; chunks "
          f"{[hi - lo for lo, hi in chunks]}", flush=True)
    results["scene"] = dict(points=int(scene.points_body.shape[0]),
                            voxels=vm.num_planes, V=V, W=W, entries=entries,
                            chunks=[hi - lo for lo, hi in chunks])
    ops = [(fa.n[lo:hi], fa.mu[lo:hi], fa.Pc[lo:hi]) for lo, hi in chunks]
    live = fa.n.sum(dim=1) > 0
    gap, lam0, lam2 = _spectrum(torch, fa, pose12)
    wc = live & (gap >= WELL_CONDITIONED_GAP)
    n_ill = int((live & ~wc).sum())
    print(f"[scene] {n_ill} of {int(live.sum())} voxels line-like (λ1 − λ0 < "
          f"{WELL_CONDITIONED_GAP}·λ2)", flush=True)
    results["scene"]["line_like_voxels"] = n_ill
    kern = {}

    # ---- 2a. soa_agg ----
    agg_k = [soa_agg(*o, pose12) for o in ops]
    agg_p = [soa_agg_plain(*o, pose12) for o in ops]
    rk = torch.cat([a[0] for a in agg_k])
    rp = torch.cat([a[0] for a in agg_p])
    pvk = torch.cat([a[1] for a in agg_k])
    pvp = torch.cat([a[1] for a in agg_p])
    torch.cuda.synchronize()
    line_like = live & ~wc

    def r_err(a, b, where):
        d = (a.double() - b.double()).abs()[where] / lam2[where].abs()
        return float(d.max()) if d.numel() else 0.0

    err_r = float((rk - rp).abs()[live].max())
    err_r_rel = r_err(rk, rp, wc)
    err_r_line = r_err(rk, rp, line_like)
    line64 = (r_err(rk, lam0, line_like), r_err(rp, lam0, line_like))
    err_u, err_bb, err_vn = _pv_errors(torch, pvk[wc], pvp[wc])
    dead_ok = bool((rk[~live] == 0).all())
    finite = bool(torch.isfinite(rk).all() and torch.isfinite(pvk).all())
    # the frame-id path (the bucketed layout's pose gather) with frame k at
    # slot k must give the aligned result bit for bit
    n0, mu0, Pc0 = ops[0]
    frame = torch.arange(W, dtype=torch.int32, device=dev).expand(
        n0.shape[0], W).contiguous()
    same_frame = all(torch.equal(a, b) for a, b in zip(
        soa_agg(n0, mu0, Pc0, pose12, frame=frame), agg_k[0]))
    print(f"[soa_agg] residv max abs err {err_r:.3e} on all live voxels; "
          f"err / λ_max {err_r_rel:.3e} on well-conditioned voxels (tol "
          f"{TOL_RESIDV_REL}), {err_r_line:.3e} on line-like voxels (tol "
          f"{TOL_RESIDV_REL_LINE:.3e}; there kernel vs float64 "
          f"{line64[0]:.3e}, plain vs float64 {line64[1]:.3e}); "
          f"well-conditioned voxels: u abs err {err_u:.3e}, BᵀB rel err "
          f"{err_bb:.3e}, v̄/(1/N) rel err {err_vn:.3e} (tol {TOL_PV}); all "
          f"voxels finite: {finite}; padded voxels residv == 0: {dead_ok}; "
          f"frame-id path equal: {same_frame}", flush=True)
    if not (err_r_rel <= TOL_RESIDV_REL and err_r_line <= TOL_RESIDV_REL_LINE
            and max(err_u, err_bb, err_vn) <= TOL_PV
            and dead_ok and finite and same_frame):
        _fail("soa_agg disagrees with soa_agg_plain")
    nb = sum(o[0].shape[0] for o in ops)
    kern["soa_agg"] = dict(
        max_abs_err=err_r,
        **_times(torch, "soa_agg",
                 lambda: [soa_agg(*o, pose12) for o in ops],
                 lambda: [soa_agg_plain(*o, pose12) for o in ops]),
        bound=_bound(nb * W * 13 * 4 + len(ops) * W * 12 * 4 + nb * 17 * 4,
                     nb * W * AGG_FLOPS_PER_CELL + nb * AGG_FLOPS_PER_VOXEL),
    )

    # ---- 2b. soa_chain (both versions take the kernel's pv) ----
    pvs = [a[1] for a in agg_k]
    ch_k = [soa_chain(*o, pose12, q) for o, q in zip(ops, pvs)]
    ch_p = [soa_chain_plain(*o, pose12, q) for o, q in zip(ops, pvs)]
    torch.cuda.synchronize()
    err_A = max(_rel(a[0], b[0]) for a, b in zip(ch_k, ch_p))
    gk, gp = sum(a[1] for a in ch_k), sum(b[1] for b in ch_p)
    hk, hp = sum(a[2] for a in ch_k), sum(b[2] for b in ch_p)
    err_g, err_hd = _rel(gk, gp), _rel(hk, hp)
    abs_A = max(float((a[0] - b[0]).abs().max()) for a, b in zip(ch_k, ch_p))
    err_A64 = max(
        _rel(b[0].double(),
             soa_chain_plain(*(x.double() for x in o), pose12.double(),
                             q.double())[0])
        for o, q, b in zip(ops, pvs, ch_p))
    dead_rows = torch.cat([a[0].reshape(-1, 3, 6 * W) for a in ch_k])[~live]
    dead_ok = bool((dead_rows == 0).all())
    print(f"[soa_chain] rows rel err {err_A:.3e} (tol {TOL_ROWS_REL}; plain "
          f"float32 vs float64 {err_A64:.3e}); g rel "
          f"err {err_g:.3e}, Hd rel err {err_hd:.3e} (tol {TOL_SUM_REL}); "
          f"padded voxels' rows == 0: {dead_ok}", flush=True)
    if not (err_A <= TOL_ROWS_REL and err_g <= TOL_SUM_REL
            and err_hd <= TOL_SUM_REL and dead_ok):
        _fail("soa_chain disagrees with soa_chain_plain")
    kern["soa_chain"] = dict(
        max_abs_err=abs_A,
        **_times(torch, "soa_chain",
                 lambda: [soa_chain(*o, pose12, q) for o, q in zip(ops, pvs)],
                 lambda: [soa_chain_plain(*o, pose12, q)
                          for o, q in zip(ops, pvs)]),
        bound=_bound(nb * W * 13 * 4 + len(ops) * W * 12 * 4 + nb * 16 * 4
                     + nb * W * 18 * 4 + W * 42 * 4,
                     nb * W * CHAIN_FLOPS_PER_CELL),
    )

    # ---- 2c. syrk ----
    As = [a[0] for a in ch_k]
    N = 6 * W
    gram_k = torch.zeros((N, N), dtype=torch.float32, device=dev)
    gram_p = torch.zeros_like(gram_k)
    for A in As:
        syrk_(gram_k, A)
        syrk_plain_(gram_p, A)
    gram_l = sum(torch.matmul(A.T, A) for A in As)
    torch.cuda.synchronize()
    err_gram = _rel(gram_k, gram_p)
    err_lib = _rel(gram_k, gram_l)
    sym = bool(torch.equal(gram_k, gram_k.T))
    print(f"[syrk] rel err vs syrk_plain_ {err_gram:.3e}, vs torch.matmul "
          f"{err_lib:.3e} (tol {TOL_GRAM_REL}); exactly symmetric: {sym}",
          flush=True)
    if not (err_gram <= TOL_GRAM_REL and err_lib <= TOL_GRAM_REL and sym):
        _fail("syrk_ disagrees with AᵀA")
    scratch = torch.zeros_like(gram_k)
    kr = sum(A.shape[0] for A in As)
    kern["syrk"] = dict(
        max_abs_err=float((gram_k - gram_p).abs().max()),
        **_times(torch, "syrk",
                 lambda: [syrk_(scratch, A) for A in As],
                 lambda: [syrk_plain_(scratch, A) for A in As],
                 lambda: [torch.matmul(A.T, A) for A in As]),
        bound=_bound(kr * N * 4 + len(As) * 2 * N * N * 4, kr * N * (N + 1)),
    )
    del scratch, gram_k, gram_p, gram_l, As, ch_k, ch_p

    # ---- 3. evaluation ----
    r1, g1, H1 = plane_cost_grad_hess(fa, R, p, W)
    r2, g2, H2 = plane_cost_grad_hess(fa, R, p, W)
    torch.cuda.synchronize()
    same = bool(torch.equal(r1, r2) and torch.equal(g1, g2)
                and torch.equal(H1, H2))
    same = same and bool(torch.isfinite(H1).all() and torch.isfinite(g1).all())
    rq = _cost_grad_hess(PLAIN_STEPS, fa, R, p, W)[0]
    # r sums λ_min over every voxel: the line-like voxels may add up to
    # their own tolerance (TOL_RESIDV_REL_LINE · λ_max each)
    r_slack = TOL_RESIDV_REL_LINE * float(lam2[line_like].abs().sum())
    e_r = max(0.0, abs(float(r1) - float(rq)) - r_slack) / abs(float(rq))
    fa_wc = fa._replace(n=fa.n * wc[:, None].to(fa.n.dtype))
    _, gk_, Hk_ = plane_cost_grad_hess(fa_wc, R, p, W)
    _, gq, Hq = _cost_grad_hess(PLAIN_STEPS, fa_wc, R, p, W)
    e_g, e_H = _rel(gk_, gq), _rel(Hk_, Hq)
    del gk_, Hk_, fa_wc
    eval_ms, ahead_e = _timed(torch, lambda: plane_cost_grad_hess(fa, R, p, W))
    plain_eval_ms, ahead_pe = _timed(
        torch, lambda: _cost_grad_hess(PLAIN_STEPS, fa, R, p, W))
    print(f"[eval] kernels vs plain: r rel err {e_r:.3e} (all voxels, beyond "
          f"the line-like voxels' {r_slack:.3e}; raw "
          f"{abs(float(r1) - float(rq)) / abs(float(rq)):.3e}), g "
          f"{e_g:.3e}, H {e_H:.3e} (well-conditioned voxels) (tol "
          f"{TOL_EVAL_REL}); full problem finite and bitwise repeatable: "
          f"{same}; eval {eval_ms:.4f} ms device time (queued ahead "
          f"{ahead_e}), plain {plain_eval_ms:.4f} ms (queued ahead "
          f"{ahead_pe})", flush=True)
    if not (e_r <= TOL_EVAL_REL and e_g <= TOL_EVAL_REL
            and e_H <= TOL_EVAL_REL and same):
        _fail("the kernel evaluation disagrees with the plain one or is "
              "not repeatable")
    Hf, gf = H1.reshape(6 * W, 6 * W), g1.reshape(-1)
    u0 = torch.tensor(0.01, dtype=Hf.dtype, device=dev)
    cg_ms, _ = _timed(torch, lambda: solve_damped_cg(
        Hf, gf, u0, max_iters=LIDAR_CG_ITERS))
    print(f"[eval] damped block-Jacobi CG solve (6W = {6 * W}, at most "
          f"{LIDAR_CG_ITERS} trips): {cg_ms:.3f} ms", flush=True)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        plane_cost_grad_hess(fa, R, p, W)
        torch.cuda.synchronize()
    prof_eval = _device_ms(prof)
    for name, sym in KERNEL_SYMBOLS.items():
        hits = [(k, v) for k, v in prof_eval.items() if sym in k]
        if hits:
            ms_k, calls = hits[0][1]
            kern[name]["kernel_device_ms"] = ms_k
            print(f"[eval] profiler: {sym} {ms_k:.4f} ms device time in "
                  f"{calls} launches per evaluation", flush=True)
        else:
            print(f"[eval] profiler: {sym}: device time not measured",
                  flush=True)
    top = sorted(prof_eval.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"[eval] profiler, device time per evaluation (ms, calls): "
          f"{[(k[:48], round(v[0], 4), v[1]) for k, v in top]}", flush=True)
    results["eval"] = dict(ms=eval_ms, plain_ms=plain_eval_ms, r_rel=e_r,
                           g_rel=e_g, H_rel=e_H, bitwise_repeatable=same,
                           cg_solve_ms=cg_ms, queued_ahead=ahead_e,
                           profiler_device_ms=prof_eval)
    del r1, g1, H1, r2, g2, H2, rq, gq, Hq, fa, Hf, gf

    # ---- 4. slice: run_lidar_ba on the card ----
    clouds = [scene.points_body[scene.frame_ids == i] for i in range(W)]
    reset_launch_counts()
    t0 = time.time()
    res = run_lidar_ba(clouds, Rp, pp, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    ate0 = ate_rmse(pp, scene.p_true)
    ate = ate_rmse(res.p_opt, scene.p_true)
    stages = res.stats["global"]
    iters = sum(s.get("lm_iters", 0) for s in stages)
    lm_s = sum(s.get("lm_s", 0.0) for s in stages)
    ms_iter = lm_s / max(iters, 1) * 1e3
    print(f"[slice] run_lidar_ba {W} frames: ATE {ate0:.6f} -> {ate:.6f} m, "
          f"wall {wall:.2f} s, {iters} LM iterations in {lm_s:.3f} s "
          f"({ms_iter:.2f} ms/iter), launches {counts}", flush=True)
    for s in stages:
        print(f"[slice] stage {s}", flush=True)
    results["slice"] = dict(ate0=ate0, ate=ate, wall_s=wall, lm_iters=iters,
                            lm_s=lm_s, ms_per_iter=ms_iter, stages=stages,
                            launches=counts)
    if not all(counts[k] > 0 for k in ("soa_agg", "soa_chain", "syrk")):
        _fail(f"a kernel of the path was never launched: {counts}")
    t0 = time.time()
    ref = run_lidar_ba(clouds, Rp, pp, slice_config("float64"), device="cpu")
    ate_ref = ate_rmse(ref.p_opt, scene.p_true)
    print(f"[slice] float64 reference on the CPU: ATE {ate_ref:.6f} m "
          f"({time.time() - t0:.1f} s)", flush=True)
    results["slice"]["ate_float64_cpu"] = ate_ref
    if not (np.isfinite(res.p_opt).all() and ate <= ate0 / 5
            and abs(ate - ate_ref) <= 0.1 * ate_ref):
        _fail(f"ATE {ate0} -> {ate} (float64 reference {ate_ref})")

    # ---- 5. the bench's W=512 problem: voxel map at the true poses ----
    vm_t = build_voxel_map(
        scene.points_body, scene.frame_ids, scene.R_true, scene.p_true,
        VOXEL, eigen_ratios=[RATIO] * 4)
    fa_t = buckets_to_device(vm_t, W=W, dtype=torch.float32, device=dev)
    lm_damping_iter(fa_t, R, p, max_iters=LM_ITERS)
    torch.cuda.synchronize()
    t0 = time.time()
    lm = lm_damping_iter(fa_t, R, p, max_iters=LM_ITERS)
    torch.cuda.synchronize()
    lm_wall = time.time() - t0
    ate_b = ate_rmse(lm.p.double().cpu().numpy(), scene.p_true)
    print(f"[bench-problem] lm_damping_iter W={W}: ATE {ate0:.6f} -> "
          f"{ate_b:.6f} m in {lm.iters} iterations, {lm_wall * 1e3:.1f} ms "
          f"({lm_wall / max(lm.iters, 1) * 1e3:.2f} ms/iter incl. the "
          f"initial evaluation)", flush=True)
    results["bench_problem"] = dict(ate=ate_b, iters=lm.iters,
                                    wall_ms=lm_wall * 1e3)
    if not ate_b <= 1e-3:
        _fail(f"bench problem ATE {ate_b} > 1 mm")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm_damping_iter(fa_t, R, p, max_iters=LM_ITERS)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    busy = sum(v[0] for v in _device_ms(prof).values())
    idle = 1.0 - busy / (prof_wall * 1e3)
    print(f"[bench-problem] under torch.profiler: {prof_wall * 1e3:.1f} ms "
          f"wall, {busy:.1f} ms device busy, idle share {idle:.3f}",
          flush=True)
    results["bench_problem"].update(profiled_wall_ms=prof_wall * 1e3,
                                    device_busy_ms=busy, idle_share=idle)

    src = "global_lvba_tpu_torch/csrc/"
    replaces = {
        "soa_agg": "global_lvba_tpu/ops/pallas/soa_fused.py:61",
        "soa_chain": "global_lvba_tpu/ops/pallas/soa_fused.py:73",
        "syrk": "global_lvba_tpu/ops/pallas/gram.py:41",
    }
    line = {"kernels": [
        dict(name=k, route="cuda", source=f"{src}{k}.cu",
             replaces=replaces[k], launches=counts[k],
             max_abs_err=v["max_abs_err"], ms=v["ms"],
             plain_ms=v["plain_ms"], bound_ms=v["bound"][0],
             bound_by=v["bound"][1], library_ms=v["library_ms"])
        for k, v in kern.items()
    ]}
    results["kernels"] = line["kernels"]
    results["kernel_timing"] = {
        k: dict(queued_ahead=v["queued_ahead"],
                kernel_device_ms=v.get("kernel_device_ms"))
        for k, v in kern.items()}
    results["card"] = card
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(results, indent=1,
                                                    default=float))
    print(json.dumps(line, default=float))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
