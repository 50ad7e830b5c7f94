#!/usr/bin/env python3
"""Checks and times the port's two z-buffers on one NVIDIA GPU, the
depth maps' (global_lvba_tpu_torch/csrc/zbuffer.cu) and the colored
clouds' (csrc/colorize.cu), beside an earlier tree's.  Run from the
repository root:

    python3 scripts/zbuffer_sweep.py [--parent DIR] [--calls N] [--variants]

Operands, at chip_smoke.py's sizes:
  * zbuffer: ladder 3's depth stage, make_joint_scene(200, 10000, 8,000
    landmarks, seed 13) at its true poses: the grid map's 2.0 M points,
    200 images of 240 x 192 and their covisible ranges (image_ranges);
  * colorize: phase 21's export, make_plane_scene(96, 10000, seed 5) in
    the world at its true poses and the 48 room_views(48, 0.15) of 640 x
    512 (the reference camera at scale 0.5), each with its +-0.5 s LiDAR
    window.
With --parent DIR (a checkout of an earlier tree, e.g. `git archive` of
the parent commit unpacked into a directory that .gitignore lists), that
tree's zbuffer.cu and colorize.cu are built beside the package's and
called as that tree's wrappers called them (the z-buffer's longest image
read back to size its grid; the colorization's window check and its
torch.nonzero compaction, two read backs); the configurations run in
turns, parent, new, new, parent.

With --variants, copies of the package's zbuffer.cu with one line
changed (VARIANTS: the guard read of a pixel from L2 instead of L1, the
atomics off, fma32 as a float32 FMA, the cull off) are timed beside it,
to take its time apart; only the first computes the same maps.

For each configuration: bitwise its plain version (the plain version
runs once on the card), and again bitwise across two calls; the kernels'
device ms a call under torch.profiler (the launcher's kernels and
memsets only, summed over --calls calls); the ms a call from CUDA events
around one call at a time, its read backs included; the synchronizing
calls a call makes (sync debug mode "warn"); launches.  Beside them the
plain version's ms, the bound (kernels/zbuffer.py work(): the operations
the inputs need after the cull, the bytes that must move, and the bytes
the design asks of L2; colorize: 43 float64 operations a window point,
the points, poses and picks once) and the card's name and power limit.
Results go to chiprun_out/zbuffer_sweep.json.  Fails without a CUDA
device or when a check misses.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "build" / "zbuffer_sweep"
# the C launchers of the tree before the voxel-major z-buffer and the
# one-pass colorization: argument types
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_SIGNATURES = {
    "zbuffer": ("lvba_zbuffer", [_P] * 4 + [_I] * 2 + [_P]
                + [ctypes.c_float] * 8 + [_I] * 2 + [_P] * 2),
    "colorize": ("lvba_colorize", [_P] * 4 + [_I] * 2
                 + [ctypes.c_double] * 8 + [_I] * 2 + [_P] * 3),
}
KERNEL_KEYS = {"zbuffer": ("zbuffer", "Memset"),
               "colorize": ("colorize", "Memset")}
# --variants: copies of the package's zbuffer.cu with one line changed,
# timed beside it (only the first computes the same maps)
VARIANTS = {
    "guard read from L2": ("if (zb < *d) atomicMin(d, zb);",
                           "if (zb < __ldcg(d)) atomicMin(d, zb);"),
    "atomics off": ("if (zb < *d) atomicMin(d, zb);",
                    "if (zb == 0x7f7fffffu) atomicMin(d, zb);"),
    "float32 FMA for fma32": (
        "  return __double2float_rn(__dadd_rn(\n"
        "      __dmul_rn(static_cast<double>(a), static_cast<double>(b)),\n"
        "      static_cast<double>(c)));",
        "  return __fmaf_rn(a, b, c);"),
    "cull off": ("  return __dadd_rn(zmax, __dmul_rn(mag, kCullMargin)) <",
                 "  return false && __dadd_rn(zmax, __dmul_rn(mag, "
                 "kCullMargin)) <"),
}


def _build_parent(parent: Path, signatures=None):
    """The earlier tree's sources named in `signatures` ({source: (C name,
    argument types)}; zbuffer.cu and colorize.cu by default), each by one
    nvcc, all started together: {name: bound C launcher}."""
    from global_lvba_tpu_torch.kernels import build

    signatures = signatures or PARENT_SIGNATURES
    OUT.mkdir(parents=True, exist_ok=True)
    csrc = parent / "global_lvba_tpu_torch" / "csrc"
    jobs = []
    for name in signatures:
        so = OUT / f"libparent_{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-o",
               str(so), str(csrc / f"{name}.cu")]
        jobs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n"
                               f"{log}")
        cname, argtypes = signatures[name]
        fn = getattr(ctypes.CDLL(str(so)), cname)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[name] = fn
    return libs


def _build_variants(source="zbuffer", variants=None):
    """The package's csrc/<source>.cu with each change of `variants`
    ({name: (old text, new text)}; VARIANTS by default), each by one
    nvcc, all started together: {name: bound C launcher}."""
    from global_lvba_tpu_torch.kernels import build

    variants = VARIANTS if variants is None else variants
    OUT.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / f"{source}.cu").read_text()
    jobs = []
    for k, (name, (old, new)) in enumerate(variants.items()):
        if old not in src:
            raise RuntimeError(f"variant {name!r}: its line is not in "
                               f"{source}.cu")
        cu = OUT / f"{source}_variant{k}.cu"
        cu.write_text(src.replace(old, new))
        so = OUT / f"lib{source}_variant{k}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, *build._defines(source),
               "-I", str(build.CSRC), "-o", str(so), str(cu)]
        jobs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    _, cname, argtypes = build.SIGNATURES[source]
    for name, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}:\n{log}")
        fn = getattr(ctypes.CDLL(str(so)), cname)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[name] = fn
    return libs


def _with_launcher(fn, run, name="zbuffer"):
    """run() with the package's launcher `name` swapped for fn."""
    from global_lvba_tpu_torch.kernels import build

    keep = build._launchers[name]
    build._launchers[name] = fn
    try:
        return run()
    finally:
        build._launchers[name] = keep


def _stream(torch):
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _parent_zbuffer(torch, fn, points, starts, counts, offsets, Rcw, tcw,
                    cam):
    """The earlier tree's wrapper: the longest image's ranges read back,
    one launch (fill, rasterize, finish)."""
    from global_lvba_tpu_torch.kernels import zbuffer as zb

    M = offsets.shape[0] - 1
    H, W = int(cam.height), int(cam.width)
    out = torch.empty((M, H, W), dtype=torch.float32, device=points.device)
    cams = zb._cams(Rcw, tcw, points.device).contiguous()
    max_ranges = int((offsets[1:] - offsets[:-1]).max())
    err = fn(zb._ptr(points), zb._ptr(starts), zb._ptr(counts),
             zb._ptr(offsets), M, max_ranges, zb._ptr(cams),
             *zb._intrinsics(cam), W, H, zb._ptr(out), _stream(torch))
    if err:
        raise RuntimeError(f"the parent's zbuffer: CUDA error {err}")
    return out


def _parent_colorize(torch, fn, points, lo, hi, Rcw, tcw, cam):
    """The earlier tree's wrapper: the window check read back, one launch
    (fill, two atomicMin passes) and the torch.nonzero compaction."""
    from global_lvba_tpu_torch.kernels import colorize as ck

    dev = points.device
    ck._check_windows(lo, hi, points.shape[0])
    H, W = int(cam.height), int(cam.width)
    M = lo.shape[0]
    cams = torch.cat([torch.as_tensor(Rcw).reshape(M, 9),
                      torch.as_tensor(tcw).reshape(M, 3)], dim=1).to(
        device=dev, dtype=torch.float64).contiguous()
    idx = torch.empty((M, H * W), dtype=torch.int32, device=dev)
    zbits = torch.empty((M, H * W), dtype=torch.int64, device=dev)
    err = fn(ctypes.c_void_p(points.data_ptr()),
             ctypes.c_void_p(lo.data_ptr()), ctypes.c_void_p(hi.data_ptr()),
             ctypes.c_void_p(cams.data_ptr()), M, points.shape[0],
             *ck._intrinsics(cam), W, H, ctypes.c_void_p(zbits.data_ptr()),
             ctypes.c_void_p(idx.data_ptr()), _stream(torch))
    if err:
        raise RuntimeError(f"the parent's colorize: CUDA error {err}")
    return ck._picks(idx, W)


def _zbuffer_operands(torch, np, dev):
    from global_lvba_tpu_torch.models.synthetic import make_joint_scene
    from global_lvba_tpu_torch.pipeline import depth

    js = make_joint_scene(200, 10_000, num_landmarks=8000, seed=13,
                          px_noise=0.3)
    sc = js.lidar
    clouds = [sc.points_body[sc.frame_ids == i] for i in range(200)]
    Rcw, tcw = depth.camera_world_to_cam(js.Rci, js.tci,
                                         sc.R_true[js.image_frame],
                                         sc.p_true[js.image_frame])
    gm = depth.build_grid_map(clouds, sc.R_true, sc.p_true, device=dev)
    starts, counts, offsets = depth.image_ranges(gm, sc.times,
                                                 js.image_times)
    args = [torch.as_tensor(a).to(dev) for a in (
        np.ascontiguousarray(gm.points, np.float32), starts, counts, offsets,
        np.asarray(Rcw, np.float64), np.asarray(tcw, np.float64))]
    return args, js.cam


def _colorize_operands(torch, np, dev):
    from global_lvba_tpu_torch.config import LvbaConfig
    from global_lvba_tpu_torch.geometry.camera import CameraModel
    from global_lvba_tpu_torch.models.synthetic import (
        make_plane_scene, room_views)

    cm = LvbaConfig().cam_model
    cam = CameraModel(fx=cm.cam_fx, fy=cm.cam_fy, cx=cm.cam_cx, cy=cm.cam_cy,
                      k1=cm.cam_d0, k2=cm.cam_d1, p1=cm.cam_d2, p2=cm.cam_d3,
                      width=cm.cam_width, height=cm.cam_height).scaled(
        cm.scale)
    F, V = 96, 48
    sc = make_plane_scene(num_frames=F, points_per_frame=10_000, seed=5)
    _, _, _, Rcw, tcw = room_views(V, 0.15)
    frame = np.round(np.arange(V) * F / V).astype(int).clip(0, F - 1)
    it = sc.times[frame] + 0.03
    clouds = [sc.points_body[sc.frame_ids == i] for i in range(F)]
    world = np.concatenate([(sc.R_true[i] @ clouds[i].T).T + sc.p_true[i]
                            for i in range(F)]).astype(np.float64)
    offs = np.concatenate([[0], np.cumsum([c.shape[0] for c in clouds])])
    lo = np.searchsorted(sc.times, it - 0.5, side="left")
    hi = np.searchsorted(sc.times, it + 0.5, side="right")
    lo, hi = offs[lo], np.where(hi > lo, offs[hi], offs[lo])
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (world, lo, hi)]
    return args + [Rcw, tcw, cam], int((hi - lo).sum())


def _kernel_ms(torch, fn, keys, calls):
    """Device ms a call of fn() in the kernels and memsets whose profiler
    keys hold one of `keys`, summed over `calls` calls; with the keys."""
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dms = cs._device_ms(prof)
    hits = {k: v for k, v in dms.items() if any(s in k for s in keys)}
    ms = sum(v[0] for v in hits.values()) / calls if hits else None
    return ms, {k: v[0] / calls for k, v in hits.items()}


def _call_ms(torch, fn, calls):
    """Mean ms of one call, CUDA events around it (its read backs
    included), each call on an idle device."""
    total = 0.0
    for _ in range(calls):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / calls


def _plain_ms(torch, fn):
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1), out


def _same(torch, a, b):
    if torch.is_tensor(a):
        return bool(torch.equal(a, b))
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _sweep(torch, name, configs, plain, calls, counter, keys=None):
    """Checks and times each configuration in turns (in order, then in
    reverse): {config: numbers}.  `keys`: the profiler keys of its
    kernels (KERNEL_KEYS[name] by default)."""
    import chip_smoke as cs

    plain_ms, ref = _plain_ms(torch, plain)
    res = {c: dict(kernel_ms=[], call_ms=[]) for c in configs}
    for c, fn in configs.items():
        a, b = fn(), fn()
        torch.cuda.synchronize()
        res[c]["bitwise_plain"] = _same(torch, a, ref)
        res[c]["repeat_bitwise"] = _same(torch, a, b)
        _, res[c]["syncs"] = cs._count_syncs(torch, fn)
        before = counter()
        fn()
        # the earlier tree's wrappers count no launch here: one a call
        res[c]["launches_a_call"] = (counter() - before if c != "parent"
                                     else None)
        del a, b
    for c in [*configs, *reversed(list(configs))]:
        ms, parts = _kernel_ms(torch, configs[c], keys or KERNEL_KEYS[name],
                               calls)
        res[c]["kernel_ms"].append(ms)
        res[c]["kernels"] = parts
        res[c]["call_ms"].append(_call_ms(torch, configs[c], calls))
    for c in configs:
        r = res[c]
        print(f"[{name}] {c}: bitwise plain {r['bitwise_plain']}, two calls "
              f"bitwise {r['repeat_bitwise']}; kernel ms (torch.profiler, "
              f"in turns) {r['kernel_ms']} {r['kernels']}; ms a call with "
              f"its read backs {r['call_ms']}; {r['syncs']} synchronizing "
              f"calls a call; launches a call {r['launches_a_call']}",
              flush=True)
    print(f"[{name}] plain version on the card {plain_ms:.1f} ms",
          flush=True)
    return dict(configs=res, plain_ms=plain_ms)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from global_lvba_tpu_torch import resolve_device
    from global_lvba_tpu_torch.kernels import build
    from global_lvba_tpu_torch.kernels import colorize as ck
    from global_lvba_tpu_torch.kernels import zbuffer as zb

    argv = sys.argv[1:]
    parent = Path(argv[argv.index("--parent") + 1]) if "--parent" in argv \
        else None
    calls = int(argv[argv.index("--calls") + 1]) if "--calls" in argv else 10
    variants = "--variants" in argv
    dev = resolve_device("cuda")
    card = cs._card_line()
    print(card, flush=True)
    t0 = time.time()
    build.launcher("zbuffer")
    plib = _build_parent(parent) if parent is not None else {}
    vlib = _build_variants() if variants else {}
    logs = build.build_logs()
    print(f"kernels built in {time.time() - t0:.1f} s; ptxas: "
          + "; ".join(line.strip() for k in ("zbuffer", "colorize")
                      for line in logs.get(k, "").splitlines()
                      if "registers" in line), flush=True)
    results = dict(card=card, parent=str(parent) if parent else None)
    hbm, f32, f64 = cs.HBM_BYTES_PER_S, cs.FP32_FLOP_PER_S, cs.FP64_FLOP_PER_S

    # ---- the depth maps' z-buffer ----
    args, cam = _zbuffer_operands(torch, np, dev)
    w = zb.work(*args, cam)
    tb = w["nbytes"] / hbm * 1e3
    to = max(w["ops"][0] / (f32 / 2), w["ops"][1] / (f64 / 2)) * 1e3
    bound = (tb, "bytes") if tb >= to else (to, "operations")
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    zb.zbuffer(*args, cam, stats=stats)
    kept = stats.tolist()
    print(f"[zbuffer] {w['covisible']} covisible (point, image) pairs, "
          f"{w['in_front']} in front; {w['pieces']} pieces, {w['pairs']} "
          f"(piece, image) pairs, the cull removes {w['culled']} "
          f"(kernel: kept {kept[0]} pairs of {kept[1]} points; mirror "
          f"{w['kept']} of {w['kept_points']}); bound {bound[0]:.4f} ms "
          f"({bound[1]}: {w['ops'][0]} float32 and {w['ops'][1]} float64 "
          f"operations at half the data sheet's rates, {to:.4f} ms; "
          f"{w['nbytes'] / 1e6:.1f} MB once, {tb:.4f} ms); L2 bytes of the "
          f"design {w['l2_bytes'] / 1e6:.1f} MB", flush=True)
    if kept != [w["kept"], w["kept_points"]]:
        raise AssertionError("zbuffer: the kernel's cull differs from its "
                             "plain mirror")
    configs = {}
    if parent is not None:
        configs["parent"] = lambda: _parent_zbuffer(
            torch, plib["zbuffer"], *args, cam)
    configs["new"] = lambda: zb.zbuffer(*args, cam)
    for vname, fn in vlib.items():
        configs[vname] = (lambda fn=fn: _with_launcher(
            fn, lambda: zb.zbuffer(*args, cam)))
    z = _sweep(torch, "zbuffer", configs,
               lambda: zb.zbuffer_plain(*args, cam), calls,
               lambda: zb.LAUNCHES["zbuffer"])
    results["zbuffer"] = dict(work=w, kernel_stats=kept, bound=bound,
                              bound_ops_ms=to, bound_bytes_ms=tb, **z)
    del args

    # ---- the colored clouds' z-buffer ----
    cargs, n_win = _colorize_operands(torch, np, dev)
    world = cargs[0]
    M = cargs[1].shape[0]
    c_ops = ck.COLORIZE_OPS * n_win
    configs = {}
    if parent is not None:
        configs["parent"] = lambda: _parent_colorize(
            torch, plib["colorize"], *cargs)
    configs["new"] = lambda: ck.colorize(*cargs)
    c = _sweep(torch, "colorize", configs, lambda: ck.colorize_plain(*cargs),
               calls, lambda: ck.LAUNCHES["colorize"])
    picks = int(ck.colorize(*cargs)[0].numel())
    c_bytes = world.numel() * 8 + M * 112 + picks * 32
    c_to = c_ops / (f64 / 2) * 1e3
    c_tb = c_bytes / hbm * 1e3
    c_bound = (c_to, "operations") if c_to >= c_tb else (c_tb, "bytes")
    H, W = int(cargs[5].height), int(cargs[5].width)
    S = ck.slab_pixels(H * W, ck._blocks(dev))
    print(f"[colorize] {M} images {W} x {H}, {n_win} window points, {picks} "
          f"picks; slabs of {S // (H * W) or S} "
          f"{'images' if S >= H * W else 'pixels'} ({S * 16 / 2**20:.1f} "
          f"MiB of cells), {len(ck.slabs(M, H * W, S))} slabs over "
          f"{ck._blocks(dev)} blocks; bound {c_bound[0]:.4f} ms "
          f"({c_bound[1]}: {c_ops} float64 operations at half the data "
          f"sheet's fp64 rate, {c_to:.4f} ms; {c_bytes / 1e6:.1f} MB once, "
          f"{c_tb:.4f} ms)", flush=True)
    results["colorize"] = dict(window_points=n_win, picks=picks, ops=c_ops,
                               bytes=c_bytes, bound=c_bound, slab_pixels=S,
                               **c)
    bad = [f"{k} {cfg}" for k in ("zbuffer", "colorize")
           for cfg, r in results[k]["configs"].items()
           if cfg in ("parent", "new", "guard read from L2")
           and not (r["bitwise_plain"] and r["repeat_bitwise"])]
    news = results["zbuffer"]["configs"]["new"], \
        results["colorize"]["configs"]["new"]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "zbuffer_sweep.json").write_text(
        json.dumps(results, indent=1, default=float))
    if bad:
        raise AssertionError(f"not bitwise their plain versions: {bad}")
    if news[0]["syncs"] != 0 or news[1]["syncs"] != 1 or any(
            r["launches_a_call"] != 1 for r in news):
        raise AssertionError("a new wrapper synchronized other than zbuffer "
                             "never and colorize once a call, or launched "
                             "other than once")
    return 0


if __name__ == "__main__":
    sys.exit(main())
