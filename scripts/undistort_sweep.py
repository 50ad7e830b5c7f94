#!/usr/bin/env python3
"""Checks and times the port's undistortion kernel
(global_lvba_tpu_torch/csrc/undistort.cu) on one NVIDIA GPU, beside an
earlier tree's.  Run from the repository root:

    python3 scripts/undistort_sweep.py [--parent DIR] [--calls N] [--variants]

Shapes: 48 images of 640 x 512 (chip_smoke.py phase 21's export: the
reference camera of configs/ at scale 0.5) and 200 images of 1280 x 1024
(that camera unscaled, ladder 3's image count), on the TMA route; on the
global route (every tap from global memory), the same two shapes with
the stack one byte past a 16-byte boundary, and 48 images of 639 x 511
(an odd width and height: the camera at scale 0.5 cut by a column and a
row).  Random uint8 images from a seed, the camera's own map
(kernels/undistort.undistort_map).

With --parent DIR (a checkout of an earlier tree, e.g. `git archive` of
the parent commit unpacked into a directory that .gitignore lists), that
tree's undistort.cu is built beside the package's (scripts/zbuffer_sweep
._build_parent) and called as that tree's wrapper called it (the (H, W)
map, the (1024, 4) weight table: kernels/undistort._device_operands);
the configurations run in turns, parent, new, new, parent.

With --variants, copies of the package's undistort.cu with one line
changed (VARIANTS: every tile's taps from global memory on the TMA
route's kernel, the global route at every width, global taps by checked
bytes only, a ring of 4, 3 or 6 blocks an SM, no register cap, twice
the resident blocks; and, computing other images, the arithmetic, the
copies or the stores left out) are timed beside it, to take its time
apart.

For each shape and configuration: bitwise the plain version (run once
on the card) and across two calls; the kernel's device ms a call under
torch.profiler (summed over --calls calls); the ms a call from CUDA
events around one call at a time; the synchronizing calls a call makes
(sync debug mode "warn"); launches.  Beside them the plain version's ms,
the bound (kernels/undistort.undistort_bytes at 3.35 TB/s), the plan
(its box, the tiles staged and over the cap, the staging route), the host
seconds of undistort_map and of the whole first-call plan (map, tile
plan, copies) with the caches emptied, and the card's name and power
limit.  Results go to chiprun_out/undistort_sweep.json.  Fails without a
CUDA device or when a check misses.
"""

from __future__ import annotations

import ctypes
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

# the C launcher of the tree before the tiled kernel: argument types
_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_SIGNATURES = {
    "undistort": ("lvba_undistort", [_P] * 4 + [_I] * 3 + [_P] * 2)}
# --variants: copies of undistort.cu with one line changed; the first seven
# compute the same images, the others leave a part out to time the rest
VARIANTS = {
    "staging off": (
        "bool staged(const int4& tp) { return tp.z != 0; }",
        "bool staged(const int4& tp) { return false; }"),
    "TMA off": ("W % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0",
                "false"),
    "global words off": ("  if (static_cast<unsigned>(x0) < "
                         "static_cast<unsigned>(W - 1) &&",
                         "  if (false &&"),
    "ring of 4": ("constexpr int kSlots = 2;", "constexpr int kSlots = 4;"),
    "3 blocks an SM": ("constexpr int kMinBlocks = 4;",
                       "constexpr int kMinBlocks = 3;"),
    "6 blocks an SM": ("constexpr int kMinBlocks = 4;",
                       "constexpr int kMinBlocks = 6;"),
    "register cap off": ("__launch_bounds__(kThreads, kMinBlocks)",
                         "__launch_bounds__(kThreads, 1)"),
    "twice the resident blocks": (
        "items < resident ? items : resident",
        "items < 2 * resident ? items : 2 * resident"),
    "arithmetic off": (
        "pixel_staged(box + pa[p], ps[p], pitch, wa[p], wb[p], v[p]);",
        "v[p][0] = v[p][1] = v[p][2] = box[pa[p]];"),
    "copies off": (
        "        mbar_expect_tx(&full_bar[s], box_bytes);\n"
        "        tma_load(smem + s * stride, &tm_src, &full_bar[s], ptp.x / 4,"
        " ptp.y,\n                 pimg);",
        "        mbar_arrive(&full_bar[s]);"),
    "stores off": ("    if (y < H) {\n      const int64_t off",
                   "    if (y < H && N < 0) {\n      const int64_t off"),
}
PARTIAL = ("arithmetic off", "copies off", "stores off")
# (images, camera scale, columns and rows cut, the stack's first byte
# past a 16-byte boundary)
SHAPES = ((48, 0.5, 0, 0), (200, 1.0, 0, 0), (48, 0.5, 0, 1),
          (200, 1.0, 0, 1), (48, 0.5, 1, 0))


def _camera(scale):
    from global_lvba_tpu_torch.config import LvbaConfig
    from global_lvba_tpu_torch.geometry.camera import CameraModel

    cm = LvbaConfig().cam_model
    return CameraModel(fx=cm.cam_fx, fy=cm.cam_fy, cx=cm.cam_cx, cy=cm.cam_cy,
                       k1=cm.cam_d0, k2=cm.cam_d1, p1=cm.cam_d2, p2=cm.cam_d3,
                       width=cm.cam_width, height=cm.cam_height).scaled(scale)


def _parent_undistort(torch, fn, images, operands):
    """The earlier tree's wrapper: one launch over the (H, W) map."""
    N, H, W = images.shape[:3]
    out = torch.empty_like(images)
    err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (
        images, *operands)), N, H, W,
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"the parent's undistort: CUDA error {err}")
    return out


def _host_seconds(ud, cam, dev):
    """Host seconds of undistort_map and of undistort_plan (map, tile
    plan, copies to the card), each with the caches emptied."""
    import torch

    ud._maps.clear()
    t0 = time.perf_counter()
    ud.undistort_map(cam, cam.width, cam.height)
    map_s = time.perf_counter() - t0
    ud._maps.clear()
    ud._tables.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ud.undistort_plan(cam, cam.width, cam.height, dev)
    torch.cuda.synchronize()
    return map_s, time.perf_counter() - t0


def main() -> int:
    import torch

    import chip_smoke as cs
    import zbuffer_sweep as zs
    from global_lvba_tpu_torch import resolve_device
    from global_lvba_tpu_torch.kernels import build
    from global_lvba_tpu_torch.kernels import undistort as ud

    argv = sys.argv[1:]
    parent = Path(argv[argv.index("--parent") + 1]) if "--parent" in argv \
        else None
    calls = int(argv[argv.index("--calls") + 1]) if "--calls" in argv else 10
    dev = resolve_device("cuda")
    card = cs._card_line()
    print(card, flush=True)
    t0 = time.time()
    build.launcher("undistort")
    plib = zs._build_parent(parent, PARENT_SIGNATURES) if parent else {}
    vlib = (zs._build_variants("undistort", VARIANTS)
            if "--variants" in argv else {})
    print(f"kernels built in {time.time() - t0:.1f} s; ptxas: "
          + "; ".join(line.strip() for line in build.build_logs().get(
              "undistort", "").splitlines() if "registers" in line),
          flush=True)
    results = dict(card=card, parent=str(parent) if parent else None,
                   shapes={})
    bad = []
    for n, scale, cut, offset in SHAPES:
        cam = _camera(scale)
        cam = cam._replace(width=cam.width - cut, height=cam.height - cut)
        H, W = cam.height, cam.width
        map_s, plan_s = _host_seconds(ud, cam, dev)
        plan = ud.undistort_plan(cam, W, H, dev)
        gen = torch.Generator(device=dev).manual_seed(5)
        buf = torch.empty(n * H * W * 3 + 16, dtype=torch.uint8, device=dev)
        lead = (offset - buf.data_ptr()) % 16
        images = buf[lead:lead + n * H * W * 3].view(n, H, W, 3)
        images.copy_(torch.randint(0, 256, (n, H, W, 3), dtype=torch.uint8,
                                   device=dev, generator=gen))
        route = ud.staging_route(images)
        tag = f"{n}x{W}x{H}" + (f"+{offset}" if offset else "")
        nbytes = ud.undistort_bytes(n, H, W)
        bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
        T = plan.tiles.shape[0]
        print(f"[{tag}] route {route}; box {plan.pitch} bytes x "
              f"{plan.rows} rows; {plan.staged} of {T} tiles staged; bound "
              f"{bound:.4f} ms (bytes: {nbytes / 1e6:.1f} MB at 3.35 TB/s); "
              f"host s: undistort_map {map_s:.4f}, the first call's plan "
              f"(map, tiles, copies) {plan_s:.4f}", flush=True)
        configs = {}
        if parent is not None:
            operands = ud._device_operands(cam, W, H, dev)
            configs["parent"] = (lambda: _parent_undistort(
                torch, plib["undistort"], images, operands))
        configs["new"] = lambda: ud.undistort(images, cam)
        for vname, fn in vlib.items():
            configs[vname] = (lambda fn=fn: zs._with_launcher(
                fn, lambda: ud.undistort(images, cam), "undistort"))
        r = zs._sweep(torch, f"undistort {tag}", configs,
                      lambda: ud.undistort_plain(images, cam), calls,
                      lambda: ud.LAUNCHES["undistort"], keys=("undistort",))
        results["shapes"][tag] = dict(
            route=route, pitch=plan.pitch, rows=plan.rows,
            staged=plan.staged, tiles=T, bound_ms=bound, bytes=nbytes,
            undistort_map_s=map_s, plan_s=plan_s, **r)
        bad += [f"{n} {c}" for c, x in r["configs"].items()
                if c not in PARTIAL
                and not (x["bitwise_plain"] and x["repeat_bitwise"])]
        new = r["configs"]["new"]
        if new["syncs"] != 0 or new["launches_a_call"] != 1:
            bad.append(f"{n}: new synchronized or launched other than once")
        del images, buf
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "undistort_sweep.json").write_text(
        json.dumps(results, indent=1, default=float))
    if bad:
        raise AssertionError(f"checks missed: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
