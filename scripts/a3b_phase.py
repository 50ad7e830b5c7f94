"""Runs chip_smoke.py's phase 19 (the JAX package's opt-in large-W
evaluations: the group forms of kernels 1 and 2, the aligned banded route,
the gather route) alone on one CUDA card, building the inputs it takes
from earlier phases (path 2c's stage-1 buckets, path 2b's), and, with
--parent DIR, times the W-wide forms of soa_agg and soa_chain (float32
and float64, on chip_smoke's main path: the W=512 aligned evaluation)
against an earlier tree's sources in turns (parent, this tree, this tree,
parent) and holds their outputs bit for bit equal.  Results go to
chiprun_out/a3b_phase.json.

    python3 scripts/a3b_phase.py [--parent DIR] [wide] [kernels] [aligned]
                                 [gather]

DIR holds the earlier tree's global_lvba_tpu_torch/csrc (e.g. `git archive
<commit> global_lvba_tpu_torch/csrc | tar -x -C _archive/parent`).  With
no part named it runs them all (wide only with --parent).  It fails, as
chip_smoke.py does, when a check misses its limit or no CUDA device is
available."""

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ORDER = ("wide", "kernels", "aligned", "gather")


def _parent_libs(parent: Path):
    """The earlier tree's soa_agg.cu and soa_chain.cu built as this tree's
    are (build.NVCC_FLAGS, its -D flags), each nvcc started at once, into
    build/a3b_parent/; their float32 and float64 launchers bound with the
    earlier C signatures."""
    from global_lvba_tpu_torch.kernels import build

    out = ROOT / "build" / "a3b_parent"
    out.mkdir(parents=True, exist_ok=True)
    csrc = parent / "global_lvba_tpu_torch" / "csrc"
    jobs = {}
    for name in ("soa_agg", "soa_chain"):
        cmd = [build._nvcc(), *build.NVCC_FLAGS, *build._defines(name),
               "-I", str(csrc), "-o", str(out / f"lib{name}.so"),
               str(csrc / f"{name}.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n"
                               f"{log}")
    P, I = ctypes.c_void_p, ctypes.c_int
    sigs = {"lvba_soa_agg": [I] + [P] * 7 + [I] + [P] * 3,
            "lvba_soa_chain": [P] * 5 + [I] * 3 + [P] * 3 + [I] + [P] * 3}
    fns = {}
    for name in ("soa_agg", "soa_chain"):
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        for sfx in ("", "_f64"):
            fn = getattr(lib, f"lvba_{name}{sfx}")
            fn.argtypes, fn.restype = sigs[f"lvba_{name}"], I
            fns[name + sfx] = fn
    return fns


def _wide(torch, np, dev, parent: Path, results):
    """soa_agg and soa_chain's W-wide forms, this tree's against the
    parent's, on the W=512 aligned evaluation (both chunks, the chain's
    running sums as an evaluation passes them): outputs bitwise equal,
    device ms per evaluation in turns."""
    import chip_smoke as cs
    from global_lvba_tpu_torch.factors.padding import buckets_to_device
    from global_lvba_tpu_torch.factors.plane_eigen import (
        pose_table, voxel_chunks)
    from global_lvba_tpu_torch.kernels import soa
    from global_lvba_tpu_torch.map.voxelize import build_voxel_map
    from global_lvba_tpu_torch.models.synthetic import (
        make_plane_scene, perturb_poses)

    fns = _parent_libs(parent)
    W = cs.FRAMES
    sc = make_plane_scene(num_frames=W, points_per_frame=cs.PPF, seed=0)
    Rp, pp = perturb_poses(sc.R_true, sc.p_true, 0.003, 0.01, seed=1)
    vm = build_voxel_map(sc.points_body, sc.frame_ids, Rp, pp, cs.VOXEL,
                         eigen_ratios=[cs.RATIO] * 4)
    out = {}
    for dt, sfx in ((torch.float32, ""), (torch.float64, "_f64")):
        fa = buckets_to_device(vm, W=W, dtype=dt, device=dev)[0]
        V = fa.n.shape[0]
        pose12 = pose_table(torch.as_tensor(Rp, dtype=dt, device=dev),
                            torch.as_tensor(pp, dtype=dt, device=dev))
        chunks = voxel_chunks(V, W)
        stream = soa._stream(dev)

        def agg_parent():
            residv = torch.empty((V,), dtype=dt, device=dev)
            pv = torch.empty((V, 16), dtype=dt, device=dev)

            def arr(*ts):
                return (ctypes.c_void_p * 1)(*(t.data_ptr() for t in ts))

            err = fns["soa_agg" + sfx](
                1, arr(fa.n), arr(fa.mu), arr(fa.Pc), arr(pose12),
                (ctypes.c_int * 1)(0), (ctypes.c_int * 1)(V),
                (ctypes.c_int * 1)(W), soa.agg_group(W)[1], arr(residv),
                arr(pv), stream)
            assert err == 0, err
            return residv, pv

        def agg_now():
            return soa.soa_agg(fa.n, fa.mu, fa.Pc, pose12)

        arrivals = torch.zeros((64,), dtype=torch.int32, device=dev)

        def chain_parent(pv):
            g = torch.empty((W, 6), dtype=dt, device=dev)
            Hd = torch.empty((W, 6, 6), dtype=dt, device=dev)
            As = []
            for i, (lo, hi) in enumerate(chunks):
                n_ = hi - lo
                vt = soa.chain_tile(n_, W, soa._chain_slots(dev, dt),
                                    soa.CHAIN_WARPS[dt])
                tiles, nvb = -(-W // soa.CHAIN_FRAME_TILE), -(-n_ // vt)
                part = torch.empty((tiles * nvb * 30 * soa.CHAIN_FRAME_TILE,),
                                   dtype=dt, device=dev)
                A = torch.empty((3 * n_, 6 * W), dtype=dt, device=dev)
                p_ = soa._ptr
                err = fns["soa_chain" + sfx](
                    p_(fa.n[lo:hi]), p_(fa.mu[lo:hi]), p_(fa.Pc[lo:hi]),
                    p_(pose12), p_(pv[lo:hi]), n_, W, vt, p_(A), p_(g),
                    p_(Hd), int(i > 0), p_(part), p_(arrivals), stream)
                assert err == 0, err
                As.append(A)
            return As, g, Hd

        def chain_now(pv):
            ops = [(fa.n[lo:hi], fa.mu[lo:hi], fa.Pc[lo:hi])
                   for lo, hi in chunks]
            return cs._chain_evaluation(soa.soa_chain, ops, pose12,
                                        [pv[lo:hi] for lo, hi in chunks])

        a_p, a_n = agg_parent(), agg_now()
        pv = a_n[1]
        c_p, c_n = chain_parent(pv), chain_now(pv)
        torch.cuda.synchronize()
        same = (all(torch.equal(x, y) for x, y in zip(a_p, a_n))
                and all(torch.equal(x, y) for x, y in zip(c_p[0], c_n[0]))
                and torch.equal(c_p[1], c_n[1])
                and torch.equal(c_p[2], c_n[2]))
        rec = dict(bitwise_equal=bool(same))
        for name, fp, fn in (("soa_agg", agg_parent, agg_now),
                             ("soa_chain", lambda: chain_parent(pv),
                              lambda: chain_now(pv))):
            ms = {"parent": [], "this tree": []}
            for who in ("parent", "this tree", "this tree", "parent"):
                ms[who].append(cs._timed(
                    torch, fp if who == "parent" else fn)[0])
            rec[name + sfx] = dict(parent_ms=ms["parent"],
                                   this_tree_ms=ms["this tree"],
                                   ratio=sum(ms["this tree"])
                                   / sum(ms["parent"]))
            print(f"[a3b-wide] {name}{sfx} W-wide form, device ms per "
                  f"evaluation in turns: parent {ms['parent']}, this tree "
                  f"{ms['this tree']} (ratio "
                  f"{rec[name + sfx]['ratio']:.4f})", flush=True)
        print(f"[a3b-wide] {dt}: outputs bitwise equal to the parent's: "
              f"{same}", flush=True)
        if not same:
            cs._fail(f"a3b-wide: the W-wide forms changed their outputs "
                     f"({dt})")
        out[str(dt)] = rec
    results["a3b_wide"] = out


def _large(torch, np, dev):
    """Path 2c's stage-1 buckets and poses on the card, as _large_w's
    stage-1 LM takes them."""
    import chip_smoke as cs
    from global_lvba_tpu_torch.__main__ import slice_config
    from global_lvba_tpu_torch.factors.padding import buckets_to_device

    W = cs.LARGE_FRAMES
    scene, Rp, pp, vm = cs._large_map(np, W, slice_config("float32"))
    bs = buckets_to_device(vm, W=W, dtype=torch.float32, device=dev)
    return (bs, torch.as_tensor(Rp, dtype=torch.float32, device=dev),
            torch.as_tensor(pp, dtype=torch.float32, device=dev))


def _corridor(torch, np, dev):
    """Path 2b's stage-1 buckets and poses on the card (KEEP["2b"])."""
    import chip_smoke as cs
    from global_lvba_tpu_torch.__main__ import slice_config
    from global_lvba_tpu_torch.factors.padding import buckets_to_device
    from global_lvba_tpu_torch.map.voxelize import build_voxel_map
    from global_lvba_tpu_torch.models.synthetic import (
        make_corridor_scene, perturb_poses)

    W = cs.CORRIDOR_FRAMES
    cfg = slice_config("float32")
    sc = make_corridor_scene(W, cs.CORRIDOR_PPF, seed=0)
    Rp, pp = perturb_poses(sc.R_true, sc.p_true, 0.003, 0.01, seed=1)
    vm = build_voxel_map(sc.points_body, sc.frame_ids, Rp, pp, cs.VOXEL,
                         eigen_ratios=[cs.RATIO] * 4, min_ps=cfg.solver.min_ps,
                         layer_limit=cfg.solver.layer_limit)
    cs.KEEP["2b"] = (buckets_to_device(vm, W=W, dtype=torch.float32,
                                       device=dev),
                     torch.as_tensor(Rp, dtype=torch.float32, device=dev),
                     torch.as_tensor(pp, dtype=torch.float32, device=dev))


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from global_lvba_tpu_torch import resolve_device

    args = sys.argv[1:]
    parent = None
    if args[:1] == ["--parent"]:
        parent, args = Path(args[1]).resolve(), args[2:]
    names = args or [n for n in ORDER if n != "wide" or parent]
    bad = [n for n in names if n not in ORDER]
    if bad or ("wide" in names and parent is None):
        raise SystemExit(f"parts: {', '.join(ORDER)} (wide needs --parent)")
    from global_lvba_tpu_torch.kernels import build

    dev = resolve_device("cuda")
    print(cs._card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    for name in build.SIGNATURES:
        build.launcher(name)
    print(f"[setup] kernels built in {time.time() - t0:.1f} s", flush=True)
    for name, log in build.build_logs().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[setup] {name}: {line.strip()}", flush=True)
    results, paths = {"card": cs._card_line()}, {}
    kern = {k: dict(max_abs_err=0.0) for k in (
        "soa_agg", "soa_chain", "soa_agg_f64", "soa_chain_f64")}
    t0 = time.time()
    if "wide" in names:
        _wide(torch, np, dev, parent, results)
    rest = [n for n in names if n != "wide"]
    if rest:
        t1 = time.time()
        large = _large(torch, np, dev)
        if "gather" in rest:
            _corridor(torch, np, dev)
        print(f"[a3b] inputs {time.time() - t1:.1f} s", flush=True)
        parts = dict(kernels=False, aligned=False, gather=False)
        parts.update({n: True for n in rest})
        t1 = time.time()
        cs._a3b(torch, np, dev, kern, results, paths, large, **parts)
        print(f"[a3b] {time.time() - t1:.1f} s", flush=True)
    results.update(launches_by_path=paths, kernel_max_abs_err=kern)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "a3b_phase.json").write_text(
        json.dumps(results, indent=1, default=float))
    print(f"all {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
