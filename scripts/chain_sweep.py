#!/usr/bin/env python3
"""Checks and times the port's aligned linearization chain
(global_lvba_tpu_torch/csrc/soa_chain.cu soa_chain_kernel) and its pose
selection (csrc/selection.cu table_select_kernel) on one NVIDIA GPU, and
shows where the chain spends its time.  Run from the repository root:

    python3 scripts/chain_sweep.py [--parent DIR]

Operands: chip_smoke.py's main path, the W=512 aligned evaluation
(make_plane_scene(512, 2000): two voxel chunks, 1,365 and 683 voxels) in
float32 and float64, and the W=512 corridor's five buckets
(make_corridor_scene(512, 2000)) for the selection.

First it checks the package's build: soa_chain against soa_chain_plain
(rows 1e-3 of max |A|, g and Hd 1e-3 of max |.|; 1e-9 in float64, as
chip_smoke.py's limits) over both chunks with the running sums, two runs
bitwise equal; table_select_buckets bitwise equal to table_select_plain.
Then it times, in turns (the configurations in order and again in
reverse), device ms per evaluation (both chunks, the running sums
included) from CUDA events over calls queued behind a spin kernel:
  * "as built": the package's kernel;
  * "spans through their ends": a copy that stages and stores through the
    general path (single values at unaligned ends) where the aligned one
    of whole 16-byte chunks applies (what the aligned path saves);
  * "chain off": a copy whose chain arithmetic is replaced by a few sums
    of the loaded values (what the chain costs);
  * "row stores off": a copy that stores no row of A (what A's 75 MB of
    stores cost);
  * "loads only": neither the chain nor the row stores (the staging, the
    sums and the launch);
  * "loads in series": a copy that waits for the next voxels' spans too
    before each chain (what the staging ring's overlap buys);
  * "2 stages", "4 stages": copies whose ring stages one or three voxels
    ahead instead of two;
  * "tile sums off": a copy whose blocks write their sums but never sum a
    tile's (what the last block's pass costs); "tile pass without g and
    Hd" (no load or store of them), "tile pass by the last
    voxel block, no arrival" (the block of the highest voxels sums
    without waiting for the others) and "loads only, tile sums off" take
    it apart;
  * "a block's warps along a voxel row, tile sums off": a copy whose
    block takes neighbouring frame tiles of the same voxels, one warp a
    tile, so a voxel's spans over the block are contiguous (W=512: the
    whole row; voxels a block sized to fill the card once), timed beside
    "tile sums off"; "spans from the L2" copies stage the spans of
    voxels 0-7 in place of each voxel's (the same instructions, bytes
    the L2 holds: what the memory behind it costs);
  * "4 warps a block", "8 warps a block": copies built with other
    CHAIN_WARPS (chain_tile sized for them; the package takes 16 in
    float32 and 8 in float64, one block a SM);
  * "two waves": the package's build with chain_tile given twice the
    card's resident blocks (half the voxels a warp);
  * beside them, the card's own rates on the same bytes: n, μ and Pc of
    the chunks copied by clone, A written by zero_;
  * with --parent DIR (a checkout of an earlier tree, e.g. unpacked by
    `git archive` into a directory that .gitignore lists): that tree's
    soa_chain.cu as it was called there (its partial sums summed by torch
    per chunk), and its table_select launched once per bucket.
Only "as built" and "two waves" compute the function; the others are
timed only.  Prints the card's name and power limit, each copy's ptxas
registers and spills and its resident blocks a SM, and one line per case;
writes chiprun_out/chain_sweep.json.
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
TOL = {"float32": 1e-3, "float64": 1e-9}

CHAIN_OFF = (
    "        chain_entry(e, P, Rm1, Rm2, Rm3, RP, s.pv, rows, acc);\n",
    "#pragma unroll\n"
    "        for (int i = 0; i < 18; ++i) rows[i] = RP[i % 9] + s.pv[i % 13];\n"
    "        acc[0] += Rm1; acc[1] += Rm2; acc[2] += Rm3;\n")
STORES_OFF = (
    ("        if constexpr (kFast) zero_chunks(out + r * ld, 6 * cn, lane);\n"
     "        else zero_span(out + r * ld, 6 * nt, lane, 32);\n",
     "        (void)out;\n"),
    ("        if constexpr (kFast) copy_chunks(out + r * ld, st[r], 6 * cn, "
     "lane);\n        else copy_span(out + r * ld, st[r], 6 * nt, lane, "
     "32);\n", "        (void)st;\n"))
GENERAL = ("  const bool fast = (W * sizeof(T)) % 16 == 0 && aligned16(n) &&\n",
           "  const bool fast = false && aligned16(n) &&\n")
IN_SERIES = ("    cp_async_wait<kStages - 1>();  // voxel v's spans have "
             "landed\n", "    cp_async_wait<0>();\n")
STAGES = ("constexpr int kStages = 3;", "constexpr int kStages = {};")
SUMS_OFF = ("  if (threadIdx.x == 0) last = atomicAdd(arrivals + tile, 1) == "
            "nvb - 1;\n", "  if (threadIdx.x == 0) last = 0;\n")
NO_OUT = (("      if (accumulate) old[u] = __ldcg(o[u]);\n", ""),
          ("      *o[u] = accumulate ? old[u] + smem[col[u]] : smem[col[u]];\n",
           "      if (smem[col[u]] == T(-1.25e-37)) *o[u] = old[u];\n"))
NO_WAIT = (SUMS_OFF[0], "  if (threadIdx.x == 0) last = vb == nvb - 1;\n")
# a block's warps on neighbouring frame tiles of the same voxels: one
# contiguous span of each array a voxel (timed with the sums off: the
# block's warp sum then mixes frames)
L2_SPANS = ("    const int64_t c = (int64_t)v * W + k0;\n"
            "    const Spans<T, kFast> s(buf, n, mu, Pc, pv, c, v);\n"
            "    if constexpr (kFast) {\n",
            "    const int64_t c = (int64_t)(v & 7) * W + k0;\n"
            "    const Spans<T, kFast> s(buf, n, mu, Pc, pv, c, v);\n"
            "    if constexpr (kFast) {\n")
ROW = (("  const int k0 = tile * kTile;\n",
        "  const int k0 = (tile * C::kWarps + warp) * kTile;\n"),
       ("  constexpr int kStep = C::kWarps;  // a warp's voxels: warp, warp + "
        "kStep...\n  int v = vb * vt + warp;\n",
        "  constexpr int kStep = 1;\n  int v = vb * vt;\n"),
       ("  const dim3 grid((W + kTile - 1) / kTile, (V + vt - 1) / vt);\n",
        "  const dim3 grid((W + kTile * Chain<T>::kWarps - 1) /\n"
        "                  (kTile * Chain<T>::kWarps), (V + vt - 1) / vt);\n"),
       SUMS_OFF)
VARIANTS = {
    "as built": ((), None),
    "spans through their ends": ((GENERAL,), None),
    "chain off": ((CHAIN_OFF,), None),
    "row stores off": (STORES_OFF, None),
    "loads only": ((CHAIN_OFF,) + STORES_OFF, None),
    "loads in series": ((IN_SERIES,), None),
    "2 stages": (((STAGES[0], STAGES[1].format(2)),), None),
    "4 stages": (((STAGES[0], STAGES[1].format(4)),), None),
    "tile sums off": ((SUMS_OFF,), None),
    "tile pass without g and Hd": (NO_OUT, None),
    "tile pass by the last voxel block, no arrival": ((NO_WAIT,), None),
    "loads only, tile sums off": ((CHAIN_OFF,) + STORES_OFF + (SUMS_OFF,),
                                  None),
    "a block's warps along a voxel row, tile sums off": (ROW, None),
    "spans from the L2, tile sums off": ((L2_SPANS, SUMS_OFF), None),
    "loads only, spans from the L2, tile sums off": (
        (CHAIN_OFF,) + STORES_OFF + (L2_SPANS, SUMS_OFF), None),
    "4 warps a block": ((), {"float32": 4, "float64": 4}),
    "8 warps a block": ((), {"float32": 8, "float64": 8}),
}
POLICIES = ("two waves",)
ROW_TILE = "a block's warps along a voxel row, tile sums off"


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


def _rel(a, b):
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / (scale if scale > 0 else 1.0)


def _operands(torch, dev):
    """The aligned evaluation's chunks [(n, mu, Pc, pv)] with its pose
    table, and the corridor's per-bucket frame ids with its pose table, in
    float32."""
    from global_lvba_tpu_torch.__main__ import slice_config
    from global_lvba_tpu_torch.factors.padding import buckets_to_device
    from global_lvba_tpu_torch.factors.plane_eigen import (
        pose_table, voxel_chunks)
    from global_lvba_tpu_torch.kernels.soa import soa_agg
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
        if name == "aligned":
            fa = bs[0]
            pv = soa_agg(fa.n, fa.mu, fa.Pc, pose12)[1]
            out[name] = ([(fa.n[lo:hi], fa.mu[lo:hi], fa.Pc[lo:hi],
                           pv[lo:hi])
                          for lo, hi in voxel_chunks(fa.n.shape[0], FRAMES)],
                         pose12)
        else:
            out[name] = ([fa.frame.reshape(-1) for fa in bs], pose12)
    return out


def _registers(log, kernel):
    """{"float" / "double": (registers, spill stores)} of `kernel`'s
    instances from ptxas' -v report."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(rf"entry function '\S*{kernel}I([fd])", line)
        if m:
            cur, spills = "float" if m[1] == "f" else "double", 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and cur:
            spills = int(m[1])
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = (int(m[1]), spills)
            cur = None
    return out


def _nvcc(build, cu, so, defines):
    cmd = [build._nvcc(), *build.NVCC_FLAGS, *defines, "-I",
           str(cu.parent), "-o", str(so), str(cu)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _build_variants(build, soa, parent):
    """{variant: library} and {variant: ptxas report}: each VARIANTS copy
    of soa_chain.cu (and with `parent`, that tree's soa_chain.cu and
    selection.cu) built by its own nvcc, all started together."""
    src = (build.CSRC / "soa_chain.cu").read_text()
    out_dir = ROOT / "build" / "chain_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    for hdr in build.CSRC.glob("*.cuh"):
        (out_dir / hdr.name).write_text(hdr.read_text())
    base = [d for d in build._defines("soa_chain")
            if not d.startswith("-DLVBA_CHAIN_WARPS_")]
    jobs = []
    for i, (name, (edits, warps)) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the edit's target is not once "
                                   f"in soa_chain.cu:\n{old}")
            text = text.replace(old, new)
        cu = out_dir / f"soa_chain_v{i}.cu"
        cu.write_text(text)
        so = out_dir / f"libsoa_chain_v{i}.so"
        w = {str(k).replace("torch.", ""): v
             for k, v in soa.CHAIN_WARPS.items()}
        w.update(warps or {})
        jobs.append((name, so, _nvcc(build, cu, so, base + [
            f"-DLVBA_CHAIN_WARPS_F32={w['float32']}",
            f"-DLVBA_CHAIN_WARPS_F64={w['float64']}"])))
    if parent is not None:
        pdir = Path(parent) / "global_lvba_tpu_torch" / "csrc"
        for stem in ("soa_chain", "selection"):
            so = out_dir / f"libparent_{stem}.so"
            jobs.append((f"parent {stem}", so,
                         _nvcc(build, pdir / f"{stem}.cu", so, base)))
    libs, logs = {}, {}
    for name, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        logs[name] = log
        libs[name] = ctypes.CDLL(str(so))
    return libs, logs


def _bind(lib, build, key):
    _, cname, argtypes = build.SIGNATURES[key]
    fn = getattr(lib, cname)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _parent_chain(torch, lib, dt):
    """The earlier tree's aligned chain as its wrapper called it: the
    kernel's partial sums (nblk, 30, W) summed over nblk by torch, then
    relaid out to g and Hd and added to the running sums."""
    from global_lvba_tpu_torch.kernels.soa import d24_to_36

    P, I = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, "lvba_soa_chain" + ("_f64" if dt == torch.float64
                                          else ""))
    fn.argtypes, fn.restype = [P] * 5 + [I] * 3 + [P] * 3, I

    def chain(n, mu, Pc, pose12, pv, g, Hd):
        V, W = n.shape
        if g is None:
            g = torch.zeros((W, 6), dtype=dt, device=n.device)
            Hd = torch.zeros((W, 6, 6), dtype=dt, device=n.device)
        nblk = -(-V // 16)
        A = torch.empty((3 * V, 6 * W), dtype=dt, device=n.device)
        part = torch.empty((nblk, 30, W), dtype=dt, device=n.device)
        err = fn(*(P(t.data_ptr()) for t in (n, mu, Pc, pose12, pv)), V, W,
                 16, P(A.data_ptr()), P(part.data_ptr()),
                 P(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"the parent's soa_chain: CUDA error {err}")
        s = part.sum(dim=0)
        g += s[:6].T
        Hd += s[6:].T[:, d24_to_36(n.device)].reshape(W, 6, 6)
        return A, g, Hd
    return chain


def _parent_select(torch, lib, dt):
    """The earlier tree's table_select, launched once per bucket."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn = getattr(lib, "lvba_table_select" + ("_f64" if dt == torch.float64
                                             else ""))
    fn.argtypes, fn.restype = [P, P, L, I, I, P, P], I

    def select(frames, tbl):
        out = []
        for f in frames:
            o = torch.empty((f.shape[0], tbl.shape[1]), dtype=dt,
                            device=f.device)
            err = fn(P(f.data_ptr()), P(tbl.data_ptr()), f.shape[0],
                     tbl.shape[0], tbl.shape[1], P(o.data_ptr()),
                     P(torch.cuda.current_stream().cuda_stream))
            if err:
                raise RuntimeError(f"the parent's table_select: error {err}")
            out.append(o)
        return out
    return select


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chain_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from global_lvba_tpu_torch.kernels import build, selection, soa

    parent = None
    if "--parent" in sys.argv[1:]:
        parent = sys.argv[sys.argv.index("--parent") + 1]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    ops = _operands(torch, dev)
    libs, logs = _build_variants(build, soa, parent)
    own_launcher, own_warps, own_slots = (build.launcher, soa.CHAIN_WARPS,
                                          soa._chain_slots)
    own_tile = soa.chain_tile
    regs, occ = {}, {}
    for name, log in logs.items():
        if name.startswith("parent"):
            continue
        regs[name] = _registers(log, "soa_chain_kernel")
        occ[name] = {}
        for f64 in (0, 1):
            blocks = ctypes.c_int(0)
            _bind(libs[name], build, "soa_chain_occupancy")(
                f64, ctypes.byref(blocks))
            occ[name]["double" if f64 else "float"] = blocks.value
        print(f"[chain_sweep] {name}: (registers, spill bytes) "
              f"{regs[name]}, blocks a SM {occ[name]}", flush=True)
    if parent is not None:
        r = _registers(logs["parent soa_chain"], "soa_chain_kernel")
        print(f"[chain_sweep] parent soa_chain_kernel: (registers, spill "
              f"bytes) {r}", flush=True)
        regs["parent"] = r
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def use(config):
        """Point the wrapper at a variant (or a tile policy)."""
        if config in POLICIES:
            soa._chain_slots = lambda d, t: 2 * own_slots(d, t)
            return
        lib = libs[config]
        fns = {k: _bind(lib, build, k) for k in
               ("soa_chain", "soa_chain_f64", "soa_chain_occupancy")}
        build.launcher = lambda k: fns[k] if k in fns else own_launcher(k)
        over = VARIANTS[config][1] or {}
        soa.CHAIN_WARPS = {
            k: over.get(str(k).replace("torch.", ""), v)
            for k, v in own_warps.items()}

        def slots(d, t):
            b = ctypes.c_int(0)
            fns["soa_chain_occupancy"](int(t == torch.float64),
                                       ctypes.byref(b))
            return sms * b.value
        soa._chain_slots = slots
        if config == ROW_TILE:
            soa.chain_tile = lambda V, W, sl, w: -(-V // sl)

    def restore():
        build.launcher, soa.CHAIN_WARPS, soa._chain_slots = (
            own_launcher, own_warps, own_slots)
        soa.chain_tile = own_tile

    configs = [*VARIANTS, *POLICIES] + (["parent"] if parent else [])
    results, ok_all = [], True
    chunks32, pose32 = ops["aligned"]
    for dt in (torch.float32, torch.float64):
        dname = str(dt).replace("torch.", "")
        chunks = [tuple(t.to(dt) for t in c) for c in chunks32]
        pose12 = pose32.to(dt)
        W = pose12.shape[0]
        parent_chain = (_parent_chain(torch, libs["parent soa_chain"], dt)
                        if parent else None)

        def evaluation(chain):
            """The chunks as plane_eigen._aligned_pass calls the chain:
            the first stores the sums, the second adds to them."""
            g = Hd = None
            As = []
            for n, mu, Pc, pv in chunks:
                A, g, Hd = chain(n, mu, Pc, pose12, pv, g, Hd)
                As.append(A)
            return As, g, Hd

        def run(config):
            if config == "parent":
                return evaluation(parent_chain)
            use(config)
            try:
                return evaluation(soa.soa_chain)
            finally:
                restore()

        ref = evaluation(soa.soa_chain_plain)
        got, again = run("as built"), run("as built")
        torch.cuda.synchronize()
        err = (max(_rel(a, b) for a, b in zip(got[0], ref[0])),
               _rel(got[1], ref[1]), _rel(got[2], ref[2]))
        rep = all(torch.equal(a, b) for a, b in
                  zip(got[0] + [got[1], got[2]],
                      again[0] + [again[1], again[2]]))
        ok = max(err) <= TOL[dname] and rep
        ok_all &= ok
        print(f"[chain_sweep] {dname} soa_chain vs soa_chain_plain over the "
              f"{len(chunks)} chunks: rel err A {err[0]:.3e}, g {err[1]:.3e}, "
              f"Hd {err[2]:.3e} (tol {TOL[dname]}); two runs bitwise equal: "
              f"{rep}", flush=True)
        if not ok:
            break
        g0 = torch.zeros((W, 6), dtype=dt, device=dev)
        H0 = torch.zeros((W, 6, 6), dtype=dt, device=dev)
        for i, (n, mu, Pc, pv) in enumerate(chunks):
            t = _timed(torch, lambda: soa.soa_chain(n, mu, Pc, pose12, pv,
                                                    g0, H0))
            results.append(dict(dtype=dname, config=f"launch {i}", ms=[t],
                                voxels=int(n.shape[0])))
            vt = soa.chain_tile(n.shape[0], W, soa._chain_slots(dev, dt),
                                soa.CHAIN_WARPS[dt])
            print(f"[chain_sweep] {dname} as built, launch {i} alone "
                  f"({n.shape[0]} voxels, vt {vt}): {t:.4f} ms", flush=True)
        # the card's own rates on these bytes: the chunks' moments read by
        # torch.sum, the Gram operands written by torch.zero_
        As = [torch.empty((3 * c[0].shape[0], 6 * W), dtype=dt, device=dev)
              for c in chunks]
        t_read = _timed(torch, lambda: [x.clone() for c in chunks
                                        for x in c[:3]])
        t_write = _timed(torch, lambda: [A.zero_() for A in As])
        nread = sum(x.numel() for c in chunks for x in c[:3]) * dt.itemsize
        nwrite = sum(A.numel() for A in As) * dt.itemsize
        del As
        results.append(dict(dtype=dname, config="torch copies n, mu, Pc",
                            ms=[t_read], bytes=2 * nread))
        results.append(dict(dtype=dname, config="torch writes A", ms=[t_write],
                            bytes=nwrite))
        print(f"[chain_sweep] {dname} clone of n, mu, Pc "
              f"({nread / 1e6:.1f} MB read and written): {t_read:.4f} ms "
              f"({2 * nread / t_read / 1e9:.2f} TB/s); "
              f"zero_ of A ({nwrite / 1e6:.1f} MB): {t_write:.4f} ms "
              f"({nwrite / t_write / 1e9:.2f} TB/s)", flush=True)
        ms = {c: [] for c in configs}
        for order in (configs, configs[::-1]):
            for c in order:
                ms[c].append(_timed(torch, lambda: run(c)))
        for c in configs:
            note = "timed only"
            if c in POLICIES or c == "parent":
                out = run(c)
                torch.cuda.synchronize()
                e = max(max(_rel(a, b) for a, b in zip(out[0], ref[0])),
                        _rel(out[1], ref[1]), _rel(out[2], ref[2]))
                good = e <= TOL[dname]
                ok_all &= good
                note = f"rel err vs plain {e:.3e}"
            results.append(dict(dtype=dname, config=c, ms=ms[c]))
            print(f"[chain_sweep] {dname} aligned evaluation, {c}: "
                  f"{ms[c][0]:.4f}, {ms[c][1]:.4f} ms; {note}", flush=True)
    # the selection over the corridor's buckets: one launch
    frames, pose32 = ops["corridor"]
    for dt in (torch.float32, torch.float64):
        dname = str(dt).replace("torch.", "")
        tbl = pose32.to(dt)
        got = selection.table_select_buckets(frames, tbl)
        want = selection.table_select_buckets_plain(frames, tbl)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        ok_all &= same
        cases = {"one launch": lambda: selection.table_select_buckets(
            frames, tbl)}
        if parent:
            cases["parent, a launch a bucket"] = (
                lambda sel=_parent_select(torch, libs["parent selection"],
                                          dt): sel(frames, tbl))
        for c, fn in cases.items():
            t = [_timed(torch, fn), _timed(torch, fn)]
            results.append(dict(dtype=dname, config=f"table_select {c}",
                                ms=t))
            print(f"[chain_sweep] {dname} table_select over the corridor's "
                  f"{len(frames)} buckets, {c}: {t[0]:.4f}, {t[1]:.4f} ms; "
                  f"bitwise the plain version: {same}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chain_sweep.json").write_text(json.dumps(
        dict(card=card, registers=regs, blocks_a_sm=occ, results=results,
             ok=ok_all), indent=1))
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
