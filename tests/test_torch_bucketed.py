"""Bucketed plane-factor layout of the PyTorch port against the JAX
package (float64, CPU): the device arrays of buckets_to_device, the
evaluation r/g/H at 1e-9 on a box room (W = 24, several tiers) and a
corridor (W = 48, sparse coupling), the per-entry chain against JAX's
_soa_core and, with frame ids planted outside [0, W) and at an odd W, its
Gram operand against JAX's one-hot M expansion, the chain kernel's
voxels-per-block choice, chunking as an exact reassociation, the f64
numpy oracle, and the multi-bucket evaluation (one Gram accumulator, one
entry_reduce over all buckets) against JAX's _total_cgh, with the steps it
calls counted."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from global_lvba_tpu.eval import oracle
from global_lvba_tpu.factors import padding as jpad
from global_lvba_tpu.factors import plane_eigen as jpe
from global_lvba_tpu.map.voxelize import build_voxel_map as jbuild
from global_lvba_tpu.models import synthetic as jsyn
from global_lvba_tpu.solver import lm as jlm
from global_lvba_tpu_torch.factors import padding, plane_eigen as pe
from global_lvba_tpu_torch.kernels import build, selection as sel, soa
from global_lvba_tpu_torch.map.voxelize import (
    PlaneFactorBucket, build_voxel_map)
from global_lvba_tpu_torch.models import synthetic
from global_lvba_tpu_torch.solver import lm

F64 = torch.float64
SCENES = {
    "plane": (24, lambda m: m.make_plane_scene(num_frames=24,
                                                points_per_frame=600, seed=3)),
    "corridor": (48, lambda m: m.make_corridor_scene(
        num_frames=48, points_per_frame=2000, seed=0)),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def prob(request):
    W, make = SCENES[request.param]
    sc = make(jsyn)
    Rp, pp = jsyn.perturb_poses(sc.R_true, sc.p_true, 0.004, 0.015, seed=1)
    args = (sc.points_body, sc.frame_ids, sc.R_true, sc.p_true, 1.0)
    vm = jbuild(*args, eigen_ratios=(0.2,) * 4)
    ja = jpad.buckets_to_device(vm, dtype=jnp.float64, W=W)
    assert all(isinstance(b, jpe.PlaneFactorArrays) for b in ja)
    fas = [padding.from_jax_arrays(b.n, b.mu, b.Pc, device="cpu", dtype=F64,
                                   frame=b.frame) for b in ja]
    return dict(name=request.param, W=W, sc=sc, vm=vm, args=args, ja=ja,
                fas=fas, Rp=Rp, pp=pp, R=torch.as_tensor(Rp),
                p=torch.as_tensor(pp))


def test_scene_copies_match_jax():
    for W, make in SCENES.values():
        a, b = make(jsyn), make(synthetic)
        np.testing.assert_array_equal(a.points_body, b.points_body)
        np.testing.assert_array_equal(a.frame_ids, b.frame_ids)
        np.testing.assert_array_equal(a.p_true, b.p_true)


@pytest.mark.parametrize("merge", ["auto", "always"])
def test_buckets_to_device_matches_jax(prob, merge):
    W = prob["W"]
    vm = build_voxel_map(*prob["args"], eigen_ratios=(0.2,) * 4)
    assert not padding.picks_aligned(vm, W)
    got = padding.buckets_to_device(vm, W=W, dtype=F64, device="cpu",
                                    merge=merge)
    want = jpad.buckets_to_device(prob["vm"], dtype=jnp.float64, W=W,
                                  merge=merge)
    assert len(got) == len(want) == (1 if merge == "always"
                                     else len(vm.buckets))
    for fa, ja in zip(got, want):
        assert isinstance(fa, pe.PlaneFactorArrays)
        assert fa.frame.dtype == torch.int32
        V = fa.n.shape[0]
        assert V == 1 << (V - 1).bit_length()
        for x, y in zip(fa, ja):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_cost_grad_hess_matches_jax(prob):
    W = prob["W"]
    Rj, pj = jnp.asarray(prob["Rp"]), jnp.asarray(prob["pp"])
    for fa, ja in zip(prob["fas"], prob["ja"]):
        r, g, H = pe.plane_cost_grad_hess(fa, prob["R"], prob["p"], W)
        rj, gj, Hj = jpe.plane_cost_grad_hess(ja, Rj, pj, W)
        assert np.isclose(float(r), float(rj), rtol=1e-12)
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_allclose(H.numpy(), np.asarray(Hj), rtol=1e-9,
                                   atol=1e-10)
        c = pe.plane_cost(fa, prob["R"], prob["p"])
        assert np.isclose(float(c), float(jpe.plane_cost(ja, Rj, pj)),
                          rtol=1e-12)


def test_chain_entries_match_soa_core(prob):
    W = prob["W"]
    for fa, ja in zip(prob["fas"], prob["ja"]):
        V, K = fa.n.shape
        pose12 = pe.pose_table(prob["R"], prob["p"])
        poses = sel.table_select(fa.frame.reshape(-1), pose12).reshape(V, K, 12)
        _, pv = soa.soa_agg(fa.n, fa.mu, fa.Pc, poses)
        A, vals = soa.soa_chain_entries(fa.n, fa.mu, fa.Pc, poses, fa.frame,
                                        pv, W)
        _, jjt6, D36, rows18 = jpe._soa_core(
            ja, jnp.asarray(prob["Rp"]), jnp.asarray(prob["pp"]), W)
        live = (fa.n > 0).numpy()
        np.testing.assert_allclose(vals[:, :6].numpy(),
                                   np.asarray(jjt6).reshape(V * K, 6),
                                   rtol=1e-10, atol=1e-12)
        D = vals[:, 6:][:, torch.as_tensor(pe._D24_TO_36)].numpy()
        np.testing.assert_allclose(D, np.asarray(D36).reshape(V * K, 36),
                                   rtol=1e-10, atol=1e-12)
        assert (vals.numpy()[~live.reshape(-1)] == 0).all()
        # A holds each live entry's rows at its frame's columns, zeros else
        vi, ki = np.nonzero(live)
        f = fa.frame.numpy()[vi, ki]
        A4 = A.numpy().reshape(V, 3, W, 6)
        rows = np.asarray(rows18).reshape(V, K, 3, 6)
        np.testing.assert_allclose(A4[vi, :, f, :], rows[vi, ki],
                                   rtol=1e-10, atol=1e-12)
        mask = np.zeros((V, W), bool)
        mask[vi, f] = True
        assert (A4.transpose(0, 2, 1, 3)[~mask] == 0).all()


ODD_W = 45             # 6W float32 values a row: not a multiple of 16 B


def _plant(frame, n, W):
    """frame with the ids -1, W and W + 3 planted in live entries of three
    voxels: JAX's one-hot drops each (its g/Hd and M column are zero), the
    port writes no row for it."""
    f = frame.copy()
    voxels = np.flatnonzero((n > 0).sum(axis=1) > 1)
    assert len(voxels) >= 3
    for v, bad in zip(voxels, (-1, W, W + 3)):
        f[v, np.flatnonzero(n[v] > 0)[0]] = bad
    return f


def _chain_entries_vs_one_hot(fa, ja, Rp, pp, W):
    """soa_chain_entries on a bucket with planted ids against JAX's
    _chunk_eval_soa (its one-hot path, plane_eigen.py:1467-1489): A is
    JAX's M, exactly zero off the live in-range entries' cells, and the
    channels of the live in-range entries sum to JAX's g and Hd."""
    V, K = fa.n.shape
    frame = _plant(np.asarray(ja.frame), np.asarray(ja.n), W)
    _, gj, Hdj, Mj = jpe._chunk_eval_soa(
        ja._replace(frame=jnp.asarray(frame)), jnp.asarray(Rp),
        jnp.asarray(pp), W)
    # the poses JAX gathers, R[frame]: -1 counts from the end, the rest clamp
    fj = np.clip(np.where(frame < 0, frame + W, frame), 0, W - 1)
    pose12 = pe.pose_table(torch.as_tensor(Rp), torch.as_tensor(pp))
    poses = pose12[torch.as_tensor(fj).long()].contiguous()
    _, pv = soa.soa_agg(fa.n, fa.mu, fa.Pc, poses)
    ft = torch.as_tensor(frame)
    A, vals = soa.soa_chain_entries(fa.n, fa.mu, fa.Pc, poses, ft, pv, W)
    A4 = A.numpy().reshape(V, 3, W, 6).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(A4, np.asarray(Mj), rtol=1e-10, atol=1e-12)
    ok = (fa.n > 0) & (ft >= 0) & (ft < W)
    vi, ki = np.nonzero(ok.numpy())
    cells = np.zeros((V, W), bool)
    cells[vi, frame[vi, ki]] = True
    assert (A4[~cells] == 0).all()
    assert int((fa.n > 0).sum() - ok.sum()) == 3
    okf = ok.reshape(-1)
    s = torch.zeros((W, 30), dtype=F64).index_add_(
        0, ft.reshape(-1)[okf].long(), vals[okf])
    np.testing.assert_allclose(s[:, :6].numpy(), np.asarray(gj), rtol=1e-10,
                               atol=1e-12)
    D = s[:, 6:][:, torch.as_tensor(pe._D24_TO_36)].reshape(W, 6, 6)
    np.testing.assert_allclose(D.numpy(), np.asarray(Hdj), rtol=1e-10,
                               atol=1e-12)
    assert (vals.numpy()[~(fa.n > 0).numpy().reshape(-1)] == 0).all()


def test_chain_entries_drop_out_of_range_frames(prob):
    ran = 0
    for fa, ja in zip(prob["fas"], prob["ja"]):
        if int(((fa.n > 0).sum(dim=1) > 1).sum()) >= 3:
            _chain_entries_vs_one_hot(fa, ja, prob["Rp"], prob["pp"],
                                      prob["W"])
            ran += 1
    assert ran


def test_chain_entries_odd_width():
    sc = jsyn.make_corridor_scene(num_frames=ODD_W, points_per_frame=800,
                                  seed=0)
    Rp, pp = jsyn.perturb_poses(sc.R_true, sc.p_true, 0.004, 0.015, seed=1)
    vm = jbuild(sc.points_body, sc.frame_ids, sc.R_true, sc.p_true, 1.0,
                eigen_ratios=(0.2,) * 4)
    ja = jpad.buckets_to_device(vm, dtype=jnp.float64, W=ODD_W)
    assert all(isinstance(b, jpe.PlaneFactorArrays) for b in ja)
    big = max(ja, key=lambda b: b.n.shape[0])
    fa = padding.from_jax_arrays(big.n, big.mu, big.Pc, device="cpu",
                                 dtype=F64, frame=big.frame)
    _chain_entries_vs_one_hot(fa, big, Rp, pp, ODD_W)


@pytest.mark.parametrize("V, K, want", [
    (32, 4, 1),        # the corridor's chunks at W=512 on 132 SMs: blocks
    (512, 16, 1),      # first (two a SM), then at most 128 entries a block
    (1927, 32, 4),
    (738, 64, 2),
    (1310, 64, 2),
    (100_000, 4, 32),  # many voxels: one round of 128 entries
    (100_000, 1, 64),  # at most 64 voxels a block
    (5000, 512, 1),    # K past 128 entries: one voxel, rounds of 128
    (3, 4096, 1),
])
def test_chain_entries_tile(V, K, want):
    vt = soa.chain_entries_tile(V, K, 132)
    assert vt == want
    assert 1 <= vt <= soa.CHAIN_MAX_TILE and vt & (vt - 1) == 0


def test_chain_entries_limits_reach_the_kernel(monkeypatch):
    """soa_chain.cu takes the limits chain_entries_tile works within from
    kernels/soa.py through the build's -D flags, and a changed limit
    rebuilds the library; zbuffer.cu, colorize.cu and undistort.cu take
    theirs from their wrappers' modules the same way, the other sources
    none."""
    from global_lvba_tpu_torch.kernels import colorize, undistort, zbuffer

    flags = build._defines("soa_chain")
    assert f"-DLVBA_CHAIN_MAX_TILE={soa.CHAIN_MAX_TILE}" in flags
    assert f"-DLVBA_CHAIN_MAX_ENTRIES={soa.CHAIN_MAX_ENTRIES}" in flags
    assert build._defines("zbuffer") == (
        f"-DLVBA_ZBUF_PIECE={zbuffer.PIECE}",
        f"-DLVBA_ZBUF_CHUNK={zbuffer.CHUNK}")
    assert build._defines("colorize") == (
        f"-DLVBA_COLORIZE_THREADS={colorize.THREADS}",
        f"-DLVBA_COLORIZE_STASH={colorize.STASH}",
        f"-DLVBA_COLORIZE_SLAB_IMAGES={colorize.SLAB_IMAGES}")
    assert build._defines("undistort") == (
        f"-DLVBA_UNDISTORT_TILE_W={undistort.TILE_W}",
        f"-DLVBA_UNDISTORT_TILE_H={undistort.TILE_H}",
        f"-DLVBA_UNDISTORT_MAX_PITCH={undistort.MAX_PITCH}",
        f"-DLVBA_UNDISTORT_MAX_ROWS={undistort.MAX_ROWS}",
        f"-DLVBA_UNDISTORT_SEL01={undistort.SEL01:#x}",
        f"-DLVBA_UNDISTORT_SEL2={undistort.SEL2:#x}")
    assert all(build._defines(n) == () for n in build.SOURCES
               if n not in ("soa_chain", "zbuffer", "colorize", "undistort"))
    src = (build.CSRC / "soa_chain.cu").read_text()
    assert "kMaxTile = LVBA_CHAIN_MAX_TILE;" in src
    assert "kEntryThreads = LVBA_CHAIN_MAX_ENTRIES;" in src
    before = build.library("soa_chain")
    monkeypatch.setattr(soa, "CHAIN_MAX_TILE", soa.CHAIN_MAX_TILE // 2)
    assert build.library("soa_chain") != before


def test_bucketed_chunking_is_exact_reassociation(prob):
    W = prob["W"]
    fa = max(prob["fas"], key=lambda b: b.n.shape[0])
    small = 64 * 1024
    assert len(pe.voxel_chunks(fa.n.shape[0], W, small, K=fa.n.shape[1])) > 1
    whole = pe.plane_cost_grad_hess(fa, prob["R"], prob["p"], W)
    tbl = pe.frame_gather_table(fa, W)
    parts = pe.plane_cost_grad_hess(fa, prob["R"], prob["p"], W,
                                    chunk_bytes=small, tbl=tbl)
    for a, b in zip(whole, parts):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                   atol=1e-14)


def test_bucketed_matches_oracle(prob):
    W = prob["W"]
    for fa in prob["fas"]:
        r, g, H = pe.plane_cost_grad_hess(fa, prob["R"], prob["p"], W)
        b = padding.PlaneFactorBucket(*(x.numpy() for x in fa))
        ro, go, Ho = oracle.bucket_cost_grad_hess(b, prob["Rp"], prob["pp"], W)
        assert abs(float(r) - ro) <= 1e-8 * max(1.0, abs(ro))
        np.testing.assert_allclose(g.reshape(-1).numpy(), go, rtol=1e-8,
                                   atol=1e-10)
        np.testing.assert_allclose(H.reshape(6 * W, 6 * W).numpy(), Ho,
                                   rtol=1e-8, atol=1e-9)


def test_bucket_to_device_defaults_to_the_card():
    """bucket_to_device resolves `device` like every entry point: an
    explicit "cpu" runs the plain path; the default is "cuda", which
    raises where no card exists instead of carrying on on the CPU."""
    rng = np.random.default_rng(0)
    b = PlaneFactorBucket(
        n=rng.integers(0, 5, (4, 3)).astype(np.float64),
        mu=rng.normal(size=(4, 3, 3)), Pc=rng.normal(size=(4, 3, 3, 3)),
        frame=rng.integers(0, 8, (4, 3)).astype(np.int32))
    fa = pe.bucket_to_device(b, dtype=F64, device="cpu")
    assert fa.n.device.type == "cpu" and fa.frame.dtype == torch.int32
    np.testing.assert_array_equal(fa.mu.numpy(), b.mu)
    if torch.cuda.is_available():
        assert pe.bucket_to_device(b).n.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pe.bucket_to_device(b)


# The multi-bucket evaluation (plane_cost_grad_hess_buckets, the LM's
# _total_cgh): one Gram accumulator, one vals buffer and one entry_reduce
# through the merged frame table, against the JAX package's _total_cgh at
# float64.  Float64 holds to test_cost_grad_hess_matches_jax's tolerance
# (r rtol 1e-12; g rtol 1e-9, atol 1e-12; H rtol 1e-9, atol 1e-10).
# Float32 holds to float32's: each of r, g, H within 1e-5 of its max |.|
# (every sum in float32; the float32 eigensolve of the line-like voxels
# keeps λ_min to ~sqrt(eps32)·λ_max, which r, g and H bound from above).
TOL32_REL = 1e-5


def _jax_total(ja_list, Rp, pp, W):
    r, g, H = jlm._total_cgh(list(ja_list), jnp.asarray(Rp), jnp.asarray(pp),
                             W)
    return float(r), np.asarray(g), np.asarray(H)


def _check_total(got, want, dtype):
    r, g, H = (x.double().numpy() for x in got)
    rj, gj, Hj = want
    if dtype == F64:
        assert np.isclose(float(r), rj, rtol=1e-12)
        np.testing.assert_allclose(g, gj, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(H, Hj, rtol=1e-9, atol=1e-10)
    else:
        assert abs(float(r) - rj) <= TOL32_REL * abs(rj)
        assert np.abs(g - gj).max() <= TOL32_REL * np.abs(gj).max()
        assert np.abs(H - Hj).max() <= TOL32_REL * np.abs(Hj).max()


@pytest.mark.parametrize("dtype", [F64, torch.float32])
def test_multi_bucket_evaluation_matches_jax_total_cgh(prob, dtype):
    W = prob["W"]
    fas = [pe.PlaneFactorArrays(fa.n.to(dtype), fa.mu.to(dtype),
                                fa.Pc.to(dtype), fa.frame)
           for fa in prob["fas"]]
    assert len(fas) > 1
    R, p = prob["R"].to(dtype), prob["p"].to(dtype)
    table = pe.buckets_frame_table(fas, W)
    r, g, H = lm._total_cgh(fas, table, R, p, W)
    assert r.dtype == g.dtype == H.dtype == dtype
    assert g.shape == (6 * W,) and H.shape == (6 * W, 6 * W)
    _check_total((r, g, H), _jax_total(prob["ja"], prob["Rp"], prob["pp"],
                                       W), dtype)
    # the table is the one the evaluation builds when given none
    got = pe.plane_cost_grad_hess_buckets(fas, R, p, W)
    assert all(torch.equal(a.reshape(-1), b.reshape(-1))
               for a, b in zip(got, (r, g, H)))


@pytest.mark.parametrize("where", [0, 2])
def test_multi_bucket_evaluation_with_an_aligned_bucket(where):
    """An aligned bucket in the list keeps its g/Hd from the aligned
    chain's voxel sums; its AᵀA joins the one Gram accumulator."""
    W, make = SCENES["plane"]
    sc = make(jsyn)
    Rp, pp = jsyn.perturb_poses(sc.R_true, sc.p_true, 0.004, 0.015, seed=1)
    vm = jbuild(sc.points_body, sc.frame_ids, sc.R_true, sc.p_true, 1.0,
                eigen_ratios=(0.2,) * 4)
    jb = jpad.buckets_to_device(vm, dtype=jnp.float64, W=W)
    jal = jpad.aligned_to_device(vm.buckets[:2], W, dtype=jnp.float64)
    ja = list(jb)
    ja.insert(where, jal)
    fas = []
    for b in ja:
        if isinstance(b, jpe.PlaneFactorArrays):
            fas.append(padding.from_jax_arrays(b.n, b.mu, b.Pc, device="cpu",
                                               dtype=F64, frame=b.frame))
        else:
            fas.append(padding.from_jax_arrays(b.n, b.mu, b.Pc, device="cpu",
                                               dtype=F64))
    assert isinstance(fas[where], pe.AlignedPlaneFactorArrays)
    R, p = torch.as_tensor(Rp), torch.as_tensor(pp)
    table = pe.buckets_frame_table(fas, W)
    got = lm._total_cgh(fas, table, R, p, W)
    _check_total(got, _jax_total(ja, Rp, pp, W), F64)


def test_agg_once_per_bucket_is_bitwise_the_chunks(prob):
    """soa_agg over a whole bucket gives bit for bit the per-chunk calls
    concatenated (the evaluation aggregates once per bucket; the chain
    takes pv[lo:hi] per chunk)."""
    W = prob["W"]
    pose12 = pe.pose_table(prob["R"], prob["p"])
    for fa in prob["fas"]:
        V, K = fa.n.shape
        poses = sel.table_select(fa.frame.reshape(-1), pose12).reshape(V, K,
                                                                       12)
        whole = soa.soa_agg(fa.n, fa.mu, fa.Pc, poses)
        chunks = pe.voxel_chunks(V, W, 16 * 1024, K=K)
        assert len(chunks) > 1 or V == 1
        parts = [soa.soa_agg(fa.n[lo:hi], fa.mu[lo:hi], fa.Pc[lo:hi],
                             poses[lo:hi]) for lo, hi in chunks]
        for i in (0, 1):
            assert torch.equal(whole[i], torch.cat([q[i] for q in parts]))


def _counting_steps(counts):
    def wrap(name, fn):
        def f(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **k)
        return f

    return pe.EvalSteps(*(wrap(name, fn) for name, fn in
                          zip(pe.EvalSteps._fields, pe.KERNEL_STEPS)))


def test_total_cgh_reduces_once_and_aggregates_once(prob, monkeypatch):
    """The LM's evaluation calls the aggregation once over all buckets
    (one soa_agg launch), the reduce step once, the pose selection once
    over all buckets (one table_select launch), and the chain and the
    Gram once per voxel chunk (counted through stubs around the kernel
    steps: on the CPU the wrappers run their plain versions and count no
    launch)."""
    W = prob["W"]
    fas = prob["fas"]
    small = 64 * 1024
    chunks = sum(len(pe.voxel_chunks(fa.n.shape[0], W, small,
                                     K=fa.n.shape[1])) for fa in fas)
    assert chunks > len(fas) > 1
    table = pe.buckets_frame_table(fas, W)
    want = lm._total_cgh(fas, table, prob["R"], prob["p"], W)
    counts = {}
    monkeypatch.setattr(pe, "KERNEL_STEPS", _counting_steps(counts))
    got = lm._total_cgh(fas, table, prob["R"], prob["p"], W)
    assert counts == dict(select=1, agg=1, chain_entries=len(fas),
                          syrk_=len(fas), reduce=1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    counts.clear()
    pe.plane_cost_grad_hess_buckets(fas, prob["R"], prob["p"], W, table,
                                    chunk_bytes=small)
    assert counts == dict(select=1, agg=1, chain_entries=chunks,
                          syrk_=chunks, reduce=1)


def test_soa_agg_buckets_is_soa_agg_per_bucket(prob):
    """soa_agg_buckets (one launch over the buckets on the card) gives
    each bucket's soa_agg bit for bit."""
    pose12 = pe.pose_table(prob["R"], prob["p"])
    ops = []
    for fa in prob["fas"]:
        V, K = fa.n.shape
        rows = sel.table_select(fa.frame.reshape(-1), pose12)
        ops.append((fa.n, fa.mu, fa.Pc, rows.reshape(V, K, 12)))
    for a, b in zip(soa.soa_agg_buckets(ops), [soa.soa_agg(*o) for o in ops]):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert soa.soa_agg_buckets([]) == []
