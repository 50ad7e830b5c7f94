"""Bucketed plane-factor layout of the PyTorch port against the JAX
package (float64, CPU): the device arrays of buckets_to_device, the
evaluation r/g/H at 1e-9 on a box room (W = 24, several tiers) and a
corridor (W = 48, sparse coupling), the per-entry chain against JAX's
_soa_core and, with frame ids planted outside [0, W) and at an odd W, its
Gram operand against JAX's one-hot M expansion, the chain kernel's
voxels-per-block choice, chunking as an exact reassociation, and the f64
numpy oracle."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from global_lvba_tpu.eval import oracle
from global_lvba_tpu.factors import padding as jpad
from global_lvba_tpu.factors import plane_eigen as jpe
from global_lvba_tpu.map.voxelize import build_voxel_map as jbuild
from global_lvba_tpu.models import synthetic as jsyn
from global_lvba_tpu_torch.factors import padding, plane_eigen as pe
from global_lvba_tpu_torch.kernels import build, selection as sel, soa
from global_lvba_tpu_torch.map.voxelize import (
    PlaneFactorBucket, build_voxel_map)
from global_lvba_tpu_torch.models import synthetic

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
    rebuilds the library."""
    flags = build._defines("soa_chain")
    assert f"-DLVBA_CHAIN_MAX_TILE={soa.CHAIN_MAX_TILE}" in flags
    assert f"-DLVBA_CHAIN_MAX_ENTRIES={soa.CHAIN_MAX_ENTRIES}" in flags
    assert all(build._defines(n) == () for n in build.SOURCES
               if n != "soa_chain")
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
