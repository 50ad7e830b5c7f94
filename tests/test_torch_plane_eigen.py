"""Aligned plane-factor evaluation of the PyTorch port against the JAX
package (float64, CPU): r/g/H at the 1e-9 of tests/test_aligned_layout.py
(at W = 8 and at W = 77, not a multiple of the chain kernel's frame
tile), the plain versions of the three CUDA kernels against the JAX
functions they transcribe (the chain's voxel sums added to running sums
as the evaluation passes them), the Gram-operand layout, the aligned
factor arrays, and the chain kernel's tile helper and build limits."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from global_lvba_tpu.factors import padding as jpad
from global_lvba_tpu.factors import plane_eigen as jpe
from global_lvba_tpu.map.voxelize import PlaneFactorBucket
from global_lvba_tpu.map.voxelize import build_voxel_map as jbuild
from global_lvba_tpu.models.synthetic import make_plane_scene, perturb_poses
from global_lvba_tpu_torch import resolve_device
from global_lvba_tpu_torch.factors import padding, plane_eigen as pe
from global_lvba_tpu_torch.kernels import build, gram, selection, soa
from global_lvba_tpu_torch.map.voxelize import build_voxel_map

F64 = torch.float64


@pytest.fixture(scope="module")
def prob():
    W = 8
    scene = make_plane_scene(num_frames=W, points_per_frame=1500, seed=0)
    args = (scene.points_body, scene.frame_ids, scene.R_true, scene.p_true, 1.0)
    vm = jbuild(*args, eigen_ratios=(0.2,) * 4)
    ja = jpad.aligned_to_device(vm.buckets, W, dtype=jnp.float64)
    fa = padding.from_jax_arrays(ja.n, ja.mu, ja.Pc, device="cpu", dtype=F64)
    Rp, pp = perturb_poses(scene.R_true, scene.p_true, 0.004, 0.01, seed=1)
    return dict(W=W, vm=vm, ja=ja, fa=fa, Rp=Rp, pp=pp, args=args,
                R=torch.as_tensor(Rp), p=torch.as_tensor(pp))


def _jax_channels(prob):
    ja = prob["ja"]
    Rj, pj = jnp.asarray(prob["Rp"]), jnp.asarray(prob["pp"])
    mu3, P6 = jpe._moment_channels(ja)
    R9, p3 = jpe._pose_channels(ja, Rj, pj)
    agg = jpe._soa_agg(ja.n, mu3, P6, R9, p3)
    return mu3, P6, R9, p3, agg


def test_cost_grad_hess_matches_jax(prob):
    W = prob["W"]
    r, g, H = pe.plane_cost_grad_hess(prob["fa"], prob["R"], prob["p"], W)
    rj, gj, Hj = jpe.plane_cost_grad_hess(
        prob["ja"], jnp.asarray(prob["Rp"]), jnp.asarray(prob["pp"]), W)
    assert np.isclose(float(r), float(rj), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), rtol=1e-9, atol=1e-10)
    Hm = H.reshape(6 * W, 6 * W).numpy()
    np.testing.assert_allclose(Hm, Hm.T, rtol=1e-13, atol=1e-12)


def test_plane_cost_matches_jax(prob):
    c = pe.plane_cost(prob["fa"], prob["R"], prob["p"])
    cj = jpe.plane_cost(prob["ja"], jnp.asarray(prob["Rp"]), jnp.asarray(prob["pp"]))
    assert np.isclose(float(c), float(cj), rtol=1e-12)


@pytest.mark.parametrize("chunk_bytes", [64 * 1024, 300 * 1024])
def test_voxel_chunking_is_exact_reassociation(prob, chunk_bytes):
    W = prob["W"]
    assert len(pe.voxel_chunks(prob["fa"].n.shape[0], W, chunk_bytes)) > 1
    whole = pe.plane_cost_grad_hess(prob["fa"], prob["R"], prob["p"], W)
    parts = pe.plane_cost_grad_hess(prob["fa"], prob["R"], prob["p"], W,
                                    chunk_bytes=chunk_bytes)
    for a, b in zip(whole, parts):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-14)


def test_soa_agg_plain_matches_jax(prob):
    fa = prob["fa"]
    residv, pv = soa.soa_agg_plain(fa.n, fa.mu, fa.Pc,
                                   pe.pose_table(prob["R"], prob["p"]))
    *_, agg = _jax_channels(prob)
    _, _, N, invN, vb, _, _, cov6 = agg
    rj, u, B1, B2 = jpe._soa_eig(cov6, N)
    np.testing.assert_allclose(residv.numpy(), np.asarray(rj), rtol=1e-10, atol=1e-18)
    ref = np.stack([np.asarray(x) for x in u + B1 + B2 + vb + (invN,)], -1)
    np.testing.assert_allclose(pv[:, :13].numpy(), ref, rtol=1e-10, atol=1e-12)
    assert (pv[:, 13:] == 0).all()


def test_soa_agg_plain_frame_gather_equals_aligned(prob):
    """The per-entry pose operand (table_select'ed rows, the bucketed
    layout's) with frame k at slot k gives the aligned result bit for
    bit."""
    fa = prob["fa"]
    V, W = fa.n.shape
    pose12 = pe.pose_table(prob["R"], prob["p"])
    frame = torch.arange(W, dtype=torch.int32).expand(V, W).contiguous()
    poses = selection.table_select(frame.reshape(-1), pose12).reshape(V, W, 12)
    a = soa.soa_agg(fa.n, fa.mu, fa.Pc, pose12)
    b = soa.soa_agg(fa.n, fa.mu, fa.Pc, poses)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_soa_chain_plain_matches_jax_and_gram_layout(prob):
    fa, W = prob["fa"], prob["W"]
    pose12 = pe.pose_table(prob["R"], prob["p"])
    _, pv = soa.soa_agg_plain(fa.n, fa.mu, fa.Pc, pose12)
    A, g, Hd = soa.soa_chain_plain(fa.n, fa.mu, fa.Pc, pose12, pv)
    mu3, P6, R9, p3, agg = _jax_channels(prob)
    mask, n, N, invN, vb, Rm, RP, cov6 = agg
    _, u, B1, B2 = jpe._soa_eig(cov6, N)
    rows, jjt, d36 = jpe._soa_chain(mask, n, invN, vb, Rm, RP, mu3, P6, R9,
                                    p3, u, B1, B2)
    np.testing.assert_allclose(
        g.numpy(), np.stack([np.asarray(c).sum(0) for c in jjt], -1),
        rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(
        Hd.reshape(W, 36).numpy(),
        np.stack([np.asarray(c).sum(0) for c in d36], -1), rtol=1e-9, atol=1e-12)
    # the kernel layout (3V, 6W) is JAX's M (V, W, 3, 6) with rows outermost
    _, _, _, M = jpe._chunk_eval_soa(prob["ja"], jnp.asarray(prob["Rp"]),
                                     jnp.asarray(prob["pp"]), W)
    V = fa.n.shape[0]
    Mt = np.asarray(M).transpose(0, 2, 1, 3).reshape(3 * V, 6 * W)
    np.testing.assert_allclose(A.numpy(), Mt, rtol=1e-10, atol=1e-12)
    # the 24 distinct diagonal-extras channels rebuild all 36
    np.testing.assert_array_equal(
        Hd.reshape(W, 36).numpy(),
        Hd.reshape(W, 36).numpy()[:, list(pe._D_UNIQUE)][:, pe._D24_TO_36])


def test_soa_chain_plain_adds_the_jax_voxel_sums(prob):
    """Given running sums g and Hd, soa_chain_plain adds the voxel sums of
    JAX's _soa_chain to them in place (1e-12 of max |.|) and returns them,
    with the same rows; from zeros it gives the sums alone."""
    fa, W = prob["fa"], prob["W"]
    pose12 = pe.pose_table(prob["R"], prob["p"])
    _, pv = soa.soa_agg_plain(fa.n, fa.mu, fa.Pc, pose12)
    mu3, P6, R9, p3, agg = _jax_channels(prob)
    mask, n, N, invN, vb, Rm, RP, cov6 = agg
    _, u, B1, B2 = jpe._soa_eig(cov6, N)
    _, jjt, d36 = jpe._soa_chain(mask, n, invN, vb, Rm, RP, mu3, P6, R9,
                                 p3, u, B1, B2)
    gj = np.stack([np.asarray(c).sum(0) for c in jjt], -1)
    Hj = np.stack([np.asarray(c).sum(0) for c in d36], -1).reshape(W, 6, 6)
    rng = np.random.default_rng(11)
    g0 = torch.as_tensor(rng.normal(size=(W, 6)))
    H0 = torch.as_tensor(rng.normal(size=(W, 6, 6)))
    A0, _, _ = soa.soa_chain_plain(fa.n, fa.mu, fa.Pc, pose12, pv)
    for start_g, start_H in ((g0, H0), (torch.zeros_like(g0),
                                        torch.zeros_like(H0))):
        g, Hd = start_g.clone(), start_H.clone()
        A, g2, Hd2 = soa.soa_chain_plain(fa.n, fa.mu, fa.Pc, pose12, pv,
                                         g, Hd)
        assert g2 is g and Hd2 is Hd
        assert torch.equal(A, A0)
        for got, want in ((g - start_g, gj), (Hd - start_H, Hj)):
            scale = np.abs(want).max()
            np.testing.assert_allclose(got.numpy() / scale, want / scale,
                                       rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="both running sums"):
        soa.soa_chain_plain(fa.n, fa.mu, fa.Pc, pose12, pv, g0.clone())
    with pytest.raises(ValueError, match="Hd must be"):
        soa.soa_chain_plain(fa.n, fa.mu, fa.Pc, pose12, pv, g0.clone(),
                            H0[:-1].clone())


@pytest.fixture(scope="module")
def prob77():
    """An aligned scene at W = 77: not a multiple of the chain kernel's
    32-frame tile (its last tile holds 13 frames), and odd, so the
    (3V, 6W) rows are not a multiple of 16 bytes."""
    W = 77
    scene = make_plane_scene(num_frames=W, points_per_frame=600, seed=2)
    vm = jbuild(scene.points_body, scene.frame_ids, scene.R_true,
                scene.p_true, 1.0, eigen_ratios=(0.2,) * 4)
    assert padding.picks_aligned(build_voxel_map(
        scene.points_body, scene.frame_ids, scene.R_true, scene.p_true, 1.0,
        eigen_ratios=(0.2,) * 4), W)
    ja = jpad.aligned_to_device(vm.buckets, W, dtype=jnp.float64)
    fa = padding.from_jax_arrays(ja.n, ja.mu, ja.Pc, device="cpu", dtype=F64)
    Rp, pp = perturb_poses(scene.R_true, scene.p_true, 0.004, 0.01, seed=1)
    return W, ja, fa, Rp, pp


def test_cost_grad_hess_matches_jax_at_w77(prob77):
    W, ja, fa, Rp, pp = prob77
    r, g, H = pe.plane_cost_grad_hess(fa, torch.as_tensor(Rp),
                                      torch.as_tensor(pp), W)
    rj, gj, Hj = jpe.plane_cost_grad_hess(ja, jnp.asarray(Rp),
                                          jnp.asarray(pp), W)
    assert np.isclose(float(r), float(rj), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), rtol=1e-9,
                               atol=1e-10)


@pytest.mark.parametrize("V, W, slots, warps, want", [
    (1365, 512, 132, 16, 176),  # the W=512 evaluation's chunks on 132 SMs,
    (683, 512, 132, 16, 96),    # one block a SM: 8 voxel blocks a tile
    (1365, 512, 132, 8, 176),   # float64
    (300, 77, 132, 16, 16),     # few voxels: one voxel a warp
    (100_000, 64, 528, 4, 380),
    (1, 4096, 132, 16, 16),     # more frame tiles than slots
    (37, 130, 1, 8, 40),        # one block a tile
])
def test_chain_tile(V, W, slots, warps, want):
    vt = soa.chain_tile(V, W, slots, warps)
    assert vt == want
    assert vt % warps == 0 and vt >= warps
    tiles = -(-W // soa.CHAIN_FRAME_TILE)
    blocks = tiles * -(-V // vt)
    # the grid fills the slots at most about once, or has a voxel a warp
    assert blocks <= max(slots, tiles) or vt == warps


def test_chain_limits_reach_the_kernel(monkeypatch):
    """soa_chain.cu takes its warps a block per dtype from kernels/soa.py
    through the build's -D flags (a changed count rebuilds the library),
    its frame tile is CHAIN_FRAME_TILE, its 24 -> 36 channel table is
    plane_eigen's, and its launcher takes the group form's group count
    and voxels a group, the running sums, the group form's entry rows,
    the accumulate flag, the partial slots and the arrival counters
    (float32 and float64 alike); the occupancy query is bound beside
    it."""
    flags = build._defines("soa_chain")
    assert (f"-DLVBA_CHAIN_WARPS_F32={soa.CHAIN_WARPS[torch.float32]}"
            in flags)
    assert (f"-DLVBA_CHAIN_WARPS_F64={soa.CHAIN_WARPS[torch.float64]}"
            in flags)
    src = (build.CSRC / "soa_chain.cu").read_text()
    assert "sizeof(T) == 4 ? LVBA_CHAIN_WARPS_F32 : LVBA_CHAIN_WARPS_F64;" \
        in src
    assert f"constexpr int kTile = {soa.CHAIN_FRAME_TILE};" in src
    body = src.split("kD24To36[36] = {", 1)[1].split("}", 1)[0]
    table = [int(x) for x in body.replace("\n", " ").split(",")]
    assert table == pe._D24_TO_36.tolist()
    for name in ("soa_chain", "soa_chain_f64"):
        assert build.SIGNATURES[name][2] == ([build._P] * 5 + [build._I] * 5
                                             + [build._P] * 4 + [build._I]
                                             + [build._P] * 3)
    assert build.SIGNATURES["soa_chain_occupancy"][:2] == (
        "soa_chain", "lvba_soa_chain_occupancy")
    before = build.library("soa_chain")
    monkeypatch.setitem(soa.CHAIN_WARPS, torch.float64, 4)
    assert build.library("soa_chain") != before


def test_syrk_plain_matches_jax_dot():
    A = np.random.default_rng(5).normal(size=(90, 48))
    G = gram.syrk_(torch.zeros(48, 48, dtype=F64), torch.as_tensor(A))
    np.testing.assert_allclose(G.numpy(), np.asarray(jnp.dot(A.T, A)),
                               rtol=1e-13, atol=1e-12)
    G2 = gram.syrk_(G.clone(), torch.as_tensor(A))
    np.testing.assert_allclose(G2.numpy(), 2 * G.numpy(), rtol=1e-14)


def test_aligned_arrays_match_jax(prob):
    W, vm = prob["W"], prob["vm"]
    ja = prob["ja"]
    fa = padding.aligned_to_device(vm.buckets, W, dtype=F64, device="cpu")
    for x, y in zip(fa, (ja.n, ja.mu, ja.Pc)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert fa.n.shape[0] == 1 << (fa.n.shape[0] - 1).bit_length()


def test_duplicate_cells_raise(prob):
    b = prob["vm"].buckets[0]
    dup = PlaneFactorBucket(n=b.n.copy(), mu=b.mu, Pc=b.Pc, frame=b.frame.copy())
    dup.frame[0, 1] = dup.frame[0, 0]
    dup.n[0, :2] = 5.0
    with pytest.raises(ValueError, match="duplicate"):
        padding.aligned_to_device([dup], prob["W"], dtype=F64, device="cpu")


def test_density_gate(prob):
    W = prob["W"]
    vm = build_voxel_map(*prob["args"], eigen_ratios=(0.2,) * 4)
    assert not padding.picks_aligned(vm, W)          # W = 8 < 64
    got = padding.buckets_to_device(vm, W=W, dtype=F64, device="cpu")
    assert len(got) == len(vm.buckets)
    assert all(isinstance(fa, pe.PlaneFactorArrays) for fa in got)


def test_width_mismatch_raises(prob):
    with pytest.raises(ValueError, match="aligned bucket width"):
        pe.plane_cost_grad_hess(prob["fa"], prob["R"][:-1], prob["p"][:-1],
                                prob["W"] - 1)


def test_no_fallback_off_cpu(prob, monkeypatch):
    fa = prob["fa"]
    meta = [t.to("meta") for t in (fa.n, fa.mu, fa.Pc)]
    pose = torch.zeros(prob["W"], 12, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        soa.soa_agg(*meta, pose)
    with pytest.raises(ValueError, match="unsupported device"):
        soa.soa_chain(*meta, pose, torch.zeros(fa.n.shape[0], 16, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        gram.syrk_(torch.zeros(6, 6, device="meta"), torch.zeros(3, 6, device="meta"))
    V, W = fa.n.shape
    frame = torch.zeros(V, W, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        selection.table_select(frame.reshape(-1), pose)
    with pytest.raises(ValueError, match="unsupported device"):
        selection.entry_reduce(torch.zeros(V * W, 30, device="meta"),
                               torch.zeros(W, 8, dtype=torch.int32,
                                           device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        soa.soa_chain_entries(*meta, torch.zeros(V, W, 12, device="meta"),
                              frame, torch.zeros(V, 16, device="meta"), W)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")


def test_soa_agg_once_is_bitwise_the_chunks(prob):
    """soa_agg over the whole aligned bucket gives bit for bit the
    per-chunk calls concatenated: the evaluation aggregates once per
    bucket and hands the chain pv[lo:hi] per chunk."""
    fa, W = prob["fa"], prob["W"]
    pose12 = pe.pose_table(prob["R"], prob["p"])
    whole = soa.soa_agg(fa.n, fa.mu, fa.Pc, pose12)
    chunks = pe.voxel_chunks(fa.n.shape[0], W, 64 * 1024)
    assert len(chunks) > 1
    parts = [soa.soa_agg(fa.n[lo:hi], fa.mu[lo:hi], fa.Pc[lo:hi], pose12)
             for lo, hi in chunks]
    for i in (0, 1):
        assert torch.equal(whole[i], torch.cat([q[i] for q in parts]))


@pytest.mark.parametrize("K, lg, ept", [
    (1, 0, 1), (2, 1, 1), (4, 2, 1), (5, 3, 1), (16, 4, 1), (32, 5, 1),
    (33, 5, 2), (45, 5, 2), (64, 5, 2), (65, 5, 4), (129, 5, 8),
    (512, 5, 16), (513, 5, 16), (1024, 5, 16), (5000, 5, 16),
])
def test_agg_group(K, lg, ept):
    """soa_agg_kernel's group: the least power of two >= K threads a voxel
    up to a warp, and the least power of two entries a thread that covers
    K up to 16 (rounds beyond)."""
    assert soa.agg_group(K) == (lg, ept)
    G = 1 << lg
    assert G <= soa.AGG_GROUP and soa.AGG_THREADS % G == 0
    assert G * ept >= K or ept == soa.AGG_EPT
    assert G == soa.AGG_GROUP or G // 2 < K


def test_agg_block_matches_the_kernel():
    """agg_group sizes groups for soa_agg_kernel's block and instances,
    soa_agg_buckets' launches hold at most the kernel's bucket table, and
    the launcher takes the bucket count, eight per-bucket arrays (the
    pose operand's voxel stride and voxels a pose block among them), one
    EPT for the launch (each bucket's group follows from its K and EPT),
    the two output arrays and the stream."""
    src = (build.CSRC / "soa_agg.cu").read_text()
    assert f"constexpr int kThreads = {soa.AGG_THREADS};" in src
    assert f"constexpr int kMaxBuckets = {soa.AGG_MAX_BUCKETS};" in src
    assert soa.AGG_GROUP == 32
    assert "while ((1 << lg) * ept < K[i] && lg < 5) ++lg;" in src
    e = 1
    while e <= soa.AGG_EPT:
        assert f"soa_agg_kernel<T, {e}><<<" in src
        e *= 2
    for name in ("soa_agg", "soa_agg_f64"):
        assert build.SIGNATURES[name][2] == ([build._I] + [build._P] * 8
                                             + [build._I] + [build._P] * 3)
