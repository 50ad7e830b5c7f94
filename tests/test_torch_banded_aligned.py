"""Aligned banded groups (slot k == local frame offset + k) in the PyTorch
port against the JAX package (float64, CPU), after
tests/test_banded_aligned.py: make_corridor_scene(48, 800, seed=4), block
8.  The group arrays equal the JAX package's exactly; banded_cgh and
banded_cgh_compact on aligned groups match JAX's and the gather layout's
(and the compact form the dense evaluation); the banded LM and the split
LM with lm.BANDED_ALIGNED match the JAX package's with
LVBA_BANDED_ALIGNED=1, and take the -aligned routes."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from global_lvba_tpu.factors import plane_eigen as jpe
from global_lvba_tpu.map.voxelize import build_voxel_map
from global_lvba_tpu.models.synthetic import (
    make_corridor_scene, perturb_poses)
from global_lvba_tpu.solver import lm as jlm
from global_lvba_tpu_torch.factors import plane_eigen as pe
from global_lvba_tpu_torch.factors.padding import from_jax_arrays
from global_lvba_tpu_torch.solver import lm

F64 = torch.float64
W = 48
BLOCK = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the CG loops' thousands of
    small ops stall on thread hand-offs when the suite's workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corridor():
    """tests/test_banded_aligned.py's setup: the JAX package's buckets and
    the port's of the same arrays, perturbed poses."""
    sc = make_corridor_scene(num_frames=W, points_per_frame=800, seed=4)
    vm = build_voxel_map(sc.points_body, sc.frame_ids, sc.R_true, sc.p_true,
                         voxel_size=1.0, eigen_ratios=(0.2,) * 4)
    ja = [jpe.bucket_to_device(b, dtype=jnp.float64) for b in vm.buckets]
    tb = [from_jax_arrays(b.n, b.mu, b.Pc, device="cpu", dtype=F64,
                          frame=b.frame) for b in ja]
    Rp, pp = perturb_poses(sc.R_true, sc.p_true, 0.004, 0.01, seed=1)
    return ja, tb, Rp, pp


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def test_aligned_groups_match_jax(corridor):
    ja, tb, _, _ = corridor
    walls = []
    for jfa, tfa in zip(ja, tb):
        jb = jpe.build_banded_groups(jfa, W, block=BLOCK, aligned=True)
        tg = pe.build_banded_groups(tfa, W, block=BLOCK, aligned=True)
        assert isinstance(jb, jpe.AlignedBandedGroups)
        assert isinstance(tg, pe.AlignedBandedGroups)
        assert isinstance(tg.fa, pe.AlignedPlaneFactorArrays)
        for name in ("n", "mu", "Pc"):
            a, b = np.asarray(getattr(jb.fa, name)), _np(getattr(tg.fa, name))
            assert a.shape == b.shape and np.array_equal(a, b), name
        for name in ("n", "mu", "Pc", "frame"):
            a = np.asarray(getattr(jb.wide_fa, name))
            b = _np(getattr(tg.wide_fa, name))
            assert a.shape == b.shape and np.array_equal(a, b), name
        for name in ("offset", "wide_inv"):
            a, b = np.asarray(getattr(jb, name)), _np(getattr(tg, name))
            assert a.shape == b.shape and np.array_equal(a, b), name
        assert tg.offset.dtype == tg.wide_inv.dtype == torch.int32
        # the host plan: the window frames of the stack's rows, each slot
        # live where a voxel of its group observes it
        G, Vp, w = tg.fa.n.shape
        assert pe.group_width(tg) == w == 2 * BLOCK
        np.testing.assert_array_equal(
            tg.host.frame, np.asarray(jb.offset)[:, None] + np.arange(w))
        np.testing.assert_array_equal(tg.host.live,
                                      _np(tg.fa.n).max(axis=1) > 0)
        walls.append(int(tg.wide_fa.n.shape[0]))
    assert max(walls) > 0   # block 8 leaves stragglers on the gather layout


def test_aligned_banded_cgh_matches_jax_and_gather(corridor):
    """banded_cgh on aligned groups against the JAX package's on its
    aligned groups and against the port's gather layout (the JAX test's
    tolerances: r rtol 1e-12; g, Hd rtol 1e-9 atol 1e-12; H atol
    1e-10), on the two buckets with stacks of several groups (the
    second with stragglers)."""
    ja, tb, Rp, pp = corridor
    R, p = jnp.asarray(Rp), jnp.asarray(pp)
    Rt, pt = torch.as_tensor(Rp), torch.as_tensor(pp)
    for jfa, tfa in zip(ja[:2], tb[:2]):
        jb = jpe.build_banded_groups(jfa, W, block=BLOCK, aligned=True)
        tg = pe.build_banded_groups(tfa, W, block=BLOCK, aligned=True)
        tgg = pe.build_banded_groups(tfa, W, block=BLOCK)
        got = pe.banded_cgh(tg, Rt, pt, W)
        for ref in (jpe.banded_cgh(jb, R, p, W), pe.banded_cgh(tgg, Rt, pt, W)):
            r0, g0, Hd0, H0 = (_np(x) for x in ref)
            r1, g1, Hd1, H1 = (_np(x) for x in got)
            assert np.isclose(float(r0), float(r1), rtol=1e-12)
            np.testing.assert_allclose(g1, g0, rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(Hd1, Hd0, rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(H1, H0, rtol=1e-9, atol=1e-10)


def test_aligned_banded_compact_matches_jax_and_dense(corridor):
    """banded_cgh_compact on aligned groups: its Grams and stragglers'
    rows against the JAX package's, and the H they make against the dense
    evaluation (tests/test_banded_aligned.py:57), on the buckets of
    test_aligned_banded_cgh_matches_jax_and_gather."""
    ja, tb, Rp, pp = corridor
    R, p = jnp.asarray(Rp), jnp.asarray(pp)
    Rt, pt = torch.as_tensor(Rp), torch.as_tensor(pp)
    for jfa, tfa in zip(ja[:2], tb[:2]):
        jb = jpe.build_banded_groups(jfa, W, block=BLOCK, aligned=True)
        tg = pe.build_banded_groups(tfa, W, block=BLOCK, aligned=True)
        r_c, g_c, Hd_c, grams, wM = pe.banded_cgh_compact(tg, Rt, pt, W)
        cref = jpe.banded_cgh_compact(jb, R, p, W)
        assert np.isclose(float(cref[0]), float(r_c), rtol=1e-12)
        for a, b in zip(cref[1:4], (g_c, Hd_c, grams)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-9,
                                       atol=1e-10)
        Vw = cref[4].shape[0]
        assert tuple(wM.shape) == (3 * Vw, 6 * W)
        M2 = wM.numpy()
        if Vw:
            np.testing.assert_allclose(
                M2.reshape(Vw, 3, W, 6).transpose(0, 2, 1, 3),
                np.asarray(cref[4]), rtol=1e-9, atol=1e-12)
        r_d, g_d, H_d = pe.plane_cost_grad_hess(tfa, Rt, pt, W)
        assert np.isclose(float(r_c), float(r_d), rtol=1e-12)
        np.testing.assert_allclose(g_c.numpy(), g_d.numpy(), rtol=1e-9,
                                   atol=1e-12)
        H = np.zeros((6 * W, 6 * W))
        width = pe.group_width(tg)
        for gi, off in enumerate(tg.offset.tolist()):
            o6 = 6 * off
            H[o6:o6 + 6 * width, o6:o6 + 6 * width] -= grams[gi].numpy()
        H -= M2.T @ M2
        for w in range(W):
            H[6 * w:6 * w + 6, 6 * w:6 * w + 6] += Hd_c[w].numpy()
        np.testing.assert_allclose(H, H_d.reshape(6 * W, 6 * W).numpy(),
                                   rtol=1e-9, atol=1e-10)


def _jax_aligned(monkeypatch, on: bool):
    """LVBA_BANDED_ALIGNED on the JAX side, its jitted loops' caches
    cleared (the switch is read at trace time)."""
    monkeypatch.setenv("LVBA_BANDED_ALIGNED", "1" if on else "0")
    jlm._lm_banded_jitted.clear_cache()
    jlm._cgh_banded_compact_exec.clear_cache()


@pytest.mark.parametrize("split", [False, True])
def test_banded_lm_aligned_matches_jax(corridor, monkeypatch, split):
    """lm_damping_iter(hessian="banded") (split: lm_damping_iter_split)
    with lm.BANDED_ALIGNED against the JAX package's with
    LVBA_BANDED_ALIGNED=1, poses within 1e-8; the route names the aligned
    layout, and without the switch the gather layout's (whose LMs
    tests/test_torch_banded.py and test_torch_lm_split.py hold to
    JAX)."""
    ja, tb, Rp, pp = corridor
    R, p = jnp.asarray(Rp), jnp.asarray(pp)
    Rt, pt = torch.as_tensor(Rp), torch.as_tensor(pp)
    run_j = jlm.lm_damping_iter_split if split else jlm.lm_damping_iter
    run_t = lm.lm_damping_iter_split if split else lm.lm_damping_iter
    _jax_aligned(monkeypatch, True)
    try:
        ref = run_j(ja, R, p, max_iters=6, hessian="banded")
    finally:
        _jax_aligned(monkeypatch, False)
    monkeypatch.setattr(lm, "BANDED_ALIGNED", True)
    got = run_t(tb, Rt, pt, max_iters=6, hessian="banded")
    monkeypatch.setattr(lm, "BANDED_ALIGNED", False)
    assert got.route == ("split-banded-aligned" if split
                         else "banded-aligned")
    assert lm.plan_route(tb, W, hessian="banded", split=split).name == (
        "split-banded" if split else "banded")
    assert got.iters == int(ref.iters)
    np.testing.assert_allclose(got.p.numpy(), _np(ref.p), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.R.numpy(), _np(ref.R), rtol=0, atol=1e-8)
    assert np.isclose(float(got.residual), float(ref.residual), rtol=1e-8)


@pytest.mark.parametrize("bucket", [0, 1])
def test_group_forms_plain_match_per_group(corridor, bucket):
    """The plain versions of the group forms against the W-wide forms run
    group by group: soa_agg on the (G, 2B, 12) windows bit for bit soa_agg
    on per-entry rows and on each group's window table; soa_chain_groups'
    rows bit for bit soa_chain's on each group's window, its (group, slot)
    rows the group's voxel sums of g and Hd's unique channels (1e-12 of
    max |.|).  The wrappers take these on CPU tensors, and refuse windows
    that do not divide the voxels."""
    from global_lvba_tpu_torch.kernels import soa

    _, tb, Rp, pp = corridor
    tg = pe.build_banded_groups(tb[bucket], W, block=BLOCK, aligned=True)
    G, Vp, w = tg.fa.n.shape
    pose12 = pe.pose_table(torch.as_tensor(Rp), torch.as_tensor(pp))
    offs = tg.offset.long()
    wins = pose12[offs[:, None] + torch.arange(w)]          # (G, 2B, 12)
    n, mu, Pc = (x.reshape((G * Vp,) + tuple(x.shape[2:])) for x in tg.fa)
    residv, pv = soa.soa_agg(n, mu, Pc, wins)
    rows = wins.repeat_interleave(Vp, dim=0)
    for a, b in zip((residv, pv), soa.soa_agg(n, mu, Pc, rows)):
        assert torch.equal(a, b)
    A, vals = soa.soa_chain_groups(n, mu, Pc, wins, pv)
    assert A.shape == (3 * G * Vp, 6 * w) and vals.shape == (G * w, 30)
    uniq = torch.as_tensor(pe._D_UNIQUE)
    for g in range(G):
        sl = slice(g * Vp, (g + 1) * Vp)
        r_g, pv_g = soa.soa_agg(n[sl], mu[sl], Pc[sl], wins[g])
        assert torch.equal(r_g, residv[sl]) and torch.equal(pv_g, pv[sl])
        A_g, g_g, Hd_g = soa.soa_chain(n[sl], mu[sl], Pc[sl], wins[g],
                                       pv[sl])
        assert torch.equal(A_g, A[3 * g * Vp:3 * (g + 1) * Vp])
        want = torch.cat([g_g, Hd_g.reshape(w, 36)[:, uniq]], dim=1)
        got = vals[g * w:(g + 1) * w]
        assert float((got - want).abs().max()) <= 1e-12 * float(
            want.abs().max())
    with pytest.raises(ValueError, match="divide"):
        soa.soa_agg(n[:-1], mu[:-1], Pc[:-1], wins)
