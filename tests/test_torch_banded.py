"""The banded Hessian of the PyTorch port against the JAX package (float64,
CPU): build_banded_groups and frame_slot_table array for array (with and
without stragglers, Vw = 0), banded_cgh and banded_cgh_compact within
1e-10 of max |.| and banded_cgh against the dense evaluation (after
test_plane_factor.py:166),
solve_damped_cg_banded against JAX and against solve_damped_cg on the
assembled H, the banded LM against JAX and the dense LM (after
test_plane_factor.py:206), and the solve's merged frame table and local
ids with planted out-of-range frame ids."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from global_lvba_tpu.factors import padding as jpad, plane_eigen as jpe
from global_lvba_tpu.map.voxelize import build_voxel_map
from global_lvba_tpu.models.synthetic import (
    make_corridor_scene, perturb_poses)
from global_lvba_tpu.solver import dist_solve as jds, lm as jlm
from global_lvba_tpu_torch.factors import plane_eigen as pe
from global_lvba_tpu_torch.factors.padding import from_jax_arrays
from global_lvba_tpu_torch.solver import dist_solve, lm

F64 = torch.float64
TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the CG loops' thousands of
    small ops (and BLAS calls on small batches) stall on thread hand-offs
    when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1e-300)


def _corridor(W, ppf, seed, pert):
    sc = make_corridor_scene(num_frames=W, points_per_frame=ppf, seed=seed)
    vm = build_voxel_map(sc.points_body, sc.frame_ids, sc.R_true, sc.p_true,
                         voxel_size=1.0, eigen_ratios=(0.2,) * 4)
    ja = jpad.buckets_to_device(vm, dtype=jnp.float64)
    tb = [from_jax_arrays(b.n, b.mu, b.Pc, device="cpu", dtype=F64,
                          frame=b.frame) for b in ja]
    Rp, pp = perturb_poses(sc.R_true, sc.p_true, *pert)
    return ja, tb, Rp, pp


@pytest.fixture(scope="module")
def w64():
    """The corridor of test_plane_factor.py:166 (W = 64, seed 4)."""
    return _corridor(64, 1000, 4, (0.01, 0.02))


@pytest.mark.parametrize("block", [None, 8])
def test_build_banded_groups_matches_jax(w64, block):
    ja, tb, _, _ = w64
    W, walls = 64, []
    for jfa, tfa in zip(ja, tb):
        jb = jpe.build_banded_groups(jfa, W, block=block)
        tg = pe.build_banded_groups(tfa, W, block=block)
        for part in ("fa", "wide_fa"):
            for name in ("n", "mu", "Pc", "frame"):
                a = np.asarray(getattr(getattr(jb, part), name))
                b = getattr(getattr(tg, part), name).numpy()
                assert a.shape == b.shape and np.array_equal(a, b), (part, name)
        for name in ("inv", "offset", "wide_inv"):
            a, b = np.asarray(getattr(jb, name)), getattr(tg, name).numpy()
            assert a.shape == b.shape and np.array_equal(a, b), name
        assert tg.inv.dtype == tg.offset.dtype == torch.int32
        walls.append(int(tg.wide_fa.n.shape[0]))
        np.testing.assert_array_equal(pe.frame_slot_table(tfa, W).numpy(),
                                      np.asarray(jpe.frame_slot_table(jfa, W)))
    # block 8 puts voxels into the straggler group; the p99 block leaves
    # none (Vw = 0), as in the JAX package
    assert max(walls) > 0 if block == 8 else max(walls) == 0
    # the aligned layout (the JAX package's pack_aligned) array for array
    ja_b = jpe.build_banded_groups(ja[1], W, block=block, aligned=True)
    tg_b = pe.build_banded_groups(tb[1], W, block=block, aligned=True)
    assert isinstance(tg_b, pe.AlignedBandedGroups)
    for part, names in (("fa", ("n", "mu", "Pc")),
                        ("wide_fa", ("n", "mu", "Pc", "frame"))):
        for name in names:
            a = np.asarray(getattr(getattr(ja_b, part), name))
            b = getattr(getattr(tg_b, part), name).numpy()
            assert a.shape == b.shape and np.array_equal(a, b), (part, name)
    for name in ("offset", "wide_inv"):
        a, b = np.asarray(getattr(ja_b, name)), getattr(tg_b, name).numpy()
        assert a.shape == b.shape and np.array_equal(a, b), name


@pytest.mark.parametrize("block", [None, 8])
def test_banded_cgh_matches_jax_and_dense(w64, block):
    ja, tb, Rp, pp = w64
    W = 64
    R, p = jnp.asarray(Rp), jnp.asarray(pp)
    Rt, pt = torch.as_tensor(Rp), torch.as_tensor(pp)
    seen = 0
    for jfa, tfa in zip(ja[1:3], tb[1:3]):
        jb = jpe.build_banded_groups(jfa, W, block=block)
        tg = pe.build_banded_groups(tfa, W, block=block)
        seen += int(tg.wide_fa.n.shape[0]) > 0
        ref = jpe.banded_cgh(jb, R, p, W)
        got = pe.banded_cgh(tg, Rt, pt, W)
        for a, b in zip(ref, got):
            assert _rel(a, b.numpy()) < TOL
        # the banded H with its block diagonal is the dense evaluation's
        r0, g0, H0 = pe.plane_cost_grad_hess(tfa, Rt, pt, W)
        H = got[3].reshape(W, 6, W, 6).clone()
        pe.add_block_diag(H, got[2], W)
        assert abs(float(got[0] - r0)) <= 1e-12 * abs(float(r0))
        assert _rel(g0.numpy(), got[1].numpy()) < TOL
        assert _rel(H0.numpy(), H.numpy()) < TOL
        # the compact form: the same Grams and rows, no (6W)² H
        cref = jpe.banded_cgh_compact(jb, R, p, W)
        cgot = pe.banded_cgh_compact(tg, Rt, pt, W)
        for a, b in zip(cref[:4], cgot[:4]):
            assert _rel(a, b.numpy()) < TOL
        Vw = cref[4].shape[0]
        assert tuple(cgot[4].shape) == (3 * Vw, 6 * W)
        if Vw:
            wM = cgot[4].numpy().reshape(Vw, 3, W, 6).transpose(0, 2, 1, 3)
            assert _rel(cref[4], wM) < TOL
    assert seen > 0 if block == 8 else seen == 0


def test_solve_damped_cg_banded_matches_jax_and_dense(w64):
    """The compact solve over every bucket's groups (stragglers included)
    against the JAX package's and against solve_damped_cg on the assembled
    H, both 96 trips."""
    ja, tb, Rp, pp = w64
    W = 64
    R, p = jnp.asarray(Rp), jnp.asarray(pp)
    Rt, pt = torch.as_tensor(Rp), torch.as_tensor(pp)
    jg = [jpe.build_banded_groups(fa, W, block=8) for fa in ja]
    tg = [pe.build_banded_groups(fa, W, block=8) for fa in tb]
    jc = [jpe.banded_cgh_compact(b, R, p, W) for b in jg]
    tc = [pe.banded_cgh_compact(b, Rt, pt, W) for b in tg]
    offs = [tuple(int(o) for o in b.offset) for b in tg]
    Hd_j = sum(c[2] for c in jc)
    g_j = sum(c[1] for c in jc)
    Hd, g = sum(c[2] for c in tc), sum(c[1] for c in tc)
    u = 0.01
    xr, dr = jds.solve_damped_cg_banded([c[3] for c in jc], [c[4] for c in jc],
                                        offs, Hd_j, g_j, jnp.asarray(u))
    x, d = dist_solve.solve_damped_cg_banded(
        [c[3] for c in tc], [c[4] for c in tc], offs, Hd, g,
        torch.tensor(u, dtype=F64))
    assert _rel(xr, x.numpy()) < TOL and _rel(dr, d.numpy()) < TOL
    H = sum(c[3] for c in (pe.banded_cgh(b, Rt, pt, W) for b in tg))
    H = H.reshape(W, 6, W, 6)
    pe.add_block_diag(H, Hd, W)
    H = H.reshape(6 * W, 6 * W)
    xd = dist_solve.solve_damped_cg(H, g.reshape(-1),
                                    torch.tensor(u, dtype=F64), max_iters=96)
    assert _rel(xd.numpy(), x.numpy()) < TOL
    assert _rel(torch.diagonal(H).numpy(), d.numpy()) < 1e-13


def test_banded_lm_matches_jax_and_dense():
    """After test_plane_factor.py:206: the banded LM (W = 96) gives the
    JAX package's poses and residual, and the dense LM's poses."""
    ja, tb, Rp, pp = _corridor(96, 400, 5, (0.005, 0.02))
    R, p = jnp.asarray(Rp), jnp.asarray(pp)
    Rt, pt = torch.as_tensor(Rp), torch.as_tensor(pp)
    ref = jlm.lm_damping_iter(ja, R, p, max_iters=5, hessian="banded")
    got = lm.lm_damping_iter(tb, Rt, pt, max_iters=5, hessian="banded")
    dense = lm.lm_damping_iter(tb, Rt, pt, max_iters=5, hessian="dense")
    assert got.route == "banded" and dense.route == "dense"
    assert got.iters == int(ref.iters) == dense.iters
    np.testing.assert_allclose(got.p.numpy(), np.asarray(ref.p), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), rtol=0,
                               atol=1e-8)
    assert np.isclose(float(got.residual), float(ref.residual), rtol=1e-8)
    np.testing.assert_allclose(got.p.numpy(), dense.p.numpy(), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got.R.numpy(), dense.R.numpy(), rtol=0,
                               atol=1e-9)


def test_banded_plan_with_planted_ids(w64):
    """Frame ids -1, W and W + 3 planted in live entries: the merged frame
    table lists exactly the in-range live entries of the stacks and
    stragglers, the local ids of every in-range live entry lie in its
    window, and the banded evaluation still equals the dense one over the
    same planted buckets (an id outside [0, W) selects a zero pose and
    adds no row and no g/Hd term on both)."""
    _, tb, Rp, pp = w64
    W = 64
    Rt, pt = torch.as_tensor(Rp), torch.as_tensor(pp)
    bs = []
    for fa in tb[1:4]:
        frame = fa.frame.clone()
        live = fa.n > 0
        # -1 in a voxel that starts past two blocks (it becomes a
        # straggler, as in the JAX package; one starting in the first
        # block would fall in no group there either)
        first = torch.where(live, fa.frame, W).min(dim=1).values
        vi, ki = torch.nonzero(live & (first[:, None] >= 16), as_tuple=True)
        frame[vi[0], ki[0]] = -1
        vi, ki = torch.nonzero(live & (frame >= 0), as_tuple=True)
        for j, bad in zip((1, 7), (W, W + 3)):
            frame[vi[j], ki[j]] = bad
        bs.append(fa._replace(frame=frame))
    groups = [pe.build_banded_groups(fa, W, block=8) for fa in bs]
    plan = pe.banded_plan(groups, W)
    fas = plan.stacks + plan.wide
    frame = torch.cat([fa.frame.reshape(-1) for fa in fas]).long()
    live = torch.cat([fa.n.reshape(-1) for fa in fas]) > 0
    ok = live & (frame >= 0) & (frame < W)
    tbl = plan.table.long()
    listed = tbl[tbl < frame.numel()]
    assert sorted(listed.tolist()) == torch.nonzero(ok).flatten().tolist()
    rows, cols = torch.nonzero(tbl < frame.numel(), as_tuple=True)
    assert torch.equal(frame[tbl[rows, cols]], rows)
    assert int((live & ~ok).sum()) == 3 * len(bs)
    for fa, loc, (G, Vp, w) in zip(plan.stacks, plan.local, plan.dims):
        f = fa.frame.long()
        good = (fa.n > 0) & (f >= 0) & (f < W)
        assert loc.dtype == torch.int32
        assert bool(((loc[good] >= 0) & (loc[good] < w)).all())
    r0, g0, H0 = pe.plane_cost_grad_hess_buckets(bs, Rt, pt, W)
    r1, g1, H1 = pe.banded_cost_grad_hess(plan, Rt, pt, W)
    assert abs(float(r1 - r0)) <= 1e-12 * abs(float(r0))
    assert _rel(g0.numpy(), g1.numpy()) < TOL
    assert _rel(H0.numpy(), H1.numpy()) < TOL


def test_to_device_splits_one_copy():
    """The index operands of a solve's plan go over in one buffer and come
    back with their shapes, dtypes and values, empty ones included."""
    rng = np.random.default_rng(0)
    arrays = [rng.integers(-5, 1 << 20, (3, 4, 5)).astype(np.int32),
              rng.integers(0, 1 << 30, (7,)).astype(np.int64),
              np.zeros((0, 9), np.int32), np.arange(6, dtype=np.int64)]
    out = dist_solve.to_device(arrays, "cpu")
    for a, t in zip(arrays, out):
        assert t.dtype == getattr(torch, a.dtype.name)
        assert tuple(t.shape) == a.shape and np.array_equal(t.numpy(), a)
