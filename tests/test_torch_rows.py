"""The matrix-free rows path of the PyTorch port against the JAX package
(float64, CPU): plane_cost_grad_rows, plane_rows_matvec and
plane_rows_cross_diag against JAX and against the dense H (after
test_dist_solve.py:90), solve_damped_cg_rows against JAX and against
solve_damped_cg on the assembled H, the cg_mf LM against JAX and against
LU (after test_lm.py:81), and the matvec's gather with planted
out-of-range frame ids."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from global_lvba_tpu.factors import padding as jpad, plane_eigen as jpe
from global_lvba_tpu.map.voxelize import build_voxel_map
from global_lvba_tpu.models.synthetic import (
    ate_rmse, make_corridor_scene, make_plane_scene, perturb_poses)
from global_lvba_tpu.solver import dist_solve as jds, lm as jlm
from global_lvba_tpu_torch.factors import plane_eigen as pe
from global_lvba_tpu_torch.factors.padding import from_jax_arrays
from global_lvba_tpu_torch.solver import dist_solve, lm

F64 = torch.float64


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


def _rows18(rows):
    """The port's row-block rows (3V, 6K) in the JAX layout (V, K, 18)."""
    V, K = rows.shape[0] // 3, rows.shape[1] // 6
    return rows.numpy().reshape(V, 3, K, 6).transpose(0, 2, 1, 3).reshape(
        V, K, 18)


@pytest.fixture(scope="module")
def w24():
    """The plane scene of test_dist_solve.py:90 (W = 24, seed 3)."""
    sc = make_plane_scene(num_frames=24, points_per_frame=1500, seed=3)
    vm = build_voxel_map(sc.points_body, sc.frame_ids, sc.R_true, sc.p_true,
                         voxel_size=1.0, eigen_ratios=(0.2,) * 4)
    ja = jpad.buckets_to_device(vm, dtype=jnp.float64)
    tb = [from_jax_arrays(b.n, b.mu, b.Pc, device="cpu", dtype=F64,
                          frame=b.frame) for b in ja]
    Rp, pp = perturb_poses(sc.R_true, sc.p_true, 0.005, 0.01, seed=1)
    return sc, ja, tb, Rp, pp


def test_rows_evaluation_matches_jax_and_dense(w24):
    _, ja, tb, Rp, pp = w24
    W = 24
    R, p = jnp.asarray(Rp), jnp.asarray(pp)
    Rt, pt = torch.as_tensor(Rp), torch.as_tensor(pp)
    x = np.random.default_rng(0).normal(size=(W, 6))
    xt = torch.as_tensor(x)
    for jfa, tfa in zip(ja, tb):
        jtbl = jpe.frame_gather_table(jfa, W)
        tbl = pe.frame_gather_table(tfa, W)
        assert np.array_equal(np.asarray(jtbl), tbl.numpy())
        ref = jpe.plane_cost_grad_rows(jfa, R, p, W, jtbl)
        got = pe.plane_cost_grad_rows(tfa, Rt, pt, W, tbl)
        for a, b in zip(ref[:3], got[:3]):
            assert _rel(a, b.numpy()) < 1e-12
        rows = got[3]
        V, K = tfa.n.shape
        assert tuple(rows.shape) == (3 * V, 6 * K)
        assert _rel(ref[3], _rows18(rows)) < 1e-12
        mv = pe.plane_rows_matvec(rows, tfa.frame, tbl, xt)
        assert _rel(jpe.plane_rows_matvec(ref[3], jfa.frame, jtbl,
                                          jnp.asarray(x)), mv.numpy()) < 1e-12
        cd = pe.plane_rows_cross_diag(rows, tbl, W)
        assert _rel(jpe.plane_rows_cross_diag(ref[3], jtbl, W),
                    cd.numpy()) < 1e-12
        # against the dense H: H x = Hd x - (MᵀM) x, diag blocks Hd - cross
        r1, g1, H1 = pe.plane_cost_grad_hess(tfa, Rt, pt, W)
        assert abs(float(r1 - got[0])) < 1e-12
        assert _rel(g1.numpy(), got[1].numpy()) < 1e-11
        Hx = (H1.reshape(6 * W, 6 * W) @ xt.reshape(-1)).reshape(W, 6)
        Hx2 = torch.einsum("wab,wb->wa", got[2], xt) - mv
        scale = float(Hx.abs().max()) + 1.0
        assert float((Hx - Hx2).abs().max()) < 1e-12 * scale
        idx = torch.arange(W)
        D1 = H1[idx, :, idx, :]
        assert float((D1 - (got[2] - cd)).abs().max()) < 1e-12 * scale


def test_solve_damped_cg_rows_matches_jax_and_dense(w24):
    """The rows solve over every bucket against the JAX package's and
    against solve_damped_cg on the assembled H, both 256 trips."""
    _, ja, tb, Rp, pp = w24
    W = 24
    R, p = jnp.asarray(Rp), jnp.asarray(pp)
    Rt, pt = torch.as_tensor(Rp), torch.as_tensor(pp)
    jt = [jpe.frame_gather_table(fa, W) for fa in ja]
    tt = [pe.frame_gather_table(fa, W) for fa in tb]
    jr = [jpe.plane_cost_grad_rows(fa, R, p, W, t) for fa, t in zip(ja, jt)]
    tr = [pe.plane_cost_grad_rows(fa, Rt, pt, W, t) for fa, t in zip(tb, tt)]
    u = 0.01
    xr, dr = jds.solve_damped_cg_rows(
        [r[3] for r in jr], [fa.frame for fa in ja], jt,
        sum(r[2] for r in jr), sum(r[1] for r in jr), jnp.asarray(u))
    Hd, g = sum(r[2] for r in tr), sum(r[1] for r in tr)
    x, d = dist_solve.solve_damped_cg_rows(
        [r[3] for r in tr], [fa.frame for fa in tb], tt, Hd, g,
        torch.tensor(u, dtype=F64))
    assert _rel(xr, x.numpy()) < 1e-10 and _rel(dr, d.numpy()) < 1e-12
    _, g1, H = pe.plane_cost_grad_hess_buckets(tb, Rt, pt, W)
    H = H.reshape(6 * W, 6 * W)
    xd = dist_solve.solve_damped_cg(H, g1.reshape(-1),
                                    torch.tensor(u, dtype=F64), max_iters=256)
    assert _rel(xd.numpy(), x.numpy()) < 1e-10
    assert _rel(torch.diagonal(H).numpy(), d.numpy()) < 1e-12


def test_cg_mf_lm_matches_jax_and_lu():
    """After test_lm.py:81: the corridor (W = 48) through the matrix-free
    LM gives the JAX package's poses and residual, and the LU LM's."""
    W = 48
    sc = make_corridor_scene(num_frames=W, points_per_frame=1200, seed=3)
    vm = build_voxel_map(sc.points_body, sc.frame_ids, sc.R_true, sc.p_true,
                         voxel_size=1.0, eigen_ratios=(0.2,) * 4)
    ja = [jpe.bucket_to_device(b, dtype=jnp.float64) for b in vm.buckets]
    tb = [from_jax_arrays(b.n, b.mu, b.Pc, device="cpu", dtype=F64,
                          frame=b.frame) for b in ja]
    Rp, pp = perturb_poses(sc.R_true, sc.p_true, 0.004, 0.012, seed=1)
    Rt, pt = torch.as_tensor(Rp), torch.as_tensor(pp)
    ref = jlm.lm_damping_iter(ja, jnp.asarray(Rp), jnp.asarray(pp),
                              max_iters=10, reduced_solver="cg_mf")
    got = lm.lm_damping_iter(tb, Rt, pt, max_iters=10, reduced_solver="cg_mf")
    lu = lm.lm_damping_iter(tb, Rt, pt, max_iters=10, reduced_solver="lu")
    assert got.route == "rows" and got.iters == int(ref.iters) == lu.iters
    np.testing.assert_allclose(got.p.numpy(), np.asarray(ref.p), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), rtol=0,
                               atol=1e-8)
    assert np.isclose(float(got.residual), float(ref.residual), rtol=1e-8)
    assert float((got.p - lu.p).abs().max()) < 1e-10
    assert ate_rmse(lu.p.numpy(), sc.p_true) < 0.6 * ate_rmse(pp, sc.p_true)


def test_rows_matvec_with_planted_ids(w24):
    """An entry whose frame id lies outside [0, W) (-1, W, W + 3 planted in
    live entries) gathers nothing in the matvec and has no row in the
    frame table: the product equals the one with those entries' rows
    zeroed."""
    _, _, tb, Rp, pp = w24
    W = 24
    fa = tb[-1]
    rows = pe.plane_cost_grad_rows(fa, torch.as_tensor(Rp),
                                   torch.as_tensor(pp), W)[3]
    V, K = fa.n.shape
    frame = fa.frame.clone()
    vi, ki = torch.nonzero(fa.n > 0, as_tuple=True)
    picks = [(int(vi[j]), int(ki[j])) for j in (0, 3, 8)]
    for (v, k), bad in zip(picks, (-1, W, W + 3)):
        frame[v, k] = bad
    tbl = pe.frame_gather_table(fa._replace(frame=frame), W)
    assert not any(int(v) * K + int(k) in set(tbl.flatten().tolist())
                   for v, k in picks)
    x = torch.as_tensor(np.random.default_rng(1).normal(size=(W, 6)))
    got = pe.plane_rows_matvec(rows, frame, tbl, x)
    r4 = rows.clone().view(V, 3, K, 6)
    for v, k in picks:
        r4[v, :, k] = 0
    want = pe.plane_rows_matvec(r4.view(3 * V, 6 * K), fa.frame,
                                pe.frame_gather_table(fa, W), x)
    assert torch.allclose(got, want, rtol=0, atol=1e-13)
