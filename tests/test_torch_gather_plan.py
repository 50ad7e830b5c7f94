"""The GatherPlan evaluation in the PyTorch port against the JAX package
(float64, CPU), after tests/test_plane_factor.py:95-138 (a 12-frame plane
scene, 1,500 points a frame): build_gather_plan array for array,
plane_cost_grad_hess with a slot table and with a plan within 1e-12 of
the largest value, lm_damping_iter(gather_tables=True) within 1e-10 (the
route `gather`), and with the split width patched low a gather solve
takes `gather` or `banded`, never a split route, as the JAX package's
does with LVBA_SPLIT_W low."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from global_lvba_tpu.factors import plane_eigen as jpe
from global_lvba_tpu.map.voxelize import build_voxel_map
from global_lvba_tpu.models.synthetic import make_plane_scene, perturb_poses
from global_lvba_tpu.solver import lm as jlm
from global_lvba_tpu_torch.factors import plane_eigen as pe
from global_lvba_tpu_torch.factors.padding import from_jax_arrays
from global_lvba_tpu_torch.parallel.mesh import make_mesh
from global_lvba_tpu_torch.solver import lm

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module (the suite's workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def plane12():
    """tests/test_plane_factor.py's setup_problem(num_frames=12, ppf=1500)
    and its perturbation: the JAX package's buckets and the port's."""
    sc = make_plane_scene(num_frames=12, points_per_frame=1500, seed=0)
    vm = build_voxel_map(sc.points_body, sc.frame_ids, sc.R_true, sc.p_true,
                         voxel_size=1.0, eigen_ratios=(0.2,) * 4)
    ja = [jpe.bucket_to_device(b, dtype=jnp.float64) for b in vm.buckets]
    tb = [from_jax_arrays(b.n, b.mu, b.Pc, device="cpu", dtype=F64,
                          frame=b.frame) for b in ja]
    Rp, pp = perturb_poses(sc.R_true, sc.p_true, 0.01, 0.02)
    return ja, tb, Rp, pp


def test_gather_plan_arrays_match_jax(plane12):
    ja, tb, _, _ = plane12
    W = 12
    for jfa, tfa in zip(ja, tb):
        jp, tp = jpe.build_gather_plan(jfa, W), pe.build_gather_plan(tfa, W)
        assert isinstance(tp, pe.GatherPlan)
        for name in ("inv", "tbl"):
            a, b = np.asarray(getattr(jp, name)), getattr(tp, name).numpy()
            assert a.shape == b.shape and np.array_equal(a, b), name
            assert getattr(tp, name).dtype == torch.int32


def test_plane_cost_grad_hess_plan_matches_jax(plane12):
    """plane_cost_grad_hess with inv= a GatherPlan against the JAX
    package's with its plan, and with inv= a slot table or none against
    the JAX package's default evaluation (which its own tests hold to its
    slot-table one at 1e-12), within 1e-12 of the largest |g| and |H| (r
    rtol 1e-12); the plan's chunking (the (3V, 6W) operand alone) within
    1e-12 of one chunk's."""
    ja, tb, Rp, pp = plane12
    W = 12
    R, p = jnp.asarray(Rp), jnp.asarray(pp)
    Rt, pt = torch.as_tensor(Rp), torch.as_tensor(pp)
    for jfa, tfa in zip(ja, tb):
        r0, g0, H0 = (np.asarray(x) for x in jpe.plane_cost_grad_hess(
            jfa, R, p, W))
        gs, Hs = max(np.abs(g0).max(), 1e-30), max(np.abs(H0).max(), 1e-30)
        plan = pe.build_gather_plan(tfa, W)
        for jinv, tinv in ((None, pe.frame_slot_table(tfa, W)),
                           (jpe.build_gather_plan(jfa, W), plan), (None, None)):
            ref = (jpe.plane_cost_grad_hess(jfa, R, p, W, inv=jinv)
                   if jinv is not None else (r0, g0, H0))
            r1, g1, H1 = (x.numpy() for x in pe.plane_cost_grad_hess(
                tfa, Rt, pt, W, inv=tinv))
            np.testing.assert_allclose(float(r1), float(ref[0]), rtol=1e-12)
            np.testing.assert_allclose(g1, np.asarray(ref[1]), rtol=0,
                                       atol=1e-12 * gs)
            np.testing.assert_allclose(H1, np.asarray(ref[2]), rtol=0,
                                       atol=1e-12 * Hs)
        small = pe.plane_cost_grad_hess(tfa, Rt, pt, W, inv=plan,
                                        chunk_bytes=W * 18 * 4 * 2 * 3)
        whole = pe.plane_cost_grad_hess(tfa, Rt, pt, W, inv=plan)
        for a, b in zip(small, whole):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-12 * max(
                                           float(b.abs().max()), 1e-30))


@pytest.mark.parametrize("solver", ["auto", "cg"])
def test_lm_gather_tables_matches_jax(plane12, solver):
    """lm_damping_iter(gather_tables=True) against the JAX package's (its
    _lm_jitted with a GatherPlan a bucket), poses within 1e-10, and
    against the port's dense route."""
    ja, tb, Rp, pp = plane12
    R, p = jnp.asarray(Rp), jnp.asarray(pp)
    Rt, pt = torch.as_tensor(Rp), torch.as_tensor(pp)
    ref = jlm.lm_damping_iter(ja, R, p, max_iters=5, gather_tables=True,
                              reduced_solver=solver)
    got = lm.lm_damping_iter(tb, Rt, pt, max_iters=5, gather_tables=True,
                             reduced_solver=solver)
    dense = lm.lm_damping_iter(tb, Rt, pt, max_iters=5, reduced_solver=solver)
    assert got.route == "gather" and dense.route == "dense"
    assert got.iters == int(ref.iters)
    for want in (ref, dense):
        np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R),
                                   rtol=0, atol=1e-10)
    assert np.isclose(float(got.residual), float(ref.residual), rtol=1e-10)


@pytest.mark.parametrize("hessian", ["auto", "banded"])
def test_gather_tables_never_split(plane12, monkeypatch, hessian):
    """With SPLIT_W (and BANDED_MIN_W) below W a gather solve stays on
    `gather`, or takes `banded` where the banded Hessian is asked for,
    and matches the JAX package's with LVBA_SPLIT_W low; without gather
    tables the same solve splits.  split=True with gather tables and
    gather tables on a mesh raise."""
    ja, tb, Rp, pp = plane12
    W = 12
    R, p = jnp.asarray(Rp), jnp.asarray(pp)
    Rt, pt = torch.as_tensor(Rp), torch.as_tensor(pp)
    monkeypatch.setenv("LVBA_SPLIT_W", "8")
    monkeypatch.setattr(lm, "SPLIT_W", 8)
    monkeypatch.setattr(lm, "BANDED_MIN_W", 8)
    # the iterations of test_lm_gather_tables_matches_jax: the JAX
    # package's gather loop is then the one it compiled there
    ref = jlm.lm_damping_iter(ja, R, p, max_iters=5, gather_tables=True,
                              hessian=hessian)
    got = lm.lm_damping_iter(tb, Rt, pt, max_iters=5, gather_tables=True,
                             hessian=hessian)
    assert got.route == ("banded" if hessian == "banded" else "gather")
    assert got.iters == int(ref.iters)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(ref.p), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), rtol=0,
                               atol=1e-8)
    split = lm.plan_route(tb, W, hessian=hessian)
    assert split.name == ("split-banded" if hessian == "banded"
                          else "split-dense")
    with pytest.raises(ValueError, match="gather"):
        lm.plan_route(tb, W, gather_tables=True, split=True)
    with pytest.raises(ValueError, match="gather_tables"):
        lm.plan_route(tb, W, gather_tables=True,
                      mesh=make_mesh(2, devices=["cpu"] * 2))
