"""The plain float64 reference against the port's float64 CPU path at a
tiny size, and its gradient and Hessian against finite differences."""

import numpy as np
import pytest
import torch

from lvba_bench import compare
from lvba_bench.reference import lm as ref_lm
from lvba_bench.reference import plane_factor as pf
from lvba_bench.reference.voxel_map import build_ref_map
from lvba_bench.scenes import synthetic as sy

F64 = torch.float64
SCENES = {"plane": (sy.make_plane_scene, 24, 1200),
          "corridor": (sy.make_corridor_scene, 60, 600)}


def _problem(kind, seed=3):
    gen, W, ppf = SCENES[kind]
    sc = gen(num_frames=W, points_per_frame=ppf, seed=seed)
    m = build_ref_map(sc.points_body, sc.frame_ids, sc.R_true, sc.p_true,
                      1.0, (0.2,) * 4)
    R, p = sy.perturb_poses(sc.R_true, sc.p_true, 0.003, 0.01, seed=5)
    return sc, m, (m.vox, m.frame, m.n, m.mu, m.Pc, int(m.cell.shape[0])), \
        torch.tensor(R), torch.tensor(p)


def _boxplus(R, p, dx):
    W = R.shape[0]
    d = dx.reshape(W, 6)
    return R @ ref_lm.exp_so3(d[:, :3]), p + d[:, 3:]


@pytest.mark.parametrize("kind", ["plane", "corridor"])
def test_against_port_float64(kind):
    from global_lvba_tpu_torch.factors.padding import buckets_to_device
    from global_lvba_tpu_torch.map.voxelize import build_voxel_map
    from global_lvba_tpu_torch.solver.lm import lm_damping_iter, plan_route

    sc, m, mt, R, p = _problem(kind)
    W = R.shape[0]
    vm = build_voxel_map(sc.points_body, sc.frame_ids, sc.R_true, sc.p_true,
                         1.0, eigen_ratios=(0.2,) * 4)
    ref_h, cells = compare.ref_entries(m)
    err = compare.map_err(compare.program_entries(vm.buckets), sc.R_true,
                          sc.p_true, ref_h, cells, 1.0, 2)
    # the port keeps the moments in float32
    assert err < 2e-7
    assert vm.num_planes == cells.shape[0]
    bk = buckets_to_device(vm, W=W, dtype=F64, device="cpu")
    route = plan_route(bk, W)
    st = route.cgh(R, p)
    c, g = pf.cost_grad(mt, R, p)
    assert compare.rel_err(float(st[0]) * route.g_size, c) < 1e-6
    assert compare.max_rel(st[1].reshape(-1), g.reshape(-1)) < 1e-5
    res = lm_damping_iter(bk, R, p, max_iters=10)
    opt = ref_lm.lm_solve(mt, R, p, max_iters=25, rel_tol=1e-12)
    gap = (float(pf.cost(mt, res.R, res.p)) - opt.cost) / opt.cost
    assert -1e-9 < gap < 1e-6


@pytest.mark.parametrize("kind", ["plane", "corridor"])
def test_derivatives_finite_differences(kind):
    _, _, mt, R, p = _problem(kind)
    W = R.shape[0]
    c, g, H = pf.cost_grad_hess(mt, R, p, chunk=7)
    _, g2 = pf.cost_grad(mt, R, p)
    assert torch.equal(g, g2.reshape(-1))
    assert torch.allclose(H, H.T, rtol=0, atol=1e-12 * H.abs().max())
    rng = np.random.default_rng(0)
    for _ in range(2):
        d = torch.tensor(rng.normal(size=6 * W))
        v = torch.tensor(rng.normal(size=6 * W))

        def f(a, b, eps=1e-4):
            return float(pf.cost(mt, *_boxplus(R, p, eps * (a * d + b * v))))

        fd_g = (f(1, 0, 1e-6) - f(-1, 0, 1e-6)) / 2e-6
        assert fd_g == pytest.approx(float(g @ d), rel=1e-5)
        fd_h = (f(1, 1) - f(1, -1) - f(-1, 1) + f(-1, -1)) / 4e-8
        assert fd_h == pytest.approx(float(d @ H @ v), rel=1e-3,
                                     abs=1e-4 * float(H.abs().max()))


def test_lm_reaches_optimum_from_starts():
    sc, _, mt, R, p = _problem("plane")
    a = ref_lm.lm_solve(mt, R, p, max_iters=25, rel_tol=1e-12)
    R2, p2 = sy.perturb_poses(sc.R_true, sc.p_true, 0.003, 0.01, seed=9)
    b = ref_lm.lm_solve(mt, torch.tensor(R2), torch.tensor(p2),
                        max_iters=25, rel_tol=1e-12)
    assert abs(a.cost - b.cost) / a.cost < 1e-9
    _, g = pf.cost_grad(mt, a.R, a.p)
    _, g0 = pf.cost_grad(mt, R, p)
    assert float(g.abs().max()) < 1e-5 * float(g0.abs().max())


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, -3.0 - 2 ** -9,
                      1.0 + 3 * 2 ** -12], dtype=torch.float32)
    y = pf.tf32_round(x)
    # 10 mantissa bits: 1 + 2^-11 is a tie, away from zero
    assert y.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                          -3.0 - 2 ** -9, 1.0 + 2 ** -10]
