"""The solver loops in the reference's form and the evaluation's dtype
dispatch, on the CPU.

The damped block-Jacobi PCG of the port runs exactly `max_iters`
done-masked trips with no read to the host, as the JAX package's
fori_loop does: its iterate is held to global_lvba_tpu.solver.dist_solve
at 1e-12 (float64) where it converges well before the last trip (the
freeze), where it runs out of trips, and on a zero right-hand side.  With
the tensor's host reads patched to raise, solve_damped_cg runs through,
and lm_damping_iter reads `converged` once per iteration and nothing
else (a bucketed solve reads its ids for the frame tables first).  The
evaluation takes the kernel steps in float32 and float64 alike, and each
LiDAR kernel binds a float64 launcher beside its float32 one."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from global_lvba_tpu.solver import dist_solve as jds
from global_lvba_tpu_torch.factors import plane_eigen as pe
from global_lvba_tpu_torch.factors.padding import (
    aligned_to_device, buckets_to_device)
from global_lvba_tpu_torch.kernels import build, gram, selection, soa
from global_lvba_tpu_torch.map.voxelize import build_voxel_map
from global_lvba_tpu_torch.models.synthetic import (
    make_plane_scene, perturb_poses)
from global_lvba_tpu_torch.solver import dist_solve, lm

F64 = torch.float64
HOST_READS = ("__bool__", "item", "tolist", "cpu", "numpy", "__float__",
              "__int__")


def _system(case, n=60, seed=7):
    """(H, g, max_iters) of a damped solve: an SPD H with a spread
    spectrum; 'freeze' converges in far fewer trips than it has, 'trips'
    runs out of them, 'zero' has g = 0."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    spread = {"freeze": 10.0, "trips": 1e6, "zero": 10.0}[case]
    H = Q @ np.diag(np.geomspace(1.0, spread, n)) @ Q.T
    H = 0.5 * (H + H.T)
    g = rng.normal(size=n) if case != "zero" else np.zeros(n)
    return H, g, {"freeze": 256, "trips": 5, "zero": 48}[case]


@pytest.mark.parametrize("case", ["freeze", "trips", "zero"])
def test_solve_damped_cg_matches_jax(case):
    H, g, iters = _system(case)
    u = 0.01
    got = dist_solve.solve_damped_cg(torch.as_tensor(H), torch.as_tensor(g),
                                     torch.tensor(u, dtype=F64),
                                     max_iters=iters)
    ref = jds.solve_damped_cg(jnp.asarray(H), jnp.asarray(g), jnp.asarray(u),
                              max_iters=iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)
    if case == "zero":
        assert torch.equal(got, torch.zeros_like(got))
    if case == "trips":     # not converged: the residual is still large
        d = np.diag(H)
        A = H + np.diag(u * d + 1e-12 * (1 + np.abs(d).max()))
        res = np.linalg.norm(A @ got.numpy() + g) / np.linalg.norm(g)
        assert res > 1e-10


@pytest.mark.parametrize("case", ["freeze", "trips", "zero"])
def test_pcg_matches_jax(case):
    """The shared loop alone, with a diagonal preconditioner, against the
    reference's _pcg on the same operator; the freeze leaves the trips
    after convergence without effect."""
    H, g, iters = _system(case, seed=3)
    dinv = 1.0 / np.diag(H)
    Ht, dt = torch.as_tensor(H), torch.as_tensor(dinv)
    Hj, dj = jnp.asarray(H), jnp.asarray(dinv)
    got = dist_solve._pcg(lambda x: Ht @ x, lambda r: dt * r,
                          torch.as_tensor(g), iters, 1e-10)
    ref = jds._pcg(lambda x: Hj @ x, lambda r: dj * r, jnp.asarray(g),
                   iters, 1e-10)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)
    if case == "freeze":        # twice the trips: the frozen state holds
        again = dist_solve._pcg(lambda x: Ht @ x, lambda r: dt * r,
                                torch.as_tensor(g), 2 * iters, 1e-10)
        assert torch.equal(again, got)


def _no_host_reads(monkeypatch, allow=()):
    """Patch torch.Tensor's host reads to raise, but those named in
    `allow`, which run and are recorded by name in the list returned."""
    events = []

    def refuse(name):
        def f(*a, **k):
            raise AssertionError(f"host read: Tensor.{name}")
        return f

    def record(name, real):
        def f(self, *a, **k):
            events.append(name)
            return real(self, *a, **k)
        return f

    for name in HOST_READS:
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name, record(name, real)
                            if name in allow else refuse(name))
    return events


def test_solve_damped_cg_reads_nothing_to_the_host(monkeypatch):
    H, g, _ = _system("freeze")
    Ht, gt, u = torch.as_tensor(H), torch.as_tensor(g), torch.tensor(0.01,
                                                                    dtype=F64)
    want = dist_solve.solve_damped_cg(Ht, gt, u, max_iters=48)
    _no_host_reads(monkeypatch)
    got = dist_solve.solve_damped_cg(Ht, gt, u, max_iters=48)
    monkeypatch.undo()
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def aligned_w24():
    scene = make_plane_scene(num_frames=24, points_per_frame=800, seed=4)
    vm = build_voxel_map(scene.points_body, scene.frame_ids, scene.R_true,
                         scene.p_true, 1.0, eigen_ratios=[0.2] * 4)
    Rp, pp = perturb_poses(scene.R_true, scene.p_true, 0.004, 0.012, seed=5)
    fa = [aligned_to_device(vm.buckets, 24, dtype=F64, device="cpu")]
    return fa, torch.as_tensor(Rp), torch.as_tensor(pp)


@pytest.mark.parametrize("solver", ["lu", "cg"])
def test_lm_reads_converged_once_per_iteration(aligned_w24, monkeypatch,
                                               solver):
    fa, R0, p0 = aligned_w24
    assert isinstance(fa[0], pe.AlignedPlaneFactorArrays)
    want = lm.lm_damping_iter(fa, R0, p0, max_iters=8, reduced_solver=solver)
    count = _no_host_reads(monkeypatch, allow=("__bool__",))
    got = lm.lm_damping_iter(fa, R0, p0, max_iters=8, reduced_solver=solver)
    monkeypatch.undo()
    assert got.iters >= 2 and len(count) == got.iters == want.iters
    assert torch.equal(got.p, want.p) and torch.equal(got.R, want.R)


def test_bucketed_lm_reads_its_ids_once_then_converged(monkeypatch):
    """A bucketed solve reads each bucket's frame ids and counts to the
    host once, for its frame tables, before its first evaluation; then
    one `converged` per iteration and nothing else."""
    scene = make_plane_scene(num_frames=12, points_per_frame=600, seed=2)
    vm = build_voxel_map(scene.points_body, scene.frame_ids, scene.R_true,
                         scene.p_true, 1.0, eigen_ratios=[0.2] * 4)
    Rp, pp = perturb_poses(scene.R_true, scene.p_true, 0.004, 0.012, seed=1)
    bs = buckets_to_device(vm, W=12, dtype=F64, device="cpu")
    assert all(isinstance(fa, pe.PlaneFactorArrays) for fa in bs)
    R0, p0 = torch.as_tensor(Rp), torch.as_tensor(pp)
    want = lm.lm_damping_iter(bs, R0, p0, max_iters=6)
    events = _no_host_reads(monkeypatch, allow=("__bool__", "cpu", "numpy"))
    got = lm.lm_damping_iter(bs, R0, p0, max_iters=6)
    monkeypatch.undo()
    first = events.index("__bool__")
    assert events[:first] == ["cpu", "numpy"] * 2 * len(bs)
    assert events[first:] == ["__bool__"] * got.iters
    assert got.iters == want.iters and torch.equal(got.p, want.p)


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_cost_grad_hess_takes_the_kernel_steps(aligned_w24, monkeypatch,
                                               dtype):
    """plane_cost_grad_hess hands the kernel steps on in float32 and
    float64 alike (the wrappers run their plain versions on these CPU
    tensors, so the result is the plain steps' bit for bit)."""
    fa64, R0, p0 = aligned_w24
    fa = fa64[0]
    fa = type(fa)(*(t.to(dtype) for t in fa))
    R, p = R0.to(dtype), p0.to(dtype)
    seen = []
    real = pe._cost_grad_hess

    def record(steps, *a, **k):
        seen.append(steps)
        return real(steps, *a, **k)

    monkeypatch.setattr(pe, "_cost_grad_hess", record)
    got = pe.plane_cost_grad_hess(fa, R, p, 24)
    assert seen == [pe.KERNEL_STEPS]
    want = real(pe.PLAIN_STEPS, fa, R, p, 24)
    assert all(torch.equal(a, b) and a.dtype == dtype
               for a, b in zip(got, want))
    assert pe.plane_cost(fa, R, p).dtype == dtype


@pytest.mark.parametrize("dtype,key", [
    (torch.float32, "soa_agg"), (F64, "soa_agg_f64"),
    (torch.float16, None), (torch.bfloat16, None)])
def test_dtype_launcher(dtype, key):
    if key is None:
        with pytest.raises(TypeError, match="float32 or float64"):
            build.dtype_launcher("soa_agg", dtype)
    else:
        assert build.dtype_launcher("soa_agg", dtype) == key


def test_every_lidar_kernel_binds_a_float64_launcher():
    """Each float64 launcher has its own launch count, lives in its
    float32 sibling's source and takes the same arguments (the Gram takes
    A and gram alone: no split in float64)."""
    counts = {**soa.LAUNCHES, **gram.LAUNCHES, **selection.LAUNCHES}
    names = ("soa_agg", "soa_chain", "soa_chain_entries", "syrk",
             "table_select", "entry_reduce")
    for name in names:
        key = build.dtype_launcher(name, F64)
        assert key in counts and key in build.SIGNATURES
        src, cname, args = build.SIGNATURES[key]
        src32, cname32, args32 = build.SIGNATURES[name]
        assert src == src32 and cname == cname32 + "_f64"
        if name != "syrk":
            assert args == args32
    assert "top2_similarity_f64" not in build.SIGNATURES


def test_kernel_checks_take_float64_of_one_dtype():
    """The wrappers' argument checks take float64 as float32, refuse a
    dtype mix or another dtype, and the tf32 split stays float32 only."""
    V, W = 4, 6
    n = torch.ones(V, W, dtype=F64)
    mu, Pc = torch.zeros(V, W, 3, dtype=F64), torch.zeros(V, W, 3, 3,
                                                          dtype=F64)
    soa._check_operands(n, mu, Pc, torch.zeros(W, 12, dtype=F64))
    with pytest.raises(TypeError, match="poses is torch.float32"):
        soa._check_operands(n, mu, Pc, torch.zeros(W, 12))
    with pytest.raises(TypeError, match="float32 or float64"):
        soa._check_operands(n.half(), mu.half(), Pc.half(),
                            torch.zeros(W, 12, dtype=torch.float16))
    A = torch.zeros(3, 6, dtype=F64)
    assert gram.check_args(torch.zeros(6, 6, dtype=F64), A)[:2] == (3, 6)
    with pytest.raises(TypeError, match="split takes float32"):
        gram.tf32_split(A)
    meta = [t.to("meta") for t in (n, mu, Pc)]
    pose = torch.zeros(W, 12, dtype=F64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        soa.soa_agg(*meta, pose)
    with pytest.raises(ValueError, match="unsupported device"):
        gram.syrk_(torch.zeros(6, 6, dtype=F64, device="meta"),
                   torch.zeros(3, 6, dtype=F64, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        selection.table_select(
            torch.zeros(V * W, dtype=torch.int32, device="meta"), pose)
