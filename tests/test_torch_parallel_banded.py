"""The banded half of the PyTorch port's multi-device layer (float64, CPU
shards): pad_banded_group_stack, the sharded banded and compact-banded
evaluations, the sharded banded and compact-banded LMs, the pair-window
banded CG and its helpers, on meshes of n in {2, 3, 8} CPU shards (n = 3
pads), each held to the port's local result and to the JAX package's local
result at 1e-8.  Fixture: the dry run's corridor, W=48 at 800 points a
frame (block 8).  tests/test_torch_parallel.py holds the rest."""

import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from global_lvba_tpu.factors import plane_eigen as jpe
from global_lvba_tpu.map.voxelize import build_voxel_map
from global_lvba_tpu.models.synthetic import make_corridor_scene, perturb_poses
from global_lvba_tpu.solver import dist_solve as jds, lm as jlm
from global_lvba_tpu_torch.factors import plane_eigen as pe
from global_lvba_tpu_torch.parallel import mesh as pmesh, shard
from global_lvba_tpu_torch.solver import dist_solve, lm

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_cg import _no_host_reads  # noqa: E402

F64 = torch.float64
TOL = 1e-8
NS = (2, 3, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the CG loops' small ops stall on thread
    hand-offs when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n, names=("factors",), shape=None):
    return pmesh.make_mesh(n, names, shape, devices=["cpu"] * n)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def _d(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def _buckets(vm):
    return ([jpe.bucket_to_device(b, dtype=jnp.float64) for b in vm.buckets],
            [pe.bucket_to_device(b, dtype=F64, device="cpu")
             for b in vm.buckets])


@pytest.fixture(scope="module")
def memo():
    """A module-wide cache of local results: memo(key, fn) runs fn once."""
    cache = {}

    def get(key, fn):
        if key not in cache:
            cache[key] = fn()
        return cache[key]

    return get


@pytest.fixture(scope="module")
def corridor():
    """The dry run's corridor: W=48, 800 points a frame, seed 4."""
    sc = make_corridor_scene(num_frames=48, points_per_frame=800, seed=4)
    vm = build_voxel_map(sc.points_body, sc.frame_ids, sc.R_true, sc.p_true,
                         voxel_size=1.0, eigen_ratios=(0.2,) * 4)
    jb, tb = _buckets(vm)
    Rp, pp = perturb_poses(sc.R_true, sc.p_true, 0.01, 0.02, seed=2)
    return jb, tb, Rp, pp


@pytest.fixture(scope="module")
def jax_banded(corridor):
    """The JAX package's banded_cgh of each corridor bucket (jitted), by
    (bucket, block), each computed once."""
    jb, _, Rp, pp = corridor
    fn = jax.jit(jpe.banded_cgh, static_argnums=3)
    cache = {}

    def get(i, block):
        if (i, block) not in cache:
            bg = jpe.build_banded_groups(jb[i], 48, block=block)
            cache[i, block] = [np.asarray(x) for x in fn(
                bg, jnp.asarray(Rp), jnp.asarray(pp), 48)]
        return cache[i, block]

    return get


@pytest.fixture(scope="module")
def jax_banded_cg_lm(corridor):
    """The JAX package's local compact banded LM (lm_damping_iter_split
    with the banded groups: the group Grams and the 96-trip banded CG, no
    (6W)² H), computed once; its banded LM with the assembled H and the
    same CG lies 2e-13 from it here, and compiles in 19 s against 12."""
    jb, _, Rp, pp = corridor
    return jlm.lm_damping_iter_split(jb, jnp.asarray(Rp), jnp.asarray(pp),
                                     max_iters=6, hessian="banded",
                                     reduced_solver="cg")


# ---------------------------------------------------------------------------
# Banded stacks on a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", NS)
def test_pad_banded_group_stack_matches_jax(corridor, memo, n):
    from global_lvba_tpu.parallel.shard import pad_banded_group_stack as jpad

    jb, tb, _, _ = corridor
    W = 48
    for i, (jfa, fa) in enumerate(zip(jb, tb)):
        got = shard.pad_banded_group_stack(
            pe.build_banded_groups(fa, W, 8), n)
        want = jax.jit(jpad, static_argnums=1)(memo(
            ("jax_groups", i), lambda: jpe.build_banded_groups(
                jfa, W, block=8)), n)
        G = want.fa.n.shape[0]
        assert got.fa.n.shape[0] == G and G % n == 0
        for a, b in zip(got.fa, want.fa):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(got.offset.numpy(),
                                      np.asarray(want.offset))
        assert got.host.offsets == tuple(int(o) for o in want.offset)


@pytest.mark.parametrize("block", [None, 8])
@pytest.mark.parametrize("n", NS)
def test_banded_cgh_sharded_matches_local_and_jax(corridor, jax_banded, memo,
                                                 n, block):
    """banded_cgh_sharded == the port's banded_cgh on every bucket of two
    groups or more, and with block 8 (which forces stragglers) on the
    first bucket with stragglers the JAX package's too (the port's
    banded_cgh is held to JAX's on every bucket at both blocks in
    tests/test_torch_banded.py); two sharded runs are bitwise equal."""
    _, tb, Rp, pp = corridor
    W = 48
    mesh = _mesh(n)
    R, p = _t(Rp), _t(pp)
    checked_jax = False
    for i, fa in enumerate(tb):
        bg = pe.build_banded_groups(fa, W, block)
        if bg.fa.n.shape[0] < 2:
            continue
        got = shard.banded_cgh_sharded(bg, R, p, W, mesh)
        loc = memo(("banded_cgh", i, block),
                   lambda: pe.banded_cgh(bg, R, p, W))
        with_jax = block and bg.wide_fa.n.shape[0] and not checked_jax
        refs = [loc] + ([jax_banded(i, block)] if with_jax else [])
        checked_jax = checked_jax or bool(with_jax)
        for ref in refs:
            for a, c in zip(got, ref):
                scale = max(float(np.abs(np.asarray(c)).max()), 1.0)
                assert _d(a, np.asarray(c).reshape(a.shape)) <= TOL * scale
        again = shard.banded_cgh_sharded(bg, R, p, W, mesh)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert checked_jax or not block


@pytest.mark.parametrize("n", NS)
def test_banded_cgh_compact_sharded_keeps_grams_on_shards(corridor, n):
    """The compact sharded evaluation: g, Hd reduced == local; the Grams of
    each shard are the padded stack's slice, never reduced; a stack not
    padded to the shard count raises."""
    _, tb, Rp, pp = corridor
    W = 48
    mesh = _mesh(n)
    R, p = _t(Rp), _t(pp)
    for fa in tb:
        bg = pe.build_banded_groups(fa, W, 8)
        if bg.fa.n.shape[0] < 2:
            continue
        padded = shard.pad_banded_group_stack(bg, n)
        r, g, Hd, grams, wM = shard.banded_cgh_compact_sharded(
            padded, R, p, W, mesh)
        r0, g0, Hd0, grams0, wM0 = pe.banded_cgh_compact(padded, R, p, W)
        assert len(grams) == n
        assert _d(torch.cat(grams), grams0) <= TOL * float(
            grams0.abs().max())
        assert _d(g, g0) <= TOL * float(g0.abs().max())
        assert _d(Hd, Hd0) <= TOL * float(Hd0.abs().max())
        assert abs(float(r - r0)) <= TOL * abs(float(r0))
        assert torch.equal(wM, wM0)
        if padded.fa.n.shape[0] != bg.fa.n.shape[0]:
            with pytest.raises(ValueError, match="pad the group stack"):
                shard.banded_cgh_compact_sharded(bg, R, p, W, mesh)


@pytest.mark.parametrize("solver", ["lu", "cg"])
@pytest.mark.parametrize("n", NS)
def test_banded_lm_sharded_matches_local_and_jax(corridor, jax_banded_cg_lm,
                                                 memo, n, solver):
    """The banded LM with the group stacks sharded (the dense H reduced) ==
    the port's local banded LM on the same solve; with the 96-trip CG also
    the JAX package's local one.  (The port's local banded LU LM is held to
    the JAX package's in tests/test_torch_banded.py.)"""
    _, tb, Rp, pp = corridor
    R0, p0 = _t(Rp), _t(pp)
    got = shard.lm_damping_iter_banded_sharded(
        tb, R0, p0, _mesh(n), max_iters=6, reduced_solver=solver)
    loc = memo(("banded", solver), lambda: lm.lm_damping_iter(
        tb, R0, p0, max_iters=6, hessian="banded", reduced_solver=solver))
    assert got.route == "sharded-banded" and got.iters == loc.iters
    refs = [loc] + ([jax_banded_cg_lm] if solver == "cg" else [])
    for ref in refs:
        assert _d(got.R, ref.R) < TOL and _d(got.p, ref.p) < TOL
        assert abs(float(got.residual) - float(ref.residual)) <= \
            TOL * float(ref.residual)


@pytest.mark.parametrize("n", NS)
def test_compact_lm_sharded_matches_local_and_jax(corridor, jax_banded_cg_lm,
                                                  memo, n):
    """The compact-banded LM on a mesh (pair-window CG over the shards'
    Grams) == the local banded CG LM, the port's and the JAX package's."""
    _, tb, Rp, pp = corridor
    R0, p0 = _t(Rp), _t(pp)
    got = shard.lm_damping_iter_banded_compact_sharded(
        tb, R0, p0, _mesh(n), max_iters=6, block=8)
    loc = memo(("banded", "cg"), lambda: lm.lm_damping_iter(
        tb, R0, p0, max_iters=6, hessian="banded", reduced_solver="cg"))
    assert got.route == "sharded-compact" and got.iters == loc.iters
    for ref in (loc, jax_banded_cg_lm):
        assert _d(got.R, ref.R) < TOL and _d(got.p, ref.p) < TOL


def test_compact_lm_raises_on_unaligned_offsets(corridor):
    _, tb, Rp, pp = corridor
    with pytest.raises(ValueError, match="not pair-aligned"):
        shard.lm_damping_iter_banded_compact_sharded(
            tb, _t(Rp), _t(pp), _mesh(2), max_iters=1, block=10)


# ---------------------------------------------------------------------------
# The pair-window banded CG
# ---------------------------------------------------------------------------


def test_pair_helpers_match_jax():
    """_pair_aligned on aligned, unaligned, clamped and odd cases;
    _pair_onehot as the index of each JAX one-hot row's 1; _pair_fold and
    _pair_unfold."""
    cases = [((0, 8, 16, 32), 16, 48), ((0, 8, 20), 16, 48),
             ((0, 40), 16, 48), ((0, 8), 15, 48), ((0, 10), 20, 50),
             ((0, 16), 16, 40)]
    for offs, width, W in cases:
        assert dist_solve._pair_aligned(offs, width, W) == \
            jds._pair_aligned(offs, width, W)
    offs, block, n_pairs = (0, 8, 24, 32, 0), 8, 5
    oh = np.asarray(jds._pair_onehot(offs, block, n_pairs, jnp.float64))
    assert (oh.sum(1) == 1).all()
    np.testing.assert_array_equal(
        dist_solve._pair_onehot(offs, block, n_pairs), oh.argmax(1))
    x = np.random.default_rng(1).normal(size=(48, 6))
    pf = dist_solve._pair_fold(_t(x), 8)
    np.testing.assert_array_equal(pf.numpy(),
                                  np.asarray(jds._pair_fold(jnp.asarray(x),
                                                            8)))
    yp = np.random.default_rng(2).normal(size=(5, 96))
    np.testing.assert_allclose(
        dist_solve._pair_unfold(_t(yp), 8, 48).numpy(),
        np.asarray(jds._pair_unfold(jnp.asarray(yp), 8, 48)), rtol=0,
        atol=1e-15)


def _damped_system(corridor):
    jb, tb, Rp, pp = corridor
    W = 48
    R, p = _t(Rp), _t(pp)
    Hd = torch.zeros((W, 6, 6), dtype=F64)
    g = torch.zeros((W, 6), dtype=F64)
    grams, wides, offs = [], [], []
    for fa in tb:
        bg = pe.build_banded_groups(fa, W, 8)
        _, g_, Hd_, gr, wM = pe.banded_cgh_compact(bg, R, p, W)
        Hd, g = Hd + Hd_, g + g_
        grams.append(gr)
        wides.append(wM)
        offs.append(bg.host.offsets)
    return grams, wides, offs, Hd, g


def test_solve_damped_cg_banded_vec_matches_unrolled_and_jax(corridor,
                                                             monkeypatch):
    """The pair-window solve == the unrolled banded solve (the port's) and
    the JAX package's solve_damped_cg_banded_vec on the full multi-bucket
    damped system (tests/test_parallel.py:203); BANDED_PAIR routes
    solve_damped_cg_banded through it."""
    grams, wides, offs, Hd, g = _damped_system(corridor)
    u = torch.tensor(0.01, dtype=F64)
    dx_v, d_v = dist_solve.solve_damped_cg_banded_vec(grams, wides, offs,
                                                      Hd, g, u)
    dx_u, d_u = dist_solve.solve_damped_cg_banded(grams, wides, offs, Hd, g,
                                                  u)
    W = 48
    jw = [jnp.asarray(w.numpy().reshape(-1, 3, W, 6).transpose(0, 2, 1, 3))
          for w in wides]
    dx_j, d_j = jax.jit(jds.solve_damped_cg_banded_vec,
                        static_argnums=2)(
        tuple(jnp.asarray(gr.numpy()) for gr in grams), tuple(jw),
        tuple(offs), jnp.asarray(Hd.numpy()), jnp.asarray(g.numpy()),
        jnp.asarray(0.01))
    scale = float(dx_u.abs().max())
    assert _d(d_v, d_u) <= 1e-12 * float(d_u.abs().max())
    assert _d(dx_v, dx_u) <= TOL * scale and _d(dx_v, dx_j) <= TOL * scale
    calls = []
    vec = dist_solve.solve_damped_cg_banded_vec
    monkeypatch.setattr(dist_solve, "solve_damped_cg_banded_vec",
                        lambda *a, **k: calls.append(1) or vec(*a, **k))
    monkeypatch.setattr(dist_solve, "BANDED_PAIR", True)
    dx_s, _ = dist_solve.solve_damped_cg_banded(grams, wides, offs, Hd, g, u)
    assert calls == [1] and torch.equal(dx_s, dx_v)




@pytest.mark.parametrize("hessian,split,solver,name,trips", [
    ("dense", False, "lu", "sharded-dense", 0),
    ("dense", False, "cg", "sharded-dense", 48),
    ("banded", False, "cg", "sharded-banded", 96),
    ("banded", True, "cg", "sharded-compact", 96)])
def test_sharded_routes_trips_and_host_reads(corridor, monkeypatch, hessian,
                                             split, solver, name, trips):
    """Each sharded route runs the JAX package's CG trips (48 for the
    sharded dense CG, solver/lm.py:309-321; 96 for the banded solves) and,
    once planned, its loop reads one value an iteration (`converged`)."""
    _, tb, Rp, pp = corridor
    route = lm.plan_route(tb, 48, solver, hessian, split=split,
                          mesh=_mesh(3), block=8)
    assert route.name == name and route.trips == trips
    seen = []
    pcg = dist_solve._pcg
    monkeypatch.setattr(dist_solve, "_pcg", lambda mv, pc, b, it, tol: (
        seen.append(it), pcg(mv, pc, b, it, tol))[1])
    events = _no_host_reads(monkeypatch, allow=("__bool__",))
    res = lm._run(route, _t(Rp), _t(pp), 2, 0.01, 2.0, 1e-6)
    monkeypatch.undo()
    assert events == ["__bool__"] * res.iters
    assert seen == ([trips] * res.iters if trips else [])
