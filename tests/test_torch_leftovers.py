"""The public-surface leftovers of the PyTorch port against the JAX package
(float64, CPU, 1e-8): geometry.se3 (compose, inverse, relative, apply),
geometry.so3 (jr, jr_inv, euler_to_rot), ops.eigh3.eigh3x3 on the seven
cases of tests/test_eigh3.py, plane_cost_aos == plane_cost_soa == JAX on
one bucket, map.planes, map.moments (after tests/test_map.py) and
ops.segments."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from global_lvba_tpu.factors import plane_eigen as jpe
from global_lvba_tpu.geometry import se3 as jse3, so3 as jso3
from global_lvba_tpu.map import moments as jmom, planes as jplanes
from global_lvba_tpu.map.voxelize import build_voxel_map
from global_lvba_tpu.models.synthetic import make_plane_scene, perturb_poses
from global_lvba_tpu.ops import eigh3 as jeig, segments as jseg
from global_lvba_tpu_torch.factors import plane_eigen as pe
from global_lvba_tpu_torch.geometry import se3, so3
from global_lvba_tpu_torch.map import moments, planes
from global_lvba_tpu_torch.ops import eigh3, segments

TOL = 1e-8


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=tol)


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    return (Rotation.random(n, random_state=seed).as_matrix(),
            rng.normal(size=(n, 3)))


@pytest.mark.parametrize("fn", ["compose", "inverse", "relative", "apply"])
def test_se3_matches_jax(fn):
    (Ra, pa), (Rb, pb) = _poses(5, 1), _poses(5, 2)
    x = np.random.default_rng(3).normal(size=(5, 3))
    args = {"compose": (Ra, pa, Rb, pb), "inverse": (Ra, pa),
            "relative": (Ra, pa, Rb, pb), "apply": (Ra, pa, x)}[fn]
    want = jax.jit(getattr(jse3, fn))(*(jnp.asarray(a) for a in args))
    got = getattr(se3, fn)(*(_t(a) for a in args))
    for g, w in zip(got if fn != "apply" else [got],
                    want if fn != "apply" else [want]):
        _close(g, w)
    if fn == "relative":                     # a ∘ rel == b
        Rc, pc = se3.compose(_t(Ra), _t(pa), *got)
        _close(Rc, Rb, 1e-12)
        _close(pc, pb, 1e-12)


@pytest.mark.parametrize("fn", ["jr", "jr_inv"])
def test_so3_jacobians_match_jax(fn):
    rng = np.random.default_rng(4)
    w = np.concatenate([rng.normal(size=(16, 3)),
                        1e-8 * rng.normal(size=(4, 3)), np.zeros((1, 3))])
    _close(getattr(so3, fn)(_t(w)),
           jax.jit(getattr(jso3, fn))(jnp.asarray(w)))
    if fn == "jr_inv":
        _close(so3.jr(_t(w)) @ so3.jr_inv(_t(w)),
               np.broadcast_to(np.eye(3), (w.shape[0], 3, 3)), 1e-12)


def test_euler_to_rot_matches_jax():
    a = np.random.default_rng(5).uniform(-np.pi, np.pi, size=(3, 32))
    got = so3.euler_to_rot(*(_t(x) for x in a))
    _close(got, jax.jit(jso3.euler_to_rot)(*(jnp.asarray(x) for x in a)))
    want = Rotation.from_euler("ZYX", a[::-1].T).as_matrix()
    _close(got, want, 1e-12)


def _rand_sym(n, seed=0):
    A = np.random.default_rng(seed).normal(size=(n, 3, 3))
    return 0.5 * (A + np.swapaxes(A, 1, 2))


def _planar():
    rng = np.random.default_rng(3)
    mats = []
    for _ in range(100):
        Q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        d = np.array([1e-6 * rng.uniform(0.5, 2), rng.uniform(0.1, 1),
                      rng.uniform(1, 3)])
        mats.append(Q @ np.diag(d) @ Q.T)
    return np.stack(mats)


def _degenerate():
    Q = np.linalg.qr(np.random.default_rng(4).normal(size=(3, 3)))[0]
    return (Q @ np.diag([1.0, 1.0, 3.0]) @ Q.T)[None]


EIGH_CASES = {
    "eigenvalues": lambda: _rand_sym(500),
    "eigenvectors": lambda: _rand_sym(500, seed=1),
    "orthonormal": lambda: _rand_sym(200, seed=2),
    "planar": _planar,
    "degenerate_pair": _degenerate,
    "identity_zero": lambda: np.stack([np.eye(3), np.zeros((3, 3))]),
    "float32": lambda: _rand_sym(300, seed=5).astype(np.float32),
}


@pytest.fixture(scope="module")
def jax_eigh():
    """The JAX package's eigh3x3 of every case, the float64 ones in one
    jitted call (one compile), by case."""
    mats = {c: f() for c, f in EIGH_CASES.items()}
    f64 = [c for c in mats if mats[c].dtype == np.float64]
    lams, U = jax.jit(jeig.eigh3x3)(jnp.asarray(np.concatenate(
        [mats[c] for c in f64])))
    out, o = {}, 0
    for c in f64:
        n = mats[c].shape[0]
        out[c] = (np.asarray(lams)[o:o + n], np.asarray(U)[o:o + n])
        o += n
    for c in set(mats) - set(f64):
        out[c] = tuple(np.asarray(x) for x in jax.jit(jeig.eigh3x3)(
            jnp.asarray(mats[c])))
    return out


@pytest.mark.parametrize("case", list(EIGH_CASES))
def test_eigh3x3_matches_jax(case, jax_eigh):
    """The seven cases of tests/test_eigh3.py: each checks what the JAX test
    checks, and the port against JAX (1e-8 in float64; float32 at 1e-5)."""
    A = EIGH_CASES[case]()
    lams, U = eigh3.eigh3x3(torch.as_tensor(A))
    jl, jU = jax_eigh[case]
    lams, U = lams.numpy(), U.numpy()
    tol = 1e-5 if case == "float32" else TOL
    _close(lams, jl, tol)
    _close(U, jU, tol)
    if case == "float32":
        assert lams.dtype == np.float32
        _close(lams, np.linalg.eigvalsh(A.astype(np.float64)), 2e-5)
    elif case == "eigenvalues":
        _close(lams, np.linalg.eigvalsh(A), 1e-9)
    elif case == "eigenvectors":
        for k in range(3):
            res = (np.einsum("nij,nj->ni", A, U[:, :, k])
                   - lams[:, k:k + 1] * U[:, :, k])
            assert np.abs(res).max() < 1e-8
    elif case == "orthonormal":
        _close(np.einsum("nij,nik->njk", U, U),
               np.tile(np.eye(3), (A.shape[0], 1, 1)), 1e-9)
    elif case == "planar":
        lref, Uref = np.linalg.eigh(A)
        np.testing.assert_allclose(lams, lref, rtol=1e-5, atol=1e-10)
        assert np.abs(np.einsum("ni,ni->n", U[:, :, 0],
                                Uref[:, :, 0])).min() > 1 - 1e-6
    elif case == "degenerate_pair":
        _close(lams[0], [1.0, 1.0, 3.0], 1e-9)
        assert np.abs(A[0] @ U[0] - U[0] * lams[0][None, :]).max() < 1e-7
    else:
        assert np.isfinite(U).all()
        _close(lams[0], [1, 1, 1], 1e-12)
        _close(lams[1], [0, 0, 0], 1e-12)
    rl, _ = eigh3.eigh3x3_reference(torch.as_tensor(A))
    _close(rl, jeig.eigh3x3_reference(jnp.asarray(A))[0], 1e-6 if
           case == "float32" else 1e-12)


def test_plane_cost_aos_soa_jax_agree():
    """plane_cost_aos == plane_cost_soa == the JAX package's, on every
    bucket of test_plane_factor.py:333's scene."""
    sc = make_plane_scene(num_frames=6, points_per_frame=2000, noise=0.003,
                          seed=9)
    vm = build_voxel_map(sc.points_body, sc.frame_ids, sc.R_true, sc.p_true,
                         voxel_size=1.0, eigen_ratios=(0.2,) * 4)
    Rp, pp = perturb_poses(sc.R_true, sc.p_true, 0.01, 0.02, seed=4)
    assert pe.plane_cost_soa is pe.plane_cost
    for b in vm.buckets:
        jfa = jpe.bucket_to_device(b, dtype=jnp.float64)
        tfa = pe.bucket_to_device(b, dtype=torch.float64, device="cpu")
        want = float(jax.jit(jpe.plane_cost_aos)(jfa, jnp.asarray(Rp),
                                                 jnp.asarray(pp)))
        aos = float(pe.plane_cost_aos(tfa, _t(Rp), _t(pp)))
        soa = float(pe.plane_cost_soa(tfa, _t(Rp), _t(pp)))
        assert abs(aos - want) <= TOL * max(abs(want), 1.0)
        assert abs(soa - want) <= TOL * max(abs(want), 1.0)
        assert abs(soa - float(jax.jit(jpe.plane_cost_soa)(
            jfa, jnp.asarray(Rp), jnp.asarray(pp)))) <= TOL * max(abs(want),
                                                                  1.0)


def test_planes_match_jax():
    rng = np.random.default_rng(6)
    n = np.array([0.2, -0.3, 0.9]) / np.linalg.norm([0.2, -0.3, 0.9])
    xy = rng.uniform(-2, 2, size=(40, 2))
    pts = np.c_[xy, (1.5 - n[0] * xy[:, 0] - n[1] * xy[:, 1]) / n[2]]
    pts += 1e-3 * rng.normal(size=pts.shape)
    for thr in (0.1, 1e-6):
        got, want = planes.esti_plane(pts, thr), jplanes.esti_plane(pts, thr)
        assert (got is None) == (want is None)
        if got is not None:
            _close(got[0], want[0], 1e-12)
            assert abs(got[1] - want[1]) < 1e-12
    assert (planes.esti_plane(pts, 1e-6)) is None
    gn, gd = planes.fit_plane_svd(pts)
    wn, wd = jplanes.fit_plane_svd(pts)
    _close(gn, wn, 1e-12)
    assert abs(gd - wd) < 1e-12


def test_moments_match_jax():
    """transform_moments, cov_from_moments and merge_moments against JAX
    and against the pointwise sums (tests/test_map.py)."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(4, 50, 3))
    P = np.einsum("bni,bnj->bij", pts, pts)
    v = pts.sum(1)
    n = np.full(4, 50.0)
    R, p = _poses(4, 1)
    got = moments.transform_moments(_t(P), _t(v), _t(n), _t(R), _t(p))
    want = jax.jit(jmom.transform_moments)(
        *(jnp.asarray(a) for a in (P, v, n, R, p)))
    for g, w in zip(got, want):
        _close(g, w)
    pts_t = np.einsum("bij,bnj->bni", R, pts) + p[:, None]
    _close(got[0], np.einsum("bni,bnj->bij", pts_t, pts_t), 1e-9)
    cov = moments.cov_from_moments(_t(P), _t(v), _t(np.r_[n[:3], 0.0]))
    _close(cov, jax.jit(jmom.cov_from_moments)(
        jnp.asarray(P), jnp.asarray(v), jnp.asarray(np.r_[n[:3], 0.0])))
    _close(cov[0], np.cov(pts[0].T, bias=True), 1e-10)
    groups = [rng.normal(loc=rng.normal(size=3), size=(k, 3))
              for k in (10, 20, 5)]
    cnt = np.array([g.shape[0] for g in groups], np.float64)
    mu = np.stack([g.mean(0) for g in groups])
    Pc = np.stack([(g - g.mean(0)).T @ (g - g.mean(0)) for g in groups])
    got = moments.merge_moments(_t(Pc)[None], _t(mu)[None], _t(cnt)[None])
    want = jax.jit(jmom.merge_moments)(jnp.asarray(Pc)[None],
                                       jnp.asarray(mu)[None],
                                       jnp.asarray(cnt)[None])
    for g, w in zip(got, want):
        _close(g, w)
    allp = np.concatenate(groups)
    _close(got[2][0], (allp - allp.mean(0)).T @ (allp - allp.mean(0)), 1e-9)


def test_segments_match_jax():
    """segment_sum (ids out of range dropped, a segment's rows added in
    their order: bitwise repeatable), run_lengths and ids_from_counts."""
    rng = np.random.default_rng(7)
    data = rng.normal(size=(300, 4))
    ids = rng.integers(-2, 23, size=300)
    got = segments.segment_sum(_t(data), torch.as_tensor(ids), 20)
    want = jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids), 20)
    _close(got, want, 1e-12)
    again = segments.segment_sum(_t(data), ids, 20)
    assert torch.equal(got, again)
    keys = np.sort(rng.integers(0, 50, size=200))
    for g, w in zip(segments.run_lengths(keys), jseg.run_lengths(keys)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(segments.run_lengths(keys[:0]),
                    jseg.run_lengths(keys[:0])):
        np.testing.assert_array_equal(g, w)
    counts = segments.run_lengths(keys)[2]
    np.testing.assert_array_equal(segments.ids_from_counts(counts),
                                  jseg.ids_from_counts(counts))
