"""SO(3)/SE(3) of the PyTorch port against the JAX package (float64, CPU):
the same seeded inputs through both, agreement at 1e-12."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from global_lvba_tpu.geometry import se3 as jse3, so3 as jso3
from global_lvba_tpu_torch.geometry import se3, so3


def _w(kind):
    rng = np.random.default_rng(0)
    if kind == "zero":
        return np.zeros((4, 3))
    if kind == "small":
        return rng.normal(scale=1e-5, size=(16, 3))
    if kind == "near_pi":
        a = rng.normal(size=(8, 3))
        a /= np.linalg.norm(a, axis=1, keepdims=True)
        return a * (np.pi - 1e-4)
    return rng.normal(scale=0.8, size=(32, 3))


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


@pytest.mark.parametrize("kind", ["zero", "small", "generic", "near_pi"])
def test_exp_log_match_jax(kind):
    w = _w(kind)
    R = so3.exp_so3(_t(w))
    np.testing.assert_allclose(R.numpy(), np.asarray(jso3.exp_so3(jnp.asarray(w))),
                               rtol=0, atol=1e-12)
    back = so3.log_so3(R)
    ref = np.asarray(jso3.log_so3(jnp.asarray(R.numpy())))
    np.testing.assert_allclose(back.numpy(), ref, rtol=0, atol=1e-9)
    np.testing.assert_allclose(back.numpy(), w, rtol=0, atol=1e-6)


def test_hat_matches_jax_and_cross():
    v = _w("generic")
    x = np.random.default_rng(1).normal(size=v.shape)
    H = so3.hat(_t(v))
    np.testing.assert_array_equal(H.numpy(), np.asarray(jso3.hat(jnp.asarray(v))))
    np.testing.assert_allclose(np.einsum("nij,nj->ni", H.numpy(), x),
                               np.cross(v, x), atol=1e-14)


def test_exp_grad_nan_free_at_zero():
    w = torch.zeros(3, dtype=torch.float64, requires_grad=True)
    so3.exp_so3(w).sum().backward()
    assert torch.isfinite(w.grad).all()


def test_boxplus_matches_jax():
    rng = np.random.default_rng(2)
    R = np.asarray(jso3.exp_so3(jnp.asarray(rng.normal(size=(10, 3)))))
    p = rng.normal(size=(10, 3))
    dx = rng.normal(scale=0.01, size=(10, 6))
    Rj, pj = jse3.boxplus_pose(jnp.asarray(R), jnp.asarray(p), jnp.asarray(dx))
    Rt, pt = se3.boxplus_pose(_t(R), _t(p), _t(dx))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-15)
