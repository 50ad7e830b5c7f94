"""Closed-form SoA eigensolve of the PyTorch port against the JAX package
(float64, CPU), including the degenerate and zero cases of
tests/test_eigh3.py — the branch choices must be the same."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from global_lvba_tpu.ops import eigh3 as jeig
from global_lvba_tpu_torch.ops import eigh3


def _mats(kind):
    rng = np.random.default_rng(3)
    if kind == "random":
        X = rng.normal(size=(64, 3, 3))
        return X + np.swapaxes(X, 1, 2)
    if kind == "planar":
        mats = []
        for _ in range(32):
            Q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
            d = [2.5e-5 * rng.uniform(0.5, 2), rng.uniform(0.06, 0.09),
                 rng.uniform(0.07, 0.1)]
            mats.append(Q @ np.diag(d) @ Q.T)
        return np.stack(mats)
    if kind == "degenerate_pair":
        Q = np.linalg.qr(np.random.default_rng(4).normal(size=(3, 3)))[0]
        return (Q @ np.diag([1.0, 1.0, 3.0]) @ Q.T)[None]
    return np.stack([np.eye(3), np.zeros((3, 3))])      # identity and zero


def _six(A):
    return (A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
            A[..., 1, 1], A[..., 1, 2], A[..., 2, 2])


@pytest.mark.parametrize("kind", ["random", "planar", "degenerate_pair",
                                  "identity_zero"])
def test_eigh3_soa_matches_jax(kind):
    A = _mats(kind)
    got = eigh3.eigh3_soa(*_six(torch.as_tensor(A)))
    ref = jeig.eigh3_soa(*_six(jnp.asarray(A)))
    for i in range(3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                   rtol=1e-12, atol=1e-14)
    for i in range(3, 6):
        for c in range(3):
            np.testing.assert_allclose(got[i][c].numpy(),
                                       np.asarray(ref[i][c]), atol=1e-10)
        assert all(torch.isfinite(x).all() for x in got[i])


@pytest.mark.parametrize("kind", ["random", "planar", "identity_zero"])
def test_eigvals3_soa_matches_jax_and_numpy(kind):
    A = _mats(kind)
    got = torch.stack(eigh3.eigvals3_soa(*_six(torch.as_tensor(A))), -1)
    ref = np.stack([np.asarray(x) for x in
                    jeig.eigvals3_soa(*_six(jnp.asarray(A)))], -1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got.numpy(), np.linalg.eigvalsh(A), atol=1e-9)


def test_degenerate_pair_vectors_are_eigenvectors():
    A = _mats("degenerate_pair")
    lam0, lam1, lam2, v0, v1, v2 = eigh3.eigh3_soa(*_six(torch.as_tensor(A)))
    U = torch.stack([torch.stack(v, -1) for v in (v0, v1, v2)], -1)[0].numpy()
    lams = np.array([float(lam0[0]), float(lam1[0]), float(lam2[0])])
    np.testing.assert_allclose(lams, [1.0, 1.0, 3.0], atol=1e-9)
    assert np.max(np.abs(A[0] @ U - U * lams[None, :])) < 1e-7
    np.testing.assert_allclose(U.T @ U, np.eye(3), atol=1e-12)
