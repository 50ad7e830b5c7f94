"""SIFT extraction of the PyTorch port against the JAX package, in float64
on the CPU (the suite's x64 setting: the JAX extractor runs in float64
with its float32 blur constants, which the port casts the same way)."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.ndimage as ndi
import torch
from scipy.spatial.transform import Rotation

from global_lvba_tpu.frontend import sift as js
from global_lvba_tpu_torch.frontend import sift as ps
from global_lvba_tpu_torch.geometry.camera import CameraModel
from global_lvba_tpu_torch.models.synthetic import (
    make_plane_scene, render_textured_views)

PARAMS = dict(max_kp=256, n_octaves=3)
H, W = 128, 160


def textured_image(h=400, w=500, seed=0, sigma=3.0):
    rng = np.random.default_rng(seed)
    img = ndi.gaussian_filter(rng.uniform(size=(h, w)).astype(np.float32),
                              sigma)
    return (img - img.min()) / (img.max() - img.min())


def _render():
    cam = CameraModel(fx=161.7, fy=161.7, cx=78.4, cy=65.3, k1=-0.076,
                      k2=0.123, p1=-0.00113, p2=0.000251, width=W, height=H)
    scene = make_plane_scene(num_frames=2, points_per_frame=60, seed=9)
    R0 = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    dR = Rotation.from_rotvec([0.0, 0.0, 0.3]).as_matrix()
    return render_textured_views(scene, cam, (R0 @ dR.T)[None],
                                 (-(R0 @ dR.T) @ [-0.5, 0.2, 0.0])[None])[0]


@pytest.fixture(scope="module")
def images():
    return {"textured": textured_image(H, W, seed=0).astype(np.float64),
            "render": _render().astype(np.float64)}


@pytest.fixture(scope="module")
def jax_features(images):
    p = js.SiftParams(**PARAMS)
    return {k: {f: np.asarray(x) for f, x in
                js.extract_sift(jnp.asarray(im), p)._asdict().items()}
            for k, im in images.items()}


@pytest.mark.parametrize("which", ["textured", "render"])
def test_extract_sift_matches_jax_float64(images, jax_features, which):
    got = ps.extract_sift(images[which], ps.SiftParams(**PARAMS),
                          device="cpu")
    want = jax_features[which]
    assert want["xy"].dtype == np.float64 and got.xy.dtype == torch.float64
    v = got.valid.numpy()
    np.testing.assert_array_equal(v, want["valid"])
    assert v.sum() > 50
    for name, tol in (("xy", 1e-8), ("desc", 1e-8), ("sigma", 1e-8),
                      ("response", 1e-12), ("orientation", 1e-8)):
        np.testing.assert_allclose(getattr(got, name).numpy()[v],
                                   want[name][v], rtol=0, atol=tol,
                                   err_msg=name)
    np.testing.assert_allclose(np.linalg.norm(got.desc.numpy()[v], axis=1),
                               1.0, atol=1e-6)


def test_blank_image_no_keypoints():
    img = np.full((H, W), 0.5, dtype=np.float32)
    f = ps.extract_sift(img, ps.SiftParams(**PARAMS), device="cpu")
    assert f.valid.shape == (256,) and f.desc.shape == (256, 128)
    assert int(f.valid.sum()) == 0


def test_batched_equals_per_image(images):
    p = ps.SiftParams(**PARAMS)
    stack = np.stack([images["textured"], images["render"]]).astype(np.float32)
    fb = ps.extract_sift_batch(stack, p, device="cpu")
    assert fb.xy.shape == (2, 256, 2) and fb.xy.dtype == torch.float32
    for b in range(2):
        f1 = ps.extract_sift(stack[b], p, device="cpu")
        assert torch.equal(fb.valid[b], f1.valid)
        v = f1.valid
        for name in ("xy", "sigma", "response", "orientation", "desc"):
            a, c = getattr(fb, name)[b][v], getattr(f1, name)[v]
            # the batched blur is one matmul over the batch: float32 sums
            # may round differently from the single-image call
            torch.testing.assert_close(a, c, rtol=0, atol=1e-5)


def test_from_jax_features_carries_the_leaves(jax_features):
    leaves = jax_features["textured"]
    f = ps.from_jax_features(**leaves, device="cpu", dtype=torch.float64)
    assert isinstance(f, ps.SiftFeatures)
    assert f.valid.dtype == torch.bool and f.desc.dtype == torch.float64
    np.testing.assert_array_equal(f.valid.numpy(), leaves["valid"])
    np.testing.assert_array_equal(f.desc.numpy(), leaves["desc"])
