"""Camera model and textured renders of the PyTorch port against the JAX
package (float64, CPU): the same seeded inputs through both."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from global_lvba_tpu.geometry import camera as jcam
from global_lvba_tpu.models import synthetic as jsyn
from global_lvba_tpu_torch.geometry import camera as cam
from global_lvba_tpu_torch.models import synthetic as syn

PARAMS = dict(fx=646.78472, fy=646.65775, cx=313.456795, cy=261.399612,
              k1=-0.076160, k2=0.123001, p1=-0.00113, p2=0.000251,
              width=640, height=512)
CAM = cam.CameraModel(**PARAMS)
JCAM = jcam.CameraModel(**PARAMS)


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def _inputs():
    rng = np.random.default_rng(0)
    Xc = np.concatenate([rng.uniform(-2, 2, (64, 2)),
                         rng.uniform(0.5, 6, (64, 1))], axis=1)
    Xc[:4, 2] = [0.0, -1.0, 1e-13, 2.0]          # behind / on the plane
    uv = rng.uniform([-5, -5], [645, 517], (64, 2))
    depth = rng.uniform(-0.5, 6.0, 64)
    R = Rotation.from_rotvec(rng.normal(scale=0.5, size=(64, 3))).as_matrix()
    t = rng.normal(size=(64, 3))
    img = rng.uniform(0.1, 5.0, (40, 50))
    img[10:14, 20:30] = 0.0                      # holes invalidate samples
    uvd = rng.uniform([-2, -2], [52, 42], (64, 2))
    return dict(Xc=Xc, uv=uv, depth=depth, R=R, t=t, img=img, uvd=uvd)


def _case(name, x, port):
    if name == "distort":
        xy = x["Xc"][:, :2] / 3.0
        return (cam.distort_normalized(CAM, _t(xy)),) if port else \
            (jcam.distort_normalized(JCAM, jnp.asarray(xy)),)
    if name == "project_cam":
        return cam.project_cam_to_pixel(CAM, _t(x["Xc"])) if port else \
            jcam.project_cam_to_pixel(JCAM, jnp.asarray(x["Xc"]))
    if name == "project_world":
        args = (x["R"], x["t"], x["Xc"])
        return cam.project_world_to_pixel(CAM, *map(_t, args)) if port else \
            jcam.project_world_to_pixel(JCAM, *map(jnp.asarray, args))
    if name == "undistort":
        return cam.undistort_pixel_to_normalized(CAM, _t(x["uv"])) if port \
            else jcam.undistort_pixel_to_normalized(JCAM, jnp.asarray(x["uv"]))
    if name == "back_project":
        return cam.back_project_pixel_depth(CAM, _t(x["uv"]), _t(x["depth"])) \
            if port else jcam.back_project_pixel_depth(
                JCAM, jnp.asarray(x["uv"]), jnp.asarray(x["depth"]))
    if name == "cam_to_world":
        args = (x["Xc"], x["R"], x["t"])
        return (cam.cam_to_world(*map(_t, args)),) if port else \
            (jcam.cam_to_world(*map(jnp.asarray, args)),)
    if name == "fetch_depth":
        return cam.fetch_depth_bilinear(_t(x["img"]), _t(x["uvd"])) if port \
            else jcam.fetch_depth_bilinear(jnp.asarray(x["img"]),
                                           jnp.asarray(x["uvd"]))
    raise KeyError(name)


@pytest.mark.parametrize("name", ["distort", "project_cam", "project_world",
                                  "undistort", "back_project", "cam_to_world",
                                  "fetch_depth"])
def test_camera_function_matches_jax(name):
    x = _inputs()
    got = _case(name, x, port=True)
    want = _case(name, x, port=False)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w)
        else:
            # relative too: points near z = 0 project to ~1e7 px
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


def test_scaled_matches_jax():
    assert tuple(CAM.scaled(0.5)) == tuple(JCAM.scaled(0.5))
    assert CAM.scaled(0.5).width == 320


def test_render_matches_jax():
    """render_textured_views at 160 x 128 with depth: image and depth
    within 1e-6 (float32 outputs of the same float64 ray cast)."""
    small = CAM.scaled(0.25)
    scene = syn.make_plane_scene(num_frames=2, points_per_frame=60, seed=9)
    R0 = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    dR = Rotation.from_rotvec([0.0, 0.05, 0.1]).as_matrix()
    Rcw = np.stack([R0, dR @ R0])
    tcw = np.stack([-R0 @ [-1.0, 0.0, 0.0], -(dR @ R0) @ [-0.8, 0.3, 0.1]])
    img, dep = syn.render_textured_views(scene, small, Rcw, tcw,
                                         return_depth=True)
    jimg, jdep = jsyn.render_textured_views(
        scene, jcam.CameraModel(*small), Rcw, tcw, return_depth=True)
    assert img.shape == (2, 128, 160) and img.dtype == np.float32
    np.testing.assert_allclose(img, jimg, rtol=0, atol=1e-6)
    np.testing.assert_allclose(dep, jdep, rtol=0, atol=1e-6)
    assert (dep > 0).mean() > 0.99 and img.std() > 0.05
