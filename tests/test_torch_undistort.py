"""The undistortion (kernels/undistort.py) on the CPU: its map bit for bit
cv2.initUndistortRectifyMap(CV_16SC2) at configs/example.yaml's camera and
on cameras with round numbers (whose exact source positions fall on
rounding ties, so every rounding of cv2's arithmetic shows), the weight
table and remap_plain bit for bit cv2.remap(INTER_LINEAR) on random maps
(every fraction, taps off every border), and undistort_plain bit for bit
the JAX package's undistort_image."""

from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml

from global_lvba_tpu.geometry import camera as jcamera
from global_lvba_tpu.pipeline import outputs as jout
from global_lvba_tpu_torch.geometry.camera import CameraModel
from global_lvba_tpu_torch.kernels import launch_counts, undistort as ud

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example_cam(scale):
    cm = yaml.safe_load((ROOT / "configs" / "example.yaml").read_text())[
        "cam_model"]
    return CameraModel(fx=cm["cam_fx"], fy=cm["cam_fy"], cx=cm["cam_cx"],
                       cy=cm["cam_cy"], k1=cm["cam_d0"], k2=cm["cam_d1"],
                       p1=cm["cam_d2"], p2=cm["cam_d3"],
                       width=cm["cam_width"], height=cm["cam_height"]
                       ).scaled(scale)


def _cv2_map(cam):
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]])
    D = np.array([cam.k1, cam.k2, cam.p1, cam.p2, 0.0])
    return cv2.initUndistortRectifyMap(K, D, np.eye(3), K,
                                       (cam.width, cam.height),
                                       cv2.CV_16SC2)


ROUND = [CameraModel(fx=100.0, fy=100.0, cx=64.0, cy=48.0, k1=-0.08,
                     k2=0.12, p1=-0.001, p2=0.0005, width=128, height=96),
         CameraModel(fx=200.0, fy=250.0, cx=80.5, cy=63.0, k1=0.05, k2=0.0,
                     p1=0.002, p2=-0.00025, width=161, height=121),
         CameraModel(fx=64.0, fy=32.0, cx=31.0, cy=24.5, k1=0.2, k2=-0.04,
                     p1=0.0, p2=0.0005, width=63, height=48)]


@pytest.mark.parametrize("cam", [_example_cam(1.0), _example_cam(0.5),
                                 _example_cam(0.125)] + ROUND)
def test_map_matches_cv2(cam):
    m1, m2 = _cv2_map(cam)
    xy, frac = ud.undistort_map(cam, cam.width, cam.height)
    assert xy.dtype == np.int16 and np.array_equal(xy, m1)
    assert np.array_equal(frac, m2.astype(np.int16))


def test_remap_on_random_maps_matches_cv2():
    """Every one of the 1,024 fractions, source pixels inside, on the
    edges and outside (the constant border's zeros)."""
    rng = np.random.default_rng(1)
    H, W = 40, 64
    img = rng.integers(0, 256, (H, W, 3), np.uint8)
    xy = np.stack([rng.integers(-3, W + 2, (H, W)),
                   rng.integers(-3, H + 2, (H, W))], -1).astype(np.int16)
    frac = np.arange(H * W, dtype=np.int64).reshape(H, W) % 1024
    frac = rng.permutation(frac.ravel()).reshape(H, W).astype(np.uint16)
    want = cv2.remap(img, xy, frac, cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    got = ud.remap_plain(torch.from_numpy(img[None]), torch.from_numpy(xy),
                         torch.from_numpy(frac.astype(np.int16)))
    assert np.array_equal(got[0].numpy(), want)
    tab = ud.remap_weights()
    assert tab.shape == (1024, 4) and (tab.sum(axis=1) == 1 << 15).all()


@pytest.mark.parametrize("scale", [0.125, 0.25])
def test_undistort_plain_matches_jax(scale):
    cam = _example_cam(scale)
    jcam = jcamera.CameraModel(*cam)
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (3, cam.height, cam.width, 3), np.uint8)
    before = launch_counts()["undistort"]
    got = ud.undistort(torch.from_numpy(imgs), cam).numpy()
    assert launch_counts()["undistort"] == before
    for k in range(3):
        assert np.array_equal(got[k], jout.undistort_image(jcam, imgs[k]))


@pytest.mark.parametrize("cam", ROUND[:2])
def test_undistort_plain_on_round_cameras_matches_jax(cam):
    img = np.random.default_rng(3).integers(0, 256,
                                            (cam.height, cam.width, 3),
                                            np.uint8)
    got = ud.undistort_plain(torch.from_numpy(img[None]), cam)[0].numpy()
    assert np.array_equal(got, jout.undistort_image(
        jcamera.CameraModel(*cam), img))


def test_wrapper_checks_and_bytes():
    cam = ROUND[0]
    with pytest.raises(ValueError, match="unsupported device"):
        ud.undistort(torch.zeros((1, 96, 128, 3), dtype=torch.uint8,
                                 device="meta"), cam)
    assert ud.undistort_bytes(2, 96, 128) == 2 * 2 * 96 * 128 * 3 \
        + 96 * 128 * 6 + 1024 * 16
