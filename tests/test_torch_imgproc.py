"""utils/imgproc (cv2's 8-bit Lab conversions, CLAHE, Gaussian blur and
x2 cubic upsample without cv2) against cv2 on the CPU, bit for bit: the
Lab conversions on all 2^24 inputs each way, the filters on random and
smooth images of sizes that fill whole tiles, vectors and kernels and
sizes that do not; preprocess_low_texture_bgr against the JAX package's
cv2 copy."""

import cv2
import numpy as np
import pytest

from global_lvba_tpu.utils import robust as jrob
from global_lvba_tpu_torch.utils import imgproc as ip
from global_lvba_tpu_torch.utils import robust

SIZES = [(1, 1), (1, 9), (9, 1), (5, 7), (16, 16), (37, 53), (64, 48),
         (100, 75), (512, 640)]


def _cube(part: int, parts: int = 4) -> np.ndarray:
    """A quarter of all 2^24 byte triples as an (N / 1024, 1024, 3)
    image."""
    n = 1 << 24
    k = np.arange(part * n // parts, (part + 1) * n // parts,
                  dtype=np.uint32)
    return np.stack([k & 255, (k >> 8) & 255, k >> 16], -1).astype(
        np.uint8).reshape(-1, 1024, 3)


def _img(h, w, kind, seed, c=None):
    rng = np.random.default_rng(seed)
    shape = (h, w) if c is None else (h, w, c)
    if kind == "random":
        return rng.integers(0, 256, shape, np.uint8)
    if kind == "flat":
        return (120 + 6 * rng.standard_normal(shape)).clip(0, 255).astype(
            np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    base = (np.sin(x / 7.0) + np.cos(y / 5.0)) * 40 + 100
    if c is not None:
        base = base[..., None] + np.arange(c) * 20
    return (base + rng.integers(0, 20, shape)).clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("part", range(4))
def test_bgr_to_lab_every_colour(part):
    img = _cube(part)
    assert np.array_equal(ip.bgr_to_lab(img),
                          cv2.cvtColor(img, cv2.COLOR_BGR2Lab))


@pytest.mark.parametrize("part", range(4))
def test_lab_to_bgr_every_triple(part):
    img = _cube(part)
    assert np.array_equal(ip.lab_to_bgr(img),
                          cv2.cvtColor(img, cv2.COLOR_Lab2BGR))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", ["random", "flat", "smooth"])
def test_clahe_equals_cv2(size, kind):
    img = _img(*size, kind, size[0] * 7 + size[1])
    want = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8)).apply(img)
    assert np.array_equal(ip.clahe(img), want)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("channels", [None, 3])
def test_gaussian_blur_equals_cv2(size, channels):
    img = _img(*size, "random", size[0] + size[1], channels)
    assert np.array_equal(ip.gaussian_blur_sigma1(img),
                          cv2.GaussianBlur(img, (0, 0), 1.0))


@pytest.mark.parametrize("size", [(1, 1), (9, 1), (5, 4), (37, 53),
                                  (64, 48), (300, 301)])
@pytest.mark.parametrize("channels", [None, 3])
def test_upsample_cubic_x2_equals_cv2(size, channels):
    """Narrow rows (fewer than 8 values: cv2's integer pass) and wide."""
    h, w = size
    img = _img(h, w, "random", h * w, channels)
    want = cv2.resize(img, (2 * w, 2 * h), interpolation=cv2.INTER_CUBIC)
    assert np.array_equal(ip.upsample_cubic_x2(img), want)


@pytest.mark.parametrize("size", [(64, 48), (37, 53), (120, 160)])
@pytest.mark.parametrize("kind", ["random", "flat", "smooth"])
@pytest.mark.parametrize("upsample", [False, True])
def test_preprocess_low_texture_matches_jax(size, kind, upsample):
    img = _img(*size, kind, sum(size), 3)
    got = robust.preprocess_low_texture_bgr(img, enable_x2_upsample=upsample)
    want = jrob.preprocess_low_texture_bgr(img, enable_x2_upsample=upsample)
    assert got.dtype == want.dtype and np.array_equal(got, want)
