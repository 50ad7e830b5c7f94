"""The colored clouds' z-buffer (kernels/colorize.py) on the CPU:
colorize_plain, and pipeline/outputs.colorize_clouds through it, bit for
bit the JAX package's colorize_clouds (the same rows in the same order)
with planted equal-depth ties, points behind and far beside the camera,
frames with no points and an image with an empty window; the exact FMA
emulation against exact rational arithmetic."""

from fractions import Fraction

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from global_lvba_tpu.geometry import camera as jcamera
from global_lvba_tpu.pipeline import outputs as jout
from global_lvba_tpu_torch.geometry.camera import CameraModel
from global_lvba_tpu_torch.kernels import colorize as ck, launch_counts
from global_lvba_tpu_torch.pipeline import outputs

CAM = CameraModel(fx=161.7, fy=161.7, cx=78.4, cy=65.3, k1=-0.076, k2=0.123,
                  p1=-0.00113, p2=0.000251, width=160, height=128)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed, F=12, M=5, ppf=3000):
    rng = np.random.default_rng(seed)
    clouds = []
    for f in range(F):
        c = rng.normal(size=(ppf, 3)) * np.array([3.0, 3.0, 1.5]) \
            + np.array([0.0, 0.0, 4.0])
        c[100:200] = c[0:100]              # duplicates: equal-depth ties
        c[200:260, 2] = -rng.uniform(0.1, 3, 60)        # behind
        c[260:280] = [[50.0, 0.0, 0.05]] * 20           # far outside
        clouds.append(c.astype(np.float32))
    clouds[4] = np.zeros((0, 3), np.float32)           # an empty frame
    lt = np.arange(F) * 0.1
    Rb = np.stack([Rotation.from_rotvec(rng.normal(size=3) * 0.02)
                   .as_matrix() for _ in range(F)])
    pb = rng.normal(size=(F, 3)) * 0.05
    it = np.concatenate([np.linspace(0.1, 1.0, M - 1), [9.0]])  # last: empty
    imgs = [rng.integers(0, 256, (CAM.height, CAM.width, 3), np.uint8)
            for _ in range(M)]
    Rcw = np.stack([Rotation.from_rotvec(rng.normal(size=3) * 0.05)
                    .as_matrix() for _ in range(M)])
    tcw = rng.normal(size=(M, 3)) * 0.1
    return (clouds, lt, Rb, pb, it, imgs, Rcw, tcw)


@pytest.mark.parametrize("seed", [0, 1])
def test_colorize_clouds_matches_jax(seed):
    args = _problem(seed)
    before = launch_counts()["colorize"]
    got = outputs.colorize_clouds(CAM, *args, device="cpu")
    assert launch_counts()["colorize"] == before
    want = jout.colorize_clouds(jcamera.CameraModel(*CAM), *args)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.shape[0] > 1000 and np.array_equal(got, want)


def test_ties_take_the_least_index():
    """Two identical points: the pick is the first, as numpy's stable
    lexsort leaves it."""
    pts = np.array([[0.0, 0.0, 5.0], [0.3, 0.1, 4.0], [0.0, 0.0, 5.0],
                    [0.3, 0.1, 4.0], [0.0, 0.0, 6.0]])
    m, v, u, p = ck.colorize_plain(torch.from_numpy(pts),
                                   torch.tensor([0]), torch.tensor([5]),
                                   np.eye(3)[None], np.zeros((1, 3)), CAM)
    assert sorted(p.tolist()) == [0, 1] and m.tolist() == [0, 0]
    lin = (v * CAM.width + u).tolist()
    assert lin == sorted(lin)


def test_fma64_is_rounded_once():
    rng = np.random.default_rng(5)
    a = rng.normal(size=4000) * 10.0 ** rng.integers(-6, 6, 4000)
    b = rng.normal(size=4000) * 10.0 ** rng.integers(-6, 6, 4000)
    c = -a * b * (1 + rng.normal(size=4000) * 1e-12)    # cancellation
    c[:1000] = rng.normal(size=1000)
    a[:10] = 0.0
    got = ck.fma64(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.array([float(Fraction(x) * Fraction(y) + Fraction(z))
                     for x, y, z in zip(a, b, c)])
    assert np.array_equal(got, want)


def test_wrapper_checks():
    with pytest.raises(ValueError, match="unsupported device"):
        ck.colorize(torch.zeros((3, 3), dtype=torch.float64, device="meta"),
                    torch.zeros(1, dtype=torch.int64),
                    torch.zeros(1, dtype=torch.int64), np.eye(3)[None],
                    np.zeros((1, 3)), CAM)


@pytest.mark.parametrize("lo,hi", [(-1, 2), (2, 4), (3, 1)])
def test_window_outside_the_points_raises(lo, hi):
    """A window [lo, hi) must lie within the points and run forwards."""
    with pytest.raises(ValueError, match="window"):
        ck.colorize(torch.zeros((3, 3), dtype=torch.float64),
                    torch.tensor([0, lo]), torch.tensor([3, hi]),
                    np.stack([np.eye(3)] * 2), np.zeros((2, 3)), CAM)


@pytest.mark.parametrize("H,W,M,blocks", [
    (512, 640, 48, 264), (60, 80, 150, 264), (2000, 2800, 3, 264),
    (512, 640, 5, 2), (1, 1, 7, 1), (96, 128, 0, 264)])
def test_slabs_cover_every_image_once(H, W, M, blocks):
    """The kernel's slab plan: slabs tile the call's pixels in order; each
    fits the L2 budget, the blocks' pixels and SLAB_IMAGES images; an
    image that fits a slab lies in exactly one, a larger one is cut into
    consecutive slabs."""
    HW = H * W
    S = ck.slab_pixels(HW, blocks)
    assert 0 < S <= min(ck.SLAB_CELLS, blocks * ck.STASH)
    assert S <= ck.SLAB_IMAGES * HW
    sl = ck.slabs(M, HW, S)
    assert [a for a, _ in sl] == list(range(0, M * HW, S))
    assert sl == [] or (sl[-1][1] == M * HW and all(
        b == a2 for (_, b), (a2, _) in zip(sl, sl[1:])))
    for m in range(M):
        holds = [k for k, (a, b) in enumerate(sl)
                 if a < (m + 1) * HW and b > m * HW]
        if HW <= S:
            assert len(holds) == 1 and S % HW == 0
        else:
            assert holds == list(range(holds[0], holds[0] + len(holds)))
            assert len(holds) >= 2


@pytest.mark.parametrize("H,W,S,blocks", [
    (12, 16, 2 * 192, 3), (12, 16, ck.STASH, 1), (100, 120, ck.STASH, 2)])
def test_compaction_order_equals_picks(H, W, S, blocks):
    """compact_plain (the kernel's compaction: slab, block, word, bit) and
    unpack_picks give _picks' rows in _picks' order, with points picked at
    several pixels, an image with no pick and images cut across slabs."""
    rng = np.random.default_rng(H + S)
    M = 5
    idx = torch.full((M, H * W), ck.NONE, dtype=torch.int32)
    hit = torch.as_tensor(rng.random((M, H * W)) < 0.3)
    idx[hit] = torch.as_tensor(rng.integers(0, 50, int(hit.sum())),
                               dtype=torch.int32)
    idx[2] = ck.NONE
    packed = ck.compact_plain(idx, S, blocks)
    assert packed.dtype == torch.int64
    for got, want in zip(ck.unpack_picks(packed, H, W), ck._picks(idx, W)):
        assert torch.equal(got, want)
