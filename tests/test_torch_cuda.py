"""Tests of the port's CUDA kernels that need a card (marked `cuda`; they
skip without one).  No JAX here: the card's machine has none.

    python -m pytest tests/test_torch_cuda.py -q

The z-buffer (csrc/zbuffer.cu) bit for bit its plain version, twice, on
seeded points and ranges (empty ranges and an image with none
included); a CPU tensor takes the plain version and counts no launch."""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from global_lvba_tpu_torch.geometry.camera import CameraModel
from global_lvba_tpu_torch.kernels import launch_counts, zbuffer as zb

CAM = dict(fx=400.0, fy=410.0, cx=320.0, cy=240.0, k1=-0.05, k2=0.08,
           p1=-0.001, p2=0.0005, width=640, height=480)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (csrc/zbuffer.cu)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_zbuffer_kernel_matches_plain(card):
    cam = CameraModel(**CAM)
    rng = np.random.default_rng(7)
    n = 300_000
    pts = rng.uniform(-8, 8, size=(n, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-2, 20, size=n)
    starts = np.sort(rng.integers(0, n - 1000, size=300)).astype(np.int64)
    counts = rng.integers(0, 1000, size=300).astype(np.int32)
    counts[::7] = 0
    R = np.stack([Rotation.from_rotvec([0.05 - 0.02 * i, -0.1, 0.02 * i])
                  .as_matrix() for i in range(3)])
    t = np.stack([[0.1 * i, -0.2, 0.5] for i in range(3)])
    host = (pts, starts, counts, np.array([0, 100, 100, 300]), R, t)
    args = [torch.as_tensor(a).to(card) for a in host]
    before = launch_counts()["zbuffer"]
    a = zb.zbuffer(*args, cam)
    b = zb.zbuffer(*args, cam)
    ref = zb.zbuffer_plain(*args, cam)
    torch.cuda.synchronize()
    assert launch_counts()["zbuffer"] == before + 2
    assert torch.equal(a, b) and torch.equal(a, ref)
    assert not a[1].any() and (a[0] > 0).sum() > 1000
    cpu = zb.zbuffer(*[torch.as_tensor(x) for x in host], cam)
    assert launch_counts()["zbuffer"] == before + 2
    assert torch.equal(cpu, ref.cpu())
