"""Tests of the port's CUDA kernels that need a card (marked `cuda`; they
skip without one).  No JAX here: the card's machine has none.

    python -m pytest tests/test_torch_cuda.py -q

The z-buffer (csrc/zbuffer.cu) bit for bit its plain version, twice, on
seeded points and ranges (empty ranges and an image with none
included); the undistortion (csrc/undistort.cu) bit for bit its plain
version on the card and on the CPU on both routes (TMA boxes, global
taps), with tiles over the box cap, at the example configuration's
camera, a strongly distorted one and on random maps; the colorization's
z-buffer (csrc/colorize.cu) bit for bit its plain version with planted equal-depth ties, an empty
window and points behind the camera, on images cut into slabs and on a
slab of many small images, and a window outside the points raising from
the kernel's status; the z-buffer's cull equal to its plain mirror.  A
CPU tensor takes the plain version and counts no launch."""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from global_lvba_tpu_torch.config import LvbaConfig
from global_lvba_tpu_torch.geometry.camera import CameraModel
from global_lvba_tpu_torch.kernels import (
    colorize as ck, launch_counts, undistort as ud, zbuffer as zb)

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


@pytest.mark.cuda
def test_zbuffer_kernel_culls_as_its_mirror(card):
    """Points around the camera (half behind it) in voxel-like ranges,
    some longer than a piece: the maps bitwise the plain version's, and
    the kernel's kept (piece, image) pairs and their points equal the
    cull's plain mirror (cull_pairs), which removes some."""
    cam = CameraModel(**CAM)
    rng = np.random.default_rng(9)
    n = 400_000
    pts = rng.uniform(-10, 10, size=(n, 3)).astype(np.float32)
    order = np.lexsort((pts[:, 2], (pts[:, 0] // 2.5) * 8
                        + pts[:, 1] // 2.5))
    pts = np.ascontiguousarray(pts[order])
    cuts = np.unique(np.concatenate([[0], rng.integers(1, n, 150), [n]]))
    starts = cuts[:-1].astype(np.int64)
    counts = np.diff(cuts).astype(np.int32)
    keep = [np.flatnonzero(rng.random(starts.shape[0]) < f)
            for f in (0.9, 0.5, 0.0, 1.0)]
    offsets = np.concatenate([[0], np.cumsum([k.size for k in keep])])
    sel = np.concatenate(keep)
    R = np.stack([Rotation.from_rotvec([0.3 * i, 0.1, -0.2 * i]).as_matrix()
                  for i in range(4)])
    t = rng.normal(size=(4, 3))
    host = (pts, starts[sel], counts[sel], offsets, R, t)
    args = [torch.as_tensor(a).to(card) for a in host]
    stats = torch.zeros(2, dtype=torch.int64, device=card)
    a = zb.zbuffer(*args, cam, stats=stats)
    ref = zb.zbuffer_plain(*args, cam)
    torch.cuda.synchronize()
    assert torch.equal(a, ref) and (a > 0).sum() > 1000
    pc = zb.range_pieces(zb.transpose_ranges(*args[1:4]))
    piece, _, kept = zb.cull_pairs(args[0], pc, args[4], args[5])
    assert 0 < int(kept.sum()) < kept.numel()
    assert stats.tolist() == [int(kept.sum()), int(
        pc.count.long()[piece[kept]].sum())]
    assert int(pc.count.max()) == zb.PIECE


def _example_cam():
    """configs/example.yaml's camera (the config's defaults)."""
    cm = LvbaConfig().cam_model
    return CameraModel(fx=cm.cam_fx, fy=cm.cam_fy, cx=cm.cam_cx, cy=cm.cam_cy,
                       k1=cm.cam_d0, k2=cm.cam_d1, p1=cm.cam_d2, p2=cm.cam_d3,
                       width=cm.cam_width, height=cm.cam_height)


def _random_map(seed, H, W):
    """A map near the identity (taps off every border), every fraction,
    and three tiles with one tap anywhere (boxes over the cap)."""
    rng = np.random.default_rng(seed)
    jj, ii = np.meshgrid(np.arange(W), np.arange(H))
    x = jj + rng.integers(-2, 3, (H, W))
    y = ii + rng.integers(-2, 3, (H, W))
    ty, tx = -(-H // ud.TILE_H), -(-W // ud.TILE_W)
    for t in rng.choice(ty * tx, 3, replace=False):
        i = (t // tx) * ud.TILE_H + rng.integers(0, min(ud.TILE_H, H))
        j = (t % tx) * ud.TILE_W + rng.integers(0, min(ud.TILE_W, W))
        i, j = min(i, H - 1), min(j, W - 1)
        x[i, j] = W + 1 if x[i, j] < W // 2 else -3
        y[i, j] = H + 1 if y[i, j] < H // 2 else -3
    xy = np.stack([x, y], -1).astype(np.int16)
    frac = rng.permutation(np.arange(H * W) % 1024).reshape(H, W)
    return xy, frac.astype(np.int16)


# (camera or random map (seed, H, W), images, route, tiles over the cap,
# the stack's first byte past a 16-byte boundary)
UNDISTORT_CASES = {
    "example-0.5": (_example_cam().scaled(0.5), 5, "tma", False, 0),
    "odd": (_example_cam().scaled(0.25)._replace(
        width=321, height=241, cx=160.2, cy=120.7), 3, "global", False, 0),
    "strong": (_example_cam().scaled(0.5)._replace(k1=-0.4), 4, "tma", True,
               0),
    "strong-odd": (_example_cam().scaled(0.25)._replace(
        k1=-0.4, width=333, height=257), 4, "global", True, 0),
    "one-image": (_example_cam().scaled(0.5), 1, "tma", False, 0),
    "13-images": (_example_cam().scaled(0.5), 13, "tma", False, 0),
    "unaligned-base": (_example_cam().scaled(0.5), 3, "global", False, 1),
    "random-16": ((5, 24, 272), 6, "tma", True, 0),
    "random-odd": ((4, 45, 301), 6, "global", True, 3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(UNDISTORT_CASES))
def test_undistort_kernel_matches_plain(card, case):
    """Each route (TMA for W % 16 == 0 on a 16-byte aligned stack, global
    taps otherwise: an odd width, a stack one byte past the boundary),
    with and without tiles over the box cap, one image and an image count
    that the blocks' runs do not divide: bitwise the plain version, twice,
    one launch a call; a CPU tensor takes the plain version."""
    src, n, route, over_cap, offset = UNDISTORT_CASES[case]
    if isinstance(src, CameraModel):
        H, W = src.height, src.width
        plan = ud.undistort_plan(src, W, H, card)
        run = lambda x: ud.undistort(x, src)
        plain = lambda x: ud.undistort_plain(x, src)
    else:
        _, H, W = src
        xy, frac = _random_map(*src)
        plan = ud.remap_plan(xy, frac, card)
        run = lambda x: (ud.remap(x, plan) if x.is_cuda else ud.remap_plain(
            x, torch.from_numpy(xy), torch.from_numpy(frac)))
        plain = lambda x: ud.remap_plain(x, *(torch.as_tensor(a).to(x.device)
                                              for a in (xy, frac)))
    assert (plan.staged < plan.tiles.shape[0]) == over_cap
    rng = np.random.default_rng(11)
    host = rng.integers(0, 256, (n, H, W, 3), np.uint8)
    buf = torch.empty(host.size + 16, dtype=torch.uint8, device=card)
    lead = (offset - buf.data_ptr()) % 16
    imgs = buf[lead:lead + host.size].view(host.shape)
    imgs.copy_(torch.as_tensor(host))
    assert imgs.data_ptr() % 16 == offset
    assert ud.staging_route(imgs) == route
    before = launch_counts()["undistort"]
    a = run(imgs)
    assert launch_counts()["undistort"] == before + 1
    b = run(imgs)
    ref = plain(imgs)
    torch.cuda.synchronize()
    assert launch_counts()["undistort"] == before + 2
    assert torch.equal(a, b) and torch.equal(a, ref)
    cpu = run(torch.as_tensor(host))
    assert launch_counts()["undistort"] == before + 2
    assert torch.equal(cpu, a.cpu())


@pytest.mark.cuda
def test_colorize_kernel_matches_plain(card):
    cam = CameraModel(**CAM)
    rng = np.random.default_rng(12)
    n = 200_000
    pts = rng.uniform(-6, 6, size=(n, 3))
    pts[:, 2] = rng.uniform(-3, 25, size=n)
    pts[1000:3000] = pts[:2000]          # equal depths at a pixel: ties
    lo = np.array([0, 50_000, 120_000, 7], np.int64)
    hi = np.array([60_000, 50_000, n, 190_000], np.int64)
    R = np.stack([Rotation.from_rotvec([0.02 * i, -0.05, 0.01]).as_matrix()
                  for i in range(4)])
    t = np.stack([[0.05 * i, 0.1, -0.3] for i in range(4)])
    args = [torch.as_tensor(a).to(card) for a in (pts, lo, hi)]
    before = launch_counts()["colorize"]
    a = ck.colorize(*args, R, t, cam)
    b = ck.colorize(*args, R, t, cam)
    ref = ck.colorize_plain(*args, R, t, cam)
    torch.cuda.synchronize()
    assert launch_counts()["colorize"] == before + 2
    for x, y, z in zip(a, b, ref):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert a[0].numel() > 1000 and not (a[0] == 1).any()
    cpu = ck.colorize(*[torch.as_tensor(x) for x in (pts, lo, hi)], R, t,
                      cam)
    assert launch_counts()["colorize"] == before + 2
    for x, y in zip(cpu, a):
        assert torch.equal(x, y.cpu())


@pytest.mark.cuda
def test_colorize_kernel_slabs_and_windows(card):
    """Images larger than a slab (cut mid-image) and many small images
    (a slab of SLAB_IMAGES) bitwise the plain version; a window outside
    the points raises the plain version's ValueError from the kernel's
    status, and the next call is right again (the cells left empty)."""
    rng = np.random.default_rng(21)
    n = 150_000
    pts = rng.uniform(-6, 6, size=(n, 3))
    pts[:, 2] = rng.uniform(0.5, 25, size=n)
    pts[5000:9000] = pts[:4000]
    for cam, M in ((CameraModel(fx=900.0, fy=900.0, cx=1400.0, cy=1000.0,
                                k1=-0.05, k2=0.08, p1=-0.001, p2=0.0005,
                                width=2800, height=2000), 3),
                   (CameraModel(fx=60.0, fy=60.0, cx=40.0, cy=30.0,
                                k1=-0.05, k2=0.08, p1=-0.001, p2=0.0005,
                                width=80, height=60), 150)):
        lo = np.sort(rng.integers(0, n, M)).astype(np.int64)
        hi = np.minimum(lo + rng.integers(0, 60_000, M), n).astype(np.int64)
        R = np.stack([Rotation.from_rotvec(rng.normal(size=3) * 0.1)
                      .as_matrix() for _ in range(M)])
        t = rng.normal(size=(M, 3)) * 0.1
        args = [torch.as_tensor(a).to(card) for a in (pts, lo, hi)]
        a = ck.colorize(*args, R, t, cam)
        ref = ck.colorize_plain(*args, R, t, cam)
        for x, y in zip(a, ref):
            assert torch.equal(x, y)
        assert a[0].numel() > 1000
        bad = hi.copy()
        bad[M // 2] = n + 1
        with pytest.raises(ValueError, match="window"):
            ck.colorize(args[0], args[1], torch.as_tensor(bad).to(card), R,
                        t, cam)
        again = ck.colorize(*args, R, t, cam)
        for x, y in zip(again, ref):
            assert torch.equal(x, y)
