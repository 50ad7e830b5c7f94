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
from test_torch_cuda import _random_map  # noqa: E402

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


# ---- the kernel's tile plan and a mirror of its staged read ----

def _strong_cam():
    """The example camera at scale 0.5 with k1 = -0.4: its corner tiles'
    taps spread past the cap and take the global path."""
    return _example_cam(0.5)._replace(k1=-0.4)


def _cam_map(cam):
    return ud.undistort_map(cam, cam.width, cam.height)


PLAN_MAPS = {
    "example-1": lambda: _cam_map(_example_cam(1.0)),
    "example-0.5": lambda: _cam_map(_example_cam(0.5)),
    "round-0": lambda: _cam_map(ROUND[0]),
    "round-1": lambda: _cam_map(ROUND[1]),
    "round-2": lambda: _cam_map(ROUND[2]),
    "strong": lambda: _cam_map(_strong_cam()),
    "random-odd": lambda: _random_map(4, 45, 301),
    "random-16": lambda: _random_map(5, 24, 272),
}


def _unpack(plan):
    p = plan.xy.numpy().view(np.uint32).astype(np.int64)
    x0 = (p & 0xFFFF).astype(np.uint16).view(np.int16).astype(np.int64)
    y0 = (p >> 16).astype(np.uint16).view(np.int16).astype(np.int64)
    return x0, y0


def _inside(plan):
    H, W = plan.height, plan.width
    return ud._by_tile(np.ones((H, W)), H, W, 0).astype(bool)


@pytest.mark.parametrize("name", list(PLAN_MAPS))
def test_tile_plan_boxes_hold_every_tap(name):
    """Every tap of a staged tile lies in its box (the whole box shape of
    the launch, within the cap); a tile is global exactly where its taps
    need more than the cap; the map laid out tile by tile is the map."""
    xy, frac = PLAN_MAPS[name]()
    plan = ud.remap_plan(xy, frac)
    H, W = frac.shape
    start, row, staged = (plan.tiles[:, k].numpy().astype(np.int64)
                          for k in range(3))
    assert plan.pitch % 16 == 0 and 16 <= plan.pitch <= ud.MAX_PITCH
    assert 1 <= plan.rows <= ud.MAX_ROWS and (start % 16 == 0).all()
    assert plan.staged == int(staged.sum())
    x0, y0 = _unpack(plan)
    inside = _inside(plan)
    assert np.array_equal(x0[inside], ud._by_tile(xy[..., 0], H, W, 0)[inside])
    assert np.array_equal(y0[inside], ud._by_tile(xy[..., 1], H, W, 0)[inside])
    assert np.array_equal(plan.frac.numpy()[inside],
                          ud._by_tile(frac, H, W, 0)[inside])
    b = (x0 * 3 - start[:, None, None], y0 - row[:, None, None])
    held = ((b[0] >= 0) & (b[0] + 6 <= plan.pitch) & (b[1] >= 0)
            & (b[1] + 2 <= plan.rows)).all(axis=(1, 2))
    assert (held[staged == 1]).all()
    # the cap: each tile's own box, as small as its taps allow
    xs = ud._by_tile(xy[..., 0].astype(np.int64), H, W, 0)
    lo_x = np.where(inside, xs, 1 << 20).min(axis=(1, 2))
    hi_x = np.where(inside, xs, -(1 << 20)).max(axis=(1, 2))
    ys = ud._by_tile(xy[..., 1].astype(np.int64), H, W, 0)
    lo_y = np.where(inside, ys, 1 << 20).min(axis=(1, 2))
    hi_y = np.where(inside, ys, -(1 << 20)).max(axis=(1, 2))
    need = -(-((hi_x + 2) * 3 - (lo_x * 3) // 16 * 16) // 16) * 16
    over = (need > ud.MAX_PITCH) | (hi_y + 2 - lo_y > ud.MAX_ROWS)
    assert np.array_equal(staged == 0, over)
    if name in ("strong", "random-odd", "random-16"):
        assert 0 < plan.staged < staged.size
    else:
        assert plan.staged == staged.size


def _funnelshift_r(lo, hi, s):
    return ((hi << 32 | lo) >> (s & 31)) & 0xFFFFFFFF


def _byte_perm(x, y, sel):
    b = y << 32 | x
    out = np.zeros_like(x)
    for n in range(4):
        k = (sel >> (4 * n)) & 7
        out |= ((b >> (8 * k)) & 0xFF) << (8 * n)
    return out


def _dp2a(a, b, c, hi):
    s = 16 if hi else 0
    return (c + (a & 0xFFFF) * ((b >> s) & 0xFF)
            + (a >> 16) * ((b >> (s + 8)) & 0xFF))


def _le_words(mem, q):
    """Little-endian 4-byte words mem[4q:4q + 4] of a byte array."""
    return sum(mem[4 * q + k] << (8 * k) for k in range(4))


def _emulate(images, plan, route="tma", base=0, pad_byte=0xAB):
    """The kernel's arithmetic in numpy on its route: on "tma" each staged
    tile's box gathered with a zero fill (and the slot's 16 spare bytes
    set to `pad_byte`), a pixel's taps read as three 4-byte words a row;
    on "global" (every tile) and for the tiles over the cap, a pixel
    whose taps lie in the image reads the aligned words of the stack laid
    out from byte `base` (the bytes around it `pad_byte`; the third word
    only where the row starts at a word's last byte), a border pixel each
    tap checked against the image.  No pixel may use a byte other than
    its taps'.  Then funnel shifts, byte permutes and dp2a pairs."""
    N, H, W = images.shape[:3]
    P, R = plan.pitch, plan.rows
    start, row, staged = (plan.tiles[:, k].numpy().astype(np.int64)
                          for k in range(3))
    T = start.size
    x0, y0 = (a.reshape(T, -1) for a in _unpack(plan))
    st = np.broadcast_to((staged == 1)[:, None] & (route == "tma"), x0.shape)
    wtab = plan.wtab.numpy().view(np.uint32).astype(np.int64)
    w = wtab[plan.frac.numpy().astype(np.int64).reshape(T, -1) & 1023]
    # staged tiles: the box's words
    flat = images.reshape(N, H, W * 3).astype(np.int64)
    gy = row[:, None] + np.arange(R)
    gb = start[:, None] + np.arange(P)
    ok = (((gy >= 0) & (gy < H))[:, :, None]
          & ((gb >= 0) & (gb < W * 3))[:, None, :])
    box = flat[:, gy.clip(0, H - 1)[:, :, None], gb.clip(0, W * 3 - 1)[
        :, None, :]]
    box = np.where(ok, box, 0).reshape(N, T, R * P)
    box = np.concatenate([box, np.full((N, T, 16), pad_byte)], axis=2)
    words = box.reshape(N, T, -1, 4) @ (1 << (8 * np.arange(4)))
    o = np.where(st, (y0 - row[:, None]) * P + x0 * 3 - start[:, None], 0)

    def word(k):
        return np.take_along_axis(words, np.broadcast_to(
            (o >> 2)[None] + k, (N,) + o.shape), axis=2)

    # global taps by words: the stack in memory from byte `base`
    inner = ~st & (x0 >= 0) & (x0 < W - 1) & (y0 >= 0) & (y0 < H - 1)
    mem = np.full(base + images.size + 16, pad_byte, np.int64)
    mem[base:base + images.size] = images.reshape(-1)
    addr = np.where(inner[None], base + np.arange(N)[:, None, None] * H * W
                    * 3 + (y0 * W + x0)[None] * 3, base)
    rows_ = []
    for r0, a in ((0, addr), (P // 4, addr + np.where(inner, W * 3, 0))):
        q, s = a >> 2, (a & 3) * 8
        g = (_le_words(mem, q), _le_words(mem, q + 1),
             np.where(s == 24, _le_words(mem, q + 2), 0))
        ws = [np.where(st[None], word(r0 + k), g[k]) for k in range(3)]
        s = np.where(st[None], (o & 3)[None] * 8, s)
        lo = _funnelshift_r(ws[0], ws[1], s)
        hi = _funnelshift_r(ws[1], ws[2], s)
        rows_.append((_byte_perm(lo, hi, ud.SEL01),
                      _byte_perm(lo, hi, ud.SEL2)))
    (a01, a22), (b01, b22) = rows_
    wa, wb = w[..., 0], w[..., 1]
    c = 1 << 14
    out = np.stack([_dp2a(wa, a01, _dp2a(wb, b01, c, 0), 0),
                    _dp2a(wa, a01, _dp2a(wb, b01, c, 1), 1),
                    _dp2a(wa, a22, _dp2a(wb, b22, c, 0), 0)], -1) >> 15
    # global border pixels: each tap checked against the image
    g = ~st & ~inner
    xg, yg = x0[g], y0[g]
    wg = w[g]
    acc = np.full((N, xg.size, 3), c, np.int64)
    for dy, dx, ww in ((0, 0, wg[:, 0] & 0xFFFF), (0, 1, wg[:, 0] >> 16),
                       (1, 0, wg[:, 1] & 0xFFFF), (1, 1, wg[:, 1] >> 16)):
        x, y = xg + dx, yg + dy
        inn = (x >= 0) & (x < W) & (y >= 0) & (y < H)
        tap = images[:, y.clip(0, H - 1), x.clip(0, W - 1)].astype(np.int64)
        acc += tap * (ww * inn)[None, :, None]
    out[:, g] = acc >> 15
    assert out.max() <= 255 and out.min() >= 0
    ty, tx = -(-H // ud.TILE_H), -(-W // ud.TILE_W)
    img = out.reshape(N, ty, tx, ud.TILE_H, ud.TILE_W, 3).transpose(
        0, 1, 3, 2, 4, 5).reshape(N, ty * ud.TILE_H, tx * ud.TILE_W, 3)
    return img[:, :H, :W].astype(np.uint8)


@pytest.mark.parametrize("route, base", [("tma", 0), ("global", 0),
                                         ("global", 1), ("global", 3)])
@pytest.mark.parametrize("name", list(PLAN_MAPS))
def test_staged_read_emulation_matches_remap_plain(name, route, base):
    """The kernel's reads and integer arithmetic on each route, emulated
    tile by tile on the plan (the global route's word reads from a stack
    that starts 0, 1 or 3 bytes past a word), bit for bit remap_plain
    (two seeded images)."""
    xy, frac = PLAN_MAPS[name]()
    plan = ud.remap_plan(xy, frac)
    H, W = frac.shape
    imgs = np.random.default_rng(6).integers(0, 256, (2, H, W, 3), np.uint8)
    want = ud.remap_plain(torch.from_numpy(imgs), torch.from_numpy(xy),
                          torch.from_numpy(frac)).numpy()
    assert np.array_equal(_emulate(imgs, plan, route, base), want)


def test_plan_weights_route_and_cpu_remap():
    """The packed weights are remap_weights' rows; the route follows the
    width and the alignment; remap (the kernel's launch) refuses a CPU
    tensor, whose plain version takes the map itself, not the plan;
    undistort on a CPU tensor is undistort_plain and counts no launch."""
    tab = ud.remap_weights().astype(np.int64)
    pw = ud.packed_weights().astype(np.int64)
    assert (tab >= 0).all() and np.array_equal(pw[:, 0] & 0xFFFF, tab[:, 0])
    assert np.array_equal(pw[:, 0] >> 16, tab[:, 1])
    assert np.array_equal(pw[:, 1] & 0xFFFF, tab[:, 2])
    assert np.array_equal(pw[:, 1] >> 16, tab[:, 3])
    assert {f"-DLVBA_UNDISTORT_SEL01={ud.SEL01:#x}",
            f"-DLVBA_UNDISTORT_TILE_W={ud.TILE_W}"} <= set(
        __import__("global_lvba_tpu_torch.kernels.build",
                   fromlist=["_defines"])._defines("undistort"))
    a = torch.zeros((2, 8, 640, 3), dtype=torch.uint8)
    assert ud.staging_route(a) == "tma"
    b = torch.zeros((2, 8, 321, 3), dtype=torch.uint8)
    assert ud.staging_route(b) == "global"
    c = torch.zeros(2 * 8 * 640 * 3 + 4, dtype=torch.uint8)[4:].view(
        2, 8, 640, 3)
    assert ud.staging_route(c) == "global"
    xy, frac = _random_map(7, 20, 150)
    plan = ud.remap_plan(xy, frac)
    imgs = torch.from_numpy(np.random.default_rng(8).integers(
        0, 256, (3, 20, 150, 3), np.uint8))
    with pytest.raises(ValueError):
        ud.remap(imgs, plan)
    cam = ROUND[1]
    ud._tables.clear()
    imgs = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (2, cam.height, cam.width, 3), np.uint8))
    before = launch_counts()["undistort"]
    got = ud.undistort(imgs, cam)
    assert launch_counts()["undistort"] == before
    assert not any(k[0] == "plan" for k in ud._tables if isinstance(k, tuple))
    assert torch.equal(got, ud.remap_plain(imgs, *map(
        torch.from_numpy, ud.undistort_map(cam, cam.width, cam.height))))
