"""cv2's 8-bit colour conversions and filters without cv2 (host numpy):
what preprocess_low_texture_bgr takes from cv2, bit for bit.

  * bgr_to_lab / lab_to_bgr: cvtColor(COLOR_BGR2Lab / COLOR_Lab2BGR) on
    uint8, OpenCV's bit-exact integer paths (color_lab.cpp RGB2Lab_b and
    Lab2RGBinteger): sRGB D65, 12-bit matrices, the gamma, cube-root,
    L -> (Y, f(Y)), f -> X / Z and inverse-gamma tables, each built as
    OpenCV builds it (softfloat float32 where it uses it, integer
    division where it does).  Both equal cv2 on all 2^24 inputs.
  * clahe: createCLAHE(2.0, (8, 8)).apply on uint8: the image
    padded by reflection to whole tiles, each tile's histogram clipped and
    its excess spread (the remainder on every 256 / r-th bin), float32
    LUTs rounded to even, and cv2's float32 bilinear blend of the four
    tiles' LUTs.
  * gaussian_blur_sigma1: GaussianBlur(img, (0, 0), 1.0) on uint8, cv2's
    fixed-point path: the 7-tap kernel (1, 14, 62, 102, 62, 14, 1) / 256
    along rows then columns, reflected borders (BORDER_REFLECT_101), the
    16-bit fraction rounded half up.
  * upsample_cubic_x2: resize(INTER_CUBIC) to twice the width and height:
    A = -0.75 taps in float32 rounded to 11 bits, the horizontal pass in
    integers, the vertical pass as cv2's float32 SIMD pass forms it,
    (S0 b0 + S1 b1) + (S2 b2 + S3 b3), rounded to even (a row of fewer
    than 8 values: cv2's integer scalar pass); edges replicated.  Bit for
    bit but at the right edge of BGR images 2 or 3 pixels wide, where cv2
    takes its integer pass for the row's last values (up to 1 level).
"""

from __future__ import annotations

import functools

import numpy as np

_F32 = np.float32

# ---------------------------------------------------------------------------
# Lab

_LAB_SHIFT = 12            # matrix fraction bits (xyz_shift)
_GAMMA_SHIFT = 3           # gamma table: 255 * 8 levels
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT
_BASE = 1 << 14            # Lab -> XYZ fixed point
_MIN_AB = -8145            # abToXZ_b's first index
_INV_GAMMA_SIZE = 1 << 12
_D65 = (0.950456, 1.0, 1.088754)
_SRGB_TO_XYZ = ((0.412453, 0.357580, 0.180423),
                (0.212671, 0.715160, 0.072169),
                (0.019334, 0.119193, 0.950227))
_XYZ_TO_SRGB = ((3.240479, -1.53715, -0.498535),
                (-0.969256, 1.875991, 0.041556),
                (0.055648, -0.204043, 1.057311))
_LTHRESH = 216 / 24389     # (6/29)^3
_LSCALE = 841 / 108        # 7.787
_LBIAS = 16 / 116
# the two cube-root entries within 2e-4 of a half that OpenCV's float32
# evaluation rounds the other way from the float64 formula
_CBRT_FIXES = {49: 9454, 628: 22126}


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _ctrunc_div(a, b: int):
    """C's integer division (toward zero) of an int64 array by b > 0."""
    q = np.abs(a) // b
    return np.where(a < 0, -q, q)


@functools.lru_cache(maxsize=None)
def _lab_tables():
    i = np.arange(256, dtype=np.float64) / 255.0
    gamma = np.rint(255 * 8 * np.where(
        i <= 0.04045, i / 12.92, ((i + 0.055) / 1.055) ** 2.4)).astype(
        np.int64)
    x = np.arange(256 * 3 // 2 * (1 << _GAMMA_SHIFT)) / (255.0 * 8)
    cbrt = np.rint((1 << _LAB_SHIFT2) * np.where(
        x < _LTHRESH, x * _LSCALE + _LBIAS, np.cbrt(x))).astype(np.int64)
    for k, v in _CBRT_FIXES.items():
        cbrt[k] = v
    # forward matrix for B, G, R inputs, rows X / Xn, Y / Yn, Z / Zn
    fwd = np.array([[round((1 << _LAB_SHIFT) * c / _D65[r]) for c in
                     _SRGB_TO_XYZ[r][::-1]] for r in range(3)], np.int64)
    # inverse matrix, rows B, G, R outputs, columns X Xn, Y Yn, Z Zn
    inv = np.array([[round((1 << _LAB_SHIFT) * _XYZ_TO_SRGB[r][c] * _D65[c])
                     for c in range(3)] for r in (2, 1, 0)], np.int64)
    # L (0..255) -> Y and f(Y) at 14 bits, OpenCV's float32 formulas
    y_tab = np.zeros(256, np.int64)
    fy_tab = np.zeros(256, np.int64)
    for L in range(256):
        if L <= 20:
            y_tab[L] = np.rint(_F32(L * _BASE * 20 * 9)
                               / _F32(17 * 29 * 29 * 29))
            fy_tab[L] = np.rint(_F32(_BASE) * (_F32(16) / _F32(116)
                                               + _F32(L * 5)
                                               / _F32(3 * 17 * 29)))
        else:
            fy = (_F32(L * 100 * _BASE) / _F32(255 * 116)
                  + _F32(16 * _BASE) / _F32(116))
            fy_tab[L] = np.rint(fy)
            y_tab[L] = np.rint(fy * fy * fy / _F32(_BASE * _BASE))
    # f -> X / Xn or Z / Zn at 14 bits, in integers
    v = np.arange(_MIN_AB, _MIN_AB + _BASE * 9 // 4, dtype=np.int64)
    xz_tab = np.where(
        v <= 3390,
        _ctrunc_div(v * 108, 841) - (_BASE * 16 // 116 * 108 // 841),
        (v * v // _BASE) * v // _BASE)
    g = np.arange(_INV_GAMMA_SIZE) / _INV_GAMMA_SIZE
    inv_gamma = np.rint(255 * np.where(
        g <= 0.0031308, g * 12.92,
        1.055 * np.power(g, 1 / 2.4) - 0.055)).astype(np.int64)
    return gamma, cbrt, fwd, inv, y_tab, fy_tab, xz_tab, inv_gamma


def bgr_to_lab(bgr: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(bgr, COLOR_BGR2Lab) on (..., 3) uint8, bit for bit."""
    gamma, cbrt, fwd, _, _, _, _, _ = _lab_tables()
    c = gamma[np.asarray(bgr, np.uint8)]
    f = [cbrt[_descale(c @ fwd[r], _LAB_SHIFT)] for r in range(3)]
    L = _descale(((116 * 255 + 50) // 100) * f[1]
                 - (16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100, _LAB_SHIFT2)
    a = _descale(500 * (f[0] - f[1]) + (128 << _LAB_SHIFT2), _LAB_SHIFT2)
    b = _descale(200 * (f[1] - f[2]) + (128 << _LAB_SHIFT2), _LAB_SHIFT2)
    return np.stack([L, a, b], -1).clip(0, 255).astype(np.uint8)


def lab_to_bgr(lab: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(lab, COLOR_Lab2BGR) on (..., 3) uint8, bit for bit."""
    _, _, _, inv, y_tab, fy_tab, xz_tab, inv_gamma = _lab_tables()
    lab = np.asarray(lab, np.uint8).astype(np.int64)
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = fy_tab[L]
    adiv = ((5 * a * 53687 + (1 << 7)) >> 13) - 128 * _BASE // 500
    bdiv = ((b * 41943 + (1 << 4)) >> 9) - 128 * _BASE // 200 + 1
    xyz = np.stack([xz_tab[fy + adiv - _MIN_AB], y_tab[L],
                    xz_tab[fy - bdiv - _MIN_AB]], -1)
    shift = _LAB_SHIFT + 14 - 12
    return np.stack([inv_gamma[_descale(xyz @ inv[r], shift).clip(
        0, _INV_GAMMA_SIZE - 1)] for r in range(3)], -1).astype(np.uint8)


# ---------------------------------------------------------------------------
# CLAHE


_CLAHE_CLIP = 2.0
_CLAHE_TILES = 8


def clahe(gray: np.ndarray) -> np.ndarray:
    """cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8)).apply(gray) on
    (H, W) uint8, bit for bit."""
    src = np.asarray(gray, np.uint8)
    tx = ty = _CLAHE_TILES
    H, W = src.shape
    ext = src
    if W % tx or H % ty:
        ext = np.pad(src, ((0, ty - H % ty), (0, tx - W % tx)),
                     mode="reflect")
    th, tw = ext.shape[0] // ty, ext.shape[1] // tx
    total = th * tw
    lut_scale = _F32(255) / _F32(total)
    limit = max(int(_CLAHE_CLIP * total / 256), 1)
    tile = (np.arange(ext.shape[0]) // th)[:, None] * tx \
        + (np.arange(ext.shape[1]) // tw)[None, :]
    hist = np.bincount((tile * 256 + ext).ravel(),
                       minlength=ty * tx * 256).reshape(ty * tx, 256)
    clipped = np.maximum(hist - limit, 0).sum(1)
    hist = np.minimum(hist, limit) + (clipped // 256)[:, None]
    for k, r in enumerate(clipped % 256):
        if r:
            hist[k, np.arange(0, 256, max(256 // int(r), 1))[:r]] += 1
    lut = np.clip(np.rint(np.cumsum(hist, 1).astype(_F32) * lut_scale),
                  0, 255).reshape(ty, tx, 256).astype(np.uint8)

    def blend(n, size, count):
        f = np.arange(n).astype(_F32) * (_F32(1) / _F32(size)) - _F32(0.5)
        i1 = np.floor(f).astype(np.int64)
        w = (f - i1.astype(_F32)).astype(_F32)
        return (np.maximum(i1, 0), np.minimum(i1 + 1, count - 1), w,
                _F32(1) - w)

    x1, x2, xa, xa1 = blend(W, tw, tx)
    y1, y2, ya, ya1 = blend(H, th, ty)
    v = src.astype(np.int64)

    def at(ys, xs):
        return lut[ys[:, None], xs[None, :], v].astype(_F32)

    res = ((at(y1, x1) * xa1 + at(y1, x2) * xa) * ya1[:, None]
           + (at(y2, x1) * xa1 + at(y2, x2) * xa) * ya[:, None])
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# filters

_GAUSS7 = np.array([1, 14, 62, 102, 62, 14, 1], np.int64)   # sigma 1 / 256


def gaussian_blur_sigma1(img: np.ndarray) -> np.ndarray:
    """cv2.GaussianBlur(img, (0, 0), 1.0) on (H, W) or (H, W, C) uint8,
    bit for bit."""
    a = np.asarray(img, np.uint8).astype(np.int64)
    H, W = a.shape[:2]
    p = np.pad(a, ((3, 3), (3, 3)) + ((0, 0),) * (a.ndim - 2),
               mode="reflect")
    rows = sum(_GAUSS7[k] * p[:, k:k + W] for k in range(7))
    out = sum(_GAUSS7[k] * rows[k:k + H] for k in range(7))
    return ((out + (1 << 15)) >> 16).clip(0, 255).astype(np.uint8)


def _cubic_taps(n: int):
    """Source rows (2n, 4) and 11-bit weights (2n, 4) of a x2 cubic
    upsample along one axis (cv2's interpolateCubic in float32)."""
    d = np.arange(2 * n)
    f = ((d + 0.5) * 0.5 - 0.5).astype(_F32)
    s = np.floor(f).astype(np.int64)
    x = (f - s.astype(_F32)).astype(_F32)
    A, one = _F32(-0.75), _F32(1)
    c0 = ((A * (x + one) - 5 * A) * (x + one) + 8 * A) * (x + one) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + one
    c2 = ((A + 2) * (one - x) - (A + 3)) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    w = np.rint(np.stack([c0, c1, c2, c3], -1) * _F32(2048)).astype(
        np.int64)
    return np.clip(s[:, None] + np.arange(-1, 3), 0, n - 1), w


def upsample_cubic_x2(img: np.ndarray) -> np.ndarray:
    """cv2.resize(img, (2 W, 2 H), interpolation=INTER_CUBIC) on (H, W)
    or (H, W, C) uint8, bit for bit."""
    img = np.asarray(img, np.uint8)
    H, W = img.shape[:2]
    a = img.reshape(H, W, -1).astype(np.int64)
    ix, wx = _cubic_taps(W)
    iy, wy = _cubic_taps(H)
    rows = (a[:, ix] * wx[None, :, :, None]).sum(2)
    if rows[0].size < 8:
        # a row shorter than one SIMD vector takes cv2's scalar pass:
        # integers, the 22-bit fraction rounded half up
        out = sum(rows[iy[:, k]] * wy[:, k, None, None] for k in range(4))
        out = (out + (1 << 21)) >> 22
    else:
        b = wy.astype(_F32) * _F32(1.0 / (2048 * 2048))
        p = [rows[iy[:, k]].astype(_F32) * b[:, k, None, None]
             for k in range(4)]
        out = np.rint((p[0] + p[1]) + (p[2] + p[3]))
    return np.clip(out, 0, 255).astype(np.uint8).reshape(
        (2 * H, 2 * W) + img.shape[2:])
