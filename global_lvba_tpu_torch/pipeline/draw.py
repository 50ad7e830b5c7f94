"""cv2's drawing for the exports, without cv2 (host numpy; the JAX package
calls cv2.line / circle / rectangle / putText in pipeline/outputs.py:
170-203, 260-289 and 305-330).

A Canvas records what cv2 would draw on a BGR uint8 image, in cv2's order:
  * line: cv2.line(..., 1, LINE_AA) between integer points, by cv2's own
    LineAA algorithm (imgproc/drawing.cpp): the end points clipped to the
    image in 16.16 fixed point, one step a pixel along the major axis,
    three pixels across it weighted by FILTER_TABLE at the line's 5-bit
    sub-pixel distance, times SLOPE_CORR of its slope and the end-point
    corrections, each blended twice as v += ((c - v) a + 127) >> 8.
    It is cv2's line bit for bit at any angle, clipped lines included.
  * dot: cv2.circle(..., r, -1, LINE_AA) as cv2 draws it: the polygon of
    ellipse2Poly (a vertex every 90 degrees below radius 3, every 30 up
    to 9, ..., from cv2's 7-decimal sine table), its edges by LineAA, then
    the scan-line fill of FillConvexPoly; bit for bit at any radius, near
    the border too.
  * rect: cv2.rectangle(centre - h, centre + h, -1): a filled set.
  * text: cv2.putText(..., FONT_HERSHEY_SIMPLEX, scale, color, thickness,
    LINE_AA) at the scales and thicknesses of draw_data.GLYPHS (0.5 and
    0.6, 1 and 2): each glyph's coverage at whole-pixel advances, blended
    a glyph after another as v = (v (255 - a) + c a + 127) // 255; bit for
    bit the cv2 that wrote draw_data (scripts/make_draw_data.py).
The blends of lines, dots and rectangles are applied per pixel in the
order recorded (overlapping marks compose exactly as cv2's); text draws
after the marks recorded before it.
"""

from __future__ import annotations

import base64
import math
import zlib
from typing import Dict, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
SET = 256          # an op's alpha that writes the colour itself

# cv2's LineAA tables (imgproc/drawing.cpp FilterTable and
# SlopeCorrTable), checked against cv2.line in tests/test_torch_draw.py
FILTER_TABLE = np.array([
    168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252,
    254, 254, 254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202,
    194, 185, 177, 168, 158, 149, 140, 131, 122, 114, 105, 97, 89, 82, 75,
    68, 62, 56, 50, 45, 40, 36, 32, 28, 25, 22, 19, 16, 14, 12, 11, 9, 8,
    7, 5, 5], dtype=np.int64)
SLOPE_CORR = (181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192,
              194, 196, 198, 201, 203, 206, 209, 211, 214, 218, 221, 224,
              227, 231, 235, 238, 242, 246, 250, 254)


def _tdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _clip_line(W: int, H: int, x1, y1, x2, y2):
    """cv2's clipLine to [0, W - 1] x [0, H - 1]: (visible, x1, y1, x2,
    y2)."""
    right, bottom = W - 1, H - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _ep_table(s: int, i: int, j: int):
    t0 = s << 7
    t1 = ((0x78 - i) | 4) * s
    t2 = (j | 4) * s
    e = [0] * 9
    e[8] = s
    e[1] = e[3] = ((((j - i) & 0x78) | 4) * s >> 8) & 0x1ff
    e[2] = (t1 >> 8) & 0x1ff
    e[4] = ((((j - i) + 0x80) | 4) * s >> 8) & 0x1ff
    e[5] = ((t1 + t0) >> 8) & 0x1ff
    e[6] = (t2 >> 8) & 0x1ff
    e[7] = ((t2 + t0) >> 8) & 0x1ff
    return np.array(e, dtype=np.int64)


def line_aa_ops(W: int, H: int, p1, p2):
    """The pixels (ys, xs) and blend alphas of cv2.line(p1, p2, LINE_AA,
    thickness 1) on a W x H image, in cv2's order."""
    return _line_aa_fixed(W, H, int(p1[0]) << XY_SHIFT,
                          int(p1[1]) << XY_SHIFT, int(p2[0]) << XY_SHIFT,
                          int(p2[1]) << XY_SHIFT)


def _line_aa_fixed(W: int, H: int, x1: int, y1: int, x2: int, y2: int):
    """cv2's LineAA between 16.16 fixed-point ends: (ys, xs, alphas)."""
    vis, x1, y1, x2, y2 = _clip_line(W << XY_SHIFT, H << XY_SHIFT,
                                     x1, y1, x2, y2)
    empty = np.zeros(0, np.int64)
    if not vis:
        return empty, empty, empty
    xmajor = abs(x2 - x1) > abs(y2 - y1)
    if not xmajor:       # walk y as the major axis: the same code transposed
        x1, y1, x2, y2 = y1, x1, y2, x2
    Wm, Hm = (W, H) if xmajor else (H, W)
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    step = _tdiv((y2 - y1) << XY_SHIFT, (x2 - x1) | 1)
    x2 += XY_ONE
    ecount = (x2 >> XY_SHIFT) - (x1 >> XY_SHIFT)
    j = -(x1 & (XY_ONE - 1))
    y1 += ((step * j) >> XY_SHIFT) + (XY_ONE >> 1)
    slope = (step >> (XY_SHIFT - 5)) & 0x3f
    if step < 0:
        slope ^= 0x3f
    i = (x1 >> (XY_SHIFT - 7)) & 0x78
    j = (x2 >> (XY_SHIFT - 7)) & 0x78
    ep = _ep_table(0x100 if slope & 0x20 else SLOPE_CORR[slope], i, j)
    k = np.arange(ecount + 1, dtype=np.int64)
    x = (x1 >> XY_SHIFT) + k
    keep = (x >= 0) & (x < Wm)
    k, x = k[keep], x[keep]
    yf = y1 + k * step
    e = ecount - k
    idx = ((((k >= 2) + 1) & (k | 2)) * 3 + (((e >= 2) + 1) & (e | 2)))
    corr = ep[idx]
    y = (yf >> XY_SHIFT) - 1
    dist = (yf >> (XY_SHIFT - 5)) & 31
    ys = np.stack([y, y + 1, y + 2], axis=1)
    fi = np.stack([dist + 32, dist, 63 - dist], axis=1)
    a = (corr[:, None] * FILTER_TABLE[fi] >> 8) & 0xff
    xs = np.broadcast_to(x[:, None], ys.shape)
    ok = (ys >= 0) & (ys < Hm)
    ys, xs, a = ys[ok], xs[ok], a[ok]
    return (ys, xs, a) if xmajor else (xs, ys, a)


_glyphs: Dict[Tuple[float, int], dict] = {}


def _sin_table(deg: int) -> float:
    """cv2's SinTable entry: sin(deg°) to 7 decimals, as a float."""
    return float(np.float32(round(math.sin(math.radians(deg)), 7)))


def _circle_poly(cx: int, cy: int, r: int):
    """cv2's polygon of a circle (EllipseEx / ellipse2Poly) in 16.16 fixed
    point: a vertex every `delta` degrees from 0 to 360, consecutive
    repeats dropped."""
    R = r << XY_SHIFT
    d = (R + (XY_ONE >> 1)) >> XY_SHIFT
    delta = 90 if d < 3 else 30 if d < 10 else 18 if d < 15 else 5
    pts = []
    for i in range(0, 360 + delta, delta):
        ang = min(i, 360)
        p = ((cx << XY_SHIFT) + int(np.rint(R * _sin_table(450 - ang))),
             (cy << XY_SHIFT) + int(np.rint(R * _sin_table(ang))))
        if not pts or pts[-1] != p:
            pts.append(p)
    return pts


def _fill_spans(W: int, H: int, v):
    """cv2's FillConvexPoly scan (LINE_AA rounding) of the 16.16 polygon v:
    [(y, x0, x1)] spans clipped to the image."""
    n = len(v)
    half = XY_ONE >> 1
    ys = [p[1] for p in v]
    xs = [p[0] for p in v]
    imin = ys.index(min(ys))
    xmin, xmax = (min(xs) + half) >> XY_SHIFT, (max(xs) + half) >> XY_SHIFT
    ymin, ymax = (min(ys) + half) >> XY_SHIFT, (max(ys) + half) >> XY_SHIFT
    spans = []
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= W or ymin >= H:
        return spans
    ymax = min(ymax, H - 1)
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, n - 1, -XY_ONE, 0, ymin]]
    edges, y = n, ymin
    while True:
        if y < ymax or y == ymin:
            for e in edge:            # [idx, di, x, dx, ye]
                if y < e[4]:
                    continue
                idx0, di = e[0], e[1]
                idx = (idx0 + di) % n
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + half) >> XY_SHIFT
                    if ty > y:
                        x0, x1 = v[idx0][0], v[idx][0]
                        e[0], e[2], e[4] = idx, x0, ty
                        e[3] = _tdiv((x1 - x0) * 2 + (ty - y), 2 * (ty - y))
                        break
                    idx0, idx = idx, (idx + di) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = (edge[1], edge[0]) if edge[0][2] > edge[1][2] \
                else (edge[0], edge[1])
            x1 = (left[2] + XY_ONE - 1) >> XY_SHIFT
            x2 = right[2] >> XY_SHIFT
            if x2 >= 0 and x1 < W:
                spans.append((y, max(x1, 0), min(x2, W - 1)))
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break
    return spans


def glyph_table(scale: float, thickness: int) -> dict:
    """{char: (dx, dy, advance, coverage (h, w) uint8)} of
    FONT_HERSHEY_SIMPLEX at scale and thickness."""
    key = (float(scale), int(thickness))
    hit = _glyphs.get(key)
    if hit is None:
        from .draw_data import GLYPH_BLOB, GLYPHS

        blob = zlib.decompress(base64.b64decode("".join(GLYPH_BLOB)))
        for sc, th, code, dx, dy, adv, h, w, off in GLYPHS:
            cov = np.frombuffer(blob, np.uint8, h * w, off).reshape(h, w)
            _glyphs.setdefault((float(sc), int(th)), {})[chr(code)] = (
                dx, dy, adv, cov)
        hit = _glyphs.get(key)
        if hit is None:
            raise ValueError(f"no glyphs at scale {scale}, thickness "
                             f"{thickness} (have {sorted(_glyphs)})")
    return hit


def _apply(flat: np.ndarray, lin, alpha, col):
    """Apply ops (pixel lin, alpha 0-255 blended twice or SET, colour (n,
    3)) to flat (H * W, 3) int64 in the order given, per pixel."""
    n = lin.shape[0]
    if n == 0:
        return
    order = np.argsort(lin, kind="stable")
    ls = lin[order]
    first = np.ones(n, dtype=bool)
    first[1:] = ls[1:] != ls[:-1]
    rank = np.arange(n) - np.maximum.accumulate(np.where(first,
                                                         np.arange(n), 0))
    for r in range(int(rank.max()) + 1):
        ops = order[rank == r]      # at most one op a pixel in this round
        px = lin[ops]
        v = flat[px]
        c = col[ops]
        a = alpha[ops][:, None]
        for _ in range(2):
            v = v + (((c - v) * a + 127) >> 8)
        flat[px] = np.where(a == SET, c, v)


def _mark_ops(kind, cx: int, cy: int, W: int, H: int):
    """(ys, xs, alphas) of one mark at an integer centre on a W x H image,
    in cv2's order: ("dot", r) cv2.circle(r, -1, LINE_AA) (its polygon's
    edges by LineAA from the last vertex round, then its scan-line fill),
    ("hline", h) / ("vline", h) cv2.line from centre - h to centre + h
    (LINE_AA), ("rect", h) cv2.rectangle(centre - h, centre + h, -1)."""
    name, h = kind
    if name == "hline":
        return line_aa_ops(W, H, (cx - h, cy), (cx + h, cy))
    if name == "vline":
        return line_aa_ops(W, H, (cx, cy - h), (cx, cy + h))
    if name == "rect":
        ys, xs = np.mgrid[cy - h:cy + h + 1, cx - h:cx + h + 1]
        return ys.ravel(), xs.ravel(), np.full(ys.size, SET, np.int64)
    if name != "dot":
        raise ValueError(f"unknown mark {kind!r}")
    v = _circle_poly(cx, cy, h)
    parts = []
    p0 = v[-1]
    for p in v:
        parts.append(_line_aa_fixed(W, H, *p0, *p))
        p0 = p
    for y, x0, x1 in _fill_spans(W, H, v):
        xs = np.arange(x0, x1 + 1, dtype=np.int64)
        parts.append((np.full_like(xs, y), xs, np.full_like(xs, SET)))
    return tuple(np.concatenate(c) for c in zip(*parts))


_templates: dict = {}


def _template(kind):
    """A mark's ops relative to its centre (dy, dx, alpha) and the margin a
    centre needs from every border for them to hold: cv2 draws a mark the
    same way at any integer centre where nothing is clipped."""
    hit = _templates.get(kind)
    if hit is None:
        R = 2 * kind[1] + 8
        ys, xs, a = _mark_ops(kind, R, R, 2 * R + 1, 2 * R + 1)
        dy, dx = ys - R, xs - R
        margin = int(max(np.abs(dy).max(), np.abs(dx).max())) + 2
        if margin >= R:
            raise ValueError(f"mark {kind!r} is too large for a template")
        hit = _templates[kind] = (dy, dx, a, margin)
    return hit


class Canvas:
    """cv2's marks on a copy of a BGR uint8 image (H, W, 3), applied in the
    order recorded; finish() returns the image."""

    def __init__(self, image: np.ndarray):
        self.H, self.W = image.shape[:2]
        self.flat = image.reshape(-1, 3).astype(np.int64)
        self._ops = []
        self._next = 0

    def _add(self, ys, xs, a, color, keys=None):
        ok = (ys >= 0) & (ys < self.H) & (xs >= 0) & (xs < self.W)
        ys, xs, a = ys[ok], xs[ok], a[ok]
        col = np.broadcast_to(np.asarray(color, np.int64)[..., :3],
                              (ok.size, 3))[ok]
        if keys is None:
            keys = np.full(ys.size, self._next, np.int64)
            self._next += 1
        else:
            keys = keys[ok]
        self._ops.append((keys, ys * self.W + xs, a, col))

    def line(self, p1, p2, color):
        """cv2.line(p1, p2, color, 1, LINE_AA)."""
        self._add(*line_aa_ops(self.W, self.H, p1, p2), color)

    def dot(self, center, radius: int, color):
        """cv2.circle(center, radius, color, -1, LINE_AA)."""
        self.marks(("dot", int(radius)), [center], [color])

    def marks(self, kind, centers, colors, order=None):
        """Marks of one kind (see _mark_ops) at integer centres (n, 2) in
        colours (n, 3) or one colour, drawn as cv2 would draw them one by
        one.  order (n,) places each mark among those of the following
        marks() calls of one batch (begin_batch / end_batch): a mark draws
        before every mark of a greater order."""
        c = np.asarray(centers, np.int64).reshape(-1, 2)
        n = c.shape[0]
        col = np.broadcast_to(np.asarray(colors, np.int64).reshape(-1, 3),
                              (n, 3))
        if order is None:
            keys = self._next + np.arange(n, dtype=np.int64)
            self._next += n
        else:
            keys = self._batch + np.asarray(order, np.int64)
            self._batch_end = max(self._batch_end, int(keys.max(initial=-1))
                                  + 1)
        dy, dx, a, m = _template(kind)
        cx, cy = c[:, 0], c[:, 1]
        inside = (cx >= m) & (cx < self.W - m) & (cy >= m) & (cy < self.H - m)
        k = dy.size
        if inside.any():
            ys = (cy[inside, None] + dy[None]).ravel()
            xs = (cx[inside, None] + dx[None]).ravel()
            self._add(ys, xs, np.tile(a, int(inside.sum())),
                      np.repeat(col[inside], k, axis=0),
                      np.repeat(keys[inside], k))
        for i in np.flatnonzero(~inside):
            ys, xs, aa = _mark_ops(kind, int(cx[i]), int(cy[i]), self.W,
                                   self.H)
            self._add(ys, xs, aa, col[i], np.full(ys.size, keys[i]))

    def begin_batch(self):
        """Start a batch of marks() calls ordered among each other."""
        self._batch = self._batch_end = self._next

    def end_batch(self):
        self._next = max(self._next, self._batch_end)

    def flush(self):
        if self._ops:
            keys, lin, a, col = (np.concatenate(c) for c in zip(*self._ops))
            self._ops = []
            o = np.argsort(keys, kind="stable")
            _apply(self.flat, lin[o], a[o], col[o])

    def text(self, text: str, org, scale: float, color, thickness: int):
        """cv2.putText(text, org, FONT_HERSHEY_SIMPLEX, scale, color,
        thickness, LINE_AA) for printable ASCII."""
        self.flush()
        table = glyph_table(scale, thickness)
        img = self.flat.reshape(self.H, self.W, 3)
        c = np.asarray(color, np.int64)[:3]
        x = int(org[0])
        for ch in text:
            g = table.get(ch)
            if g is None:
                raise ValueError(f"no glyph for {ch!r}")
            dx, dy, adv, cov = g
            y0, x0 = int(org[1]) + dy, x + dx
            ya, xa = max(y0, 0), max(x0, 0)
            yb = min(y0 + cov.shape[0], self.H)
            xb = min(x0 + cov.shape[1], self.W)
            if ya < yb and xa < xb:
                a = cov[ya - y0:yb - y0, xa - x0:xb - x0, None].astype(
                    np.int64)
                sub = img[ya:yb, xa:xb]
                sub[:] = (sub * (255 - a) + c * a + 127) // 255
            x += adv

    def finish(self) -> np.ndarray:
        self.flush()
        return self.flat.reshape(self.H, self.W, 3).astype(np.uint8)
