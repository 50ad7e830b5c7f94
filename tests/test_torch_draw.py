"""cv2's drawing without cv2 (pipeline/draw.py) against cv2 on the CPU:
LINE_AA lines between random integer points (clipped ones included), the
filled LINE_AA dots (radius 2 and 3, and others) and filled rectangles at
random centres near and across the borders, on two backgrounds and where
the marks overlap, batches of marks in an interleaved order, and
FONT_HERSHEY_SIMPLEX text at the exports' scales and thicknesses: each
printable glyph and the exports' strings, bit for bit, and within the
stated tolerance (ink masks, pixels moved by more than 32 levels, IoU >=
0.9; ink boxes within 1 px)."""

import string

import cv2
import numpy as np
import pytest

from global_lvba_tpu_torch.pipeline.draw import Canvas

FONT = cv2.FONT_HERSHEY_SIMPLEX


def _backgrounds(h, w, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), np.uint8),
            np.full((h, w, 3), 230, np.uint8)]


def test_lines_match_cv2():
    rng = np.random.default_rng(0)
    for bg in _backgrounds(60, 80, 0):
        for _ in range(150):
            p1 = tuple(int(v) for v in rng.integers(-25, 105, 2))
            p2 = tuple(int(v) for v in rng.integers(-25, 105, 2))
            col = tuple(int(v) for v in rng.integers(0, 256, 3))
            want = bg.copy()
            cv2.line(want, p1, p2, col, 1, cv2.LINE_AA)
            cv = Canvas(bg)
            cv.line(p1, p2, col)
            assert np.array_equal(cv.finish(), want), (p1, p2)


@pytest.mark.parametrize("radius", [1, 2, 3, 5, 12])
def test_dots_match_cv2_near_and_across_borders(radius):
    rng = np.random.default_rng(radius)
    for bg in _backgrounds(30, 34, radius):
        for _ in range(80):
            c = (int(rng.integers(-6, 40)), int(rng.integers(-6, 36)))
            col = tuple(int(v) for v in rng.integers(0, 256, 3))
            want = bg.copy()
            cv2.circle(want, c, radius, col, -1, cv2.LINE_AA)
            cv = Canvas(bg)
            cv.dot(c, radius, col)
            assert np.array_equal(cv.finish(), want), c


def test_overlapping_marks_compose_as_cv2():
    """Crosses, dots and rectangles drawn over each other in an order that
    interleaves the kinds, one mark at a time and in batches."""
    rng = np.random.default_rng(7)
    n = 300
    c = rng.integers(-4, 68, (n, 2))
    kinds = rng.integers(0, 4, n)
    cols = rng.integers(0, 256, (n, 3))
    for bg in _backgrounds(60, 64, 7):
        want = bg.copy()
        cv = Canvas(bg)
        for (x, y), k, col in zip(c.tolist(), kinds, cols.tolist()):
            col = tuple(col)
            if k == 0:
                cv2.line(want, (x - 5, y), (x + 5, y), col, 1, cv2.LINE_AA)
                cv2.line(want, (x, y - 5), (x, y + 5), col, 1, cv2.LINE_AA)
                cv.line((x - 5, y), (x + 5, y), col)
                cv.line((x, y - 5), (x, y + 5), col)
            elif k == 1:
                cv2.circle(want, (x, y), 2, col, -1, cv2.LINE_AA)
                cv.dot((x, y), 2, col)
            elif k == 2:
                cv2.circle(want, (x, y), 3, col, -1, cv2.LINE_AA)
                cv.dot((x, y), 3, col)
            else:
                cv2.rectangle(want, (x - 1, y - 1), (x + 1, y + 1), col, -1)
                cv.marks(("rect", 1), [(x, y)], col)
        assert np.array_equal(cv.finish(), want)
        # the same marks as batches, one call a kind, ordered as drawn
        cv = Canvas(bg)
        cv.begin_batch()
        order = 2 * np.arange(n)
        for k, kind in enumerate([("hline", 5), ("dot", 2), ("dot", 3),
                                  ("rect", 1)]):
            sel = kinds == k
            cv.marks(kind, c[sel], cols[sel], order[sel])
            if k == 0:
                cv.marks(("vline", 5), c[sel], cols[sel], order[sel] + 1)
        cv.end_batch()
        assert np.array_equal(cv.finish(), want)


STYLES = [(0.5, 1), (0.6, 1), (0.6, 2), (0.5, 2)]
STRINGS = ["img=17 N=342 mean_pre=1.234 mean_post=0.567",
           "img=0 N=0 mean_pre=-1.000 mean_post=-1.000",
           "sift=2048 track=731", string.printable[:95]]


def _text(bg, s, org, scale, th, col):
    want = bg.copy()
    cv2.putText(want, s, org, FONT, scale, col, th, cv2.LINE_AA)
    cv = Canvas(bg)
    cv.text(s, org, scale, col, th)
    return want, cv.finish()


@pytest.mark.parametrize("scale,th", STYLES)
def test_every_glyph_matches_cv2(scale, th):
    bg = _backgrounds(40, 40, 3)[0]
    for ch in string.printable[:95]:
        want, got = _text(bg, ch, (12, 24), scale, th, (20, 200, 90))
        assert np.array_equal(got, want), repr(ch)


def _ink(img, bg):
    return np.abs(img.astype(int) - bg.astype(int)).max(axis=2) > 32


@pytest.mark.parametrize("scale,th", STYLES)
def test_strings_match_cv2_and_tolerance(scale, th):
    for k, bg in enumerate(_backgrounds(40, 420, 4)):
        for s in STRINGS:
            for col in ((0, 0, 0), (255, 255, 255)):
                want, got = _text(bg, s, (12, 24), scale, th, col)
                a, b = _ink(got, bg), _ink(want, bg)
                if k and col == (0, 0, 0):   # the tolerance, on the
                    # uniform 230 (white moves it by 25 levels: no ink)
                    iou = (a & b).sum() / max((a | b).sum(), 1)
                    assert iou >= 0.9
                    for ax in (0, 1):
                        ia = np.flatnonzero(a.any(axis=ax))
                        ib = np.flatnonzero(b.any(axis=ax))
                        assert abs(ia[0] - ib[0]) <= 1
                        assert abs(ia[-1] - ib[-1]) <= 1
                assert np.array_equal(got, want), (s, col)


def test_track_image_text_twice_and_clipping():
    """White thick text under black thin text, as the track images draw
    it, and a string running off the image's right edge."""
    bg = _backgrounds(30, 120, 5)[0]
    want = bg.copy()
    s = "sift=123 track=45 and more"
    cv2.putText(want, s, (12, 24), FONT, 0.6, (255, 255, 255), 2,
                cv2.LINE_AA)
    cv2.putText(want, s, (12, 24), FONT, 0.6, (0, 0, 0), 1, cv2.LINE_AA)
    cv = Canvas(bg)
    cv.text(s, (12, 24), 0.6, (255, 255, 255), 2)
    cv.text(s, (12, 24), 0.6, (0, 0, 0), 1)
    assert np.array_equal(cv.finish(), want)
    with pytest.raises(ValueError, match="no glyphs"):
        Canvas(bg).text("x", (0, 0), 0.7, (0, 0, 0), 1)
