"""The port's image files (io/image.py) against cv2 on the CPU: PNG of every
colour type and bit depth (written by cv2, by PIL and by the filter-choosing
writer png_writer.py), BMP of 8, 24 and 32 bits bottom-up and top-down,
both reads bit for bit cv2.imread's; resize_linear bit for bit
cv2.resize(INTER_LINEAR) at 2:1, 0.37 and upward; the PNG writer read back
by cv2; the frontend's load_gray_image bit for bit the JAX package's (PNG,
BMP, baseline and progressive JPEG, Adam7 PNG, an EXIF-oriented JPEG); the
JPEG formats cv2 reads nothing of, and damaged files, raising ValueError
with their name."""

import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from global_lvba_tpu.pipeline import sift_frontend as jsf
from global_lvba_tpu_torch.io import image as gi
from global_lvba_tpu_torch.pipeline import sift_frontend as psf
from png_writer import png as _png

H, W = 23, 37


def _same_reads(path):
    g = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    c = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert g is not None and c is not None
    pg, pc = gi.imread_gray(path), gi.imread_color(path)
    assert pg.dtype == np.uint8 and pg.shape == g.shape
    assert np.array_equal(pg, g)
    assert pc.dtype == np.uint8 and pc.shape == c.shape
    assert np.array_equal(pc, c)


CASES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
         (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


@pytest.mark.parametrize("color,depth", CASES)
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (0, 1, 2, 3, 4)])
def test_png_every_type_depth_and_filter(tmp_path, color, depth, filters):
    rng = np.random.default_rng(color * 100 + depth)
    top = (1 << depth) if color != 3 else min(1 << depth, 200)
    s = rng.integers(0, top, (H, W, CHANNELS[color]))
    plte = rng.integers(0, 256, (top, 3)) if color == 3 else None
    p = tmp_path / "f.png"
    p.write_bytes(_png(s, color, depth, filters, plte))
    _same_reads(p)


def test_png_palette_with_transparency_and_gray_levels(tmp_path):
    rng = np.random.default_rng(3)
    s = rng.integers(0, 16, (H, W, 1))
    plte = rng.integers(0, 256, (16, 3))
    p = tmp_path / "t.png"
    p.write_bytes(_png(s, 3, 4, (4,), plte, trns=bytes(range(0, 160, 10))))
    _same_reads(p)
    # equal R, G, B: the gray read keeps the level exactly
    g = np.repeat(rng.integers(0, 65536, (H, W, 1)), 3, axis=2)
    p = tmp_path / "g.png"
    p.write_bytes(_png(g, 2, 16, (1, 4)))
    _same_reads(p)


@pytest.mark.parametrize("ch,dtype", [(1, np.uint8), (1, np.uint16),
                                      (3, np.uint8), (3, np.uint16),
                                      (4, np.uint8), (4, np.uint16)])
def test_png_written_by_cv2(tmp_path, ch, dtype):
    rng = np.random.default_rng(ch)
    top = 256 if dtype == np.uint8 else 65536
    a = rng.integers(0, top, (H, W, ch) if ch > 1 else (H, W), dtype=dtype)
    p = tmp_path / "c.png"
    for level in (1, 9):
        cv2.imwrite(str(p), a, [cv2.IMWRITE_PNG_COMPRESSION, level])
        _same_reads(p)


@pytest.mark.parametrize("mode", ["1", "L", "LA", "RGB", "RGBA", "P", "P2",
                                  "P4", "I;16"])
def test_png_written_by_pil(tmp_path, mode):
    rng = np.random.default_rng(len(mode))
    rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    kw = {}
    if mode == "1":
        im = Image.fromarray(rng.integers(0, 2, (H, W)).astype(bool))
    elif mode == "L":
        im = Image.fromarray(rgb[:, :, 0])
    elif mode in ("LA", "RGBA"):
        n = 2 if mode == "LA" else 4
        im = Image.fromarray(rng.integers(0, 256, (H, W, n), np.uint8),
                             mode)
    elif mode == "RGB":
        im = Image.fromarray(rgb)
    elif mode.startswith("P"):
        bits = int(mode[1:] or 8)
        im = Image.fromarray(rgb).quantize(1 << bits)
        kw = {"bits": bits} if bits < 8 else {}
    else:
        im = Image.fromarray(rng.integers(0, 65536, (H, W), np.uint16))
    p = tmp_path / "p.png"
    im.save(p, **kw)
    _same_reads(p)


def _bmp(img, bits, top_down, pal=None) -> bytes:
    h, w = img.shape[:2]
    stride = (w * bits // 8 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * bits // 8] = img.reshape(h, -1)
    if not top_down:
        rows = rows[::-1]
    palb = b"" if pal is None else np.concatenate(
        [pal, np.zeros((len(pal), 1), np.uint8)], 1).astype(np.uint8) \
        .tobytes()
    off = 14 + 40 + len(palb)
    head = struct.pack("<2sIHHI", b"BM", off + rows.size, 0, 0, off)
    dib = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bits,
                      0, rows.size, 2835, 2835,
                      0 if pal is None else len(pal), 0)
    return head + dib + palb + rows.tobytes()


@pytest.mark.parametrize("bits", [8, 24, 32])
@pytest.mark.parametrize("top_down", [False, True])
def test_bmp(tmp_path, bits, top_down):
    rng = np.random.default_rng(bits)
    pal = None
    if bits == 8:
        pal = rng.integers(0, 256, (256, 3))
        img = rng.integers(0, 256, (H, W), np.uint8)
    else:
        img = rng.integers(0, 256, (H, W, bits // 8), np.uint8)
    p = tmp_path / "b.bmp"
    p.write_bytes(_bmp(img, bits, top_down, pal))
    _same_reads(p)


@pytest.mark.parametrize("ch", [1, 3])
def test_bmp_written_by_cv2_and_a_gray_palette(tmp_path, ch):
    rng = np.random.default_rng(ch)
    img = rng.integers(0, 256, (H, W, 3) if ch == 3 else (H, W), np.uint8)
    p = tmp_path / "c.bmp"
    cv2.imwrite(str(p), img)
    _same_reads(p)
    gray = np.repeat(np.arange(256)[:, None], 3, axis=1)
    p = tmp_path / "g.bmp"
    p.write_bytes(_bmp(rng.integers(0, 256, (H, W), np.uint8), 8, False,
                       gray))
    _same_reads(p)


def _smooth(h, w, ch):
    y, x = np.mgrid[0:h, 0:w]
    base = (x * 7 + y * 3) % 256
    planes = [base, 255 - base, (base * 3 + y) % 256][:ch]
    return np.stack(planes, -1).astype(np.uint8).reshape(
        (h, w, ch) if ch > 1 else (h, w))


@pytest.mark.parametrize("src", [(256, 320), (128, 160), (37, 53)])
@pytest.mark.parametrize("ch", [1, 3])
@pytest.mark.parametrize("kind", ["random", "smooth"])
def test_resize_linear_matches_cv2(src, ch, kind):
    h, w = src
    rng = np.random.default_rng(h + ch)
    img = rng.integers(0, 256, (h, w, ch) if ch > 1 else (h, w), np.uint8) \
        if kind == "random" else _smooth(h, w, ch)
    sizes = [(w // 2, h // 2), (max(1, int(w * 0.37)), max(1, int(h * 0.37))),
             (w * 2 + 3, h + 5), (w - 3, h * 3 // 4)]
    for (dw, dh) in sizes:
        want = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR)
        got = gi.resize_linear(img, dw, dh)
        assert got.shape == want.shape and np.array_equal(got, want), \
            (dw, dh)
    assert np.array_equal(gi.resize_linear(img, w, h), img)


def test_resize_deployment_reduction():
    """The reference configuration's 1280 x 1024 -> 640 x 512 (scale 0.5)
    on a BGR image: cv2's 2x2 average."""
    img = np.random.default_rng(9).integers(0, 256, (1024, 1280, 3),
                                            np.uint8)
    want = cv2.resize(img, (640, 512), interpolation=cv2.INTER_LINEAR)
    assert np.array_equal(gi.resize_linear(img, 640, 512), want)


@pytest.mark.parametrize("ch", [1, 3])
def test_imwrite_png_read_back_by_cv2(tmp_path, ch):
    img = np.random.default_rng(ch).integers(
        0, 256, (H, W, 3) if ch == 3 else (H, W), np.uint8)
    p = tmp_path / "w.png"
    gi.imwrite_png(p, img)
    assert np.array_equal(cv2.imread(str(p), cv2.IMREAD_UNCHANGED), img)
    _same_reads(p)


def exif_tiff(orientation: int, order: str = "II") -> bytes:
    """An EXIF block (TIFF header, IFD0 of one SHORT entry: tag 0x0112)."""
    e = "<" if order == "II" else ">"
    return (order.encode() + struct.pack(e + "HIH", 42, 8, 1)
            + struct.pack(e + "HHIH", 0x0112, 3, 1, orientation) + b"\0\0"
            + struct.pack(e + "I", 0))


def jpeg_with_app1(jpg: bytes, payload: bytes) -> bytes:
    """jpg with an APP1 segment holding payload right after SOI."""
    return (jpg[:2] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2)
            + payload + jpg[2:])


def _write_for_jax_parity(p, img):
    """img (H, W, 3) BGR written as the file name says: cv2's PNG, BMP,
    baseline or progressive JPEG, an Adam7 PNG (the writer above), or a
    baseline JPEG with EXIF orientation 6."""
    name = p.name
    if "progressive" in name:
        cv2.imwrite(str(p), img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    elif "adam7" in name:
        p.write_bytes(_png(img[:, :, ::-1], 2, 8, (0, 1, 2, 3, 4),
                           interlace=1))
    elif "exif6" in name:
        jpg = cv2.imencode(".jpg", img)[1].tobytes()
        p.write_bytes(jpeg_with_app1(jpg, b"Exif\0\0" + exif_tiff(6)))
    else:
        cv2.imwrite(str(p), img)


@pytest.mark.parametrize("name", ["a.png", "b.bmp", "c.jpg",
                                  "d_progressive.jpg", "e_adam7.png",
                                  "f_exif6.jpg"])
def test_load_gray_image_matches_jax(tmp_path, name):
    """The frontend's decode + resize, as the JAX package's (cv2) loads it,
    at the deployment's 2:1 and at another size; an EXIF-oriented file is
    turned before the resize, as cv2.imread turns it."""
    img = np.random.default_rng(4).integers(0, 256, (64, 96, 3), np.uint8)
    p = tmp_path / name
    _write_for_jax_parity(p, img)
    if "exif6" in name:
        assert gi.imread_gray(p).shape == (96, 64)
    for w, h in ((48, 32), (70, 45), (96, 64)):
        got = psf.load_gray_image(p, w, h)
        want = jsf.load_gray_image(p, w, h)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _splice_sof(jpg: bytes, marker: int, precision=8, ncomp=None) -> bytes:
    """jpg with its SOF0 segment rewritten: another SOF marker, precision
    or component count (extra components copy the last one's fields; with
    fewer, the scan names only the frame's)."""
    k = jpg.index(b"\xff\xc0")
    n = struct.unpack(">H", jpg[k + 2:k + 4])[0]
    body = bytearray(jpg[k + 4:k + 2 + n])
    body[0] = precision
    comps = [bytes(body[6 + 3 * c:9 + 3 * c]) for c in range(body[5])]
    if ncomp is not None:
        comps = (comps + [bytes([9 + c]) + comps[-1][1:]
                          for c in range(ncomp)])[:ncomp]
    body = bytes(body[:5]) + bytes([len(comps)]) + b"".join(comps)
    rest = jpg[k + 2 + n:]
    s = rest.index(b"\xff\xda")
    ns = rest[s + 4]
    if len(comps) < ns:
        scan = (bytes([len(comps)]) + rest[s + 5:s + 5 + 2 * len(comps)]
                + rest[s + 5 + 2 * ns:s + 8 + 2 * ns])
        rest = (rest[:s + 2] + struct.pack(">H", len(scan) + 2) + scan
                + rest[s + 8 + 2 * ns:])
    return (jpg[:k] + bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2)
            + body + rest)


OUT_OF_SCOPE = [
    (0xC5, 8, None, "hierarchical JPEG"),
    (0xC0, 12, None, "12-bit JPEG"),
    (0xC0, 8, 2, "2 components"),
]


def test_unsupported_inputs_raise(tmp_path):
    """The JPEG formats cv2 reads nothing of raise ValueError by name (made
    by splicing the SOF marker of a cv2 JPEG), as does a JPEG cut inside
    its header; one cut inside its scan reads as cv2 reads it (libjpeg's
    fake EOI); an unknown format, a cut PNG and a missing file raise."""
    img = np.random.default_rng(2).integers(0, 256, (16, 24, 3), np.uint8)
    jpg = cv2.imencode(".jpg", img)[1].tobytes()
    spliced = tmp_path / "x.jpg"
    for marker, precision, ncomp, match in OUT_OF_SCOPE:
        spliced.write_bytes(_splice_sof(jpg, marker, precision, ncomp))
        with pytest.raises(ValueError, match=match):
            gi.imread_color(spliced)
        with pytest.raises(ValueError, match=match):
            psf.load_gray_image(spliced, 24, 16)
    cut = tmp_path / "cut.jpg"
    sos = jpg.index(b"\xff\xda")
    for end in (sos // 2, sos + 4):
        cut.write_bytes(jpg[:end])
        assert cv2.imread(str(cut), cv2.IMREAD_GRAYSCALE) is None
        with pytest.raises(ValueError, match="JPEG"):
            gi.imread_gray(cut)
    for end in ((sos + len(jpg)) // 2, len(jpg) - 40, len(jpg) - 2):
        cut.write_bytes(jpg[:end])
        assert np.array_equal(gi.imread_gray(cut), cv2.imread(
            str(cut), cv2.IMREAD_GRAYSCALE))
    other = tmp_path / "o.gif"
    other.write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="unknown image format"):
        gi.imread_gray(other)
    bad = tmp_path / "f.png"
    bad.write_bytes(_png(np.zeros((4, 4, 1), np.uint8), 0, 8)
                    .replace(b"IDAT", b"IDAT", 1)[:-20])
    with pytest.raises(ValueError):
        gi.imread_gray(bad)
    with pytest.raises(FileNotFoundError):
        gi.imread_gray(tmp_path / "missing.png")


def test_png_unfilter_bad_filter_type_raises():
    raw = np.zeros(2 * 5, np.uint8)
    raw[5] = 7
    with pytest.raises(ValueError, match="filter type"):
        gi.png_unfilter(raw, 2, 4, 1)
