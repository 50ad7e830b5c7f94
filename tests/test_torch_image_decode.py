"""The port's JPEG decoder and Adam7 / EXIF handling (io/image.py and the
native library's lvba_jpeg_info / lvba_jpeg_decode) against cv2.imread on
the CPU, bit for bit with tolerance 0: every cv2.imencode(".jpg") variant
of this cv2 (sampling 4:1:1, 4:2:0, 4:2:2, 4:4:0, 4:4:4; quality 50, 95,
100; progressive, optimized Huffman tables, restart intervals 1 and 3,
progressive with restarts; one component) at 1 x 1, 2 x 2, 7 x 5, 17 x 9, 33 x 65 and 640 x 512; the
colour space markers (Adobe APP14 transform 0 and 1, 'R', 'G', 'B'
component ids without JFIF); 16-bit DQT entries and a stream without DHT;
the EXIF orientations 1-8 in both byte orders on JPEG and PNG, and the
blocks cv2 ignores; Adam7 PNG of every colour type and depth; the
committed fixtures (tests/data/images, scripts/make_image_fixtures.py);
decodes on several threads at once."""

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from global_lvba_tpu_torch.io import image as gi
from png_writer import png as _png
from test_torch_image import (
    CASES, CHANNELS, exif_tiff, jpeg_with_app1)

FIXTURES = Path(__file__).resolve().parent / "data" / "images"
SIZES = [(1, 1), (2, 2), (7, 5), (17, 9), (33, 65)]
SAMPLING = {
    "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
}
# each writer variant's Y sampling (h, v); Cb and Cr are 1 x 1
Y_SAMPLING = {"411": (4, 1), "420": (2, 2), "422": (2, 1), "440": (1, 2),
              "444": (1, 1)}
MODES = {
    "baseline": [],
    "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
    "optimize": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
    "rst1": [cv2.IMWRITE_JPEG_RST_INTERVAL, 1],
    "rst3": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
    "progressive_rst2": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                         cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(h, w, seed):
    """Noise over a smooth colour field: flat areas, edges and texture."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([128 + 100 * np.sin(x / 6 + y / 9),
                     128 + 100 * np.cos(x / 4 - y / 7),
                     (x * 5 + y * 3) % 256], -1)
    return np.clip(base + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(
        np.uint8)


def _same_reads(path):
    """imread_gray / imread_color of path equal cv2.imread's bit for bit."""
    for flag, read in ((cv2.IMREAD_GRAYSCALE, gi.imread_gray),
                       (cv2.IMREAD_COLOR, gi.imread_color)):
        want = cv2.imread(str(path), flag)
        assert want is not None
        got = read(path)
        assert got.dtype == np.uint8 and got.shape == want.shape, path.name
        assert np.array_equal(got, want), path.name


def _jpeg(img, *flags) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, list(flags))
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("quality", [50, 95, 100])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_cv2_jpeg_variants(tmp_path, sampling, quality, mode):
    """Each writer variant at every small size: partial MCUs, the
    downsampled width <= 2 branches (replication) and the fancy ones."""
    p = tmp_path / "v.jpg"
    for k, (h, w) in enumerate(SIZES):
        p.write_bytes(_jpeg(_image(h, w, k), cv2.IMWRITE_JPEG_QUALITY,
                            quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                            SAMPLING[sampling], *MODES[mode]))
        _same_reads(p)
    info = gi.jpeg_info(p.read_bytes())
    assert info["format"] == ("progressive" if "progressive" in mode
                              else "baseline")
    assert info["color_space"] == "YCbCr" and info["components"] == 3
    assert info["sampling"] == (Y_SAMPLING[sampling], (1, 1), (1, 1))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_cv2_jpeg_640x512(tmp_path, sampling, mode):
    p = tmp_path / "l.jpg"
    p.write_bytes(_jpeg(_image(512, 640, 9), cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                        SAMPLING[sampling], *MODES[mode]))
    _same_reads(p)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("quality", [50, 95, 100])
def test_gray_jpeg(tmp_path, quality, mode):
    """One-component JPEGs: the gray read is the plane, the colour read
    gray_rgb_convert's copies."""
    p = tmp_path / "g.jpg"
    for k, (h, w) in enumerate(SIZES + [(512, 640)]):
        p.write_bytes(_jpeg(_image(h, w, k)[:, :, 1], cv2.IMWRITE_JPEG_QUALITY,
                            quality, *MODES[mode]))
        _same_reads(p)
    assert gi.jpeg_info(p.read_bytes())["color_space"] == "gray"


def _segments(jpg: bytes):
    """(SOI, [(marker, segment bytes)] up to the first SOS, the rest)."""
    out, p = [], 2
    while jpg[p + 1] != 0xDA:
        n = struct.unpack(">H", jpg[p + 2:p + 4])[0]
        out.append((jpg[p + 1], jpg[p:p + 2 + n]))
        p += 2 + n
    return jpg[:2], out, jpg[p:]


def _respliced(jpg: bytes, jfif=True, adobe=None, ids=None) -> bytes:
    """jpg with its JFIF APP0 kept or dropped, an Adobe APP14 with the
    given transform added, and its component ids replaced (SOF and SOS)."""
    soi, segs, rest = _segments(jpg)
    out = soi
    if adobe is not None:
        body = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, adobe])
        out += b"\xff\xee" + struct.pack(">H", len(body) + 2) + body
    for m, s in segs:
        if m == 0xE0 and not jfif:
            continue
        if m == 0xC0 and ids:
            s = bytearray(s)
            for c in range(3):
                s[10 + 3 * c] = ids[c]
            s = bytes(s)
        out += s
    if ids:
        rest = bytearray(rest)
        for c in range(3):
            rest[5 + 2 * c] = ids[c]
        rest = bytes(rest)
    return out + rest


@pytest.mark.parametrize("case,space", [
    (dict(adobe=0), "YCbCr"),                      # JFIF comes first
    (dict(jfif=False, adobe=0), "RGB"),
    (dict(jfif=False, adobe=1), "YCbCr"),
    (dict(jfif=False, ids=b"RGB"), "RGB"),
    (dict(ids=b"RGB"), "YCbCr"),
    (dict(jfif=False, ids=b"\x05\x06\x07"), "YCbCr"),
    (dict(jfif=False), "YCbCr"),
])
@pytest.mark.parametrize("sampling", ["420", "444"])
def test_color_space_markers(tmp_path, case, space, sampling):
    """The colour space as libjpeg picks it: a JFIF marker means YCbCr,
    Adobe transform 0 RGB and 1 YCbCr, else ids 'R' 'G' 'B' mean RGB; an
    RGB file is copied (colour) or weighted by rgb_gray_convert (gray)."""
    p = tmp_path / "c.jpg"
    for k, (h, w) in enumerate(SIZES):
        p.write_bytes(_respliced(_jpeg(_image(h, w, k),
                                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                       SAMPLING[sampling]), **case))
        _same_reads(p)
        assert gi.jpeg_info(p.read_bytes())["color_space"] == space


def test_dqt_16_bit_and_no_dht(tmp_path):
    """A DQT of 16-bit entries (the same values) and a stream with its DHT
    segments removed (libjpeg-turbo starts from the Annex K tables, which
    cv2's writer uses) read as cv2 reads them."""
    jpg = _jpeg(_image(37, 45, 3))
    soi, segs, rest = _segments(jpg)
    wide = b""
    for m, s in segs:
        if m == 0xDB:
            body, k, out = s[4:], 0, b""
            while k < len(body):
                t = body[k]
                out += bytes([0x10 | t]) + np.frombuffer(
                    body[k + 1:k + 65], np.uint8).astype(">u2").tobytes()
                k += 65
            s = b"\xff\xdb" + struct.pack(">H", len(out) + 2) + out
        wide += s
    p = tmp_path / "q.jpg"
    p.write_bytes(soi + wide + rest)
    _same_reads(p)
    assert np.array_equal(gi.imread_color(p), cv2.imdecode(
        np.frombuffer(jpg, np.uint8), cv2.IMREAD_COLOR))
    p.write_bytes(soi + b"".join(s for m, s in segs if m != 0xC4) + rest)
    _same_reads(p)


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("order", ["II", "MM"])
@pytest.mark.parametrize("container", ["png", "jpeg"])
def test_exif_orientation_matches_cv2(tmp_path, orientation, order,
                                      container):
    """cv2.imread's EXIF orientation (IMREAD_COLOR and IMREAD_GRAYSCALE),
    from a PNG's eXIf chunk or a JPEG's APP1: 2 flip horizontally, 3
    rotate 180 degrees, 4 flip vertically, 5 transpose, 6 rotate 90
    degrees clockwise, 7 transverse, 8 rotate 90 degrees counter-
    clockwise."""
    img = _image(6, 10, orientation)
    tiff = exif_tiff(orientation, order)
    p = tmp_path / f"o.{container}"
    if container == "png":
        p.write_bytes(_png(img[:, :, ::-1], 2, 8, (0, 4), exif=tiff))
    else:
        p.write_bytes(jpeg_with_app1(_jpeg(img), b"Exif\0\0" + tiff))
    _same_reads(p)
    turned = orientation >= 5
    assert gi.imread_gray(p).shape == ((10, 6) if turned else (6, 10))
    if container == "png":
        want = {1: img, 2: img[:, ::-1], 3: img[::-1, ::-1], 4: img[::-1],
                5: img.swapaxes(0, 1), 6: np.rot90(img, -1),
                7: np.rot90(img, -1)[::-1], 8: np.rot90(img, 1)}[orientation]
        assert np.array_equal(gi.imread_color(p), want)
    # the depth-PNG reader (IMREAD_UNCHANGED in the JAX package) keeps the
    # stored orientation
    if container == "png":
        assert gi.read_png(p.read_bytes())[0].shape[:2] == (6, 10)


def _ifd(entries, order="II", off=8):
    e = "<" if order == "II" else ">"
    body = order.encode() + struct.pack(e + "HI", 42, off)
    body += bytes(off - 8) + struct.pack(e + "H", len(entries))
    for tag, typ, cnt, val in entries:
        body += struct.pack(e + "HHI", tag, typ, cnt) + val
    return body + bytes(4)


_L = struct.Struct("<I").pack
_S6, _S3 = struct.pack("<HH", 6, 0), struct.pack("<HH", 3, 0)
EXIF_EDGES = {
    # (block, the orientation cv2 applies)
    "orientation 0": (exif_tiff(0), 1),
    "orientation 9": (exif_tiff(9), 1),
    "LONG 6 little-endian": (_ifd([(0x112, 4, 1, _L(6))]), 6),
    "LONG 6 big-endian": (_ifd([(0x112, 4, 1, struct.pack(">I", 6))],
                               "MM"), 1),
    "BYTE type, count 0": (_ifd([(0x112, 1, 0, _S6)]), 6),
    "tag mark 43": (b"II" + struct.pack("<HI", 43, 8) + exif_tiff(6)[8:], 1),
    "byte order IM": (b"IM" + exif_tiff(6)[2:], 1),
    "no entries": (_ifd([]), 1),
    "IFD0 at 12": (_ifd([(0x112, 3, 1, _S6)], off=12), 6),
    "IFD0 past the end": (b"II" + struct.pack("<HI", 42, 4000)
                          + exif_tiff(6)[8:], 1),
    "cut in the value": (exif_tiff(6)[:19], 1),
    "cut after the value": (exif_tiff(6)[:20], 6),
    "more entries than written": (exif_tiff(6)[:8] + b"\x05\x00"
                                  + exif_tiff(6)[10:22], 6),
    "two orientations, the first kept": (
        _ifd([(0x112, 3, 1, _S6), (0x112, 3, 1, _S3)]), 6),
    "a Make string past the end first": (
        _ifd([(0x10F, 2, 20, _L(1000)), (0x112, 3, 1, _S6)]), 1),
    "an XResolution past the end first": (
        _ifd([(0x11A, 5, 1, _L(1000)), (0x112, 3, 1, _S6)]), 1),
    "an XResolution past the end after": (
        _ifd([(0x112, 3, 1, _S6), (0x11A, 5, 1, _L(1000))]), 6),
    "an unknown tag past the end first": (
        _ifd([(0x9999, 7, 100, _L(5000)), (0x112, 3, 1, _S6)]), 6),
    "an Exif IFD pointer first": (
        _ifd([(0x8769, 4, 1, _L(1000)), (0x112, 3, 1, _S6)]), 6),
}


@pytest.mark.parametrize("case", list(EXIF_EDGES))
def test_exif_blocks_cv2_ignores_or_applies(tmp_path, case):
    """Missing, malformed, cut or out-of-range orientation tags: the port
    applies exactly what cv2 applies, in PNG and JPEG."""
    tiff, want = EXIF_EDGES[case]
    assert gi.exif_orientation(tiff) == want
    img = _image(6, 10, 1)
    p = tmp_path / "e.png"
    p.write_bytes(_png(img[:, :, ::-1], 2, 8, exif=tiff))
    if tiff[:2] in (b"II", b"MM"):   # libpng drops any other eXIf
        _same_reads(p)
    q = tmp_path / "e.jpg"
    q.write_bytes(jpeg_with_app1(_jpeg(img), b"Exif\0\0" + tiff))
    _same_reads(q)
    assert gi.jpeg_info(q.read_bytes())["orientation"] == want


def test_exif_app1_choice(tmp_path):
    """cv2 takes the first APP1 that begins with Exif\\0\\0 (an XMP APP1
    before it is passed over; a second Exif APP1 is not read), and a PNG's
    first eXIf chunk, before or after IDAT."""
    img = _image(6, 10, 2)
    xmp = b"http://ns.adobe.com/xap/1.0/\0<x/>"
    q = tmp_path / "a.jpg"
    for payloads in ([xmp, b"Exif\0\0" + exif_tiff(6)],
                     [b"Exif\0\0" + exif_tiff(3), b"Exif\0\0" + exif_tiff(6)],
                     [b"Exiq\0\0" + exif_tiff(6)], [exif_tiff(6)]):
        jpg = _jpeg(img)
        for pl in reversed(payloads):
            jpg = jpeg_with_app1(jpg, pl)
        q.write_bytes(jpg)
        _same_reads(q)
    png = _png(img[:, :, ::-1], 2, 8)
    k = png.index(b"IEND") - 4
    chunk = (struct.pack(">I", 26) + b"eXIf" + exif_tiff(6)
             + struct.pack(">I", zlib.crc32(b"eXIf" + exif_tiff(6))))
    p = tmp_path / "a.png"
    p.write_bytes(png[:k] + chunk + png[k:])
    _same_reads(p)
    assert gi.imread_gray(p).shape == (10, 6)


ADAM7_SIZES = [(1, 1), (2, 3), (5, 1), (1, 9), (9, 17), (23, 37)]


@pytest.mark.parametrize("color,depth", CASES)
def test_adam7_every_type_and_depth(tmp_path, color, depth):
    """Adam7 PNGs of every colour type and depth, at sizes whose passes
    are empty (1 x 1, 2 x 3, 5 x 1, 1 x 9) and full, under every row
    filter: cv2.imread's pixels bit for bit."""
    rng = np.random.default_rng(color * 100 + depth)
    top = (1 << depth) if color != 3 else min(1 << depth, 200)
    plte = rng.integers(0, 256, (top, 3)) if color == 3 else None
    p = tmp_path / "i.png"
    for h, w in ADAM7_SIZES:
        s = rng.integers(0, top, (h, w, CHANNELS[color]))
        for filters in ((0,), (1, 2), (3, 4), (0, 1, 2, 3, 4)):
            p.write_bytes(_png(s, color, depth, filters, plte, interlace=1))
            _same_reads(p)
            plain = tmp_path / "p.png"
            plain.write_bytes(_png(s, color, depth, filters, plte))
            assert np.array_equal(gi.read_png(p.read_bytes())[0],
                                  gi.read_png(plain.read_bytes())[0])


def test_adam7_png_cut_short_raises(tmp_path):
    s = np.zeros((9, 9, 3), np.uint8)
    data = _png(s, 2, 8, interlace=1)
    k = data.index(b"IDAT")
    n = struct.unpack(">I", data[k - 4:k])[0]
    body = zlib.compress(zlib.decompress(
        data[k + 4:k + 4 + n] + data[data.index(b"IDAT", k + 4) + 4:
                                     data.index(b"IEND") - 8])[:-5])
    cut = (data[:k - 4] + struct.pack(">I", len(body)) + b"IDAT" + body
           + struct.pack(">I", zlib.crc32(b"IDAT" + body))
           + data[data.index(b"IEND") - 4:])
    p = tmp_path / "c.png"
    p.write_bytes(cut)
    with pytest.raises(ValueError, match="PNG data"):
        gi.imread_gray(p)


# the fixtures cv2 reads in no mode (scripts/make_image_fixtures.py)
UNREADABLE_FIXTURES = ("filter64.png",)


@pytest.mark.parametrize("name", sorted(
    p.name for p in FIXTURES.glob("*") if p.suffix in (".jpg", ".png",
                                                       ".bmp")))
def test_committed_fixtures(name):
    """The committed files decode to the committed cv2 decodes (which
    chip_smoke.py holds the port to on a machine without cv2) and to this
    cv2's, colour, gray and unchanged; where cv2 reads a file one way only
    (a lossless JPEG), the port raises the other way, and where cv2 reads
    it in no way (filter64.png), the port raises in every way."""
    ref = np.load(FIXTURES / "decodes.npz")
    p = FIXTURES / name
    for kind, read, flag in (
            ("color", gi.imread_color, cv2.IMREAD_COLOR),
            ("gray", gi.imread_gray, cv2.IMREAD_GRAYSCALE),
            ("unchanged", gi.imread_unchanged, cv2.IMREAD_UNCHANGED)):
        key = f"{name}:{kind}"
        if key in ref.files:
            got = read(p)
            assert got.dtype == ref[key].dtype
            assert np.array_equal(got, ref[key])
            assert np.array_equal(got, cv2.imread(str(p), flag))
        else:
            assert cv2.imread(str(p), flag) is None
            with pytest.raises(ValueError):
                read(p)
    assert any(k.startswith(name + ":") for k in ref.files) == (
        name not in UNREADABLE_FIXTURES)


def test_decodes_on_threads_agree(tmp_path):
    """The decoder holds no state between calls: 16 decodes on 8 threads
    (ctypes lets go of the GIL) equal the serial ones."""
    paths = []
    for k in range(4):
        p = tmp_path / f"t{k}.jpg"
        p.write_bytes(_jpeg(_image(96, 128, k),
                            *MODES[list(MODES)[k % len(MODES)]]))
        paths.append(p)
    serial = [gi.imread_color(p) for p in paths]
    with ThreadPoolExecutor(8) as ex:
        par = list(ex.map(gi.imread_color, paths * 4))
    assert all(np.array_equal(a, serial[k % 4]) for k, a in enumerate(par))


def _dht(tc_th: int, counts, values) -> bytes:
    """A DHT segment of one table: counts[l - 1] codes of length l."""
    body = bytes([tc_th]) + bytes(list(counts) + [0] * (16 - len(counts)))
    body += bytes(values)
    return b"\xff\xc4" + struct.pack(">H", len(body) + 2) + body


def test_jpeg_damage_reads_as_cv2(tmp_path):
    """Where libjpeg warns and goes on, the port reads what cv2 reads, bit
    for bit, colour and gray: data cut in the scan (an EOI appended), a
    restart marker removed, an EOI missing, bytes of the scan changed into
    codes outside the Huffman table.  A Huffman table whose codes do not
    fit their lengths (3 codes of 1 bit, 255 codes of 1 bit, an all-ones
    code of 1 bit) stops libjpeg where a scan uses it: cv2 reads nothing
    and the port raises before its lookahead table is filled.  Where the
    file's own DHT replaces it before the scan, both read the file
    alike."""
    jpg = _jpeg(_image(33, 65, 5), cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    p = tmp_path / "d.jpg"
    k = jpg.index(b"\xff\xd0")
    cases = [jpg[:len(jpg) // 2] + b"\xff\xd9",
             jpg[:k] + jpg[k + 2:],
             jpg[:-2],
             jpg[:len(jpg) - 40] + b"\xff\x00" * 8 + jpg[-2:]]
    for data in cases:
        p.write_bytes(data)
        _same_reads(p)
    for dht in (_dht(0x00, [3], [0, 1, 2]),
                _dht(0x10, [255], range(255)),
                _dht(0x01, [2, 1], [0, 1, 2])):
        sos = jpg.index(b"\xff\xda")
        p.write_bytes(jpg[:sos] + dht + jpg[sos:])
        assert cv2.imread(str(p), cv2.IMREAD_COLOR) is None
        for read in (gi.imread_color, gi.imread_gray):
            with pytest.raises(ValueError, match="bad JPEG Huffman table"):
                read(p)
        p.write_bytes(jpg[:2] + dht + jpg[2:])
        _same_reads(p)


def test_marker_segments_libjpeg_skips(tmp_path):
    """A COM segment, 0xFF fill bytes before a marker and a DNL segment
    after the scan (libjpeg skips it) read as cv2 reads them."""
    jpg = _jpeg(_image(33, 65, 6))
    p = tmp_path / "m.jpg"
    for data in (jpg[:2] + b"\xff\xfe\x00\x05abc" + b"\xff\xff\xff" + jpg[2:],
                 jpg[:-2] + b"\xff\xdc\x00\x04\x00\x21" + jpg[-2:]):
        p.write_bytes(data)
        _same_reads(p)


def test_unrefined_progressive_smoothed_as_cv2(tmp_path):
    """A progressive file cut after any of its scans but the last (an EOI
    appended) leaves AC coefficients unrefined, which libjpeg smooths
    across blocks (jdcoefct.c decompress_smooth_data): the port reads
    each cut as cv2 does."""
    jpg = _jpeg(_image(33, 65, 7), *MODES["progressive"])
    starts = [k for k in range(len(jpg) - 1) if jpg[k:k + 2] == b"\xff\xda"]
    assert len(starts) == 10
    p = tmp_path / "u.jpg"
    for k in starts[1:]:
        p.write_bytes(jpg[:k] + b"\xff\xd9")
        _same_reads(p)
