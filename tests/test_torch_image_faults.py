"""The last image faults of the port against cv2.imread 5.0 (libpng 1.6.58,
libjpeg-turbo 3.1.2) on the CPU, bit for bit (tolerance 0), in the three
read modes (colour, gray, unchanged), or refused by both: cv2's None is the
port's ValueError, cv2's cv2.error past its size limit the port's
ImageSizeError.

  * C9: the gray read of a colour PNG (RGB, RGBA, palette; 8 and 16 bits)
    that states a gamma: gAMA, sRGB (each rendering intent), with and
    without cHRM and iCCP, where they count (before PLTE and IDAT, the
    first valid one), sBIT's gamma shift at 16 bits, a suggested palette
    in an RGB image; libpng's tables on every colour of 2^18 and on every
    16-bit gray level.
  * C10: IHDR fields libpng's png_check_IHDR refuses (every byte of the
    header at 17 values, on five sources).
  * C11: the planes field of an OS/2 BMP, which cv2 does not read; cv2's
    size limit on header-only files of each format just inside and just
    outside it, raised before the port allocates pixels or inflates data;
    imread_color_or_none lets it through (a match-image export that stops
    there in both packages: tests/test_torch_sift_frontend.py).
  * C12: imread_unchanged on every PNG colour type and depth with and
    without tRNS, BMP palettes (gray and colour), OS/2, bit fields and
    alpha masks, and JPEG.
Each case is one test (its source and mutation in its id); the whole file
runs in ~10 s on one worker."""

import struct
import tracemalloc
import zlib

import cv2
import numpy as np
import pytest
import torch

import bmp_writer as bw
import jpeg_writer as jw
from global_lvba_tpu_torch.io import image as gi
from png_writer import chunk, png


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


READS = ((cv2.IMREAD_COLOR, gi.imread_color),
         (cv2.IMREAD_GRAYSCALE, gi.imread_gray),
         (cv2.IMREAD_UNCHANGED, gi.imread_unchanged))


def _outcome(read, *args):
    """The image, "none" (cv2's None, the port's ValueError) or "size"
    (cv2.error, ImageSizeError)."""
    try:
        img = read(*args)
    except (cv2.error, gi.ImageSizeError):
        return "size"
    except ValueError:
        return "none"
    return "none" if img is None else img


def _as_cv2(path, what=""):
    """The three reads of path equal cv2's, or both refuse alike."""
    for flag, read in READS:
        want = _outcome(cv2.imread, str(path), flag)
        got = _outcome(read, path)
        if isinstance(want, str) or isinstance(got, str):
            assert isinstance(got, str) and got == want, (what, flag, got)
        else:
            assert got.dtype == want.dtype and got.shape == want.shape, (
                what, flag)
            assert np.array_equal(got, want), (what, flag)


def _insert(data: bytes, chunks, after=b"IHDR") -> bytes:
    """data with chunks (bytes) inserted after its first chunk of type
    `after` (b"IDAT": after the last IDAT)."""
    pos, ends = 8, {}
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        pos += 12 + n
        ends.setdefault(tag, pos)
        if tag == b"IDAT":
            ends[tag] = pos
    at = ends[after]
    return data[:at] + b"".join(chunks) + data[at:]


def _gama(v):
    return chunk(b"gAMA", struct.pack(">I", v))


def _srgb(intent):
    return chunk(b"sRGB", bytes([intent]))


def _sbit(*v):
    return chunk(b"sBIT", bytes(v))


CHRM = chunk(b"cHRM", struct.pack(">8I", 31270, 32900, 64000, 33000, 30000,
                                  60000, 15000, 6000))
# an iCCP chunk whose (empty) profile is not sRGB's
ICCP = chunk(b"iCCP", b"not sRGB\0\0" + zlib.compress(bytes(132)))


def _bad_crc(c: bytes) -> bytes:
    return c[:-1] + bytes([c[-1] ^ 1])


# ---------------------------------------------------------------------------
# C9: libpng's gamma in the gray read


def _samples(seed, h, w, ch, depth):
    """Random samples whose first rows have equal R, G and B (libpng's
    gamma_table path) and whose next rows differ in one channel by one."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << depth, (h, w, ch))
    if ch >= 3:
        a[:3, :, 1] = a[:3, :, 2] = a[:3, :, 0]
        a[3:5, :, 1] = a[3:5, :, 0]
        a[3:5, :, 2] = a[3:5, :, 0] ^ 1
    return a


GAMMA_SOURCES = {
    "rgb8": lambda: png(_samples(1, 24, 20, 3, 8), 2, 8, (0, 4)),
    "rgb16": lambda: png(_samples(2, 24, 20, 3, 16), 2, 16, (0, 1)),
    "rgba8": lambda: png(_samples(3, 24, 20, 4, 8), 6, 8, (0, 2)),
    "rgba16": lambda: png(_samples(4, 24, 20, 4, 16), 6, 16, (0, 3)),
    "palette8": lambda: png(
        _samples(5, 24, 20, 1, 8), 3, 8,
        plte=np.random.default_rng(6).integers(0, 256, (256, 3))),
    "palette4_trns": lambda: png(
        _samples(7, 24, 20, 1, 4), 3, 4,
        plte=np.random.default_rng(8).integers(0, 256, (16, 3)),
        trns=bytes([0, 128, 255])),
    "rgb8_adam7": lambda: png(_samples(9, 24, 20, 3, 8), 2, 8, (0, 1, 2),
                              interlace=1),
}
GAMMA_CHUNKS = {
    "gAMA45455": [_gama(45455)],
    "gAMA22000": [_gama(22000)],
    "gAMA100500": [_gama(100500)],  # inside libpng's 5% threshold
    "gAMA0": [_gama(0)],
    "sRGB0": [_srgb(0)],
    "sRGB1": [_srgb(1)],
    "sRGB2": [_srgb(2)],
    "sRGB3": [_srgb(3)],
    "sRGB_gAMA22000": [_srgb(0), _gama(22000)],
    "gAMA22000_sRGB": [_gama(22000), _srgb(2)],
    "cHRM": [CHRM],
    "cHRM_gAMA45455": [CHRM, _gama(45455)],
    "iCCP": [ICCP],
    "iCCP_gAMA22000": [ICCP, _gama(22000)],
}


@pytest.mark.parametrize("chunks", list(GAMMA_CHUNKS))
@pytest.mark.parametrize("source", list(GAMMA_SOURCES))
def test_png_gamma_reads_as_cv2(tmp_path, source, chunks):
    p = tmp_path / "g.png"
    p.write_bytes(_insert(GAMMA_SOURCES[source](), GAMMA_CHUNKS[chunks]))
    _as_cv2(p, (source, chunks))


def test_png_gamma_changes_the_gray_read(tmp_path):
    """The fault itself: under gAMA 45455 most gray pixels differ from the
    plain weights', and the port follows cv2 there."""
    base = GAMMA_SOURCES["rgb8"]()
    p, q = tmp_path / "g.png", tmp_path / "plain.png"
    p.write_bytes(_insert(base, [_gama(45455)]))
    q.write_bytes(base)
    g, plain = gi.imread_gray(p), gi.imread_gray(q)
    assert np.mean(g != plain) > 0.5
    assert np.array_equal(g, cv2.imread(str(p), cv2.IMREAD_GRAYSCALE))


# where gAMA, sRGB and sBIT count: (chunks after IHDR, after the palette,
# after the last IDAT) on RGB16 and a palette image
GAMMA_RULES = {
    "gAMA_after_PLTE": ([], [_gama(22000)], []),
    "sRGB_after_PLTE": ([], [_srgb(0)], []),
    "gAMA_after_IDAT": ([], [], [_gama(22000)]),
    "gAMA_bad_crc": ([_bad_crc(_gama(22000))], [], []),
    "gAMA_bad_crc_then_gAMA": ([_bad_crc(_gama(50000)), _gama(22000)], [],
                               []),
    "gAMA_3_bytes_then_gAMA": ([chunk(b"gAMA", b"\0\0\1"), _gama(22000)],
                               [], []),
    "gAMA_5_bytes": ([chunk(b"gAMA", struct.pack(">IB", 22000, 0))], [],
                     []),
    "gAMA_2^31_then_gAMA": ([_gama(1 << 31), _gama(50000)], [], []),
    "gAMA_twice": ([_gama(22000), _gama(50000)], [], []),
    "gAMA0_then_gAMA": ([_gama(0), _gama(50000)], [], []),
    "gAMA0_sRGB": ([_gama(0), _srgb(0)], [], []),
    "gAMA1": ([_gama(1)], [], []),
    "gAMA_2^31-1": ([_gama((1 << 31) - 1)], [], []),
    "gAMA94999": ([_gama(94999)], [], []),
    "gAMA95001": ([_gama(95001)], [], []),  # its screen gamma counts
    "gAMA105001": ([_gama(105001)], [], []),
    "sRGB4_gAMA": ([_srgb(4), _gama(22000)], [], []),
    "sRGB_2_bytes_sRGB": ([chunk(b"sRGB", b"\0\0"), _srgb(0)], [], []),
    "sRGB_twice": ([_srgb(0), _srgb(3)], [], []),
    "sBIT9": ([_sbit(9, 9, 9), _gama(45455)], [], []),
    "sBIT_9_10_4": ([_gama(45455), _sbit(9, 10, 4)], [], []),
    "sBIT3": ([_sbit(3, 3, 3), _gama(22000)], [], []),
    "sBIT0": ([_sbit(0, 9, 9), _gama(45455)], [], []),
    "sBIT17": ([_sbit(17, 9, 9), _gama(45455)], [], []),
    "sBIT_2_bytes": ([_sbit(9, 9), _gama(45455)], [], []),
    "sBIT_twice": ([_sbit(9, 9, 9), _sbit(12, 12, 12), _gama(45455)], [],
                   []),
    "sBIT_after_IDAT": ([_gama(45455)], [], [_sbit(9, 9, 9)]),
}


@pytest.mark.parametrize("source", ["rgb16", "palette8"])
@pytest.mark.parametrize("case", list(GAMMA_RULES))
def test_png_gamma_chunk_rules(tmp_path, case, source):
    head, after_plte, after_idat = GAMMA_RULES[case]
    data = _insert(GAMMA_SOURCES[source](), head)
    if source == "palette8":
        data = _insert(data, after_plte, b"PLTE")
    elif after_plte:
        return  # no palette to follow
    p = tmp_path / "r.png"
    p.write_bytes(_insert(data, after_idat, b"IDAT"))
    _as_cv2(p, case)


@pytest.mark.parametrize("plte", ["3", "768", "bad_crc", "2", "771",
                                  "empty"])
@pytest.mark.parametrize("color", [2, 6])
def test_png_suggested_palette_before_gamma(tmp_path, plte, color):
    """A PLTE in an RGB or RGBA image: one of a valid length, whatever its
    CRC, stops a later gAMA from counting, one of a bad length is dropped,
    an empty one reads nothing."""
    body = {"3": bytes(3), "768": bytes(768), "bad_crc": bytes(6),
            "2": bytes(2), "771": bytes(771), "empty": b""}[plte]
    c = chunk(b"PLTE", body)
    if plte == "bad_crc":
        c = _bad_crc(c)
    ch = 3 if color == 2 else 4
    p = tmp_path / "s.png"
    p.write_bytes(_insert(png(_samples(10, 8, 8, ch, 16), color, 16),
                          [c, _gama(22000)]))
    _as_cv2(p, plte)


@pytest.mark.parametrize("gamma", [45455, 22000, 94999, 1, (1 << 31) - 1])
def test_png_gamma_8bit_tables(tmp_path, gamma):
    """2^18 colours of an 8-bit RGB image (every R and G, B in steps of
    85) through libpng's gamma_to_1 / gamma_from_1 tables."""
    v = np.arange(1 << 18)
    rgb = np.stack([v & 255, (v >> 8) & 255, ((v >> 16) & 3) * 85], -1)
    p = tmp_path / "t.png"
    p.write_bytes(_insert(png(rgb.reshape(512, 512, 3), 2, 8),
                          [_gama(gamma)]))
    assert np.array_equal(gi.imread_gray(p),
                          cv2.imread(str(p), cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("sbit", [0, 9, 12])
def test_png_gamma_16bit_tables(tmp_path, sbit):
    """Every 16-bit level as R = G = B (libpng 1.6.58's 16-to-8 table),
    with B one off and with G and B zero, under gAMA 45455 and sBIT."""
    v = np.arange(1 << 16).reshape(64, 1024)
    rgb = np.zeros((192, 1024, 3), np.int64)
    rgb[:64] = v[:, :, None]
    rgb[64:128, :, :2] = v[:, :, None]
    rgb[64:128, :, 2] = v ^ 1
    rgb[128:, :, 0] = v
    chunks = [_gama(45455)] + ([_sbit(sbit, sbit, sbit)] if sbit else [])
    p = tmp_path / "t16.png"
    p.write_bytes(_insert(png(rgb, 2, 16), chunks))
    assert np.array_equal(gi.imread_gray(p),
                          cv2.imread(str(p), cv2.IMREAD_GRAYSCALE))


# ---------------------------------------------------------------------------
# C10: libpng's IHDR checks


def _with_ihdr(data: bytes, body: bytes) -> bytes:
    return data[:8] + chunk(b"IHDR", body) + data[33:]


IHDR_SOURCES = {
    "gray8": lambda: png(_samples(11, 7, 9, 1, 8), 0, 8),
    "rgb8": lambda: png(_samples(12, 7, 9, 3, 8), 2, 8),
    "palette4": lambda: png(
        _samples(13, 7, 9, 1, 4), 3, 4,
        plte=np.random.default_rng(14).integers(0, 256, (16, 3))),
    "rgba16": lambda: png(_samples(15, 7, 9, 4, 16), 6, 16),
    "gray1_adam7": lambda: png(_samples(16, 7, 9, 1, 1), 0, 1,
                               interlace=1),
}
IHDR_VALUES = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 15, 16, 17, 64, 127, 128, 255)


@pytest.mark.parametrize("source", list(IHDR_SOURCES))
def test_png_ihdr_sweep(tmp_path, source):
    """Each of IHDR's 13 bytes set to each of 17 values, its CRC
    recomputed: the three reads as cv2's (the image, None or its size
    error)."""
    data = IHDR_SOURCES[source]()
    p = tmp_path / "i.png"
    for off in range(13):
        for v in IHDR_VALUES:
            body = bytearray(data[16:29])
            body[off] = v
            p.write_bytes(_with_ihdr(data, bytes(body)))
            _as_cv2(p, (source, off, v))


# fields libpng refuses that a reader without its checks takes: (width,
# height, compression, filter)
IHDR_REFUSED = {
    "height_0": (9, 0, 0, 0),
    "compression_1": (9, 7, 1, 0),
    "filter_1": (9, 7, 0, 1),
    "filter_64": (9, 7, 0, 64),
    "width_1000001": (1_000_001, 7, 0, 0),
    "height_1000001": (9, 1_000_001, 0, 0),
    "width_2^31": (1 << 31, 7, 0, 0),
}


@pytest.mark.parametrize("case", list(IHDR_REFUSED))
def test_png_ihdr_refused(tmp_path, case):
    W, H, comp, filt = IHDR_REFUSED[case]
    data = IHDR_SOURCES["rgb8"]()
    p = tmp_path / "i.png"
    p.write_bytes(_with_ihdr(data, struct.pack(">IIBBBBB", W, H, 8, 2, comp,
                                               filt, 0)))
    for flag, read in READS:
        assert cv2.imread(str(p), flag) is None
        with pytest.raises(ValueError, match="IHDR"):
            read(p)


# ---------------------------------------------------------------------------
# C11: the OS/2 planes field and cv2's size limit


@pytest.mark.parametrize("planes", [0, 2, 129, 255, 256, 0xFFFF])
def test_bmp_os2_planes_field_is_not_read(tmp_path, planes):
    from pathlib import Path

    data = bytearray((Path(__file__).parent / "data" / "images"
                      / "os2_4.bmp").read_bytes())
    data[22:24] = struct.pack("<H", planes)
    p = tmp_path / "o.bmp"
    p.write_bytes(bytes(data))
    assert cv2.imread(str(p), cv2.IMREAD_COLOR) is not None
    _as_cv2(p, planes)


@pytest.mark.parametrize("header", [40, 56, 108, 124])
def test_bmp_planes_field_under_larger_headers(tmp_path, header):
    data = bytearray(bw.bmp(_samples(17, 5, 7, 3, 8).astype(np.uint8), 24,
                            header=header))
    p = tmp_path / "b.bmp"
    for planes in (0, 2, 0xFFFF):
        data[26:28] = struct.pack("<H", planes)
        p.write_bytes(bytes(data))
        _as_cv2(p, (header, planes))


def _png_header(W, H, filt=0, idat=None):
    """Signature, IHDR (8-bit gray) and one IDAT of idat's zlib stream (a
    few zero bytes by default), then IEND."""
    z = zlib.compress(idat if idat is not None else bytes(16))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, filt, 0))
            + chunk(b"IDAT", z) + chunk(b"IEND", b""))


def _bmp_header(W, H):
    """The 54-byte header and a zero palette of an 8-bit BMP, no pixels."""
    off = 14 + 40 + 1024
    return (struct.pack("<2sIHHI", b"BM", off, 0, 0, off)
            + struct.pack("<IiiHHIIiiII", 40, W, H, 1, 8, 0, 0, 0, 0, 0, 0)
            + bytes(1024))


def _jpeg_header(W, H, tables=True, ncomp=3):
    """A cv2 JPEG of 16 x 16 (or two components from tests/jpeg_writer)
    with its frame size set to W x H; without its DQT segments when not
    tables (libjpeg refuses that only once decoding starts)."""
    if ncomp == 2:
        data = bytearray(jw.lossy([np.zeros((16, 16))] * 2, quality=90))
    else:
        data = bytearray(cv2.imencode(".jpg", np.zeros((16, 16, 3),
                                                       np.uint8))[1])
    k = data.index(b"\xff\xc0")
    data[k + 5:k + 9] = struct.pack(">HH", H, W)
    while not tables and b"\xff\xdb" in data:
        k = data.index(b"\xff\xdb")
        del data[k:k + 2 + struct.unpack(">H", data[k + 2:k + 4])[0]]
    return bytes(data)


# (file, the outcome in all three modes): just inside and just outside the
# side limit (2^20) and the pixel limit (2^30), and the refusals that come
# first.  Inside the limit each file fails while decoding, so no read
# allocates its image.
SIZE_CASES = {
    "bmp_side_2^20": (lambda: _bmp_header(1 << 20, 1), "none"),
    "bmp_side_2^20+1": (lambda: _bmp_header((1 << 20) + 1, 1), "size"),
    "bmp_height_2^20+1_top_down": (lambda: _bmp_header(1, -(1 << 20) - 1),
                                   "size"),
    "bmp_pixels_2^30": (lambda: _bmp_header(32768, 32768), "none"),
    "bmp_pixels_2^30+32768": (lambda: _bmp_header(32768, 32769), "size"),
    "png_side_1000000": (lambda: _png_header(1_000_000, 1), "none"),
    "png_side_1000001": (lambda: _png_header(1_000_001, 1), "none"),
    "png_pixels_2^30": (lambda: _png_header(32768, 32768), "none"),
    "png_pixels_2^30+32768": (lambda: _png_header(32768, 32769), "size"),
    "png_40000_filter_1": (lambda: _png_header(40000, 40000, filt=1),
                           "none"),
    "png_40000_no_idat": (lambda: _png_header(40000, 40000)[:33]
                          + chunk(b"IEND", b""), "none"),
    "png_40000_idat_bad_crc": (
        lambda: _bad_crc(_png_header(40000, 40000)[:-12])
        + chunk(b"IEND", b""), "size"),
    "png_40000_no_iend": (lambda: _png_header(40000, 40000)[:-12], "size"),
    "jpeg_side_65501": (lambda: _jpeg_header(65501, 1), "none"),
    "jpeg_pixels_2^30_no_tables": (
        lambda: _jpeg_header(32768, 32768, tables=False), "none"),
    "jpeg_pixels_2^30+32768": (lambda: _jpeg_header(32768, 32769), "size"),
    "jpeg_60000_no_tables": (
        lambda: _jpeg_header(60000, 60000, tables=False), "size"),
    "jpeg_60000_two_components": (
        lambda: _jpeg_header(60000, 60000, ncomp=2), "size"),
}


@pytest.mark.parametrize("case", list(SIZE_CASES))
def test_size_limit_header_only(tmp_path, case):
    make, outcome = SIZE_CASES[case]
    p = tmp_path / f"h.{case.split('_')[0]}"
    p.write_bytes(make())
    for flag, read in READS:
        assert _outcome(cv2.imread, str(p), flag) == outcome
        if outcome == "size":
            tracemalloc.start()
            try:
                with pytest.raises(gi.ImageSizeError,
                                   match="larger than cv2 reads"):
                    read(p)
                peak = tracemalloc.get_traced_memory()[1]
            finally:
                tracemalloc.stop()
            assert peak < 1 << 20  # no pixels, no inflated rows
        else:
            with pytest.raises(ValueError):
                read(p)


def test_png_size_limit_before_inflating(tmp_path):
    """A 40000 x 40000 PNG whose first IDAT inflates to 64 MB: the port
    raises at that IDAT without inflating it."""
    p = tmp_path / "z.png"
    p.write_bytes(_png_header(40000, 40000, idat=bytes(64 << 20)))
    with pytest.raises(cv2.error):
        cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
    tracemalloc.start()
    try:
        with pytest.raises(gi.ImageSizeError):
            gi.imread_gray(p)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 4 << 20


@pytest.mark.parametrize("fmt", ["png", "bmp", "jpg"])
def test_imread_color_or_none_lets_the_size_error_through(tmp_path, fmt):
    p = tmp_path / f"big.{fmt}"
    p.write_bytes({"png": lambda: _png_header(40000, 40000),
                   "bmp": lambda: _bmp_header(40000, 40000),
                   "jpg": lambda: _jpeg_header(40000, 40000)}[fmt]())
    with pytest.raises(cv2.error):
        cv2.imread(str(p), cv2.IMREAD_COLOR)
    with pytest.raises(gi.ImageSizeError):
        gi.imread_color_or_none(p)
    assert gi.imread_color_or_none(tmp_path / "missing.png") is None


# ---------------------------------------------------------------------------
# C12: imread_unchanged


def _unchanged_sources():
    out = {}
    rng = np.random.default_rng(19)
    for color, depths in gi._PNG_DEPTHS.items():
        ch = gi._PNG_CHANNELS[color]
        for depth in depths:
            s = _samples(20 + depth, 9, 11, ch, depth)
            s[0, :3] = s[0, 5]
            plte = (rng.integers(0, 256, (1 << min(depth, 8), 3))
                    if color == 3 else None)
            name = f"png_c{color}_d{depth}"
            out[name] = png(s, color, depth, plte=plte)
            if color == 0:
                out[name + "_trns"] = png(s, color, depth, trns=struct.pack(
                    ">H", int(s[0, 0, 0])))
            elif color == 2:
                key = [int(v) for v in s[0, 5]]
                out[name + "_trns"] = png(s, color, depth,
                                          trns=struct.pack(">HHH", *key))
                high = [v + 0x100 for v in key] if depth == 8 else key
                out[name + "_trns_high"] = png(
                    s, color, depth, trns=struct.pack(">HHH", *high))
            elif color == 3:
                out[name + "_trns"] = png(s, color, depth, plte=plte,
                                          trns=bytes([0, 77, 154]))
                out[name + "_trns_long"] = png(s, color, depth, plte=plte,
                                               trns=bytes(len(plte) + 1))
            else:
                out[name + "_trns"] = png(s, color, depth, trns=bytes(6))
    out["png_c2_d8_adam7_exif"] = png(_samples(30, 9, 11, 3, 8), 2, 8,
                                      interlace=1,
                                      exif=b"MM\0*\0\0\0\x08\0\x01\x01\x12"
                                      b"\0\x03\0\0\0\x01\0\x06\0\0")
    idx = rng.integers(0, 16, (5, 7))
    pal = rng.integers(0, 256, (16, 3))
    gray_pal = np.repeat(np.arange(0, 256, 17)[:, None], 3, 1)
    bgra = rng.integers(0, 256, (5, 7, 4)).astype(np.uint8)
    rgb8 = (0xFF0000, 0xFF00, 0xFF)
    bmps = {
        "bmp8_color": bw.bmp(idx, 8, palette=pal),
        "bmp8_gray": bw.bmp(idx, 8, palette=gray_pal),
        "bmp8_gray_16_colours": bw.bmp(idx, 8, palette=gray_pal,
                                       clr_used=16),
        "bmp4_gray": bw.bmp(idx, 4, palette=gray_pal),
        "bmp1_gray": bw.bmp(idx & 1, 1, palette=[[0, 0, 0],
                                                  [255, 255, 255]]),
        "bmp_rle8_gray": bw.bmp(idx, 8, palette=gray_pal,
                                compression=bw.BI_RLE8),
        "bmp_rle4_color": bw.bmp(idx, 4, palette=pal,
                                 compression=bw.BI_RLE4),
        "bmp_os2_4_gray": bw.bmp(idx, 4, palette=gray_pal, header=12),
        "bmp_os2_8_color": bw.bmp(idx, 8, palette=pal, header=12),
        "bmp_os2_24": bw.bmp(bgra[:, :, :3], 24, header=12),
        "bmp_os2_32": bw.bmp(bgra, 32, header=12),
        "bmp16": bw.bmp(rng.integers(0, 65536, (5, 7)), 16),
        "bmp16_565": bw.bmp(rng.integers(0, 65536, (5, 7)), 16,
                            compression=bw.BI_BITFIELDS, masks=bw.MASKS_565),
        "bmp24": bw.bmp(bgra[:, :, :3], 24),
        "bmp32": bw.bmp(bgra, 32),
        "bmp32_fields_40": bw.bmp(bgra, 32, compression=bw.BI_BITFIELDS,
                                  masks=rgb8),
        "bmp32_fields_52": bw.bmp(bgra, 32, compression=bw.BI_BITFIELDS,
                                  masks=rgb8, header=52),
        "bmp32_fields_v5": bw.bmp(bgra, 32, compression=bw.BI_BITFIELDS,
                                  masks=rgb8, header=124),
        "bmp32_fields_v5_zero_mask": bw.bmp(
            bgra, 32, compression=bw.BI_BITFIELDS, masks=(0, 0xFF00, 0xFF),
            header=124),
    }
    for am, name in ((0xFF000000, "alpha_ff"), (0x0F000000, "alpha_0f"),
                     (0xC0000000, "alpha_c0")):
        data = bytearray(bw.bmp(bgra, 32, compression=bw.BI_BITFIELDS,
                                masks=(0x3FF00000, 0xFFC00, 0x3FF),
                                header=124))
        data[66:70] = struct.pack("<I", am)
        bmps[f"bmp32_fields_v5_10bit_{name}"] = bytes(data)
    out.update(bmps)
    img = _samples(31, 19, 23, 3, 8).astype(np.uint8)
    out["jpg_color"] = cv2.imencode(".jpg", img)[1].tobytes()
    out["jpg_gray"] = cv2.imencode(".jpg", img[:, :, 0])[1].tobytes()
    out["jpg_cmyk"] = jw.lossy(jw.cmyk_from_bgr(img), quality=90)
    out["jpg_lossless_gray"] = jw.lossless([img[:, :, 1]], predictor=1)
    out["jpg_lossless_rgb"] = jw.lossless(
        [img[:, :, 2], img[:, :, 1], img[:, :, 0]], predictor=1)
    return out


UNCHANGED = _unchanged_sources()


@pytest.mark.parametrize("name", list(UNCHANGED))
def test_imread_unchanged(tmp_path, name):
    p = tmp_path / f"u.{name.split('_')[0][:3]}"
    p.write_bytes(UNCHANGED[name])
    want = cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
    assert want is not None
    got = gi.imread_unchanged(p)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)
