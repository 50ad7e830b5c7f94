"""The rest of cv2's image input in the port (io/image.py and the native
library's JPEG decoder) against cv2.imread on the CPU, bit for bit with
tolerance 0, in colour and in gray, at odd sizes: BMP of 1, 4 and 16 bits,
bit fields, RLE8 and RLE4 (encoded and absolute runs, end of line, delta,
end of bitmap, runs past a row or past the image) and OS/2 headers
(tests/bmp_writer.py); CMYK and YCCK JPEG at 4:4:4 and 4:2:0, one from
PIL; arithmetic-coded sequential and progressive JPEG with and without
restarts and a DAC segment, lossless JPEG at every predictor, point
transforms 0 and 2 and precisions 8 and 6 (tests/jpeg_writer.py); every
progressive file cut after each scan but the last, Huffman-coded (cv2's)
and arithmetic-coded, which libjpeg's block smoothing reads.  Where cv2
returns None (hierarchical, 12-bit, two-component, arithmetic-coded
lossless frames, colour from a one-component lossless file), the port
raises a ValueError naming the format."""

import io
import struct

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import bmp_writer as bw
import jpeg_writer as jw
from global_lvba_tpu_torch.io import image as gi
from test_torch_image import exif_tiff
from test_torch_image_decode import _same_reads

SIZES = [(1, 1), (7, 5), (17, 9), (37, 53)]
SAMPLING = {"444": [(1, 1)] * 3, "420": [(2, 2), (1, 1), (1, 1)]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(h, w, seed):
    """Noise over a smooth colour field (BGR)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([128 + 90 * np.sin(x / 7 + y / 11),
                     128 + 90 * np.cos(x / 5 - y / 9),
                     (x * 3 + y * 2) % 256], -1)
    return np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(
        np.uint8)


def _refused(path, match, flags=(cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE)):
    """cv2 reads nothing of path under flags, and the port raises a
    ValueError matching match there."""
    reads = {cv2.IMREAD_COLOR: gi.imread_color,
             cv2.IMREAD_GRAYSCALE: gi.imread_gray}
    for flag in flags:
        assert cv2.imread(str(path), flag) is None
        with pytest.raises(ValueError, match=match):
            reads[flag](path)


def _same_or_refused(path):
    """cv2 and the port agree on path: the same pixels, or cv2 reads
    nothing and the port raises."""
    for flag, read in ((cv2.IMREAD_COLOR, gi.imread_color),
                       (cv2.IMREAD_GRAYSCALE, gi.imread_gray)):
        want = cv2.imread(str(path), flag)
        if want is None:
            with pytest.raises(ValueError):
                read(path)
        else:
            got = read(path)
            assert got.shape == want.shape and np.array_equal(got, want)


# ---------------------------------------------------------------------------
# BMP


@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("top_down", [False, True])
@pytest.mark.parametrize("colors", ["full", "half"])
def test_bmp_palette(tmp_path, bits, top_down, colors):
    """Palette images of 1, 4 and 8 bits (high bits first); a palette of
    fewer entries than 2^bits (clrUsed) leaves the others black, which an
    index may name; gray is cv2's weighting of the palette colour."""
    rng = np.random.default_rng(bits)
    p = tmp_path / "p.bmp"
    for h, w in SIZES:
        pal = rng.integers(0, 256, (1 << bits, 3))
        if colors == "half":
            pal = pal[:max(1, len(pal) // 2)]
        idx = rng.integers(0, 1 << bits, (h, w))
        p.write_bytes(bw.bmp(idx, bits, palette=pal, top_down=top_down))
        _same_reads(p)


@pytest.mark.parametrize("kind", ["555", "bitfields 565", "bitfields 555"])
@pytest.mark.parametrize("top_down", [False, True])
def test_bmp_16_bit(tmp_path, kind, top_down):
    """16 bits: plain (555) and BI_BITFIELDS with cv2's two mask sets
    (565: R 0xF800, G 0x7E0, B 0x1F; 555: 0x7C00, 0x3E0, 0x1F), each
    channel's bits shifted to the top of its byte."""
    rng = np.random.default_rng(16)
    masks = {"555": None, "bitfields 565": bw.MASKS_565,
             "bitfields 555": bw.MASKS_555}[kind]
    p = tmp_path / "s.bmp"
    for h, w in SIZES:
        v = rng.integers(0, 65536, (h, w))
        p.write_bytes(bw.bmp(v, 16, compression=bw.BI_BITFIELDS if masks
                             else bw.BI_RGB, masks=masks, top_down=top_down))
        _same_reads(p)


def test_bmp_16_bit_other_masks_refused(tmp_path):
    """Bit fields other than cv2's 565 and 555 masks: cv2 reads nothing,
    the port raises naming them."""
    p = tmp_path / "m.bmp"
    p.write_bytes(bw.bmp(np.zeros((5, 7), np.uint16), 16,
                         compression=bw.BI_BITFIELDS,
                         masks=(0xF00, 0xF0, 0xF)))
    _refused(p, "bit fields")


@pytest.mark.parametrize("masks", [(0xFF0000, 0xFF00, 0xFF),
                                   (0xFF, 0xFF00, 0xFF0000)])
@pytest.mark.parametrize("top_down", [False, True])
def test_bmp_32_bit_bitfields(tmp_path, masks, top_down):
    """32 bits with bit fields after a 40-byte header: cv2 takes the bytes
    as B, G, R, A whatever the masks say."""
    rng = np.random.default_rng(32)
    p = tmp_path / "b.bmp"
    for h, w in SIZES:
        px = rng.integers(0, 256, (h, w, 4))
        p.write_bytes(bw.bmp(px, 32, compression=bw.BI_BITFIELDS,
                             masks=masks, top_down=top_down))
        _same_reads(p)


@pytest.mark.parametrize("masks", [
    (0xFF0000, 0xFF00, 0xFF), (0xFF, 0xFF00, 0xFF0000),
    (0x3FF00000, 0xFFC00, 0x3FF), (0xFF000000, 0xFF0000, 0xFF00),
    (0x3F, 0xFC0, 0x3F000), (0xFF0000, 0xFF00, 0)])
@pytest.mark.parametrize("alpha", [0, 0xFF000000])
@pytest.mark.parametrize("header", [56, 108, 124])
def test_bmp_32_bit_bitfields_under_a_v3_v4_v5_header(tmp_path, masks,
                                                      alpha, header):
    """32 bits with bit fields inside a header of 56 bytes or more: cv2
    5.0 scales each masked field in float32 ((int)(field * (255.0f /
    max)); 8-bit masks plain, reversed and shifted, 10- and 6-bit masks)
    and takes gray as floor((0.299f R + 0.587f G) + 0.114f B); a zero
    mask leaves the bytes B, G, R and cv2's fixed-point gray.  The alpha
    mask changes nothing.  Bit for bit, colour and gray, bottom-up and
    top-down."""
    rng = np.random.default_rng(header + len(masks))
    p = tmp_path / "v.bmp"
    for top_down in (False, True):
        for h, w in SIZES:
            words = rng.integers(0, 1 << 32, (h, w), dtype=np.uint64).astype(
                np.uint32)
            data = bytearray(bw.bmp(
                words.view(np.uint8).reshape(h, w, 4), 32,
                compression=bw.BI_BITFIELDS, masks=masks, header=header,
                top_down=top_down))
            struct.pack_into("<I", data, 14 + 52, alpha)
            p.write_bytes(bytes(data))
            _same_reads(p)


@pytest.mark.parametrize("bits", [1, 4, 8, 24, 32])
def test_bmp_os2_header(tmp_path, bits):
    """The OS/2 BITMAPCOREHEADER (12 bytes: 16-bit width and height,
    3-byte palette entries, 2^bits of them)."""
    rng = np.random.default_rng(bits + 1)
    p = tmp_path / "o.bmp"
    for h, w in SIZES:
        if bits <= 8:
            px = rng.integers(0, 1 << bits, (h, w))
            pal = rng.integers(0, 256, (1 << bits, 3))
        else:
            px, pal = rng.integers(0, 256, (h, w, bits // 8)), None
        p.write_bytes(bw.bmp(px, bits, palette=pal, header=12))
        _same_reads(p)


@pytest.mark.parametrize("header", [108, 124])
@pytest.mark.parametrize("bits", [8, 24])
def test_bmp_v4_v5_headers(tmp_path, header, bits):
    rng = np.random.default_rng(header)
    h, w = 17, 9
    pal = rng.integers(0, 256, (256, 3)) if bits == 8 else None
    px = rng.integers(0, 256, (h, w) if bits == 8 else (h, w, 3))
    p = tmp_path / "v.bmp"
    p.write_bytes(bw.bmp(px, bits, palette=pal, header=header))
    _same_reads(p)


def _indices(h, w, top, seed):
    """Palette indices with long runs (a blocky pattern) and noise rows."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    idx = ((y // 3 + x // 5) % top).astype(np.uint8)
    idx[::4] = rng.integers(0, top, (len(idx[::4]), w))
    return idx


@pytest.mark.parametrize("compression", ["rle8", "rle4"])
@pytest.mark.parametrize("top_down", [False, True])
def test_bmp_rle(tmp_path, compression, top_down):
    """RLE8 and RLE4 streams of encoded runs (up to 255 pixels), absolute
    runs (padded to 16 bits), an end of line after each row and an end of
    bitmap, bottom-up and top-down, in colour and in gray."""
    bits = 8 if compression == "rle8" else 4
    comp = bw.BI_RLE8 if bits == 8 else bw.BI_RLE4
    rng = np.random.default_rng(bits)
    p = tmp_path / "r.bmp"
    for h, w in SIZES + [(9, 300)]:
        pal = rng.integers(0, 256, (1 << bits, 3))
        p.write_bytes(bw.bmp(_indices(h, w, 1 << bits, h), bits, palette=pal,
                             compression=comp, top_down=top_down))
        _same_reads(p)


def test_bmp_rle8_delta_gap_is_palette_zero(tmp_path):
    """An RLE8 delta escape skips pixels (here 3 along and 2 rows down);
    cv2 fills them with palette entry 0, and so does the port."""
    h, w = 9, 13
    idx = _indices(h, w, 256, 1)
    pal = np.random.default_rng(2).integers(0, 256, (256, 3))
    stream = bw.rle(idx[::-1], 8, deltas={(2, 4): (3, 2)})
    p = tmp_path / "d.bmp"
    p.write_bytes(bw.bmp(idx, 8, palette=pal, compression=bw.BI_RLE8,
                         stream=stream))
    _same_reads(p)
    got = gi.imread_color(p)[::-1]  # file order
    gap = np.zeros((h, w), bool)
    gap.ravel()[2 * w + 4:4 * w + 7] = True
    assert np.all(got[gap] == pal[0]) and not np.all(got[~gap] == pal[0])


@pytest.mark.parametrize("case", [
    "rle4 delta", "no end of bitmap", "early end of bitmap",
    "end of line after the last row", "full-row run then end of line",
    "run past its row", "stream cut", "rows past the image"])
@pytest.mark.parametrize("bits", [8, 4])
def test_bmp_rle_edges(tmp_path, case, bits):
    """What cv2 does with unusual streams, held in colour and gray: in
    RLE4 a delta moves along the row only and an end of bitmap ends the
    row (so an early one leaves the stream short and cv2 reads nothing);
    in RLE8 a run that fills its row moves to the next one and a
    following end of line is passed over; a run past its row's end and a
    stream cut short read as nothing; rows past the image's last are not
    read.  Where cv2 reads nothing, the port raises."""
    h, w = 7, 11
    top = 1 << bits
    comp = bw.BI_RLE8 if bits == 8 else bw.BI_RLE4
    idx = _indices(h, w, top, 3)
    pal = np.random.default_rng(4).integers(0, 256, (top, 3))
    rows = idx[::-1]
    full = bytes([w, 0x33 if bits == 4 else 3, 0, 0])
    stream = {
        "rle4 delta": bw.rle(rows, bits, deltas={(1, 2): (2, 1)}),
        "no end of bitmap": bw.rle(rows, bits, eob=False),
        "early end of bitmap": bw.rle(rows[:3], bits),
        "end of line after the last row": bw.rle(rows, bits, eol_last=True),
        "full-row run then end of line": full + bw.rle(rows[1:], bits),
        "run past its row": bytes([w + 1, 5]) + bw.rle(rows, bits),
        "stream cut": bw.rle(rows, bits)[:-7],
        "rows past the image": bw.rle(np.concatenate([rows, rows]), bits),
    }[case]
    p = tmp_path / "e.bmp"
    p.write_bytes(bw.bmp(idx, bits, palette=pal, compression=comp,
                         stream=stream))
    _same_or_refused(p)
    if case in ("run past its row", "stream cut") or (
            bits == 4 and case in ("rle4 delta", "early end of bitmap")):
        _refused(p, "BMP")


def test_bmp_refused_headers(tmp_path):
    """Headers cv2 does not read: a 20-byte header, compression 4 (JPEG),
    RLE8 at 4 bits, clrUsed above 256."""
    px = np.zeros((3, 5), np.uint8)
    pal = np.zeros((16, 3), np.uint8)
    base = bw.bmp(px, 8, palette=pal)
    p = tmp_path / "h.bmp"
    for data, match in (
            (base[:14] + (20).to_bytes(4, "little") + base[18:], "header"),
            (base[:30] + (4).to_bytes(4, "little") + base[34:],
             "compression 4"),
            (bw.bmp(px, 4, palette=pal, compression=bw.BI_RLE8,
                    stream=b"\x00\x01"), "compression 1"),
            (bw.bmp(px, 8, palette=pal, clr_used=300), "palette")):
        p.write_bytes(data)
        _refused(p, match)


def test_bmp_rle8_view_written_quantised(tmp_path):
    """The writer's 256-colour quantisation and RLE8 stream of a view (as
    chip_smoke.py writes one): cv2 and the port read back exactly the
    quantised image."""
    img = _scene(45, 61, 9)
    idx, pal = bw.quantize(img)
    p = tmp_path / "q.bmp"
    p.write_bytes(bw.bmp(idx, 8, palette=pal, compression=bw.BI_RLE8))
    _same_reads(p)
    assert np.array_equal(gi.imread_color(p), pal[idx])


# ---------------------------------------------------------------------------
# four-component JPEG


@pytest.mark.parametrize("space", ["CMYK", "YCCK", "CMYK without Adobe"])
@pytest.mark.parametrize("sampling", ["444", "420"])
@pytest.mark.parametrize("coding", ["huffman", "arith"])
def test_cmyk_and_ycck(tmp_path, space, sampling, coding):
    """CMYK (Adobe transform 0, or no Adobe marker) and YCCK (transform 2,
    through ycck_cmyk_convert), then cv2's conversion: x' = K - (((255 -
    x) K) >> 8), BGR (y', m', c'), gray (4899 R + 9617 G + 1868 B + 8192)
    >> 14."""
    p = tmp_path / "k.jpg"
    samp = [(2, 2), (1, 1), (1, 1), (2, 2)] if sampling == "420" else None
    for k, (h, w) in enumerate(SIZES):
        planes = jw.cmyk_from_bgr(_scene(h, w, k))
        adobe = 0
        if space == "YCCK":
            planes, adobe = jw.ycck_from_cmyk(planes), 2
        elif space != "CMYK":
            adobe = None
        p.write_bytes(jw.lossy(planes, quality=90, sampling=samp,
                               adobe=adobe, coding=coding))
        _same_reads(p)
    info = gi.jpeg_info(p.read_bytes())
    assert info["components"] == 4
    assert info["color_space"] == ("YCCK" if space == "YCCK" else "CMYK")


def test_cmyk_written_by_pil(tmp_path):
    rng = np.random.default_rng(1)
    p = tmp_path / "pil.jpg"
    for h, w in SIZES:
        cmyk = rng.integers(0, 256, (h, w, 4), np.uint8)
        buf = io.BytesIO()
        Image.fromarray(cmyk, "CMYK").save(buf, "JPEG", quality=90)
        p.write_bytes(buf.getvalue())
        _same_reads(p)


def test_cmyk_and_lossless_exif_orientation(tmp_path):
    """An Exif APP1 turns the new frames as it turns baseline ones (a
    three-component lossless frame has no gray read)."""
    img = _scene(6, 10, 3)
    p = tmp_path / "o.jpg"
    for data, read, shape in (
            (jw.lossy(jw.cmyk_from_bgr(img), adobe=0, exif=exif_tiff(6)),
             gi.imread_gray, (10, 6)),
            (jw.lossless([img[:, :, 2], img[:, :, 1], img[:, :, 0]],
                         exif=exif_tiff(8)), gi.imread_color, (10, 6, 3)),
            (jw.lossy(jw.ycc_from_bgr(img), coding="arith", progressive=True,
                      exif=exif_tiff(3)), gi.imread_gray, (6, 10))):
        p.write_bytes(data)
        _same_or_refused(p)
        assert read(p).shape == shape


# ---------------------------------------------------------------------------
# arithmetic coding


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("dac", [None, {"dc": {0: (1, 3), 1: (2, 5)},
                                        "ac": {0: 2, 1: 30}}])
@pytest.mark.parametrize("sampling", ["444", "420"])
def test_arith_sequential(tmp_path, restart, dac, sampling):
    p = tmp_path / "a.jpg"
    for k, (h, w) in enumerate(SIZES):
        p.write_bytes(jw.lossy(jw.ycc_from_bgr(_scene(h, w, k)), quality=90,
                               coding="arith", restart=restart, dac=dac,
                               sampling=SAMPLING[sampling]))
        _same_reads(p)
    assert gi.jpeg_info(p.read_bytes())["format"] == \
        "arithmetic-coded sequential"


@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("sampling", ["444", "420", "gray"])
def test_arith_progressive(tmp_path, restart, sampling):
    p = tmp_path / "a.jpg"
    for k, (h, w) in enumerate(SIZES):
        img = _scene(h, w, k)
        planes = [img[:, :, 1]] if sampling == "gray" else jw.ycc_from_bgr(img)
        p.write_bytes(jw.lossy(planes, quality=90, coding="arith",
                               progressive=True, restart=restart,
                               sampling=None if sampling == "gray"
                               else SAMPLING[sampling]))
        _same_reads(p)
    assert gi.jpeg_info(p.read_bytes())["format"] == \
        "arithmetic-coded progressive"


def test_arith_damage(tmp_path):
    """Bytes of an arithmetic-coded scan changed: libjpeg decodes on where
    the codes stay valid, and at a code it flags as bad
    (JWRN_ARITH_BAD_CODE) ends the MCU and the rest of the scan's restart
    interval.  Every variant reads as cv2 reads it, bit for bit, colour and
    gray: garbage decodes into coefficients far outside any encoder's
    range, which the port's IDCT saturates and wraps in 16 bits as
    libjpeg-turbo's SIMD IDCT does."""
    jpg = jw.lossy(jw.ycc_from_bgr(_scene(37, 53, 2)), quality=90,
                   coding="arith")
    sos = jpg.index(b"\xff\xda") + 14
    p = tmp_path / "x.jpg"
    for k in range(sos, len(jpg) - 2, 7):
        bad = bytearray(jpg)
        bad[k] = 0xFE if bad[k] != 0xFE else 0x01
        p.write_bytes(bytes(bad))
        for flag, read in ((cv2.IMREAD_COLOR, gi.imread_color),
                           (cv2.IMREAD_GRAYSCALE, gi.imread_gray)):
            want = cv2.imread(str(p), flag)
            assert want is not None and np.array_equal(read(p), want), k


# ---------------------------------------------------------------------------
# lossless


@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("pt", [0, 2])
@pytest.mark.parametrize("precision", [8, 6])
def test_lossless_gray(tmp_path, predictor, pt, precision):
    """One-component lossless frames: the gray read is the samples shifted
    back by the point transform (below 8 bits not scaled); the colour read
    is refused (libjpeg converts nothing in lossless mode)."""
    p = tmp_path / "l.jpg"
    for k, (h, w) in enumerate(SIZES):
        s = _scene(h, w, k)[:, :, 1] >> (8 - precision)
        p.write_bytes(jw.lossless([s], precision=precision,
                                  predictor=predictor, pt=pt,
                                  restart_rows=2 if k % 2 else 0))
        want = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
        assert np.array_equal(want, (s >> pt) << pt)
        assert np.array_equal(gi.imread_gray(p), want)
        _refused(p, "lossless JPEG with 1 component has no colour",
                 (cv2.IMREAD_COLOR,))
    assert gi.jpeg_info(p.read_bytes())["format"] == "lossless"


@pytest.mark.parametrize("layout", ["interleaved", "one scan a component",
                                    "restarts", "420", "RGB ids",
                                    "Adobe 0"])
def test_lossless_color(tmp_path, layout):
    """Three-component lossless frames are RGB (no JFIF marker: libjpeg
    guesses RGB in lossless mode), copied into BGR, upsampled by
    replication; their gray read is refused, as is colour from a YCbCr
    one (JFIF marker or Adobe transform 1)."""
    kw = {"interleaved": {}, "one scan a component": {"interleave": False},
          "restarts": {"restart_rows": 3},
          "420": {"sampling": SAMPLING["420"]},
          "RGB ids": {"ids": [82, 71, 66]}, "Adobe 0": {"adobe": 0}}[layout]
    p = tmp_path / "c.jpg"
    for k, (h, w) in enumerate(SIZES):
        img = _scene(h, w, k)
        p.write_bytes(jw.lossless([img[:, :, 2], img[:, :, 1], img[:, :, 0]],
                                  predictor=k % 7 + 1, **kw))
        want = cv2.imread(str(p), cv2.IMREAD_COLOR)
        assert np.array_equal(gi.imread_color(p), want)
        if layout != "420":
            assert np.array_equal(want, img)
        _refused(p, "no gray", (cv2.IMREAD_GRAYSCALE,))
    for ycc in ({"jfif": True}, {"adobe": 1}):
        p.write_bytes(jw.lossless([img[:, :, 0]] * 3, **ycc))
        _refused(p, "lossless JPEG with 3 components")


def test_lossless_cmyk(tmp_path):
    """A four-component lossless frame is CMYK, passed to cv2's
    conversion unchanged."""
    p = tmp_path / "k.jpg"
    for k, (h, w) in enumerate(SIZES):
        p.write_bytes(jw.lossless(jw.cmyk_from_bgr(_scene(h, w, k)),
                                  predictor=4, adobe=0))
        _same_reads(p)


# ---------------------------------------------------------------------------
# block smoothing


def _cuts(jpg: bytes):
    """jpg cut before each of its scans but the first, an EOI appended."""
    starts = [k for k in range(len(jpg) - 1) if jpg[k:k + 2] == b"\xff\xda"]
    return [jpg[:k] + b"\xff\xd9" for k in starts[1:]]


@pytest.mark.parametrize("sampling", ["420", "444", "422", "440", "gray"])
@pytest.mark.parametrize("quality", [50, 95])
def test_cut_progressive_huffman(tmp_path, sampling, quality):
    """cv2's progressive files cut after each scan but the last leave
    coefficients imprecise, which libjpeg estimates from the DC values of
    the 5 x 5 blocks around (jdcoefct.c decompress_smooth_data): the DC
    too after the first scan, the first five AC coefficients after
    later ones."""
    flags = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
    p = tmp_path / "u.jpg"
    for k, (h, w) in enumerate([(17, 9), (33, 65), (41, 23)]):
        img = _scene(h, w, k)
        if sampling == "gray":
            img, extra = img[:, :, 1], []
        else:
            extra = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flags[sampling]]
        jpg = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                         cv2.IMWRITE_JPEG_QUALITY, quality]
                           + extra)[1].tobytes()
        for cut in _cuts(jpg):
            p.write_bytes(cut)
            _same_reads(p)


@pytest.mark.parametrize("sampling", ["420", "444", "gray"])
def test_cut_progressive_arith(tmp_path, sampling):
    p = tmp_path / "u.jpg"
    for k, (h, w) in enumerate([(17, 9), (41, 23)]):
        img = _scene(h, w, k)
        planes = [img[:, :, 1]] if sampling == "gray" else jw.ycc_from_bgr(img)
        jpg = jw.lossy(planes, quality=90, coding="arith", progressive=True,
                       sampling=None if sampling == "gray"
                       else SAMPLING[sampling])
        for cut in _cuts(jpg):
            p.write_bytes(cut)
            _same_reads(p)


# ---------------------------------------------------------------------------
# frames cv2 reads nothing of


@pytest.mark.parametrize("case,match", [
    ("SOF5", "hierarchical JPEG \\(SOF5\\)"),
    ("12-bit", "12-bit JPEG"),
    ("2 components", "2 components"),
    ("2 components, arithmetic", "2 components"),
    ("SOF11", "arithmetic-coded lossless JPEG \\(SOF11\\)"),
    ("12-bit lossless", "12-bit lossless JPEG"),
    ("lossless restart inside a row", "restart interval"),
])
def test_frames_cv2_refuses_raise(tmp_path, case, match):
    img = _scene(13, 29, 1)
    g = img[:, :, 1]
    data = {
        "SOF5": lambda: jw.lossy([g], sof=0xC5),
        "12-bit": lambda: jw.lossy([g], precision=12),
        "2 components": lambda: jw.lossy([g, img[:, :, 0]]),
        "2 components, arithmetic": lambda: jw.lossy(
            [g, img[:, :, 0]], coding="arith"),
        "SOF11": lambda: jw.lossless([g], sof=0xCB),
        "12-bit lossless": lambda: jw.lossless(
            [g.astype(np.uint16) * 16], precision=12),
        "lossless restart inside a row": lambda: jw.lossless([g])[:2]
        + jw.segment(0xDD, b"\x00\x05") + jw.lossless([g])[2:],
    }[case]()
    p = tmp_path / "r.jpg"
    p.write_bytes(data)
    _refused(p, match)


@pytest.mark.parametrize("fmt", ["jpeg", "bmp"])
def test_images_larger_than_cv2_reads_raise(tmp_path, fmt):
    """A header claiming more than 2^30 pixels (40000 x 40000): cv2's
    validateInputImageSize refuses it before decoding (cv2 5.0 raises),
    and the port raises its ImageSizeError before allocating."""
    p = tmp_path / f"big.{fmt}"
    if fmt == "jpeg":
        data = bytearray(jw.lossy([np.zeros((8, 8), np.uint8)]))
        k = data.index(b"\xff\xc0")
        data[k + 5:k + 9] = (40000).to_bytes(2, "big") * 2
    else:
        data = bytearray(bw.bmp(np.zeros((1, 1), np.uint8), 8,
                                palette=np.zeros((1, 3)),
                                compression=bw.BI_RLE8, stream=b"\x00\x01"))
        data[18:26] = (40000).to_bytes(4, "little") * 2
    p.write_bytes(bytes(data))
    with pytest.raises(cv2.error):
        cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
    with pytest.raises(gi.ImageSizeError, match="larger than cv2 reads"):
        gi.imread_gray(p)
