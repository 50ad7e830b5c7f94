"""Image files without cv2: PNG, JPEG and BMP decoding, the linear resize
and the PNG and JPEG writers (host numpy and the native library; the
port's own copy of what the JAX package takes from cv2's imread, resize
and imwrite).

imread_gray / imread_color give cv2.imread's pixels bit for bit
(IMREAD_GRAYSCALE / IMREAD_COLOR, BGR uint8):
  * PNG, every colour type (0, 2, 3, 4, 6) and bit depth (1, 2, 4, 8,
    16), plain or Adam7-interlaced, as libpng transforms it for cv2: gray
    below 8 bits scaled to 8, the palette expanded, alpha dropped, 16 bits
    cut to their high byte, and RGB to gray with libpng's fixed-point
    weights for 0.299 / 0.587 ((9797 R + 19234 G + 3737 B) >> 15 at 8
    bits, the same plus 16384 at 16 bits, before the cut).  The rows are
    inflated with zlib and unfiltered by the native library
    (lvba_png_unfilter), an Adam7 pass at a time.
  * JPEG, by the native library's lvba_jpeg_decode: libjpeg-turbo's
    decompressor with cv2's settings (islow IDCT, fancy upsampling, block
    smoothing, BGR or the Y plane out; read_jpeg): baseline, extended
    sequential and progressive frames, Huffman- or arithmetic-coded, of
    one, three or four components (CMYK, or YCCK under Adobe transform
    2, turned into BGR or gray as cv2 turns libjpeg's CMYK:
    x' = K - (((255 - x) K) >> 8), gray (4899 R + 9617 G + 1868 B +
    8192) >> 14); lossless frames of 2-8 bits (gray from one component,
    colour from RGB, as libjpeg converts nothing else in lossless mode);
    progressive files whose later scans are missing, smoothed as libjpeg
    smooths them; damaged files as libjpeg recovers them under cv2.imread
    (cut anywhere, a missing EOI, restart markers lost or out of order,
    bad Huffman or arithmetic codes, coefficients past an encoder's range
    through the SIMD IDCT's 16-bit arithmetic: lvba_native.cpp).
    Hierarchical and arithmetic-coded lossless frames, precision other
    than 8 bits (2-8 lossless), two components and what libjpeg finds
    fatal (a cut header, bad tables, no scan) raise ValueError naming the
    format, as cv2 reads none of them.
  * BMP as cv2's grfmt_bmp reads it: 1-, 4- and 8-bit palettes
    (uncompressed, RLE4, RLE8 with its end of line, delta and end of
    bitmap), 16 bits (555, bit fields 555 or 565), 24 and 32 bits (bit
    fields after a 40- or 52-byte header as bytes, inside a V3+ header
    scaled by their masks), BITMAPINFOHEADER, V4, V5 and OS/2 headers,
    bottom-up and top-down (read_bmp); gray with cv2's own weights ((4899
    R + 9617 G + 1868 B + 8192) >> 14), or in float32 for the masked
    fields (_gray_float).
  * PNG chunks under cv2 5.0's rules (_read_png): an ancillary chunk with
    a bad CRC dropped, IEND's CRC unread, a refusal where cv2 reads
    nothing.
  * The gray read of a colour PNG (RGB, RGBA, palette) that states a
    significant gamma (gAMA, or sRGB's 45455) as libpng 1.6.58 makes it
    for cv2: each channel to linear light and back through libpng's gamma
    tables (_png_gamma_gray).
Both reads turn the image by its EXIF orientation as cv2.imread does
(a PNG's eXIf chunk, a JPEG's first Exif APP1; exif_orientation,
apply_orientation).  imread_unchanged is cv2.imread(IMREAD_UNCHANGED):
no orientation, 16-bit PNG samples kept, alpha kept (BGRA), and BMP and
JPEG with the channels cv2 gives them.  Other inputs raise ValueError
naming the format, where cv2.imread returns None; an image past cv2's
size limit (a side over 2^20 or more than 2^30 pixels) raises
ImageSizeError once its header is read, where cv2.imread raises.

resize_linear is cv2.resize(INTER_LINEAR) on uint8 bit for bit: an exact
2:1 reduction is cv2's 2x2 average ((a + b + c + d + 2) >> 2), any other
ratio its 11-bit fixed-point taps, with the rows' rounding of cv2's
16-bit SIMD pass.  imwrite_png writes 8-bit gray or BGR with filter 0
rows at zlib level 1: its bytes differ from cv2's, its pixels do not.
encode_jpeg / imwrite_jpeg are the native library's baseline encoder
(lvba_jpeg_encode: cv2.imwrite(".jpg")'s defaults, quality 95, 4:2:0,
libjpeg's integer arithmetic; its bytes are cv2's), an image a thread.
"""

from __future__ import annotations

import math
import struct
import zlib
from functools import lru_cache
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
               6: (8, 16)}


# cv2's validateInputImageSize (loadsave.cpp): each side up to 2^20, at
# most 2^30 pixels
MAX_SIDE = 1 << 20
MAX_PIXELS = 1 << 30
# libpng's default user limits on an IHDR's width and height
PNG_USER_MAX = 1_000_000


class ImageSizeError(Exception):
    """An image past cv2's size limit (a side over 2^20, or more than 2^30
    pixels): cv2.imread raises cv2.error there, once the header is read,
    where it returns None for a file it cannot read.  Not a ValueError, so
    imread_color_or_none lets it through."""


def _check_size(W: int, H: int, name):
    if W > MAX_SIDE or H > MAX_SIDE or W * H > MAX_PIXELS:
        raise ImageSizeError(f"{name}: an image of {W} x {H} pixels is "
                             f"larger than cv2 reads (sides up to 2^20, "
                             f"2^30 pixels)")


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_unfilter(raw: np.ndarray, H: int, rowbytes: int,
                 bpp: int) -> np.ndarray:
    """(H, rowbytes) uint8 rows from the inflated stream raw (H rows of
    a filter type byte and rowbytes filtered bytes); bpp is the bytes of a
    whole pixel.  ValueError on a short stream or a filter type outside
    0-4."""
    from ..native.runtime import library, _ptr

    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    if raw.size < H * (rowbytes + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, "
                         f"{H * (rowbytes + 1)} needed")
    out = np.empty((H, rowbytes), dtype=np.uint8)
    if library().lvba_png_unfilter(_ptr(raw), H, rowbytes, bpp,
                                   _ptr(out)) != 0:
        raise ValueError("PNG filter type outside 0-4")
    return out


# Adam7's seven passes: (x0, y0, dx, dy) of each pass's pixel lattice
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_samples(rows: np.ndarray, h: int, w: int, ch: int,
                 depth: int) -> np.ndarray:
    """(h, w, ch) samples of unfiltered rows (h, rowbytes): 16-bit as
    big-endian pairs, below 8 bits one channel packed from the high
    bits."""
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    if depth == 8:
        return rows.reshape(h, w, ch)
    per = 8 // depth
    shifts = (8 - depth * (1 + np.arange(per))).astype(np.uint8)
    return ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(
        h, -1)[:, :w, None]


class _Png(NamedTuple):
    """A PNG as _read_png reads it: the stored samples and what libpng
    keeps of the ancillary chunks that change cv2's reads."""
    px: np.ndarray        # (H, W, C) uint8, or uint16 at 16 bits
    color: int            # colour type
    depth: int            # bit depth
    plte: Optional[np.ndarray]  # (n, 3) uint8 palette
    exif: Optional[bytes]  # the first eXIf chunk's bytes
    trns: Optional[bytes]  # a tRNS chunk libpng accepts
    gamma: int            # the file gamma x 100000 (0: none stated)
    sbit: int             # sBIT's largest colour channel (0: none)


def _ihdr_ok(W, H, depth, color, compression, filt, interlace) -> bool:
    """libpng's png_check_IHDR under its default user limits (filter method
    64 is MNG's, refused in a PNG stream)."""
    return (0 < W <= PNG_USER_MAX and 0 < H <= PNG_USER_MAX
            and color in _PNG_CHANNELS and depth in _PNG_DEPTHS[color]
            and interlace <= 1 and compression == 0 and filt == 0)


def _read_png(data: bytes, name="PNG") -> _Png:
    """A PNG's samples and chunks under cv2 5.0's chunk rules (its own
    chunk reader, then libpng's; the same for IMREAD_COLOR,
    IMREAD_GRAYSCALE and IMREAD_UNCHANGED).  Found by a sweep against
    cv2.imread of flipped CRCs, inserted, repeated and missing chunks and
    cuts at every chunk boundary (tests/test_torch_image_damage.py):
      * the first chunk is IHDR with a valid CRC and fields libpng's
        png_check_IHDR accepts; the chunks up to IEND are read whole
        (length, type, data, CRC), their types four letters: a file that
        ends before IEND's CRC, or has no IEND, reads nothing;
      * IEND ends the file, its CRC and data unread, and what follows it
        is never read;
      * a bad CRC on IDAT, or on PLTE in a palette image, reads nothing;
        an ancillary chunk (lowercase first letter) with a bad CRC is
        dropped, and so is PLTE in an image without a palette;
      * a second IHDR, a second palette PLTE, a PLTE after the image
        data and an unknown critical chunk (uppercase first letter) read
        nothing;
      * the IDAT chunks follow one another: a chunk between them before
        the zlib stream ends, or an IDAT after another chunk, reads
        nothing; data after the stream's end is ignored;
      * cv2 has the header once the first IDAT chunk is read whole: a
        palette image without PLTE reads nothing there, and an image past
        cv2's size limit raises ImageSizeError there, before any inflation
        (and before IDAT's CRC is checked);
      * gAMA, sRGB and sBIT count before PLTE and IDAT, tRNS before IDAT
        (after PLTE in a palette image), each the first of its kind that
        libpng accepts: gAMA of 4 bytes up to 2^31 - 1 (0 counts, and
        states no gamma), sRGB of one byte, intent 0-3 (gamma 45455,
        before any gAMA), sBIT of one byte a channel, each 1 to the sample
        depth, tRNS of 2 bytes (gray), 6 (RGB) or 1 to the palette's
        entries (none with an alpha channel).
    Every refusal is a ValueError naming the format."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")

    def refuse(what):
        return ValueError(f"{name}: PNG {what}")

    pos, n, hdr, plte, exif = 8, len(data), None, None, None
    z, out, in_idat, after_idat = zlib.decompressobj(), [], False, False
    gamma = srgb = sbit = trns = None
    any_plte = False  # a suggested palette in an RGB(A) image
    while True:
        if pos + 12 > n:
            raise refuse("file ends before its IEND chunk" if hdr else
                          "file has no IHDR chunk")
        size, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if pos + 12 + size > n:
            raise refuse(f"chunk {tag!r} is cut short")
        body = data[pos + 8:pos + 8 + size]
        crc_ok = struct.unpack(">I", data[pos + 8 + size:pos + 12 + size])[
            0] == zlib.crc32(tag + body) & 0xFFFFFFFF
        pos += 12 + size
        if not tag.isalpha() or not tag.isascii():
            raise refuse(f"chunk type {tag!r} is not valid")
        if hdr is None:
            if tag != b"IHDR" or not crc_ok or size != 13:
                raise refuse("does not start with a valid IHDR chunk")
            hdr = struct.unpack(">IIBBBBB", body)
            if not _ihdr_ok(*hdr):
                raise refuse("IHDR {} x {}, bit depth {}, colour type {}, "
                             "compression {}, filter {}, interlace {} is "
                             "not valid".format(*hdr))
            W, H, depth, color, _, _, interlace = hdr
            continue
        if tag == b"IEND":
            break
        palette = color == 3
        if tag == b"IDAT":
            if not in_idat and not after_idat:
                if palette and plte is None:
                    raise refuse("palette image without PLTE before IDAT")
                _check_size(W, H, name)
            if not crc_ok:
                raise refuse("IDAT chunk has a bad CRC")
            if after_idat:
                raise refuse("IDAT chunk after the image data")
            in_idat = True
            if not z.eof:
                try:
                    out.append(z.decompress(body))
                except zlib.error as e:
                    raise refuse(f"image data does not inflate ({e})")
            continue
        if in_idat:
            if not z.eof:
                raise refuse(f"chunk {tag!r} inside the image data")
            after_idat = True
        if tag == b"IHDR":
            raise refuse("has a second IHDR chunk")
        if tag == b"PLTE":
            if palette:
                if not crc_ok:
                    raise refuse("PLTE chunk has a bad CRC")
                if plte is not None or in_idat:
                    raise refuse("PLTE chunk repeated or after the image "
                                 "data")
                plte = np.frombuffer(body, dtype=np.uint8).reshape(-1, 3)
            elif color & 2:  # a suggested palette in an RGB(A) image
                if size == 0:
                    raise refuse("PLTE chunk is empty")
                # counted whatever its CRC; one of a bad length is dropped
                any_plte |= size % 3 == 0 and size <= 768
        elif not tag[0] & 0x20:
            raise refuse(f"unknown critical chunk {tag!r}")
        elif not crc_ok:
            continue
        elif tag == b"eXIf":
            if exif is None and body[:2] in (b"II", b"MM"):
                # libpng keeps the first eXIf whose byte order is II or MM
                exif = body
        elif in_idat:
            continue  # libpng reads no gamma, sBIT or tRNS after IDAT
        elif tag == b"tRNS":
            if trns is None and (
                    (color == 0 and size == 2) or (color == 2 and size == 6)
                    or (palette and plte is not None
                        and 0 < size <= plte.shape[0])):
                trns = body
        elif any_plte or plte is not None:
            continue  # gAMA, sRGB and sBIT come before PLTE
        elif tag == b"gAMA":
            if gamma is None and size == 4 and body[0] < 0x80:
                gamma = struct.unpack(">I", body)[0]
        elif tag == b"sRGB":
            if srgb is None and size == 1 and body[0] <= 3:
                srgb = _SRGB_GAMMA
        elif tag == b"sBIT":
            ch = 3 if palette else _PNG_CHANNELS[color]
            top = 8 if palette else depth
            if sbit is None and size == ch and all(
                    1 <= b <= top for b in body):
                sbit = max(body[:3]) if color & 2 else body[0]
    if not z.eof:
        raise refuse("image data is cut short" if in_idat
                     else "has no IDAT chunk")
    ch = _PNG_CHANNELS[color]
    bpp = max(1, ch * depth // 8)
    raw = np.frombuffer(b"".join(out), dtype=np.uint8)
    file_gamma = srgb or gamma or 0
    if not interlace:
        rowbytes = (W * ch * depth + 7) // 8
        px = _png_samples(png_unfilter(raw, H, rowbytes, bpp), H, W, ch,
                          depth)
        return _Png(px, color, depth, plte, exif, trns, file_gamma,
                    sbit or 0)
    # Adam7: the inflated stream holds the passes one after the other, each
    # a filtered image of its own; an empty pass has no rows at all
    passes = [(x0, y0, dx, dy, max(0, -(-(W - x0) // dx)),
               max(0, -(-(H - y0) // dy))) for x0, y0, dx, dy in ADAM7]
    need = sum(ph * ((pw * ch * depth + 7) // 8 + 1)
               for *_, pw, ph in passes if pw and ph)
    if raw.size < need:
        raise ValueError(f"PNG data holds {raw.size} bytes, {need} needed")
    px = np.zeros((H, W, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy, pw, ph in passes:
        if pw == 0 or ph == 0:
            continue
        rowbytes = (pw * ch * depth + 7) // 8
        rows = png_unfilter(raw[pos:], ph, rowbytes, bpp)
        pos += ph * (rowbytes + 1)
        px[y0::dy, x0::dx] = _png_samples(rows, ph, pw, ch, depth)
    return _Png(px, color, depth, plte, exif, trns, file_gamma, sbit or 0)


def read_png(data: bytes, name="PNG"):
    """(pixels (H, W, C) uint8 or >u2-decoded uint16 as stored, colour type,
    bit depth, palette (n, 3) uint8 or None) of a PNG, interlaced or not;
    no EXIF orientation applied."""
    return tuple(_read_png(data, name)[:4])


def _png_rgb(px, color, depth, plte):
    """8-bit RGB or gray channels as libpng hands them to cv2 (gray below
    8 bits scaled, palette expanded, alpha dropped); 16-bit samples stay
    16-bit.  Returns (array (H, W, 1 or 3), is_color)."""
    if color == 3:
        idx = px[:, :, 0]
        pal = np.zeros((256, 3), dtype=np.uint8)
        pal[:plte.shape[0]] = plte
        return pal[idx], True
    if color in (0, 4):
        g = px[:, :, :1]
        if depth < 8:
            g = (g.astype(np.uint16) * (255 // ((1 << depth) - 1))).astype(
                np.uint8)
        return g, False
    return px[:, :, :3], True


def _strip16(a: np.ndarray) -> np.ndarray:
    return (a >> 8).astype(np.uint8) if a.dtype == np.uint16 else a


# ---------------------------------------------------------------------------
# libpng 1.6.58's gamma in png_do_rgb_to_gray (pngrtran.c), which cv2's
# IMREAD_GRAYSCALE reaches through png_set_rgb_to_gray(1, 0.299, 0.587)
# with no screen gamma set: the screen gamma is then 1 / file gamma, and
# the tables are built where either gamma is significant.  Gamma values
# are png_fixed_point (x 100000); the arithmetic is libpng's floating
# point (png.c), exact against cv2 on all 2^24 colours of an 8-bit image.

_FP1 = 100000
_SRGB_GAMMA = 45455  # PNG_GAMMA_sRGB_INVERSE
_RGB_TO_GRAY = (9797, 19234, 3737)  # 0.299, 0.587 in 1/32768 (truncated)


def _gamma_significant(g: int) -> bool:
    return g < _FP1 - 5000 or g > _FP1 + 5000  # PNG_GAMMA_THRESHOLD 0.05


def _fixed(r: float) -> int:
    """floor(r + .5) as a png_fixed_point, 0 on overflow."""
    r = math.floor(r + .5)
    return int(r) if -2147483648 <= r <= 2147483647 else 0


def _reciprocal(a: int) -> int:  # png_reciprocal
    return _fixed(1e10 / a) if a else 0


def _reciprocal2(a: int, b: int) -> int:  # png_reciprocal2
    return _fixed(1e15 / a / b)


def _product2(a: int, b: int) -> int:  # png_product2
    return _fixed(a * 1e-5 * b)


def _correct16(v: int, g: int) -> int:  # png_gamma_16bit_correct
    if 0 < v < 65535:
        return int(math.floor(65535 * math.pow(v / 65535., g * .00001)
                              + .5)) & 0xFFFF
    return v


@lru_cache(maxsize=64)
def _table8(g: int) -> np.ndarray:
    """png_build_8bit_table: png_gamma_8bit_correct of 0-255, or the
    identity where g is not significant."""
    t = np.arange(256, dtype=np.uint8)
    if _gamma_significant(g):
        for v in range(1, 255):
            t[v] = int(math.floor(255 * math.pow(v / 255., g * .00001)
                                  + .5)) & 0xFF
    t.flags.writeable = False  # shared by every caller
    return t


@lru_cache(maxsize=64)
def _table16(shift: int, g: int) -> np.ndarray:
    """png_build_16bit_table: (2^(8 - shift), 256) uint16, looked up as
    t[(v & 0xFF) >> shift, v >> 8]."""
    num, top = 1 << (8 - shift), (1 << (16 - shift)) - 1
    ig = (np.arange(256)[None, :] << (8 - shift)) + np.arange(num)[:, None]
    if not _gamma_significant(g):
        if shift:
            ig = (ig * 65535 + (1 << (15 - shift))) // top
        t = ig.astype(np.uint16)
    else:
        fmax = 1.0 / top
        t = np.array([[int(math.floor(65535. * math.pow(int(v) * fmax,
                                                        g * .00001) + .5))
                       & 0xFFFF for v in row] for row in ig], np.uint16)
    t.flags.writeable = False
    return t


@lru_cache(maxsize=64)
def _table16to8(shift: int, g: int) -> np.ndarray:
    """png_build_16to8_table as libpng 1.6.58 builds it (cv2 strips 16 to
    8 bits): each (16 - shift)-bit input up to the rounded boundary of
    output i takes i * 257, the rest 65535."""
    num, top = 1 << (8 - shift), (1 << (16 - shift)) - 1
    flat = np.full(num << 8, 65535, np.uint16)
    last = 0
    for i in range(255):
        bound = (_correct16(i * 257 + 128, g) * top + 32767) // 65535 + 1
        flat[last:max(last, bound)] = i * 257
        last = max(last, bound)
    # the input v11 = v >> shift is looked up at t[v11 & (num - 1),
    # v11 >> (8 - shift)]
    v11 = np.arange(num << 8)
    t = np.empty((num, 256), np.uint16)
    t[v11 & (num - 1), v11 >> (8 - shift)] = flat
    t.flags.writeable = False
    return t


def _png_gamma_gray(a: np.ndarray, file_gamma: int, sbit: int):
    """libpng's rgb-to-gray of (H, W, 3) RGB, uint8 or uint16, under a
    file gamma, cut to 8 bits as cv2's png_set_strip_16 cuts it; None
    where neither the file nor the screen gamma is significant (the plain
    weights apply)."""
    screen = _reciprocal(file_gamma)
    if not (_gamma_significant(file_gamma) or _gamma_significant(screen)):
        return None
    rc, gc, bc = _RGB_TO_GRAY
    r, g, b = (a[:, :, i].astype(np.int64) for i in range(3))
    same = (r == g) & (r == b)
    from_gamma = _reciprocal(screen) if screen > 0 else file_gamma
    if a.dtype == np.uint8:
        to1 = _table8(_reciprocal(file_gamma)).astype(np.int64)
        gray = _table8(from_gamma)[(rc * to1[r] + gc * to1[g] + bc * to1[b]
                                    + 16384) >> 15]
        table = _table8(_reciprocal2(file_gamma, screen) if screen > 0
                        else _FP1)
        return np.where(same, table[r], gray)
    # gamma_shift: the bits below sBIT's, at least 16 - PNG_MAX_GAMMA_8
    shift = 16 - sbit if 0 < sbit < 16 else 0
    shift = min(max(shift, 16 - 11), 8)

    def look(t, v):
        return t[(v & 0xFF) >> shift, v >> 8].astype(np.int64)

    to1 = _table16(shift, _reciprocal(file_gamma))
    s = (rc * look(to1, r) + gc * look(to1, g) + bc * look(to1, b)
         + 16384) >> 15
    w = np.where(same, look(_table16to8(shift, _product2(file_gamma, screen)
                                        if screen > 0 else _FP1), r),
                 look(_table16(shift, from_gamma), s))
    return (w >> 8).astype(np.uint8)


def _png_gray(png: _Png) -> np.ndarray:
    a, is_color = _png_rgb(png.px, png.color, png.depth, png.plte)
    if not is_color:
        return _strip16(a[:, :, 0])
    if png.gamma:
        gray = _png_gamma_gray(a, png.gamma, png.sbit)
        if gray is not None:
            return gray
    r, g, b = (a[:, :, i].astype(np.int64) for i in range(3))
    if a.dtype == np.uint16:
        return _strip16(((9797 * r + 19234 * g + 3737 * b + 16384) >> 15)
                        .astype(np.uint16))
    return ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)


def _png_color(png: _Png) -> np.ndarray:
    a, is_color = _png_rgb(png.px, png.color, png.depth, png.plte)
    a = _strip16(a)
    if not is_color:
        return np.repeat(a, 3, axis=2)
    return np.ascontiguousarray(a[:, :, ::-1])


def _png_unchanged(png: _Png) -> np.ndarray:
    """cv2's IMREAD_UNCHANGED of a PNG: gray (H, W) (below 8 bits scaled,
    tRNS dropped), gray + alpha as (G, G, G, A), RGB as BGR, RGBA as BGRA,
    a palette expanded to BGR; RGB and palette images with a tRNS libpng
    accepts as BGRA (alpha 0 where an RGB pixel equals the tRNS colour,
    8-bit samples against its low bytes, else the maximum; a palette entry
    past tRNS's opaque).  16-bit samples stay uint16."""
    px, color = png.px, png.color
    if color in (0, 4):
        g = _png_rgb(px, color, png.depth, png.plte)[0][:, :, 0]
        return (g if color == 0 else
                np.stack([g, g, g, px[:, :, 1]], -1))
    if color == 3:
        bgr = _png_rgb(px, color, png.depth, png.plte)[0][:, :, ::-1]
        if png.trns is None:
            return np.ascontiguousarray(bgr)
        alpha = np.full(256, 255, np.uint8)
        alpha[:len(png.trns)] = np.frombuffer(png.trns, np.uint8)
        return np.concatenate([bgr, alpha[px[:, :, :1]]], -1)
    if color == 6:
        return np.ascontiguousarray(px[:, :, [2, 1, 0, 3]])
    bgr = px[:, :, ::-1]
    if png.trns is None:
        return np.ascontiguousarray(bgr)
    key = np.array(struct.unpack(">HHH", png.trns), np.uint16)
    if px.dtype == np.uint8:
        key = key & 0xFF
    opaque = np.iinfo(px.dtype).max
    alpha = np.where((px == key.astype(px.dtype)).all(-1), 0, opaque)
    return np.concatenate([bgr, alpha[:, :, None].astype(px.dtype)], -1)


def _fill_run(out, p, line_end, y, count, value, W, H):
    """cv2's FillUniColor in palette indices: count pixels of value from p
    on, wrapping to the next row at its end; returns (p, line_end, y)."""
    while True:
        end = min(p + count, line_end)
        count -= end - p
        out[p:end] = value
        p = end
        if p >= line_end:
            line_end += W
            p = line_end - W
            y += 1
            if y >= H:
                break
        if count <= 0:
            break
    return p, line_end, y


def _rle_indices(data: bytes, pos: int, W: int, H: int, four: bool, name):
    """Palette indices (H * W, file order) of an RLE8 or RLE4 stream from
    pos, as cv2's grfmt_bmp walks it: encoded runs (RLE4: two alternating
    nibbles), absolute runs padded to 16 bits, end of line, delta and end
    of bitmap filling what they skip with entry 0.  A run past the row's
    end, or a stream that ends first, raises (cv2 reads nothing).  In RLE8
    an encoded run that reaches the row's end moves to the next row, and
    an end of line right after it is then passed over.  In RLE4 a delta
    moves dx pixels along the row (its dy is not read) and an end of
    bitmap ends the row only, as an end of line does."""
    out = np.zeros(H * W, np.uint8)
    n = len(data)
    p, line_end, y, flag = 0, W, 0, 0

    def cut():
        return ValueError(f"{name}: BMP RLE data ends before the image")

    while True:
        if pos + 2 > n:
            raise cut()
        ln, code = data[pos], data[pos + 1]
        pos += 2
        if ln:  # encoded
            if p + ln > line_end:
                raise ValueError(f"{name}: a BMP RLE run passes the end of "
                                 f"its row")
            if four:
                pair = np.array([code >> 4, code & 15], np.uint8)
                out[p:p + ln] = np.resize(pair, ln)
                p += ln
            elif p + ln < line_end:  # the common case: inside the row
                out[p:p + ln] = code
                p += ln
                flag = 0
            else:
                prev_y = y
                p, line_end, y = _fill_run(out, p, line_end, y, ln, code, W,
                                           H)
                flag = y - prev_y
                if y >= H:
                    break
        elif code > 2:  # absolute
            if p + code > line_end:
                raise ValueError(f"{name}: a BMP RLE run passes the end of "
                                 f"its row")
            nb = (code + 1) // 2 if four else code
            sz = (nb + 1) & ~1
            if pos + sz > n:
                raise cut()
            raw = np.frombuffer(data, np.uint8, nb, pos)
            if four:
                raw = np.stack([raw >> 4, raw & 15], 1).ravel()[:code]
            out[p:p + code] = raw
            p += code
            pos += sz
            flag = 0
        else:  # end of line (0), end of bitmap (1), delta (2)
            x_shift, y_shift = line_end - p, H - y
            if four or code or not flag or x_shift < W:
                if code == 2:
                    if pos + 2 > n:
                        raise cut()
                    x_shift, y_shift = data[pos], data[pos + 1]
                    pos += 2
                if code and not four:  # RLE4 moves along the row only
                    x_shift += y_shift * W
                if y >= H:
                    break
                p, line_end, y = _fill_run(out, p, line_end, y, x_shift, 0,
                                           W, H)
                if y >= H:
                    break
            flag = 0
            if y >= H:
                break
    return out


def read_bmp(data: bytes, name="BMP"):
    """(BGR pixels (H, W, 3) uint8 top row first) of a BMP as cv2's
    grfmt_bmp reads it: a header of 36 bytes or more (BITMAPINFOHEADER, V4,
    V5) or an OS/2 BITMAPCOREHEADER (12 bytes: 16-bit sizes, 3-byte
    palette entries); palette images of 1, 4 and 8 bits, uncompressed, RLE4
    and RLE8; 16 bits as 555, or bit fields 555 / 565 (other masks are not
    read); 24 bits; 32 bits plain, or with bit fields after a 40- or
    52-byte header (the masks ignored: bytes B, G, R, A) or inside a
    header of 56 bytes or more (V3, V4, V5): there, where the red, green
    and blue masks are all nonzero, each channel is its field scaled as
    cv2 5.0 scales it in float32, (int)(field * (255.0f / (mask >>
    shift))), shift the mask's trailing zeros (any mask, contiguous or
    not; the alpha mask unread), and a zero mask leaves the bytes B, G, R;
    bottom-up or top-down.  The palette follows the
    header, of clrUsed entries (2^bits when 0), the 16-bit masks too (after
    the whole header, as cv2 reads them even where a V4 or V5 header holds
    them).  Other files raise ValueError naming the format."""
    return _read_bmp(data, name).bgr


def _field_channel(words: np.ndarray, mask: int) -> np.ndarray:
    """uint8 channel of 32-bit pixels under a nonzero bit-field mask, as
    cv2 5.0 scales it: (int)((float)field * (255.0f / (float)max))."""
    shift = (mask & -mask).bit_length() - 1
    field = (words & np.uint32(mask)) >> np.uint32(shift)
    scale = np.float32(255) / np.float32(mask >> shift)
    return (field.astype(np.float32) * scale).astype(np.uint8)


def _gray_float(bgr: np.ndarray) -> np.ndarray:
    """cv2 5.0's gray of the masked 32-bit path: floor((0.299f R +
    0.587f G) + 0.114f B) in float32 (exact against cv2 on all 2^24
    colours)."""
    b, g, r = (bgr[:, :, i].astype(np.float32) for i in range(3))
    s = (np.float32(0.299) * r + np.float32(0.587) * g) \
        + np.float32(0.114) * b
    return s.astype(np.uint8)


class _Bmp(NamedTuple):
    """A BMP as _read_bmp reads it, and what cv2's three reads take."""
    bgr: np.ndarray  # (H, W, 3) uint8, the top row first
    # cv2 takes the gray in float32 (_gray_float: 32-bit bit fields under a
    # header of 56 bytes or more) rather than by cvtColor's fixed point
    masked: bool
    # IMREAD_UNCHANGED gives the gray read: an OS/2 header, or a palette of
    # 2^bits entries (zeros past the file's) all gray
    gray_unchanged: bool
    # IMREAD_UNCHANGED's fourth channel at 32 bits with bit fields: the
    # fourth byte, or with masked fields the alpha mask's field scaled as
    # the others (255 under a zero alpha mask); None elsewhere
    alpha: Optional[np.ndarray]


def _bmp_gray(bmp: _Bmp) -> np.ndarray:
    return _gray_float(bmp.bgr) if bmp.masked else _bgr_to_gray_cv(bmp.bgr)


def _read_bmp(data: bytes, name) -> _Bmp:
    n = len(data)
    if data[:2] != b"BM" or n < 18:
        raise ValueError(f"{name}: not a BMP file")
    off, hsize = struct.unpack_from("<Ii", data, 10)

    def bad(what):
        return ValueError(f"{name}: BMP {what} is not supported")

    def need(end):
        if end > n:
            raise ValueError(f"{name}: BMP file is cut short")

    pal = np.zeros((256, 3), np.uint8)
    masked, alpha = False, None
    if hsize >= 36:
        need(14 + 36)
        W, Hs = struct.unpack_from("<ii", data, 18)
        bits, comp = struct.unpack_from("<Hi", data, 28)
        clr_used = struct.unpack_from("<i", data, 46)[0]
        ok = ((bits in (1, 4, 8, 16, 24, 32) and comp == 0)
              or (bits in (16, 32) and comp == 3)
              or (bits == 4 and comp == 2) or (bits == 8 and comp == 1))
        if not (ok and W > 0 and Hs != 0):
            raise bad(f"of {bits} bits, compression {comp}")
        at = 14 + hsize
        if bits <= 8:
            if not 0 <= clr_used <= 256:
                raise bad(f"palette of {clr_used} colours")
            k = clr_used or 1 << bits
            need(at + 4 * k)
            pal[:k] = np.frombuffer(data, np.uint8, 4 * k, at).reshape(
                k, 4)[:, :3]
        elif bits == 16 and comp == 3:
            need(at + 12)
            masks = struct.unpack_from("<III", data, at)
            if masks == (0x7C00, 0x3E0, 0x1F):
                bits = 15
            elif masks != (0xF800, 0x7E0, 0x1F):
                raise bad(f"bit fields {tuple(hex(m) for m in masks)}")
        elif bits == 16:
            bits = 15
        elif comp == 3 and hsize >= 56:
            need(14 + 52)
            masks = struct.unpack_from("<III", data, 14 + 40)
            masked = all(masks)
    elif hsize == 12:
        need(26)
        # the planes field (bytes 22-23) is not read, as cv2 reads none
        W, Hs, _, bits = struct.unpack_from("<HHHH", data, 18)
        comp = 0
        if not (W > 0 and Hs != 0 and bits in (1, 4, 8, 24, 32)):
            raise bad(f"(OS/2) of {bits} bits")
        if bits <= 8:
            k = 1 << bits
            need(26 + 3 * k)
            pal[:k] = np.frombuffer(data, np.uint8, 3 * k, 26).reshape(k, 3)
    else:
        raise bad(f"header of {hsize} bytes")
    H = abs(Hs)
    _check_size(W, H, name)
    gray_unchanged = hsize == 12 or (bits <= 8 and not (
        pal[:1 << bits] != pal[:1 << bits, :1]).any())
    if comp in (1, 2):
        idx = _rle_indices(data, off, W, H, comp == 2, name).reshape(H, W)
        bgr = pal[idx]
    else:
        stride = ((W * (16 if bits == 15 else bits) + 7) // 8 + 3) & ~3
        need(off + stride * H)
        rows = np.frombuffer(data, np.uint8, stride * H, off).reshape(
            H, stride)
        if bits < 8:
            per = 8 // bits
            shifts = (8 - bits * (1 + np.arange(per))).astype(np.uint8)
            idx = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(
                H, -1)[:, :W]
            bgr = pal[idx]
        elif bits == 8:
            bgr = pal[rows[:, :W]]
        elif bits in (15, 16):
            t = rows[:, :2 * W].view("<u2").astype(np.int32)
            if bits == 15:
                g = (t >> 2) & 0xF8
                r = (t >> 7) & 0xF8
            else:
                g = (t >> 3) & 0xFC
                r = (t >> 8) & 0xF8
            bgr = np.stack([(t << 3) & 0xF8, g, r], -1).astype(np.uint8)
        elif masked:
            words = rows[:, :4 * W].view("<u4")
            bgr = np.stack([_field_channel(words, m) for m in masks[::-1]],
                           -1)
            am = struct.unpack_from("<I", data, 66)[0] if n >= 70 else 0
            alpha = (_field_channel(words, am) if am else
                     np.full((H, W), 255, np.uint8))
        else:
            k = bits // 8
            px = rows[:, :W * k].reshape(H, W, k)
            bgr = px[:, :, :3]
            if k == 4 and comp == 3:
                alpha = px[:, :, 3]
    if Hs > 0:
        bgr = bgr[::-1]
        alpha = None if alpha is None else alpha[::-1]
    return _Bmp(np.ascontiguousarray(bgr), masked, gray_unchanged, alpha)


def _bgr_to_gray_cv(bgr: np.ndarray) -> np.ndarray:
    b, g, r = (bgr[:, :, i].astype(np.int32) for i in range(3))
    return ((b * 1868 + g * 9617 + r * 4899 + 8192) >> 14).astype(np.uint8)


# ---------------------------------------------------------------------------
# EXIF orientation


class _ExifCut(Exception):
    pass


# IFD0 tags whose values cv2's ExifReader reads (and may find cut short):
# strings, rationals (with their count), 16-bit values
_EXIF_STRINGS = {0x010E, 0x010F, 0x0110, 0x0131, 0x0132, 0x8298}
_EXIF_RATIONALS = {0x011A: 1, 0x011B: 1, 0x013E: 2, 0x013F: 6, 0x0211: 3,
                   0x0214: 6}
_EXIF_SHORTS = {0x0112, 0x0128, 0x0213}
_ORIENTATION = 0x0112


def exif_orientation(tiff: bytes) -> int:
    """The orientation (1-8) that cv2.imread applies from an EXIF block
    (a TIFF header: byte order II or MM, 42, the offset of IFD0), 1 where
    it applies none.  It reads IFD0 as cv2's ExifReader does: entry by
    entry, the value of tag 0x0112 as 16 bits at the entry's value field
    whatever its type and count, the first such entry kept.  A read past
    the block's end stops the walk (an entry read before it still counts),
    and so does a string or rational entry whose data lies past the end;
    a value outside 1-8 is ignored."""
    n = len(tiff)
    order = "<" if tiff[:2] == b"II" else ">"

    def u16(o):
        if o + 1 >= n:
            raise _ExifCut
        return struct.unpack_from(order + "H", tiff, o)[0]

    def u32(o):
        if o + 3 >= n:
            raise _ExifCut
        return struct.unpack_from(order + "I", tiff, o)[0]

    found = None
    try:
        if u16(2) != 42:
            return 1
        off = u32(4)
        count = u16(off)
        off += 2
        for _ in range(count):
            tag = u16(off)
            if tag in _EXIF_STRINGS:
                size = u32(off + 4)
                at = u32(off + 8) if size > 4 else 8
                if at > n or at + size > n:
                    raise _ExifCut
            elif tag in _EXIF_RATIONALS:
                at = u32(off + 8)
                for i in range(_EXIF_RATIONALS[tag]):
                    u32(at + 8 * i)
                    u32(at + 8 * i + 4)
            elif tag in _EXIF_SHORTS:
                v = u16(off + 8)
                if tag == _ORIENTATION and found is None:
                    found = v
            off += 12
    except _ExifCut:
        pass
    return found if found is not None and 1 <= found <= 8 else 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """img (H, W) or (H, W, C) turned as cv2.imread turns it for an EXIF
    orientation: 2 flip horizontally, 3 rotate 180 degrees, 4 flip
    vertically, 5 transpose, 6 rotate 90 degrees clockwise, 7 transverse,
    8 rotate 90 degrees counter-clockwise; 1 (and any other value) as it
    is."""
    t = img.swapaxes(0, 1) if orientation in (5, 6, 7, 8) else img
    if orientation in (2, 3, 6, 7):
        t = t[:, ::-1]
    if orientation in (3, 4, 7, 8):
        t = t[::-1]
    return t if t is img else np.ascontiguousarray(t)


# ---------------------------------------------------------------------------
# JPEG reader (the native library's lvba_jpeg_info / lvba_jpeg_decode)

JPEG_FORMATS = ("baseline", "extended sequential", "progressive", "lossless",
                "arithmetic-coded sequential",
                "arithmetic-coded progressive")
JPEG_COLOR_SPACES = ("gray", "YCbCr", "RGB", "CMYK", "YCCK")
_JPEG_ERR = 512


def jpeg_info(data: bytes, name="JPEG") -> dict:
    """The header of a JPEG up to its first scan: height, width,
    components, sampling ((h, v) a component), format (JPEG_FORMATS),
    color_space (as libjpeg picks it from JFIF, Adobe APP14 and the
    component ids), orientation (its EXIF APP1's, 1 without one).
    ValueError naming the format for a file whose header libjpeg refuses
    (jpeg_read_header), ImageSizeError past cv2's size limit; what libjpeg
    refuses later (a missing table, two components) is read_jpeg's
    ValueError."""
    import ctypes

    from ..native.runtime import _ptr, library

    buf = np.frombuffer(data, dtype=np.uint8)
    info = np.zeros(16, dtype=np.int64)
    err = ctypes.create_string_buffer(_JPEG_ERR)
    if library().lvba_jpeg_info(_ptr(buf), buf.size, _ptr(info), err,
                                _JPEG_ERR) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    H, W, nc, kind, color, eoff, elen = (int(v) for v in info[:7])
    _check_size(W, H, name)
    return dict(height=H, width=W, components=nc,
                sampling=tuple((int(info[7 + 2 * c]), int(info[8 + 2 * c]))
                               for c in range(nc)),
                format=JPEG_FORMATS[kind],
                color_space=JPEG_COLOR_SPACES[color],
                orientation=exif_orientation(data[eoff:eoff + elen])
                if eoff >= 0 else 1)


def read_jpeg(data: bytes, gray: bool, name="JPEG", info=None) -> np.ndarray:
    """(H, W) uint8 (gray: libjpeg's JCS_GRAYSCALE output, the Y plane of
    a YCbCr file, or cv2's gray of a four-component one) or (H, W, 3) BGR
    uint8 of a JPEG, libjpeg-turbo's decode with cv2's settings bit for
    bit; no EXIF orientation applied.
    info is jpeg_info(data) where the caller has it already.
    ValueError on a file the decoder does not read (libjpeg's fatal
    errors); damage libjpeg recovers from is recovered from alike."""
    import ctypes

    from ..native.runtime import _ptr, library

    if info is None:
        info = jpeg_info(data, name)
    shape = (info["height"], info["width"]) + (() if gray else (3,))
    out = np.empty(shape, dtype=np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8)
    err = ctypes.create_string_buffer(_JPEG_ERR)
    if library().lvba_jpeg_decode(_ptr(buf), buf.size, int(bool(gray)),
                                  _ptr(out), err, _JPEG_ERR) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def _read(path) -> bytes:
    p = Path(path)
    if not p.is_file():
        raise FileNotFoundError(str(path))
    return p.read_bytes()


def _format(data: bytes, path) -> str:
    if data[:8] == _PNG_SIGNATURE:
        return "png"
    if data[:2] == b"BM":
        return "bmp"
    if data[:3] == b"\xff\xd8\xff":
        return "jpeg"
    raise ValueError(f"{path}: unknown image format (PNG, JPEG and BMP are "
                     f"read)")


def _imread(path, gray: bool) -> np.ndarray:
    data = _read(path)
    kind = _format(data, path)
    if kind == "bmp":
        bmp = _read_bmp(data, path)
        return _bmp_gray(bmp) if gray else bmp.bgr
    if kind == "jpeg":
        info = jpeg_info(data, path)
        return apply_orientation(read_jpeg(data, gray, path, info),
                                 info["orientation"])
    png = _read_png(data, path)
    img = _png_gray(png) if gray else _png_color(png)
    return apply_orientation(img, 1 if png.exif is None
                             else exif_orientation(png.exif))


def imread_gray(path) -> np.ndarray:
    """(H, W) uint8, cv2.imread(path, IMREAD_GRAYSCALE) bit for bit (the
    EXIF orientation applied)."""
    return _imread(path, True)


def imread_color(path) -> np.ndarray:
    """(H, W, 3) BGR uint8, cv2.imread(path, IMREAD_COLOR) bit for bit (the
    EXIF orientation applied)."""
    return _imread(path, False)


def imread_unchanged(path) -> np.ndarray:
    """cv2.imread(path, IMREAD_UNCHANGED) bit for bit: no EXIF orientation;
    PNG as _png_unchanged gives it (16-bit samples as uint16, alpha and
    tRNS as a fourth channel); JPEG as the gray read (H, W) of one
    component, else the colour read; BMP as the gray read under an OS/2
    header or a gray palette, BGRA at 32 bits with bit fields, else the
    colour read."""
    data = _read(path)
    kind = _format(data, path)
    if kind == "bmp":
        bmp = _read_bmp(data, path)
        if bmp.alpha is not None:
            return np.concatenate([bmp.bgr, bmp.alpha[:, :, None]], -1)
        return _bmp_gray(bmp) if bmp.gray_unchanged else bmp.bgr
    if kind == "jpeg":
        info = jpeg_info(data, path)
        return read_jpeg(data, info["components"] == 1, path, info)
    return _png_unchanged(_read_png(data, path))


def imread_color_or_none(path):
    """imread_color(path), or None exactly where cv2.imread(path,
    IMREAD_COLOR) returns None: a missing file, or one the readers refuse
    (their ValueError naming the format).  Any other error is raised,
    ImageSizeError among them (cv2.imread raises past its size limit)."""
    try:
        return _imread(path, False)
    except (FileNotFoundError, ValueError):
        return None


# ---------------------------------------------------------------------------
# resize

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _taps(dst: int, src: int, clamp: bool):
    """cv2.resize's INTER_LINEAR source offsets and 11-bit weights along
    one axis (resizeGeneric_'s float arithmetic): (lo (dst,), w0, w1).
    Columns (clamp) past either edge take the edge pixel at full weight;
    rows keep their weights and read the edge row twice."""
    scale = np.float64(1.0) / (np.float64(dst) / np.float64(src))
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        left = s < 0
        f[left], s[left] = 0.0, 0
        right = s >= src - 1
        f[right], s[right] = 0.0, src - 1
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(
        np.int64)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    return s, w0, w1


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=INTER_LINEAR) on an
    (H, W) or (H, W, C) uint8 image, bit for bit."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError("resize_linear takes an (H, W) or (H, W, C) uint8 "
                         "image")
    H, W = img.shape[:2]
    if (W, H) == (width, height):
        return img.copy()
    a = img.reshape(H, W, -1)
    if W == 2 * width and H == 2 * height:
        # cv2 turns an exact 2:1 linear reduction into its area average
        s = a.astype(np.int32)
        out = (s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2]
               + 2) >> 2
        return out.astype(np.uint8).reshape(
            (height, width) + img.shape[2:])
    xs, xw0, xw1 = _taps(width, W, True)
    ys, yw0, yw1 = _taps(height, H, False)
    xs1 = np.minimum(xs + 1, W - 1)
    # horizontal pass: int sums at 11 bits; the taps past the right edge
    # hold the last pixel at full weight
    s = a.astype(np.int64)
    rows = (s[:, xs] * xw0[None, :, None] + s[:, xs1] * xw1[None, :, None])
    rows = rows.reshape(H, -1)
    y0 = np.clip(ys, 0, H - 1)
    y1 = np.clip(ys + 1, 0, H - 1)
    # vertical pass as cv2's VResizeLinearVec_32s8u rounds it, over the
    # whole row: the 16-bit high halves of (S >> 4) * b, summed, (+ 2) >> 2
    def mulhi(v, b):
        return ((v >> 4) * b) >> 16

    out = (mulhi(rows[y0], yw0[:, None]) + mulhi(rows[y1], yw1[:, None])
           + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape(
        (height, width) + img.shape[2:])


# ---------------------------------------------------------------------------
# PNG writer


def encode_png(img: np.ndarray) -> bytes:
    """8-bit gray (H, W) or BGR (H, W, 3) as PNG bytes: one IDAT of filter 0
    rows deflated at level 1."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (
            img.ndim == 3 and img.shape[2] in (1, 3))):
        raise ValueError("imwrite_png takes (H, W) or (H, W, 3) uint8")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    H, W = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    px = img if color == 0 else img[:, :, ::-1]
    rows = np.zeros((H, 1 + px[0].size), dtype=np.uint8)
    rows[:, 1:] = px.reshape(H, -1)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, color, 0, 0, 0)
    return (_PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + _png_chunk(b"IEND", b""))


def imwrite_png(path, img: np.ndarray):
    """Write `img` (8-bit gray or BGR) as a PNG file; cv2.imread gives the
    same pixels back."""
    Path(path).write_bytes(encode_png(img))


# ---------------------------------------------------------------------------
# JPEG writer


# the first pass's room an image, in bytes a pixel: quality 95 keeps even
# noise under 1.2; an image that does not fit is
# encoded again with room for the worst case a baseline stream can take
JPEG_FIRST_BYTES_A_PIXEL = 3.0
# 6 blocks an MCU of 256 pixels, at most 64 codes of 16 + 11 bits each,
# every byte of it 0xFF and stuffed
_JPEG_WORST_BYTES_A_PIXEL = 6 * 64 * 27 / 8 * 2 / 256


def _jpeg_batch(imgs, cap):
    """lvba_jpeg_encode over a stack with `cap` bytes an image: bytes per
    image, None where the stream did not fit."""
    from ..native.runtime import library, _ptr

    n, H, W = imgs.shape[:3]
    out = np.empty((n, cap), dtype=np.uint8)
    sizes = np.empty(n, dtype=np.int64)
    library().lvba_jpeg_encode(_ptr(imgs), n, H, W, _ptr(out), cap,
                               _ptr(sizes))
    return [out[i, :sizes[i]].tobytes() if sizes[i] >= 0 else None
            for i in range(n)]


def encode_jpeg(images) -> list:
    """Baseline JPEG bytes of each BGR uint8 image of a stack (N, H, W, 3)
    (or one (H, W, 3) image), as cv2.imencode(".jpg") writes them at its
    defaults; one thread an image on every hardware thread."""
    imgs = np.ascontiguousarray(images, dtype=np.uint8)
    if imgs.ndim == 3:
        imgs = imgs[None]
    if imgs.ndim != 4 or imgs.shape[3] != 3:
        raise ValueError("encode_jpeg takes BGR uint8 (N, H, W, 3) or "
                         "(H, W, 3)")
    H, W = imgs.shape[1:3]
    if not (0 < H < 65536 and 0 < W < 65536):
        raise ValueError(f"a JPEG frame holds at most 65535 x 65535 pixels, "
                         f"got {W} x {H}")
    res = _jpeg_batch(imgs, int(JPEG_FIRST_BYTES_A_PIXEL * H * W) + 4096)
    for i, data in enumerate(res):
        if data is None:
            res[i] = _jpeg_batch(
                imgs[i:i + 1],
                int(_JPEG_WORST_BYTES_A_PIXEL * (H + 15) * (W + 15))
                + 4096)[0]
    return res


def imwrite_jpeg(path, img: np.ndarray):
    """Write a BGR uint8 image as cv2.imwrite(path.jpg) does."""
    Path(path).write_bytes(encode_jpeg(img)[0])
