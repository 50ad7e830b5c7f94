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
  * JPEG: baseline, extended sequential and progressive Huffman-coded,
    8 bits, one or three components, by the native library's
    lvba_jpeg_decode: libjpeg-turbo's decompressor with cv2's settings
    (islow IDCT, fancy upsampling, BGR or the Y plane out; read_jpeg).
    Arithmetic coding, lossless and hierarchical frames, 12-bit samples
    and two- or four-component (CMYK / YCCK) frames raise ValueError
    naming the format, and so does a damaged file, where libjpeg warns
    and cv2 returns what it decoded.
  * BMP, uncompressed 8-bit (palette), 24- and 32-bit, bottom-up and
    top-down, with cv2's own gray weights ((4899 R + 9617 G + 1868 B +
    8192) >> 14).
Both reads turn the image by its EXIF orientation as cv2.imread does
(a PNG's eXIf chunk, a JPEG's first Exif APP1; exif_orientation,
apply_orientation); read_png, the depth maps' reader, does not, as
cv2's IMREAD_UNCHANGED does not.  Other inputs raise ValueError naming
the format.

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

import struct
import zlib
from pathlib import Path

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
               6: (8, 16)}


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


def _read_png(data: bytes, name="PNG"):
    """read_png's four results and the first eXIf chunk's bytes (None
    without one)."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, idat, hdr, plte, exif = 8, [], None, None, None
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4 or struct.unpack(">I", crc)[0] \
                != zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise ValueError(f"{name}: chunk {tag!r} is cut or corrupt")
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, dtype=np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"eXIf" and exif is None and body[:2] in (b"II", b"MM"):
            # libpng keeps the first eXIf whose byte order is II or MM
            exif = body
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{name}: no IHDR chunk")
    W, H, depth, color, _, _, interlace = hdr
    if interlace > 1:
        raise ValueError(f"{name}: PNG interlace method {interlace} is not "
                         f"valid")
    if color not in _PNG_CHANNELS or depth not in _PNG_DEPTHS[color]:
        raise ValueError(f"{name}: PNG colour type {color} at bit depth "
                         f"{depth} is not valid")
    if color == 3 and plte is None:
        raise ValueError(f"{name}: palette PNG without PLTE")
    ch = _PNG_CHANNELS[color]
    bpp = max(1, ch * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    if not interlace:
        rowbytes = (W * ch * depth + 7) // 8
        px = _png_samples(png_unfilter(raw, H, rowbytes, bpp), H, W, ch,
                          depth)
        return px, color, depth, plte, exif
    # Adam7: the inflated stream holds the passes one after the other, each
    # a filtered image of its own; an empty pass has no rows at all
    px = np.zeros((H, W, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in ADAM7:
        pw, ph = max(0, -(-(W - x0) // dx)), max(0, -(-(H - y0) // dy))
        if pw == 0 or ph == 0:
            continue
        rowbytes = (pw * ch * depth + 7) // 8
        rows = png_unfilter(raw[pos:], ph, rowbytes, bpp)
        pos += ph * (rowbytes + 1)
        px[y0::dy, x0::dx] = _png_samples(rows, ph, pw, ch, depth)
    return px, color, depth, plte, exif


def read_png(data: bytes, name="PNG"):
    """(pixels (H, W, C) uint8 or >u2-decoded uint16 as stored, colour type,
    bit depth, palette (n, 3) uint8 or None) of a PNG, interlaced or not;
    no EXIF orientation applied."""
    return _read_png(data, name)[:4]


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


def _png_gray(px, color, depth, plte) -> np.ndarray:
    a, is_color = _png_rgb(px, color, depth, plte)
    if not is_color:
        return _strip16(a[:, :, 0])
    r, g, b = (a[:, :, i].astype(np.int64) for i in range(3))
    if a.dtype == np.uint16:
        return _strip16(((9797 * r + 19234 * g + 3737 * b + 16384) >> 15)
                        .astype(np.uint16))
    return ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)


def _png_color(px, color, depth, plte) -> np.ndarray:
    a, is_color = _png_rgb(px, color, depth, plte)
    a = _strip16(a)
    if not is_color:
        return np.repeat(a, 3, axis=2)
    return np.ascontiguousarray(a[:, :, ::-1])


def read_bmp(data: bytes, name="BMP"):
    """(BGR pixels (H, W, 3) uint8 top row first, per-pixel palette or
    direct) of an uncompressed 8-, 24- or 32-bit BMP."""
    if data[:2] != b"BM" or len(data) < 54:
        raise ValueError(f"{name}: not a BMP file")
    off = struct.unpack("<I", data[10:14])[0]
    hsize = struct.unpack("<I", data[14:18])[0]
    if hsize < 40:
        raise ValueError(f"{name}: OS/2 BMP headers are not supported")
    W, Hs, _, bits, comp = struct.unpack("<iiHHI", data[18:34])
    ncol = struct.unpack("<I", data[46:50])[0]
    top_down = Hs < 0
    H = abs(Hs)
    if bits not in (8, 24, 32) or comp not in (0, 3) or \
            (comp == 3 and bits != 32) or W <= 0 or H == 0:
        raise ValueError(f"{name}: BMP of {bits} bits, compression {comp} "
                         f"is not supported (8/24/32-bit uncompressed only)")
    if comp == 3:
        masks = struct.unpack("<III", data[54:66])
        if masks != (0xFF0000, 0xFF00, 0xFF):
            raise ValueError(f"{name}: BMP bit fields {masks} are not "
                             f"supported")
    stride = (W * bits // 8 + 3) & ~3
    buf = np.frombuffer(data, dtype=np.uint8, count=stride * H, offset=off)
    rows = buf.reshape(H, stride)
    if not top_down:
        rows = rows[::-1]
    if bits == 8:
        n = ncol if ncol else 256
        pal = np.frombuffer(data, dtype=np.uint8, count=4 * n,
                            offset=14 + hsize).reshape(n, 4)[:, :3]
        full = np.zeros((256, 3), dtype=np.uint8)
        full[:n] = pal
        return full[rows[:, :W]]
    k = bits // 8
    return np.ascontiguousarray(rows[:, :W * k].reshape(H, W, k)[:, :, :3])


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

JPEG_FORMATS = ("baseline", "extended sequential", "progressive")
JPEG_COLOR_SPACES = ("gray", "YCbCr", "RGB")
_JPEG_ERR = 512


def jpeg_info(data: bytes, name="JPEG") -> dict:
    """The header of a JPEG up to its first scan: height, width,
    components, sampling ((h, v) a component), format (JPEG_FORMATS),
    color_space (as libjpeg picks it from JFIF, Adobe APP14 and the
    component ids), orientation (its EXIF APP1's, 1 without one).
    ValueError naming the format for a file the decoder does not read."""
    import ctypes

    from ..native.runtime import _ptr, library

    buf = np.frombuffer(data, dtype=np.uint8)
    info = np.zeros(16, dtype=np.int64)
    err = ctypes.create_string_buffer(_JPEG_ERR)
    if library().lvba_jpeg_info(_ptr(buf), buf.size, _ptr(info), err,
                                _JPEG_ERR) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    H, W, nc, kind, color, eoff, elen = (int(v) for v in info[:7])
    return dict(height=H, width=W, components=nc,
                sampling=tuple((int(info[7 + 2 * c]), int(info[8 + 2 * c]))
                               for c in range(nc)),
                format=JPEG_FORMATS[kind],
                color_space=JPEG_COLOR_SPACES[color],
                orientation=exif_orientation(data[eoff:eoff + elen])
                if eoff >= 0 else 1)


def read_jpeg(data: bytes, gray: bool, name="JPEG", info=None) -> np.ndarray:
    """(H, W) uint8 (gray: libjpeg's JCS_GRAYSCALE output, the Y plane of
    a YCbCr file) or (H, W, 3) BGR uint8 of a JPEG, libjpeg-turbo's
    decode with cv2's settings bit for bit; no EXIF orientation applied.
    info is jpeg_info(data) where the caller has it already.
    ValueError on a file the decoder does not read or finds damaged."""
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
        bgr = read_bmp(data, path)
        return _bgr_to_gray_cv(bgr) if gray else bgr
    if kind == "jpeg":
        info = jpeg_info(data, path)
        return apply_orientation(read_jpeg(data, gray, path, info),
                                 info["orientation"])
    *png, exif = _read_png(data, path)
    img = _png_gray(*png) if gray else _png_color(*png)
    return apply_orientation(img, 1 if exif is None
                             else exif_orientation(exif))


def imread_gray(path) -> np.ndarray:
    """(H, W) uint8, cv2.imread(path, IMREAD_GRAYSCALE) bit for bit (the
    EXIF orientation applied)."""
    return _imread(path, True)


def imread_color(path) -> np.ndarray:
    """(H, W, 3) BGR uint8, cv2.imread(path, IMREAD_COLOR) bit for bit (the
    EXIF orientation applied)."""
    return _imread(path, False)


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
