"""A BMP writer for test data: palette images of 1, 4 and 8 bits,
uncompressed or run-length encoded (RLE8, RLE4: encoded and absolute runs,
end of line, delta and end of bitmap), 16 bits (555, and bit fields 565 or
555), 24 bits, 32 bits plain or with bit fields, under a BITMAPINFOHEADER,
a V4 or V5 header or an OS/2 BITMAPCOREHEADER, bottom-up or top-down.
numpy and plain Python only, so that the tests,
scripts/make_image_fixtures.py and chip_smoke.py, on a machine without cv2,
share this one writer."""

import struct

import numpy as np

BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3
MASKS_555 = (0x7C00, 0x03E0, 0x001F)
MASKS_565 = (0xF800, 0x07E0, 0x001F)


def _rows(pixels: np.ndarray, bits: int) -> np.ndarray:
    """Uncompressed rows (H, stride) of pixels: palette indices (H, W) at
    1, 4 or 8 bits (high bits first), 16-bit values (H, W), or bytes
    (H, W, 3) / (H, W, 4) at 24 and 32 bits."""
    h, w = pixels.shape[:2]
    stride = (w * bits + 31) // 32 * 4
    out = np.zeros((h, stride), np.uint8)
    if bits < 8:
        per = 8 // bits
        padded = np.zeros((h, -(-w // per) * per), np.uint8)
        padded[:, :w] = pixels
        packed = np.zeros((h, padded.shape[1] // per), np.uint8)
        for k in range(per):
            packed |= (padded[:, k::per] << (8 - bits * (k + 1))).astype(
                np.uint8)
        out[:, :packed.shape[1]] = packed
    elif bits == 16:
        out[:, :2 * w] = pixels.astype("<u2").view(np.uint8).reshape(h, -1)
    else:
        out[:, :w * bits // 8] = pixels.astype(np.uint8).reshape(h, -1)
    return out


def _runs(seg: np.ndarray):
    """(start, length, value) of the runs of equal values in seg."""
    if seg.size == 0:
        return []
    edges = np.flatnonzero(np.diff(seg.astype(np.int64))) + 1
    starts = np.concatenate([[0], edges])
    lengths = np.diff(np.concatenate([starts, [seg.size]]))
    return list(zip(starts.tolist(), lengths.tolist(),
                    seg[starts].tolist()))


def _encode_segment(seg: np.ndarray, four: bool) -> bytearray:
    """One row segment as RLE runs: runs of 3 or more as encoded runs (at
    most 255 pixels each), other pixels gathered into absolute runs of 3
    to 255 pixels (padded to a 16-bit boundary), what is left as encoded
    runs of one or two."""
    out = bytearray()
    lit = []

    def flush_literals():
        i = 0
        while len(lit) - i >= 3:
            n = min(255, len(lit) - i)
            chunk = lit[i:i + n]
            if four:
                nib = chunk + [0] * (n % 2)
                body = bytes((nib[j] << 4) | nib[j + 1]
                             for j in range(0, len(nib), 2))
            else:
                body = bytes(chunk)
            out.extend([0, n])
            out.extend(body + bytes(len(body) % 2))
            i += n
        for v in lit[i:]:
            out.extend([1, (v << 4) | v if four else v])
        lit.clear()

    for _, n, v in _runs(seg):
        if n >= 3:
            flush_literals()
            while n > 0:
                k = min(255, n)
                out.extend([k, (v << 4) | v if four else v])
                n -= k
        else:
            lit.extend([v] * n)
    flush_literals()
    return out


def rle(indices: np.ndarray, bits: int, deltas=None, eob=True,
        eol_last=False) -> bytes:
    """An RLE8 (bits 8) or RLE4 (bits 4) stream of palette indices (H, W)
    in file order (the first row first): each row's runs, an end of line
    after each row but the last, and an end of bitmap; deltas {(row, col):
    (dx, dy)} jumps from (row, col) to (row + dy, col + dx), the pixels
    between left to the reader; eob False leaves the end of bitmap out,
    eol_last writes an end of line after the last row too."""
    H, W = indices.shape
    deltas = dict(deltas or {})
    out = bytearray()
    y = x = 0
    while y < H:
        stops = [c for (r, c) in deltas if r == y and c >= x]
        stop = min(stops) if stops else W
        out += _encode_segment(indices[y, x:stop], bits == 4)
        x = stop
        if (y, x) in deltas:
            dx, dy = deltas.pop((y, x))
            out += bytes([0, 2, dx, dy])
            x += dx
            y += dy
            continue
        if y < H - 1 or eol_last:
            out += b"\x00\x00"
        y += 1
        x = 0
    if eob:
        out += b"\x00\x01"
    return bytes(out)


def bmp(pixels=None, bits=24, *, palette=None, compression=BI_RGB,
        masks=None, header=40, top_down=False, stream=None,
        clr_used=None) -> bytes:
    """A BMP file.  pixels in display order (the top row first): palette
    indices (H, W) at 1, 4 and 8 bits, 16-bit values (H, W), BGR (H, W, 3)
    or BGRA (H, W, 4); palette (n, 3) BGR; compression BI_RGB, BI_RLE8,
    BI_RLE4 (the rle() of the pixels, or stream: RLE data in file order
    for pixels of that size) or BI_BITFIELDS with
    masks (R, G, B) after a 40-byte header or inside a V4 (108) / V5 (124)
    header; header 12 an OS/2 BITMAPCOREHEADER (16-bit sizes, 3-byte
    palette entries, 2^bits of them); top_down a negative height;
    clr_used the palette count written (default: the palette's)."""
    h, w = pixels.shape[:2]
    if compression in (BI_RLE8, BI_RLE4):
        data = stream if stream is not None else rle(
            pixels if top_down else pixels[::-1],
            8 if compression == BI_RLE8 else 4)
    else:
        rows = _rows(pixels, bits)
        data = (rows if top_down else rows[::-1]).tobytes()
    pal = b""
    n_pal = 0
    if palette is not None:
        palette = np.asarray(palette, np.uint8)
        n_pal = len(palette)
        if header == 12:
            full = np.zeros((1 << bits, 3), np.uint8)
            full[:n_pal] = palette[:1 << bits]
            pal = full.tobytes()
        else:
            pal = np.concatenate([palette, np.zeros((n_pal, 1), np.uint8)],
                                 1).tobytes()
    if header == 12:
        dib = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        dib = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                          1, bits, compression, len(data), 2835, 2835,
                          n_pal if clr_used is None else clr_used, 0)
        extra = b""
        if header >= 52:
            m = masks if masks is not None else (0, 0, 0)
            extra = struct.pack("<III", *m)
        if header >= 56:
            extra += struct.pack("<I", 0)
        dib += extra + bytes(header - len(dib) - len(extra))
        if compression == BI_BITFIELDS and header == 40:
            dib += struct.pack("<III", *masks)
    off = 14 + len(dib) + len(pal)
    head = struct.pack("<2sIHHI", b"BM", off + len(data), 0, 0, off)
    return head + dib + pal + data


def quantize(bgr: np.ndarray):
    """(indices (H, W) uint8, palette (256, 3) BGR): 3 bits of R and G and
    2 of B pick a cell, each cell's colour the mean of its pixels."""
    b, g, r = (bgr[:, :, i].astype(np.int64) for i in range(3))
    idx = ((r >> 5) << 5) | ((g >> 5) << 2) | (b >> 6)
    counts = np.bincount(idx.ravel(), minlength=256)
    pal = np.zeros((256, 3), np.uint8)
    for i in range(3):
        sums = np.bincount(idx.ravel(), weights=bgr[:, :, i].ravel(),
                           minlength=256)
        pal[:, i] = np.rint(sums / np.maximum(counts, 1)).astype(np.uint8)
    return idx.astype(np.uint8), pal
