"""A PNG writer for test data: every colour type and depth, any of the five
row filters, and Adam7 interlacing (cv2 and the port write no interlaced
PNG).  numpy only, so the tests, scripts/make_image_fixtures.py and
chip_smoke.py, on a machine without cv2, share this one writer."""

import struct
import zlib

import numpy as np

from global_lvba_tpu_torch.io.image import ADAM7


def filter_rows(raw: np.ndarray, bpp: int, filters) -> bytes:
    """PNG scanlines of raw (H, rowbytes) uint8, row y under filter
    filters[y % len(filters)] (the PNG specification's five)."""
    out = bytearray()
    prior = np.zeros(raw.shape[1], np.int64)
    for y, row in enumerate(raw.astype(np.int64)):
        ft = filters[y % len(filters)]
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])[:row.size]
        c = np.concatenate([np.zeros(bpp, np.int64),
                            prior[:-bpp]])[:row.size]
        if ft == 4:
            p = a + prior - c
            pa, pb, pc = abs(p - a), abs(p - prior), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prior, c))
        else:
            pred = (0 * a, a, prior, (a + prior) >> 1)[ft]
        out += bytes([ft]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prior = row
    return bytes(out)


def chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def raw_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """Unfiltered PNG rows (h, rowbytes) of samples (h, w, C): 16 bits
    big-endian, below 8 bits one channel packed high bits first."""
    h, w, ch = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    per = 8 // depth
    padded = np.zeros((h, -(-w // per) * per), np.uint8)
    padded[:, :w] = samples[:, :, 0]
    raw = np.zeros((h, padded.shape[1] // per), np.uint8)
    for k in range(per):
        raw |= (padded[:, k::per] << (8 - depth * (k + 1))).astype(np.uint8)
    return raw


def png(samples: np.ndarray, color: int, depth: int, filters=(0,),
        plte=None, trns=None, interlace=0, exif=None) -> bytes:
    """A PNG of samples (H, W, C) (palette indices or gray levels below 8
    bits packed high bits first), its rows under the given filters; with
    interlace=1 the seven Adam7 passes, each a filtered image of its own
    (an empty pass writes nothing); exif an eXIf chunk's bytes.  The
    deflate stream is split over two IDAT chunks, which a reader joins."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                      interlace))
    if plte is not None:
        body += chunk(b"PLTE", plte.astype(np.uint8).tobytes())
    if trns is not None:
        body += chunk(b"tRNS", trns)
    if exif is not None:
        body += chunk(b"eXIf", exif)
    if interlace:
        stream = b"".join(
            filter_rows(raw_rows(samples[y0::dy, x0::dx], depth), bpp,
                        filters)
            for x0, y0, dx, dy in ADAM7 if w > x0 and h > y0)
    else:
        stream = filter_rows(raw_rows(samples, depth), bpp, filters)
    data = zlib.compress(stream)
    body += chunk(b"IDAT", data[:len(data) // 2])
    body += chunk(b"IDAT", data[len(data) // 2:])
    return b"\x89PNG\r\n\x1a\n" + body + chunk(b"IEND", b"")
