"""Writes tests/data/images/: small image files in the formats the port's
decoders read (io/image.py), and cv2's decodes of each, so that a machine
without cv2 can hold the port's decoders to cv2 bit for bit.

Run where cv2 and PIL are installed (they are the reference here, never a
dependency of the port):

    python scripts/make_image_fixtures.py

The files (odd sizes, made from seed 18):
  progressive.jpg   IMWRITE_JPEG_PROGRESSIVE, 4:2:0, quality 90
  s422.jpg          sampling 4:2:2, quality 95
  s411.jpg          sampling 4:1:1, quality 95
  restart.jpg       IMWRITE_JPEG_RST_INTERVAL 2, 4:2:0, quality 95
  gray.jpg          one component, quality 95
  exif6.jpg         4:2:0, an APP1 EXIF block with orientation 6
  smoothed.jpg      progressive.jpg's kind cut after its third scan (an EOI
                    appended): libjpeg's block smoothing
  cmyk_pil.jpg      CMYK written by PIL (Adobe APP14)
  ycck.jpg          YCCK (Adobe transform 2), Y and K 2x2
  arith.jpg         arithmetic-coded sequential, 4:2:0, restart interval
                    2, a DAC segment
  arith_prog.jpg    arithmetic-coded progressive, 4:2:0
  lossless.jpg      lossless, one component, predictor 7, Pt 1, restarts
                    (cv2 reads no colour from it)
  lossless_rgb.jpg  lossless, RGB, predictor 4 (cv2 reads no gray from it)
  adam7_16.png      RGB of 16 bits, Adam7-interlaced, every row filter
  pal1.bmp          1-bit palette
  bf565.bmp         16 bits, bit fields 565
  rle8_delta.bmp    RLE8 with a delta escape (its gap is palette entry 0)
  rle4.bmp          RLE4
  os2_4.bmp         4-bit palette under an OS/2 BITMAPCOREHEADER
and damaged or unusual files, read as libjpeg, cv2's PNG reader and its
grfmt_bmp recover them:
  cut_baseline.jpg  4:2:0 cut inside its scan at 60% of its bytes, no
                    EOI (a killed recorder's file)
  rst_removed.jpg   restart interval 2, its first RST marker removed
  cut_progressive.jpg  progressive, cut in the middle of its last scan
                    that starts before 70% of its bytes
  cut_arith.jpg     arithmetic-coded sequential, cut inside its scan
  badcrc_text.png   a tEXt chunk with a bad CRC before the IDAT
  v5_bitfields.bmp  32 bits, 10-bit bit fields inside a V5 header
files whose gamma, header or channels change what cv2 reads:
  srgb_rgb.png      RGB of 8 bits with an sRGB chunk (libpng's gray read
                    through its gamma tables, gamma 45455)
  gamma22_rgba16.png  RGBA of 16 bits with gAMA 22000
  gamma_pal.png     a 256-colour palette with gAMA 45455
  filter64.png      RGB with IHDR filter method 64 (MNG's: cv2 reads
                    nothing in any mode)
  os2_planes0.bmp   os2_4.bmp's kind with its planes field 0 (cv2 does
                    not read the field)
  gray8.png         8-bit gray written by cv2 (the unchanged read: (H, W))
  rgb16.png         16-bit RGB written by cv2 (the unchanged read: uint16)
(tests/png_writer.py, jpeg_writer.py and bmp_writer.py write what cv2
does not) and decodes.npz: for each file name, "<name>:color" (cv2.imread
IMREAD_COLOR), "<name>:gray" (IMREAD_GRAYSCALE) and "<name>:unchanged"
(IMREAD_UNCHANGED), each where cv2 reads the file that way; a file cv2
reads in no mode (UNREADABLE) has no key.  Every file is read back with
cv2 before the archive is written; the whole set stays under 1 MB.
"""

import struct
import sys
from pathlib import Path

import io

import cv2
import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "data" / "images"
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
import bmp_writer as bw  # noqa: E402  (the tests' writers)
import jpeg_writer as jw  # noqa: E402
from png_writer import chunk as png_chunk, png  # noqa: E402


def _scene(h, w, seed):
    """A smooth colour field with noise: edges, gradients and texture."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([128 + 90 * np.sin(x / 7 + y / 11),
                     128 + 90 * np.cos(x / 5 - y / 9),
                     (x * 3 + y * 2) % 256], -1)
    return np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(
        np.uint8)


def _exif6() -> bytes:
    """Exif\\0\\0 and a big-endian TIFF block whose IFD0 holds orientation
    6 after a Make string."""
    ifd = struct.pack(">H", 2)
    ifd += struct.pack(">HHI", 0x010F, 2, 4) + b"cam\0"
    ifd += struct.pack(">HHIH", 0x0112, 3, 1, 6) + b"\0\0"
    return b"Exif\0\0" + b"MM" + struct.pack(">HI", 42, 8) + ifd + bytes(4)


def files() -> dict:
    jq = cv2.IMWRITE_JPEG_QUALITY
    sf = cv2.IMWRITE_JPEG_SAMPLING_FACTOR

    def jpg(img, *flags):
        ok, buf = cv2.imencode(".jpg", img, list(flags))
        assert ok
        return buf.tobytes()

    out = {
        "progressive.jpg": jpg(_scene(61, 83, 1), jq, 90,
                               cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
        "s422.jpg": jpg(_scene(45, 77, 2), jq, 95, sf,
                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
        "s411.jpg": jpg(_scene(37, 101, 3), jq, 95, sf,
                        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
        "restart.jpg": jpg(_scene(53, 71, 4), jq, 95,
                           cv2.IMWRITE_JPEG_RST_INTERVAL, 2),
        "gray.jpg": jpg(_scene(39, 55, 5)[:, :, 1], jq, 95),
    }
    base = jpg(_scene(29, 47, 6), jq, 95)
    app1 = _exif6()
    out["exif6.jpg"] = (base[:2] + b"\xff\xe1"
                        + struct.pack(">H", len(app1) + 2) + app1 + base[2:])
    rgb16 = (_scene(23, 31, 7).astype(np.uint16) * 257
             + np.random.default_rng(8).integers(0, 257, (23, 31, 3))
             ).astype(np.uint16)
    out["adam7_16.png"] = png(rgb16, 2, 16, (0, 1, 2, 3, 4),
                              interlace=1)
    prog = jpg(_scene(41, 23, 9), jq, 75, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    scans = [k for k in range(len(prog) - 1)
             if prog[k:k + 2] == b"\xff\xda"]
    out["smoothed.jpg"] = prog[:scans[3]] + b"\xff\xd9"
    buf = io.BytesIO()
    Image.fromarray(_scene(27, 35, 10)[:, :, ::-1]).convert("CMYK").save(
        buf, "JPEG", quality=90)
    out["cmyk_pil.jpg"] = buf.getvalue()
    out["ycck.jpg"] = jw.lossy(
        jw.ycck_from_cmyk(jw.cmyk_from_bgr(_scene(25, 33, 11))), quality=90,
        adobe=2, sampling=[(2, 2), (1, 1), (1, 1), (2, 2)])
    s420 = [(2, 2), (1, 1), (1, 1)]
    out["arith.jpg"] = jw.lossy(
        jw.ycc_from_bgr(_scene(29, 43, 12)), quality=90, coding="arith",
        restart=2, sampling=s420, dac={"dc": {0: (1, 4)}, "ac": {0: 8}})
    out["arith_prog.jpg"] = jw.lossy(
        jw.ycc_from_bgr(_scene(31, 39, 13)), quality=90, coding="arith",
        progressive=True, sampling=s420)
    out["lossless.jpg"] = jw.lossless([_scene(21, 27, 14)[:, :, 1]],
                                      predictor=7, pt=1, restart_rows=4)
    rgb = _scene(19, 23, 15)
    out["lossless_rgb.jpg"] = jw.lossless(
        [rgb[:, :, 2], rgb[:, :, 1], rgb[:, :, 0]], predictor=4)
    rng = np.random.default_rng(16)
    out["pal1.bmp"] = bw.bmp(rng.integers(0, 2, (19, 29)), 1,
                             palette=rng.integers(0, 256, (2, 3)))
    out["bf565.bmp"] = bw.bmp(rng.integers(0, 65536, (17, 21)), 16,
                              compression=bw.BI_BITFIELDS,
                              masks=bw.MASKS_565)
    idx, pal = bw.quantize(_scene(23, 37, 17))
    out["rle8_delta.bmp"] = bw.bmp(
        idx, 8, palette=pal, compression=bw.BI_RLE8,
        stream=bw.rle(idx[::-1], 8, deltas={(5, 7): (4, 2)}))
    out["rle4.bmp"] = bw.bmp(idx >> 4, 4, palette=pal[::16],
                             compression=bw.BI_RLE4)
    out["os2_4.bmp"] = bw.bmp(idx & 15, 4, palette=pal[:16], header=12)
    cut = jpg(_scene(43, 57, 19), jq, 90)
    out["cut_baseline.jpg"] = cut[:len(cut) * 6 // 10]
    rst = jpg(_scene(35, 49, 20), jq, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    k = rst.index(b"\xff\xd0")
    out["rst_removed.jpg"] = rst[:k] + rst[k + 2:]
    prog = jpg(_scene(39, 51, 21), jq, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    # the middle of the last scan that starts before 70% of the bytes
    sos = [k for k in range(len(prog) - 1) if prog[k:k + 2] == b"\xff\xda"
           and k < len(prog) * 7 // 10]
    end = next(k for k in range(sos[-1] + 2, len(prog) - 1)
               if prog[k] == 0xFF and prog[k + 1] not in (0, 0xFF))
    out["cut_progressive.jpg"] = prog[:(sos[-1] + end) // 2]
    arith = jw.lossy(jw.ycc_from_bgr(_scene(33, 45, 22)), quality=90,
                     coding="arith", sampling=s420)
    out["cut_arith.jpg"] = arith[:len(arith) * 6 // 10]
    gray = _scene(21, 25, 23)[:, :, 0]
    ok, buf = cv2.imencode(".png", gray)
    assert ok
    text = png_chunk(b"tEXt", b"Comment\0damaged")
    text = text[:-1] + bytes([text[-1] ^ 0x5A])
    out["badcrc_text.png"] = buf.tobytes()[:33] + text + buf.tobytes()[33:]
    words = rng.integers(0, 1 << 32, (15, 19), dtype=np.uint64).astype(
        np.uint32)
    out["v5_bitfields.bmp"] = bw.bmp(
        words.view(np.uint8).reshape(15, 19, 4), 32,
        compression=bw.BI_BITFIELDS, masks=(0x3FF00000, 0xFFC00, 0x3FF),
        header=124)

    def after_ihdr(data, tag, body):
        return data[:33] + png_chunk(tag, body) + data[33:]

    out["srgb_rgb.png"] = after_ihdr(
        png(_scene(27, 33, 24)[:, :, ::-1], 2, 8, (0, 1, 2, 3, 4)),
        b"sRGB", b"\0")
    rng = np.random.default_rng(25)
    rgba16 = np.concatenate(
        [_scene(21, 29, 26)[:, :, ::-1], _scene(21, 29, 27)[:, :, :1]], -1
    ).astype(np.uint16) * 257 + rng.integers(0, 257, (21, 29, 4))
    out["gamma22_rgba16.png"] = after_ihdr(
        png(rgba16.astype(np.uint16), 6, 16, (0, 4)), b"gAMA",
        struct.pack(">I", 22000))
    idx, pal = bw.quantize(_scene(25, 31, 28))
    out["gamma_pal.png"] = after_ihdr(
        png(idx[:, :, None], 3, 8, plte=pal[:, ::-1]), b"gAMA",
        struct.pack(">I", 45455))
    rgb = png(_scene(9, 11, 29), 2, 8)
    ihdr = bytearray(rgb[16:29])
    ihdr[11] = 64
    out["filter64.png"] = rgb[:8] + png_chunk(b"IHDR", bytes(ihdr)) + rgb[33:]
    os2 = bytearray(bw.bmp(idx & 15, 4, palette=pal[:16], header=12))
    os2[22:24] = bytes(2)
    out["os2_planes0.bmp"] = bytes(os2)
    ok, buf = cv2.imencode(".png", _scene(23, 27, 30)[:, :, 1])
    assert ok
    out["gray8.png"] = buf.tobytes()
    ok, buf = cv2.imencode(".png", (_scene(19, 25, 31).astype(np.uint16)
                                    * 257 + rng.integers(0, 257, (19, 25, 3))
                                    ).astype(np.uint16))
    assert ok
    out["rgb16.png"] = buf.tobytes()
    return out


# files cv2 reads in no mode: their reads must raise
UNREADABLE = ("filter64.png",)


def main() -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    decodes = {}
    total = 0
    for name, data in files().items():
        path = OUT / name
        path.write_bytes(data)
        total += len(data)
        for kind, flag in (("color", cv2.IMREAD_COLOR),
                           ("gray", cv2.IMREAD_GRAYSCALE),
                           ("unchanged", cv2.IMREAD_UNCHANGED)):
            img = cv2.imread(str(path), flag)
            if img is not None:
                decodes[f"{name}:{kind}"] = img
        read = any(k.startswith(name + ":") for k in decodes)
        if read == (name in UNREADABLE):
            raise RuntimeError(f"cv2 reads {name}" if read else
                               f"cv2 does not read {name}")
    if decodes["exif6.jpg:gray"].shape != (47, 29):
        raise RuntimeError("cv2 did not apply exif6.jpg's orientation")
    np.savez_compressed(OUT / "decodes.npz", **decodes)
    total += (OUT / "decodes.npz").stat().st_size
    if total >= 1 << 20:
        raise RuntimeError(f"the fixtures take {total} bytes, 1 MB at most")
    print(f"{len(decodes)} decodes of the files in decodes.npz, {OUT} "
          f"({total} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
