"""Writes tests/data/images/: small image files in the formats the port's
decoders read (io/image.py), and cv2's decodes of each, so that a machine
without cv2 can hold the port's decoders to cv2 bit for bit.

Run where cv2 is installed (it is the reference here, never a dependency
of the port):

    python scripts/make_image_fixtures.py

The files (odd sizes, made from seed 18):
  progressive.jpg   IMWRITE_JPEG_PROGRESSIVE, 4:2:0, quality 90
  s422.jpg          sampling 4:2:2, quality 95
  s411.jpg          sampling 4:1:1, quality 95
  restart.jpg       IMWRITE_JPEG_RST_INTERVAL 2, 4:2:0, quality 95
  gray.jpg          one component, quality 95
  exif6.jpg         4:2:0, an APP1 EXIF block with orientation 6
  adam7_16.png      RGB of 16 bits, Adam7-interlaced, every row filter
                    (tests/png_writer.py: cv2 writes no interlaced PNG)
and decodes.npz: for each file name, "<name>:color" (cv2.imread
IMREAD_COLOR) and "<name>:gray" (IMREAD_GRAYSCALE).  Every file is read
back with cv2 before the archive is written; the whole set stays under
1 MB.
"""

import struct
import sys
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "data" / "images"
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
from png_writer import png  # noqa: E402  (the tests' PNG writer)


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
    return out


def main() -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    decodes = {}
    total = 0
    for name, data in files().items():
        path = OUT / name
        path.write_bytes(data)
        total += len(data)
        for kind, flag in (("color", cv2.IMREAD_COLOR),
                           ("gray", cv2.IMREAD_GRAYSCALE)):
            img = cv2.imread(str(path), flag)
            if img is None:
                raise RuntimeError(f"cv2 does not read {name}")
            decodes[f"{name}:{kind}"] = img
    if decodes["exif6.jpg:gray"].shape != (47, 29):
        raise RuntimeError("cv2 did not apply exif6.jpg's orientation")
    np.savez_compressed(OUT / "decodes.npz", **decodes)
    total += (OUT / "decodes.npz").stat().st_size
    if total >= 1 << 20:
        raise RuntimeError(f"the fixtures take {total} bytes, 1 MB at most")
    print(f"{len(decodes) // 2} files and decodes.npz written to {OUT} "
          f"({total} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
