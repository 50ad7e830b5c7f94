"""A wider sweep of damaged image files than the tests' (CPU, cv2 5.0 as
the reference):

    python scripts/image_damage_sweep.py [--seeds N]
        every source of tests/test_torch_image_damage.py (cv2 and
        tests/jpeg_writer.py files) and every JPEG fixture of
        tests/data/images, each mutated by the tests' generator
        (_jpeg_mutations: cuts, changed scan bytes, RST edits) under N
        seeds: each case read by the port and by cv2.imread, colour and
        gray, bit for bit or refused by both; prints the count and every
        mismatch, and fails on one.
    python scripts/image_damage_sweep.py --sanitize [--seeds N]
        the same cases through lvba_jpeg_info / lvba_jpeg_decode of the
        native library built with g++ -fsanitize=address,undefined into
        build/sanitize/ (a small program that reads each file into a
        buffer of its exact size); fails on the first report.
    python scripts/image_damage_sweep.py --bmp-gray
        a 4096 x 4096 32-bit BMP of all 2^24 colours under 8-bit bit
        fields inside a V5 header: the port's colour and gray reads
        against cv2's (the float32 gray of masked fields).
The modes below hold colour, gray and unchanged reads to cv2.imread's:
the same array, or a ValueError where cv2 returns None, or ImageSizeError
where cv2 raises past its size limit; each prints the files swept and the
files that agree in all three modes, with every mismatch, and fails on
one:
    python scripts/image_damage_sweep.py --png-gamma
        the gamma cases of tests/test_torch_image_faults.py (gAMA, sRGB,
        sBIT, cHRM, iCCP and their rules) inserted after IHDR, after PLTE
        and after the last IDAT of each of its seven sources; then all
        2^24 colours of an 8-bit RGB image and every 16-bit level (R = G
        = B, and B one off) under gamma values and sBIT depths, gray read
        only.
    python scripts/image_damage_sweep.py --png-ihdr
        every byte of IHDR at all 256 values (CRC recomputed) on the five
        IHDR sources of tests/test_torch_image_faults.py, and sizes at
        libpng's and cv2's limits.
    python scripts/image_damage_sweep.py --bmp-header
        every BMP fixture of tests/data/images and three BMPs cv2 or
        tests/bmp_writer.py wrote, each header byte (the file header, the
        info header and 12 bytes past it) at 19 values.
    python scripts/image_damage_sweep.py --jpeg-markers
        a baseline, a progressive and a restart-interval JPEG from cv2
        and a lossless, an arithmetic-coded and an arithmetic-coded
        progressive one from tests/jpeg_writer.py: APP5, COM, an empty
        COM, the reserved FFC8 and FFF0, DRI 0 and 3, DNL, EXP, fill bytes,
        a stray RST0, TEM, a second SOI and two junk bytes inserted before
        each header segment and after the first scan header, and each
        header segment repeated before each one.
--sanitize runs the --jpeg-markers files through the sanitized library
too.
"""

import argparse
import itertools
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

MAIN_SOURCE = r"""
#include <cstdio>
#include <fstream>
#include <iostream>
#include <iterator>
#include <string>
#include <vector>
extern "C" int lvba_jpeg_info(const unsigned char*, long, long*, char*, int);
extern "C" int lvba_jpeg_decode(const unsigned char*, long, int,
                                unsigned char*, char*, int);
int main() {
  std::string path;
  long files = 0, decodes = 0;
  while (std::getline(std::cin, path)) {
    std::ifstream f(path, std::ios::binary);
    std::vector<unsigned char> d((std::istreambuf_iterator<char>(f)), {});
    unsigned char* buf = new unsigned char[d.size() ? d.size() : 1];
    std::copy(d.begin(), d.end(), buf);
    long info[16];
    char err[512];
    ++files;
    // io/image.py raises ImageSizeError past 2^30 pixels, before a decode
    if (lvba_jpeg_info(buf, (long)d.size(), info, err, 512) == 0 &&
        info[0] * info[1] <= (1L << 30))
      for (int gray = 0; gray < 2; ++gray) {
        std::vector<unsigned char> out((size_t)info[0] * info[1] *
                                       (gray ? 1 : 3));
        decodes += lvba_jpeg_decode(buf, (long)d.size(), gray, out.data(),
                                    err, 512) == 0;
      }
    delete[] buf;
  }
  std::printf("%ld files, %ld decodes\n", files, decodes);
  return 0;
}
"""


def cases(seeds: int):
    """(name, bytes) of every mutated file of the sweep."""
    import test_torch_image_damage as t

    sources = {name: fn() for name, fn in t.JPEG_SOURCES.items()}
    for f in sorted((ROOT / "tests" / "data" / "images").glob("*.jpg")):
        sources[f.name] = f.read_bytes()
    for name, data in sources.items():
        for seed in range(seeds):
            for what, mutated in t._jpeg_mutations(
                    data, seed * 7919 + sum(name.encode())):
                yield f"{name} seed {seed}: {what}", mutated


def sweep(seeds: int) -> int:
    import cv2
    import numpy as np

    from global_lvba_tpu_torch.io import image as gi

    bad = n = 0
    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "m.jpg"
        for what, data in cases(seeds):
            p.write_bytes(data)
            n += 1
            for flag, read in ((cv2.IMREAD_COLOR, gi.imread_color),
                               (cv2.IMREAD_GRAYSCALE, gi.imread_gray)):
                want = cv2.imread(str(p), flag)
                try:
                    got = read(p)
                except ValueError:
                    got = None
                if (want is None) != (got is None) or (
                        want is not None and not np.array_equal(want, got)):
                    bad += 1
                    print(f"mismatch: {what} ({'colour' if flag else 'gray'})")
    print(f"{n} mutated JPEGs, {bad} mismatches against cv2.imread")
    return int(bad > 0)


def _outcome(read, *args):
    """The image, "none" (cv2's None, the port's ValueError) or "size"
    (cv2.error, the port's ImageSizeError)."""
    import cv2

    from global_lvba_tpu_torch.io import image as gi

    try:
        img = read(*args)
    except (cv2.error, gi.ImageSizeError):
        return "size"
    except ValueError:
        return "none"
    return "none" if img is None else img


def compare(cases, suffix: str, modes=("color", "gray", "unchanged")) -> int:
    """Each (name, bytes) of cases read by the port and by cv2.imread in
    the given modes; prints the count of files and of files that agree in
    every mode, and each mismatch.  Returns 1 on a mismatch."""
    import cv2
    import numpy as np

    from global_lvba_tpu_torch.io import image as gi

    reads = {"color": (cv2.IMREAD_COLOR, gi.imread_color),
             "gray": (cv2.IMREAD_GRAYSCALE, gi.imread_gray),
             "unchanged": (cv2.IMREAD_UNCHANGED, gi.imread_unchanged)}
    n = agree = 0
    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / f"case{suffix}"
        for what, data in cases:
            p.write_bytes(data)
            n += 1
            ok = True
            for mode in modes:
                flag, read = reads[mode]
                want = _outcome(cv2.imread, str(p), flag)
                got = _outcome(read, p)
                if isinstance(want, str) or isinstance(got, str):
                    same = isinstance(got, str) and got == want
                else:
                    same = (got.dtype == want.dtype
                            and np.array_equal(got, want))
                if not same:
                    ok = False
                    print(f"mismatch: {what} ({mode})")
            agree += ok
    print(f"{n} files, {agree} agree with cv2.imread in "
          f"{' / '.join(modes)}")
    return int(agree < n)


def _png_chunks(data: bytes):
    pos, out = 8, []
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        out.append(data[pos:pos + 12 + n])
        pos += 12 + n
    return out


def png_gamma_cases():
    import test_torch_image_faults as t

    lists = dict(t.GAMMA_CHUNKS)
    for name, (head, plte, idat) in t.GAMMA_RULES.items():
        lists[name] = head + plte + idat
    for sname, make in t.GAMMA_SOURCES.items():
        base = make()
        tags = [c[4:8] for c in _png_chunks(base)]
        for cname, chunks in lists.items():
            for after in (b"IHDR", b"PLTE", b"IDAT"):
                if after in tags:
                    yield (f"{sname} {cname} after {after.decode()}",
                           t._insert(base, chunks, after))


def png_gamma_tables() -> int:
    """All 2^24 colours at 8 bits (16 images of 2^20) and every 16-bit
    level, gray read only."""
    import numpy as np

    import test_torch_image_faults as t
    from png_writer import png

    def colours():
        v = np.arange(1 << 20)
        for g in (45455, 22000, 94999, 95001, 1, (1 << 31) - 1):
            for b in range(16):
                rgb = np.stack([v & 255, (v >> 8) & 255,
                                (v >> 16) + 16 * b], -1)
                yield (f"8-bit colours blue {16 * b}-{16 * b + 15}, gAMA "
                       f"{g}", t._insert(png(rgb.reshape(1024, 1024, 3), 2,
                                             8), [t._gama(g)]))

    def levels():
        v = np.arange(1 << 16).reshape(64, 1024)
        rgb = np.zeros((128, 1024, 3), np.int64)
        rgb[:64] = v[:, :, None]
        rgb[64:, :, :2] = v[:, :, None]
        rgb[64:, :, 2] = v ^ 1
        base = png(rgb, 2, 16)
        for g in (45455, 22000, 200000):
            for sb in [0] + list(range(1, 17)):
                chunks = [t._gama(g)] + ([t._sbit(sb, sb, sb)] if sb else [])
                yield (f"16-bit levels, gAMA {g}, sBIT {sb}",
                       t._insert(base, chunks))

    return compare(colours(), ".png", ("gray",)) | compare(
        levels(), ".png", ("gray",))


def png_ihdr_cases():
    import struct

    import test_torch_image_faults as t

    for sname, make in t.IHDR_SOURCES.items():
        data = make()
        for off in range(13):
            for v in range(256):
                body = bytearray(data[16:29])
                body[off] = v
                yield f"{sname} IHDR byte {off} = {v}", t._with_ihdr(
                    data, bytes(body))
        for W, H in ((1_000_000, 1), (1_000_001, 1), (1, 1_000_001),
                     ((1 << 31) - 1, 1), (1 << 31, 1), (32768, 32768),
                     (32768, 32769), (40000, 40000)):
            body = bytearray(data[16:29])
            body[:8] = struct.pack(">II", W, H)
            yield f"{sname} IHDR {W} x {H}", t._with_ihdr(data, bytes(body))


def bmp_header_cases():
    import struct

    import cv2
    import numpy as np

    import bmp_writer as bw

    rng = np.random.default_rng(5)
    sources = {f.name: f.read_bytes() for f in sorted(
        (ROOT / "tests" / "data" / "images").glob("*.bmp"))}
    for name, img in (("cv2 gray", rng.integers(0, 256, (13, 17), np.uint8)),
                      ("cv2 BGR", rng.integers(0, 256, (13, 17, 3),
                                               np.uint8))):
        sources[name] = cv2.imencode(".bmp", img)[1].tobytes()
    sources["32-bit bit fields, 40-byte header"] = bw.bmp(
        rng.integers(0, 256, (6, 5, 4)), 32, compression=bw.BI_BITFIELDS,
        masks=(0xFF0000, 0xFF00, 0xFF))
    values = (0, 1, 2, 3, 4, 8, 12, 15, 16, 24, 32, 40, 56, 64, 108, 124,
              127, 128, 255)
    for name, data in sources.items():
        hsize = struct.unpack_from("<I", data, 14)[0]
        for off in range(min(len(data), 14 + hsize + 12)):
            for v in values:
                m = bytearray(data)
                m[off] = v
                yield f"{name} byte {off} = {v}", bytes(m)


JPEG_INSERTS = {
    "APP5": b"\xff\xe5\x00\x06abcd", "COM": b"\xff\xfe\x00\x05abc",
    "empty COM": b"\xff\xfe\x00\x02", "FFC8": b"\xff\xc8\x00\x04\x00\x00",
    "FFF0": b"\xff\xf0\x00\x04\x00\x00", "DRI 0": b"\xff\xdd\x00\x04\x00\x00",
    "DRI 3": b"\xff\xdd\x00\x04\x00\x03", "DNL": b"\xff\xdc\x00\x04\x00\x10",
    "EXP": b"\xff\xdf\x00\x03\x11", "fill bytes": b"\xff\xff\xff",
    "RST0": b"\xff\xd0", "TEM": b"\xff\x01", "second SOI": b"\xff\xd8",
    "two junk bytes": b"\x12\x34"}


def _header_segments(data: bytes):
    """(start, end) of each marker segment after SOI up to the first SOS's
    header, that one included."""
    pos, out = 2, []
    while True:
        m = data[pos + 1]
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        out.append((pos, end))
        pos = end
        if m == 0xDA:
            return out


def jpeg_marker_cases():
    import cv2
    import numpy as np

    import jpeg_writer as jw

    rng = np.random.default_rng(3)
    img = cv2.GaussianBlur(rng.integers(0, 256, (40, 56, 3)).astype(
        np.uint8), (0, 0), 1.5)

    def enc(*params):
        return cv2.imencode(".jpg", img, list(params))[1].tobytes()

    sources = {
        "baseline": enc(),
        "progressive": enc(cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
        "restart": enc(cv2.IMWRITE_JPEG_RST_INTERVAL, 2),
        "lossless": jw.lossless([img[:, :, 1]], predictor=1, restart_rows=2),
        "arithmetic": jw.lossy(jw.ycc_from_bgr(img), quality=90,
                               coding="arith", restart=2),
        "arithmetic progressive": jw.lossy(jw.ycc_from_bgr(img), quality=90,
                                           coding="arith", progressive=True),
    }
    for sname, d in sources.items():
        segs = _header_segments(d)
        for k, (a, _) in enumerate(segs):
            for iname, ins in JPEG_INSERTS.items():
                yield f"{sname}: {iname} before segment {k}", (
                    d[:a] + ins + d[a:])
            for j, (c, e) in enumerate(segs):
                yield f"{sname}: segment {j} repeated before segment {k}", (
                    d[:a] + d[c:e] + d[a:])
        a = segs[-1][1]
        for iname, ins in JPEG_INSERTS.items():
            yield f"{sname}: {iname} after the first scan header", (
                d[:a] + ins + d[a:])


def sanitize(seeds: int) -> int:
    out = ROOT / "build" / "sanitize"
    shutil.rmtree(out, ignore_errors=True)
    (out / "cases").mkdir(parents=True)
    (out / "main.cpp").write_text(MAIN_SOURCE)
    exe = out / "sanitized_reader"
    subprocess.run(
        ["g++", "-O1", "-g", "-std=c++17", "-pthread",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=undefined",
         "-fno-omit-frame-pointer", "-o", str(exe), str(out / "main.cpp"),
         str(ROOT / "global_lvba_tpu_torch" / "native" / "lvba_native.cpp")],
        check=True)
    names = []
    for k, (_, data) in enumerate(itertools.chain(cases(seeds),
                                                  jpeg_marker_cases())):
        f = out / "cases" / f"{k:06d}.jpg"
        f.write_bytes(data)
        names.append(str(f))
    env = {"ASAN_OPTIONS": "detect_leaks=1:halt_on_error=1",
           "UBSAN_OPTIONS": "halt_on_error=1:print_stacktrace=1",
           "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([str(exe)], input="\n".join(names) + "\n",
                          text=True, capture_output=True, env=env)
    print(proc.stdout.strip(), proc.stderr[-4000:], sep="\n")
    shutil.rmtree(out / "cases")
    print(f"sanitizers: rc {proc.returncode}")
    return proc.returncode


def bmp_gray() -> int:
    import cv2
    import numpy as np

    import bmp_writer as bw
    from global_lvba_tpu_torch.io import image as gi

    words = np.arange(1 << 24, dtype=np.uint32).reshape(4096, 4096)
    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "all.bmp"
        p.write_bytes(bw.bmp(words.view(np.uint8).reshape(4096, 4096, 4),
                             32, compression=bw.BI_BITFIELDS,
                             masks=(0xFF0000, 0xFF00, 0xFF), header=124))
        ok = all(np.array_equal(read(p), cv2.imread(str(p), flag))
                 for read, flag in ((gi.imread_color, cv2.IMREAD_COLOR),
                                    (gi.imread_gray, cv2.IMREAD_GRAYSCALE)))
    print(f"all 2^24 colours, V5 bit fields: colour and gray equal cv2's: "
          f"{ok}")
    return int(not ok)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--sanitize", action="store_true")
    ap.add_argument("--bmp-gray", action="store_true")
    ap.add_argument("--png-gamma", action="store_true")
    ap.add_argument("--png-ihdr", action="store_true")
    ap.add_argument("--bmp-header", action="store_true")
    ap.add_argument("--jpeg-markers", action="store_true")
    a = ap.parse_args()
    if a.bmp_gray:
        return bmp_gray()
    if a.png_gamma:
        return compare(png_gamma_cases(), ".png") | png_gamma_tables()
    if a.png_ihdr:
        return compare(png_ihdr_cases(), ".png")
    if a.bmp_header:
        return compare(bmp_header_cases(), ".bmp")
    if a.jpeg_markers:
        return compare(jpeg_marker_cases(), ".jpg")
    return sanitize(a.seeds) if a.sanitize else sweep(a.seeds)


if __name__ == "__main__":
    sys.exit(main())
