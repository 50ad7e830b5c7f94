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
"""

import argparse
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
    if (lvba_jpeg_info(buf, (long)d.size(), info, err, 512) == 0)
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
    for k, (_, data) in enumerate(cases(seeds)):
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
    a = ap.parse_args()
    if a.bmp_gray:
        return bmp_gray()
    return sanitize(a.seeds) if a.sanitize else sweep(a.seeds)


if __name__ == "__main__":
    sys.exit(main())
