"""The port's JPEG decode pool (peclr_tpu_torch/csrc/jpeg_decode.cc) under
the host compiler's sanitizers, on the CPU.

A small main program (DECODE_MAIN below) calls the pool's C ABI,
`peclr_decode_jpeg` on each file and `peclr_decode_batch` on all of them,
and is compiled with the pool's source into one executable in the test's
temporary directory:

  - with AddressSanitizer and UndefinedBehaviorSanitizer (shift-base
    included, no recovery), over the 32 committed fixture frames and a
    seeded set of corruptions of them (truncations, and byte flips in the
    header and in the entropy-coded scan), each file alone and the whole
    set through the pool at 8 threads;
  - with ThreadSanitizer, the pool at 8 threads over the same files.

A failed decode is allowed (the pool returns 1 for a file it cannot read);
a sanitizer report is not.  The test also holds the pool byte-equal to
cv2 (libjpeg) on flat dark images, whose blocks take the IDCT's DC-only
shortcut with a negative DC term.  It skips only where no C++ compiler is
on PATH, as peclr_tpu_torch/build.py would fail to build the pool there.
"""

import os
import shutil
import subprocess

import cv2
import numpy as np
import pytest

from peclr_tpu_torch import build
from peclr_tpu_torch.data import native_loader

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures", "torch_freihand_like",
                           "freihand_dataset", "training", "rgb")
SOURCE = os.path.join(build.CSRC_DIR, "jpeg_decode.cc")
SEED = 17
CORRUPTIONS = 300  # seeded corrupt files, about a third of each kind
HEADER_BYTES = 700  # where a header flip lands: the markers before the scan
THREADS = 8
CANVAS = 224
COMPILE_TIMEOUT_S = 120
RUN_TIMEOUT_S = 120
COMMON_FLAGS = ["-O1", "-g", "-std=c++17", "-pthread",
                "-fno-omit-frame-pointer"]
ASAN_UBSAN = ["-fsanitize=address,undefined", "-fno-sanitize-recover=all"]
TSAN = ["-fsanitize=thread"]
SANITIZER_ENV = {
    "ASAN_OPTIONS": "detect_leaks=1:abort_on_error=0:exitcode=23",
    "UBSAN_OPTIONS": "print_stacktrace=1:halt_on_error=1:exitcode=24",
    "TSAN_OPTIONS": "halt_on_error=1:exitcode=25",
}
REPORT_MARKS = ("runtime error:", "AddressSanitizer", "LeakSanitizer",
                "ThreadSanitizer", "UndefinedBehaviorSanitizer")

DECODE_MAIN = r"""
// Decodes the files listed in argv[1], one path a line: each alone through
// peclr_decode_jpeg, then all of them through peclr_decode_batch at
// argv[2] threads into argv[3]-square canvases ("batch" in argv[4] skips
// the files alone).  Prints the counts it saw.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <string>
#include <vector>

extern "C" int peclr_decode_jpeg(const char* path, unsigned char* out, int capacity,
                                 int* out_h, int* out_w);
extern "C" int peclr_decode_batch(const char** paths, int count, unsigned char* out,
                                  int canvas, int threads);

int main(int argc, char** argv) {
  if (argc < 4) return 2;
  std::ifstream list(argv[1]);
  std::vector<std::string> paths;
  for (std::string line; std::getline(list, line);)
    if (!line.empty()) paths.push_back(line);
  const int threads = std::atoi(argv[2]), canvas = std::atoi(argv[3]);
  const bool batch_only = argc > 4 && std::strcmp(argv[4], "batch") == 0;
  int ok = 0, failed = 0, too_large = 0;
  if (!batch_only) {
    const int capacity = 1024 * 1024 * 3;
    std::vector<unsigned char> out(capacity);
    for (const std::string& p : paths) {
      int h = 0, w = 0;
      const int rc = peclr_decode_jpeg(p.c_str(), out.data(), capacity, &h, &w);
      if (rc == 0) ++ok;
      else if (rc == 2) ++too_large;
      else ++failed;
    }
  }
  std::vector<const char*> cpaths;
  for (const std::string& p : paths) cpaths.push_back(p.c_str());
  std::vector<unsigned char> canvases(paths.size() * canvas * canvas * 3);
  const int batch_failed = peclr_decode_batch(cpaths.data(), static_cast<int>(cpaths.size()),
                                              canvases.data(), canvas, threads);
  std::printf("files %zu ok %d failed %d too_large %d batch_failed %d\n", paths.size(), ok,
              failed, too_large, batch_failed);
  return 0;
}
"""


def fixture_paths():
    return sorted(os.path.join(FIXTURE_DIR, name)
                  for name in os.listdir(FIXTURE_DIR) if name.endswith(".jpg"))


def scan_start(data: bytes) -> int:
    """The offset of the first byte after the SOS segment."""
    sos = data.find(b"\xff\xda")
    assert sos > 0, "no SOS marker"
    return sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")


def corruptions(sources, count: int, seed: int):
    """[(kind, bytes)]: `count` corrupt copies of the source files, made
    from a numpy seed, the kinds in turn: a truncation anywhere after the
    SOI marker, 1-4 bytes flipped in the first HEADER_BYTES, 1-8 bytes
    flipped in the entropy-coded scan."""
    rng = np.random.default_rng(seed)
    blobs = [open(p, "rb").read() for p in sources]
    out = []
    for i in range(count):
        data = bytearray(blobs[int(rng.integers(len(blobs)))])
        kind = ("truncate", "header", "scan")[i % 3]
        if kind == "truncate":
            data = data[:int(rng.integers(2, len(data)))]
        else:
            lo, hi = ((2, min(HEADER_BYTES, len(data))) if kind == "header"
                      else (scan_start(bytes(data)), len(data) - 2))
            flips = int(rng.integers(1, 5 if kind == "header" else 9))
            for at in rng.integers(lo, hi, flips):
                data[at] ^= int(rng.integers(1, 256))
        out.append((kind, bytes(data)))
    return out


@pytest.fixture(scope="module")
def cxx():
    found = shutil.which("c++") or shutil.which("g++")
    if found is None:
        pytest.skip("no C++ compiler (c++, g++) on PATH")
    return found


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The fixture frames and their seeded corruptions, listed in one file."""
    root = tmp_path_factory.mktemp("sanitize_files")
    paths = fixture_paths()
    assert len(paths) == 32
    for i, (kind, data) in enumerate(corruptions(paths, CORRUPTIONS, SEED)):
        path = root / f"corrupt_{i:03d}_{kind}.jpg"
        path.write_bytes(data)
        paths.append(str(path))
    listing = root / "files.txt"
    listing.write_text("\n".join(paths) + "\n")
    return str(listing), len(paths)


def build_decoder(cxx, root, flags, name):
    main = root / "decode_main.cc"
    main.write_text(DECODE_MAIN)
    exe = root / name
    cmd = [cxx, *COMMON_FLAGS, *flags, "-o", str(exe), SOURCE, str(main)]
    done = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=COMPILE_TIMEOUT_S)
    assert done.returncode == 0, done.stdout + done.stderr
    return str(exe)


def run_decoder(exe, listing, threads, *mode):
    env = {**os.environ, **SANITIZER_ENV}
    done = subprocess.run([exe, listing, str(threads), str(CANVAS), *mode],
                          capture_output=True, text=True, env=env,
                          timeout=RUN_TIMEOUT_S)
    output = done.stdout + done.stderr
    reports = [mark for mark in REPORT_MARKS if mark in output]
    assert done.returncode == 0 and not reports, (
        f"exit {done.returncode}, reports {reports}:\n{output[-6000:]}")
    counts = done.stdout.split()
    return dict(zip(counts[::2], map(int, counts[1::2])))


def test_corruptions_are_seeded_and_cover_each_kind():
    paths = fixture_paths()
    first = corruptions(paths, CORRUPTIONS, SEED)
    assert first == corruptions(paths, CORRUPTIONS, SEED)
    kinds = [kind for kind, _ in first]
    assert {k: kinds.count(k) for k in set(kinds)} == {
        "truncate": 100, "header": 100, "scan": 100}
    originals = {open(p, "rb").read() for p in paths}
    assert not any(data in originals for _, data in first)


def test_asan_ubsan_decode_each_and_batch(cxx, files, tmp_path):
    listing, n = files
    exe = build_decoder(cxx, tmp_path, ASAN_UBSAN, "decode_asan_ubsan")
    counts = run_decoder(exe, listing, THREADS)
    assert counts["files"] == n
    assert counts["ok"] + counts["failed"] + counts["too_large"] == n
    # every fixture frame decodes, alone and in the batch
    assert counts["ok"] >= 32 and counts["batch_failed"] <= n - 32
    assert counts["failed"] > 0, "no corruption made a decode fail"


def test_tsan_decode_batch_8_threads(cxx, files, tmp_path):
    listing, n = files
    exe = build_decoder(cxx, tmp_path, TSAN, "decode_tsan")
    counts = run_decoder(exe, listing, THREADS, "batch")
    assert counts["files"] == n and counts["batch_failed"] <= n - 32


@pytest.mark.parametrize("level", [0, 17, 64, 127])
def test_dc_only_blocks_with_negative_dc_equal_cv2(tmp_path, level):
    """Flat images darker than mid-grey: every block is a lone negative DC
    term, the IDCT's shortcut (jpeg_decode.cc's idct_block)."""
    img = np.full((48, 40, 3), level, np.uint8)
    path = str(tmp_path / f"flat_{level}.jpg")
    assert cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_QUALITY, 90])
    got = native_loader.decode(path)
    ref = cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1]
    assert got is not None and got.shape == ref.shape
    assert np.array_equal(got, ref)
    assert int(got.max()) < 128
