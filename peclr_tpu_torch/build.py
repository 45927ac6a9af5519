"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface.  It is compiled by `nvcc` for
Hopper (`sm_90a`) into `_build/lib<name>-<hash>.so` the first time it is
used, where the hash covers the sources and the flags, so an edited kernel is
rebuilt and an unchanged one is loaded as it is.  The library is bound with
ctypes; nothing here includes PyTorch's headers, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA toolkit is "
            "needed to build the port's kernels"
        )
    return path


def library_path(name: str) -> str:
    """Where `csrc/<name>.cu` is built, keyed by its sources and flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    sources = [os.path.join(CSRC_DIR, f"{name}.cu")]
    sources += sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for src in sources:
        with open(src, "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str]) -> Dict[str, float]:
    """Build every named kernel library that is not built yet, one `nvcc`
    per source, all started together.  Returns the seconds each took (0.0
    for a cached one) and raises with the compiler's output on a failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    started = {}
    seconds: Dict[str, float] = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            seconds[name] = 0.0
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    if failures:
        raise RuntimeError("nvcc failed\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The built `csrc/<name>.cu` library, building it on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(library_path(name))
    return lib
