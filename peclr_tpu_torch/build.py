"""Build and load the port's hand-written native code.

Each `csrc/<name>.cu` is a CUDA kernel library with a plain C interface,
compiled by `nvcc` for Hopper (`sm_90a`).  Each `csrc/<name>.cc` is host
code (the JPEG decode pool), compiled by the host's C++ compiler (`c++`,
else `g++`), which is also the one `nvcc` drives.  Either is built into
`_build/lib<name>-<hash>.so` the first time it is used, where the hash
covers the sources and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  The library is bound with ctypes;
nothing here includes PyTorch's headers, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
#: -lineinfo maps the code to source lines for a tool that reports them (it
#: leaves the generated code as it is)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
)
HOST_CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


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


def _cxx() -> str:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (c++, g++) on PATH: one is needed "
                       "to build the port's host libraries")


def is_host(name: str) -> bool:
    """True for a host source (`csrc/<name>.cc`), False for a kernel."""
    return os.path.exists(os.path.join(CSRC_DIR, f"{name}.cc"))


def _sources(name: str) -> List[str]:
    if is_host(name):
        return [os.path.join(CSRC_DIR, f"{name}.cc")]
    return [os.path.join(CSRC_DIR, f"{name}.cu")] + sorted(
        glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _flags(name: str) -> tuple:
    return HOST_CXX_FLAGS if is_host(name) else NVCC_FLAGS


def library_path(name: str) -> str:
    """Where `csrc/<name>.cu` or `.cc` is built, keyed by its sources and
    flags."""
    digest = hashlib.sha256(" ".join(_flags(name)).encode())
    for src in _sources(name):
        with open(src, "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str]) -> Dict[str, float]:
    """Build every named library that is not built yet, one compiler per
    source, all started together.  Returns the seconds each took (0.0 for a
    cached one) and raises with the compiler's output on a failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    started = {}
    seconds: Dict[str, float] = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            seconds[name] = 0.0
            continue
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        compiler = _cxx() if is_host(name) else _nvcc()
        cmd = [compiler, *_flags(name), "-o", tmp, _sources(name)[0]]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{os.path.basename(_sources(name)[0])}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    if failures:
        raise RuntimeError("build failed\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The built `csrc/<name>` library, building it on first use."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:  # threads that decode at once build it once
            lib = _loaded.get(name)
            if lib is None:
                build([name])
                lib = _loaded[name] = ctypes.CDLL(library_path(name))
    return lib
