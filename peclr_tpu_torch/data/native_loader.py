"""ctypes binding of the native C++ JPEG decode pool (port of
peclr_tpu/data/native_loader.py over the same, unchanged
`native/libpeclr_loader.so`, built with `make -C native` against libjpeg).

The library is optional: where it is missing or cannot load (no
libjpeg.so.62 on the host), `available()` is False and the pipeline
decodes with cv2 or PIL instead.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

from peclr_tpu_torch.constants import REPO_ROOT

_LIB_PATH = os.path.join(REPO_ROOT, "native", "libpeclr_loader.so")

_lib: Optional[ctypes.CDLL] = None
_checked = False
#: why the library is not available (None when it is)
load_error: Optional[str] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _checked, load_error
    if _checked:
        return _lib
    _checked = True
    if not os.path.exists(_LIB_PATH):
        load_error = f"{_LIB_PATH} is not built (make -C native)"
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:  # built for another host, or libjpeg missing
        load_error = str(e)
        return None
    lib.peclr_decode_jpeg.restype = ctypes.c_int
    lib.peclr_decode_jpeg.argtypes = [
        ctypes.c_char_p,                  # path
        ctypes.POINTER(ctypes.c_ubyte),   # out buffer
        ctypes.c_int,                     # buffer capacity (bytes)
        ctypes.POINTER(ctypes.c_int),     # out height
        ctypes.POINTER(ctypes.c_int),     # out width
    ]
    lib.peclr_decode_batch.restype = ctypes.c_int
    lib.peclr_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),  # paths
        ctypes.c_int,                     # count
        ctypes.POINTER(ctypes.c_ubyte),   # out canvas buffer
        ctypes.c_int,                     # canvas size (square)
        ctypes.c_int,                     # threads
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def decode(path: str, max_side: int = 4096) -> Optional[np.ndarray]:
    """Decode one JPEG to RGB uint8 (H, W, 3); None on failure."""
    lib = _load()
    if lib is None:
        return None
    cap = max_side * max_side * 3
    buf = np.empty((cap,), np.uint8)
    h = ctypes.c_int(0)
    w = ctypes.c_int(0)
    rc = lib.peclr_decode_jpeg(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        cap, ctypes.byref(h), ctypes.byref(w),
    )
    if rc != 0:
        return None
    return buf[: h.value * w.value * 3].reshape(h.value, w.value, 3).copy()


def decode_batch_to_canvas(paths: Sequence[str], canvas: int,
                           threads: int = 8) -> Optional[np.ndarray]:
    """Decode many JPEGs into a new (N, canvas, canvas, 3) uint8 batch with
    the C++ thread pool (canvas-sized sources such as FreiHAND); None on
    failure."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    out = np.zeros((n, canvas, canvas, 3), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.peclr_decode_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), canvas,
        threads,
    )
    if rc != 0:
        return None
    return out
