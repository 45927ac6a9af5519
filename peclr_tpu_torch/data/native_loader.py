"""ctypes binding of the port's own JPEG decode pool, csrc/jpeg_decode.cc
(the counterpart of the reference package's C++ pool over libjpeg, with the
same C ABI).

The pool is the port's: a baseline JPEG decoder written for it, byte-equal
to libjpeg-turbo's default decode, and a thread pool that decodes whole
batches straight into the canvas with no interpreter lock held.  It links
no JPEG library and is built from its source by the host's C++ compiler at
first use (build.py), so it runs on a host with no libjpeg.  A build or
load failure raises with the compiler's output.

A file the decoder refuses (progressive, arithmetic-coded, 4:1:1 or 4:4:0
sampling, ...) or cannot read gives None, and the pipeline then takes the
reference's path for a failed native decode: `decode_image` goes on to cv2,
then PIL, and a batch goes to the thread pool (data/pipeline.py).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence

import numpy as np

from peclr_tpu_torch import build

_lib: Optional[ctypes.CDLL] = None
#: True once the library was loaded, or switched off (`_lib` None)
_checked = False
_lock = threading.Lock()
#: each thread's output buffer for `decode`, kept between calls: a fresh
#: max_side² buffer a call costs the host a map, page faults and an unmap
#: each time, more than the decode itself on the card's host
_scratch = threading.local()
#: the last build or load failure's message (None when there was none)
load_error: Optional[str] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _checked, load_error
    if _checked:
        return _lib
    with _lock:
        if _checked:
            return _lib
        try:
            lib = build.load("jpeg_decode")
        except (RuntimeError, OSError) as e:
            load_error = str(e)
            raise
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
        _checked = True
    return _lib


def available() -> bool:
    """True where the pool is in use: it is built and loaded here on the
    first call (raising on a failure); False only when it was switched
    off."""
    return _load() is not None


def decode(path: str, max_side: int = 4096) -> Optional[np.ndarray]:
    """Decode one JPEG to RGB uint8 (H, W, 3); None when the file is
    missing, corrupt, refused or larger than max_side² pixels."""
    lib = _load()
    if lib is None:
        return None
    cap = max_side * max_side * 3
    buf = getattr(_scratch, "buf", None)
    if buf is None or buf.size < cap:
        buf = _scratch.buf = np.empty((cap,), np.uint8)
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
    the C++ thread pool (a frame of another size is resized to the canvas
    by nearest neighbour, as the reference's pool does); None when any
    frame failed."""
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
