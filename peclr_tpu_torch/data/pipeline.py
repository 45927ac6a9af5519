"""Host-side JPEG decode (port of peclr_tpu/data/pipeline.py:28-49).

The decoder order is the reference's: the native C++ decoder
(`native/libpeclr_loader.so`, built with `make -C native`) when it is
present, else cv2, else PIL.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from peclr_tpu_torch.constants import REPO_ROOT

_NATIVE_LIB = os.path.join(REPO_ROOT, "native", "libpeclr_loader.so")
_MAX_SIDE = 4096
_native: Optional[ctypes.CDLL] = None
_native_checked = False


def _native_decoder() -> Optional[ctypes.CDLL]:
    global _native, _native_checked
    if not _native_checked:
        _native_checked = True
        if os.path.exists(_NATIVE_LIB):
            try:
                lib = ctypes.CDLL(_NATIVE_LIB)
            except OSError:  # built for another platform or missing libjpeg
                lib = None
            if lib is not None:
                lib.peclr_decode_jpeg.restype = ctypes.c_int
                lib.peclr_decode_jpeg.argtypes = [
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte),
                    ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_int),
                ]
            _native = lib
    return _native


def _decode_native(lib: ctypes.CDLL, path: str) -> Optional[np.ndarray]:
    cap = _MAX_SIDE * _MAX_SIDE * 3
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


def decode_image(path: str) -> np.ndarray:
    """JPEG -> RGB uint8 (H, W, 3)."""
    lib = _native_decoder()
    if lib is not None:
        img = _decode_native(lib, path)
        if img is not None:
            return img
    try:
        import cv2
    except ImportError:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(
            f"could not decode image {path!r} (missing or corrupt file)"
        )
    return img[:, :, ::-1].copy()  # BGR -> RGB
