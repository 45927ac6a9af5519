"""The augmentation's photometric tail in one pass: colour jitter ->
[Gaussian noise] -> [colour drop] -> /255 -> [ImageNet normalisation].

No TPU kernel stands behind it: the reference leaves the chain to XLA,
which fuses it.  `photometric` launches one hand-written CUDA kernel
(`csrc/photometric.cu`, whose header says how it is designed and what
bounds it) for CUDA tensors and counts each launch (`.launches`); under
a capture it adds the images it took to the counter `photometric_images`
(utils/profiler.py:count).  CPU tensors take `photometric_plain`, which
composes ops/image.py's functions in the augmentation's order.  On the
card the kernel equals the plain chain bit for bit, but for the colour
drop's gray value (a few ulp: the plain chain's einsum sums in cuBLAS's
order).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from peclr_tpu_torch import build
from peclr_tpu_torch.ops import image as im
from peclr_tpu_torch.utils.profiler import count

def photometric_plain(x: torch.Tensor, h: Optional[torch.Tensor],
                      s: Optional[torch.Tensor], a: Optional[torch.Tensor],
                      b: Optional[torch.Tensor],
                      noise: Optional[torch.Tensor] = None,
                      noise_flag: Optional[torch.Tensor] = None,
                      drop_flag: Optional[torch.Tensor] = None,
                      jitter: bool = True, normalize: bool = True,
                      noise_std: float = 25.0) -> torch.Tensor:
    """The tail from torch ops: x (B, H, W, 3) in [0, 255] -> colour jitter
    with the per-sample factors h, s, a, b (when `jitter`), Gaussian noise
    (noise * noise_std, where noise_flag is 1), gray (where drop_flag is 1),
    /255, ImageNet normalisation (when `normalize`)."""
    if jitter:
        x = im.color_jitter(x, h, s, a, b)
    if noise is not None:
        x = im.where_flag(noise_flag, im.gaussian_noise(x, noise, noise_std),
                          x)
    if drop_flag is not None:
        x = im.where_flag(drop_flag, im.grayscale(x), x)
    x = x / 255.0
    if normalize:
        x = im.normalize_imagenet(x)
    return x


def _library() -> ctypes.CDLL:
    lib = build.load("photometric")
    fn = lib.peclr_photometric
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        ptr, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [ptr, ll, ll, ll, ll, ptr, ll, ll, ll, ll,
                       i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr,
                       ctypes.c_float, ptr, i32, i32, ptr]
        lib.peclr_photometric_error_string.restype = ctypes.c_char_p
        lib.peclr_photometric_error_string.argtypes = [ctypes.c_int]
    return lib


def _check(x: torch.Tensor, factors, noise, noise_flag, drop_flag,
           jitter: bool) -> None:
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"x must be (B, H, W, 3), not {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"the photometric kernel takes float32, not {x.dtype}")
    n = x.shape[0]
    named = dict(zip("hsab", factors)) if jitter else {}
    if jitter and any(t is None for t in factors):
        raise ValueError("jitter needs the factors h, s, a and b")
    if (noise is None) != (noise_flag is None):
        raise ValueError("noise and noise_flag come together")
    named.update(noise_flag=noise_flag, drop_flag=drop_flag)
    for name, t in named.items():
        if t is None:
            continue
        if t.shape != (n,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 of shape ({n},), not "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}")
    if noise is not None and (noise.shape != x.shape
                              or noise.dtype != torch.float32
                              or noise.device != x.device):
        raise ValueError("noise must be float32 of x's shape on x's device")


def photometric(x: torch.Tensor, h: Optional[torch.Tensor],
                s: Optional[torch.Tensor], a: Optional[torch.Tensor],
                b: Optional[torch.Tensor],
                noise: Optional[torch.Tensor] = None,
                noise_flag: Optional[torch.Tensor] = None,
                drop_flag: Optional[torch.Tensor] = None,
                jitter: bool = True, normalize: bool = True,
                noise_std: float = 25.0) -> torch.Tensor:
    """`photometric_plain` as one kernel: x (B, H, W, 3) f32 in [0, 255],
    any strides; h, s, a, b the (B,) colour-jitter factors (unused without
    `jitter`); noise (B, H, W, 3) with its (B,) coins noise_flag, or
    neither; drop_flag (B,) coins or None.  Returns a (B, H, W, 3) f32
    tensor, normalised or in [0, 1] without `normalize`: contiguous with
    the jitter, else laid out as x (the plain chain's layouts for the
    jitter and for /255 and the normalisation alone, so the fine-tune's
    views reach the model as they did; under noise or drop without the
    jitter the plain chain's `where` may lay out its result otherwise,
    with the same values)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no photometric kernel for device {x.device}")
    factors = (h, s, a, b)
    _check(x, factors, noise, noise_flag, drop_flag, jitter)
    if x.device.type == "cpu":
        return photometric_plain(x, h, s, a, b, noise, noise_flag, drop_flag,
                                 jitter, normalize, noise_std)
    used = (factors if jitter else ()) + (noise, noise_flag, drop_flag)
    if any(t is not None and not t.is_contiguous() for t in used):
        raise ValueError("the photometric kernel takes contiguous factors, "
                         "coins and noise")
    n, height, width, _ = x.shape
    # the plain chain's layout: its jitter stacks the channels (NHWC), its
    # division and normalisation keep x's
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device) \
        if jitter else torch.empty_like(x)
    if y.numel() == 0:
        return y

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.peclr_photometric(
            x.data_ptr(), *x.stride(), y.data_ptr(), *y.stride(), n, height,
            width,
            *(ptr(t) for t in factors), ptr(noise),
            ptr(noise_flag), noise_std, ptr(drop_flag), int(jitter),
            int(normalize), stream)
    if rc != 0:
        reason = ("arguments the kernel does not take" if rc == -1 else
                  lib.peclr_photometric_error_string(rc).decode())
        raise RuntimeError(f"photometric kernel launch failed: {reason}")
    photometric.launches += 1
    count("photometric_images", n)
    return y


photometric.launches = 0
