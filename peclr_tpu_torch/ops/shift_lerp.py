"""Grouped per-row shift + fractional lerp: the warp's row-shift kernel.

Port of `fused_shift_lerp_grouped` (peclr_tpu/ops/pallas/barrel_shift.py),
whose two Pallas bodies `_kernel(grouped=True)` and `_kernel_raw` become one
templated CUDA kernel, `csrc/shift_lerp.cu` (its header says how it is
designed and what bounds it).  G planes of N rows share one shift per row:

  lerp: out[g, n, u] = x[g, n, u + k_n] * (1 - f_n) + x[g, n, u + k_n + 1] * f_n
  raw:  out[g, n, u] = x[g, n, u + k_n]

with taps outside [0, W) reading zero and k_n clamped to [-(out + 2), W], so a
clamped row comes out all zero.  The lerp runs in f32 and is cast to the
output type; the raw window keeps the input type, bit for bit.

`fused_shift_lerp_grouped` launches the kernel for CUDA tensors and counts
each launch in `fused_shift_lerp_grouped.launches` (lerp) or
`fused_shift_lerp_grouped.raw_launches` (raw).  CPU tensors take
`shift_lerp_grouped_plain`, the PyTorch version of the same arithmetic.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from peclr_tpu_torch import build

#: dtype codes of csrc/shift_lerp.cu
_DTYPE_CODES = {torch.uint8: 0, torch.bfloat16: 1, torch.float32: 2}
_INT32_MAX = 2**31 - 1


def _out_dtype(rows3: torch.Tensor, out_dtype, lerp: bool) -> torch.dtype:
    if lerp:
        return torch.bfloat16 if out_dtype is None else out_dtype
    if out_dtype is not None and out_dtype != rows3.dtype:
        raise ValueError(
            "lerp=False emits the window in rows3.dtype; leave out_dtype unset"
        )
    return rows3.dtype


def shift_lerp_grouped_plain(rows3: torch.Tensor, k: torch.Tensor,
                             f: Optional[torch.Tensor], out_elems: int,
                             out_dtype: Optional[torch.dtype] = None,
                             lerp: bool = True) -> torch.Tensor:
    """PyTorch version of the kernel: pad, gather, lerp in f32."""
    out_dtype = _out_dtype(rows3, out_dtype, lerp)
    g, n, w = rows3.shape
    pad = out_elems + 2
    kk = k.to(torch.int64).clamp(-pad, w)
    # padded[p] = rows3[p - pad]; tap u + k lands at padded index u + k + pad,
    # which spans [0, w + 2 * out_elems + 2] for the clamped k
    padded = F.pad(rows3, (pad, out_elems + 3))
    taps = out_elems + 1 if lerp else out_elems
    idx = kk[:, None] + pad + torch.arange(taps, device=rows3.device)[None, :]
    window = torch.gather(padded, 2, idx[None].expand(g, n, taps))
    if not lerp:
        return window
    window = window.to(torch.float32)
    fr = f.to(torch.float32)[None, :, None]
    return (window[..., :-1] * (1.0 - fr) + window[..., 1:] * fr).to(out_dtype)


def _check_cuda_operands(rows3, k, f, out_elems, out_dtype, lerp):
    if rows3.dim() != 3:
        raise ValueError(f"rows3 must be (G, N, W), got {tuple(rows3.shape)}")
    g, n, w = rows3.shape
    if rows3.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtypes {rows3.dtype} -> {out_dtype}")
    if lerp and out_dtype == torch.uint8:
        raise TypeError("the lerp writes bf16 or f32")
    if max(w + out_elems + 2, n) > _INT32_MAX:
        raise ValueError("row width + window and row count must fit int32")
    if k.shape != (n,) or k.dtype != torch.int32:
        raise ValueError(f"k must be int32 of shape ({n},)")
    if lerp and (f is None or f.shape != (n,) or f.dtype != torch.float32):
        raise ValueError(f"f must be float32 of shape ({n},)")
    operands = (rows3, k) + ((f,) if lerp else ())
    for t in operands:
        if t.device != rows3.device:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")


def _library() -> ctypes.CDLL:
    lib = build.load("shift_lerp")
    fn = lib.peclr_shift_lerp_grouped
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p,
        ]
        lib.peclr_cuda_error_string.restype = ctypes.c_char_p
        lib.peclr_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def fused_shift_lerp_grouped(rows3: torch.Tensor, k: torch.Tensor,
                             f: Optional[torch.Tensor], out_elems: int,
                             out_dtype: Optional[torch.dtype] = None,
                             lerp: bool = True) -> torch.Tensor:
    """rows3 (G, N, W) uint8/bf16/f32; k (N,) int32; f (N,) f32 (ignored,
    may be None, when lerp=False) -> (G, N, out_elems).

    lerp=True writes `out_dtype` (bf16 by default, or f32); lerp=False writes
    the integer-shifted window in rows3.dtype.  Any N, W and out_elems."""
    if rows3.device.type == "cpu":
        return shift_lerp_grouped_plain(rows3, k, f, out_elems, out_dtype,
                                        lerp)
    if rows3.device.type != "cuda":
        raise ValueError(f"no shift kernel for device {rows3.device}")
    out_dtype = _out_dtype(rows3, out_dtype, lerp)
    _check_cuda_operands(rows3, k, f, out_elems, out_dtype, lerp)
    g, n, w = rows3.shape
    out = torch.empty((g, n, out_elems), dtype=out_dtype, device=rows3.device)
    lib = _library()
    with torch.cuda.device(rows3.device):
        stream = torch.cuda.current_stream(rows3.device).cuda_stream
        rc = lib.peclr_shift_lerp_grouped(
            rows3.data_ptr(), _DTYPE_CODES[rows3.dtype], k.data_ptr(),
            f.data_ptr() if lerp else None, out.data_ptr(),
            _DTYPE_CODES[out_dtype], int(lerp), g, n, w, out_elems, stream,
        )
    if rc != 0:
        reason = ("unsupported dtypes" if rc < 0 else
                  lib.peclr_cuda_error_string(rc).decode())
        raise RuntimeError(f"shift_lerp kernel launch failed: {reason}")
    if lerp:
        fused_shift_lerp_grouped.launches += 1
    else:
        fused_shift_lerp_grouped.raw_launches += 1
    return out


fused_shift_lerp_grouped.launches = 0
fused_shift_lerp_grouped.raw_launches = 0
