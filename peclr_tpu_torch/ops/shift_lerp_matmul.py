"""Fused per-row shift + lerp + per-image tap matmul: one warp pass in one
kernel.

Port of `fused_shift_lerp_matmul` (peclr_tpu/ops/pallas/barrel_shift.py),
whose Pallas body `_matmul_kernel` becomes the CUDA kernel
`csrc/shift_lerp_matmul.cu` (its header says how it is designed and what
bounds it).  For G planes of B images of R rows:

  win[g, b, r, u] = lerp of row (b, r) shifted by k + f, cast to w_t's type
  out[g, b, m, r] = sum_u win[g, b, r, u] * w_t[b, m, u]    (f32 sum)

with the shift semantics of the grouped kernel (ops/shift_lerp.py): taps
outside [0, W) read zero and a clamped row comes out zero.  The output is
transposed (m before r), the layout the warp's next pass reads.

`fused_shift_lerp_matmul` launches the kernel for CUDA tensors and counts
each launch in `fused_shift_lerp_matmul.launches`; CPU tensors take
`shift_lerp_matmul_plain`: the grouped shift's plain version, then an f32
einsum.
"""

from __future__ import annotations

import ctypes

import torch

from peclr_tpu_torch import build
from peclr_tpu_torch.ops.shift_lerp import (
    _DTYPE_CODES,
    _INT32_MAX,
    _raise_on,
    shift_lerp_grouped_plain,
)


def shift_lerp_matmul_plain(rows4: torch.Tensor, k: torch.Tensor,
                            f: torch.Tensor, w_t: torch.Tensor,
                            out_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """PyTorch version of the kernel: the lerped window in w_t's type, then
    a per-image NT product summed in f32."""
    g, b, r, w = rows4.shape
    u = w_t.shape[2]
    win = shift_lerp_grouped_plain(rows4.reshape(g, b * r, w), k, f, u,
                                   out_dtype=w_t.dtype)
    out = torch.einsum("gbru,bmu->gbmr", win.reshape(g, b, r, u).float(),
                       w_t.float())
    return out.to(out_dtype)


def _check_cuda_operands(rows4, k, f, w_t, out_dtype):
    if rows4.dim() != 4 or w_t.dim() != 3:
        raise ValueError(f"rows4 must be (G, B, R, W) and w_t (B, M, U), got "
                         f"{tuple(rows4.shape)} and {tuple(w_t.shape)}")
    g, b, r, w = rows4.shape
    if w_t.shape[0] != b:
        raise ValueError(f"w_t holds {w_t.shape[0]} images, rows4 {b}")
    if rows4.dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported input dtype {rows4.dtype}")
    if w_t.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the taps are bf16 or f32, got {w_t.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the output is bf16 or f32, got {out_dtype}")
    if max(g, b, r, w + w_t.shape[2] + 2, w_t.shape[1]) > _INT32_MAX:
        raise ValueError("every dimension must fit int32")
    if k.shape != (b * r,) or k.dtype != torch.int32:
        raise ValueError(f"k must be int32 of shape ({b * r},)")
    if f.shape != (b * r,) or f.dtype != torch.float32:
        raise ValueError(f"f must be float32 of shape ({b * r},)")
    for t in (rows4, k, f, w_t):
        if t.device != rows4.device:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")


def _library() -> ctypes.CDLL:
    lib = build.load("shift_lerp_matmul")
    fn = lib.peclr_shift_lerp_matmul
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.peclr_cuda_error_string.restype = ctypes.c_char_p
        lib.peclr_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def fused_shift_lerp_matmul(rows4: torch.Tensor, k: torch.Tensor,
                            f: torch.Tensor, w_t: torch.Tensor,
                            out_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """rows4 (G, B, R, W) uint8/bf16/f32; k (B*R,) int32 and f (B*R,) f32
    row shifts, R-major per image; w_t (B, M, U) bf16/f32 taps, transposed
    -> (G, B, M, R) out_dtype (bf16 or f32).  Any G, B, R, W, U and M."""
    if rows4.device.type == "cpu":
        return shift_lerp_matmul_plain(rows4, k, f, w_t, out_dtype)
    if rows4.device.type != "cuda":
        raise ValueError(f"no shift+matmul kernel for device {rows4.device}")
    _check_cuda_operands(rows4, k, f, w_t, out_dtype)
    g, b, r, w = rows4.shape
    _, m, u = w_t.shape
    out = torch.empty((g, b, m, r), dtype=out_dtype, device=rows4.device)
    lib = _library()
    with torch.cuda.device(rows4.device):
        stream = torch.cuda.current_stream(rows4.device).cuda_stream
        rc = lib.peclr_shift_lerp_matmul(
            rows4.data_ptr(), _DTYPE_CODES[rows4.dtype], k.data_ptr(),
            f.data_ptr(), w_t.data_ptr(), _DTYPE_CODES[w_t.dtype],
            out.data_ptr(), _DTYPE_CODES[out_dtype], g, b, r, w, u, m, stream,
        )
    if rc == -2:
        raise ValueError(f"grid of {g}x{b} planes too large for one launch")
    _raise_on(rc, lib, "shift_lerp_matmul")
    fused_shift_lerp_matmul.launches += 1
    return out


fused_shift_lerp_matmul.launches = 0
