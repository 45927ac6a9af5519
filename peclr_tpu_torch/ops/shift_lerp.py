"""Per-row shift + fractional lerp: the warp's row-shift kernels.

Port of `fused_shift_lerp_grouped` and `fused_shift_lerp`
(peclr_tpu/ops/pallas/barrel_shift.py), whose Pallas bodies
`_kernel(grouped=True)`, `_kernel_raw` and `_kernel(grouped=False)` become one
templated CUDA kernel, `csrc/shift_lerp.cu` (its header says how it is
designed and what bounds it).  Grouped: G planes of N rows share one shift
per row:

  lerp: out[g, n, u] = x[g, n, u + k_n] * (1 - f_n) + x[g, n, u + k_n + 1] * f_n
  raw:  out[g, n, u] = x[g, n, u + k_n]

Flat: NHWC rows with C channels folded in, taps C elements apart:

  out[n, u*C + c] = x[n, (u + k_n)*C + c] * (1 - f_n) + x[n, (u + k_n + 1)*C + c] * f_n

Taps outside the row read zero and k_n is clamped to [-(out + 2), W] (in
pixels), so a clamped row comes out all zero.  The lerp runs in f32 and is
cast to the output type; the raw window keeps the input type, bit for bit.

`fused_shift_lerp_grouped` and `fused_shift_lerp` launch the kernel for CUDA
tensors and count each launch (`fused_shift_lerp_grouped.launches` for the
lerp, `.raw_launches` for the raw mode, `fused_shift_lerp.launches`); each
records the kernel path of its last launch in `.last_path`, as `shift_path`
chose it: "vec16" (16-byte staged rows and stores) or "scalar".  CPU
tensors take `shift_lerp_grouped_plain` / `shift_lerp_flat_plain`, the
PyTorch versions of the same arithmetic.
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
#: the widest source row, in bytes, that the kernel's 16-byte path stages
#: (kMaxRowBytes of csrc/shift_lerp.cu: two buffers of row + 32 bytes for
#: each of 8 warps within 48 KB of shared memory)
VEC16_MAX_ROW_BYTES = 48 * 1024 // 16 - 32


def shift_path(in_ptr: int, in_row_bytes: int, out_ptr: int,
               out_row_bytes: int) -> str:
    """The kernel path for operands at these addresses and row sizes:
    "vec16" when both bases and both row sizes are multiples of 16 bytes and
    the source row fits the staging buffers, else "scalar".  Both paths are
    the CUDA kernel."""
    aligned = all(v % 16 == 0 for v in (in_ptr, in_row_bytes, out_ptr,
                                         out_row_bytes))
    return ("vec16" if aligned and in_row_bytes <= VEC16_MAX_ROW_BYTES
            else "scalar")


def _path_of(rows: torch.Tensor, out: torch.Tensor) -> str:
    return shift_path(rows.data_ptr(), rows.shape[-1] * rows.element_size(),
                      out.data_ptr(), out.shape[-1] * out.element_size())


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


def _check_cuda_operands(rows3, k, f, out_elems, out_dtype, lerp, c=1):
    if rows3.dim() != 3:
        raise ValueError(f"rows3 must be (G, N, W), got {tuple(rows3.shape)}")
    g, n, w = rows3.shape
    if rows3.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtypes {rows3.dtype} -> {out_dtype}")
    if lerp and out_dtype == torch.uint8:
        raise TypeError("the lerp writes bf16 or f32")
    if max(w + out_elems + 2 * c + 16, n) > _INT32_MAX:
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
            ctypes.c_int, ctypes.c_void_p,
        ]
        flat = lib.peclr_shift_lerp_flat
        flat.restype = ctypes.c_int
        flat.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p,
        ]
        lib.peclr_cuda_error_string.restype = ctypes.c_char_p
        lib.peclr_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _raise_on(rc: int, lib: ctypes.CDLL, what: str) -> None:
    if rc != 0:
        reason = {-1: "unsupported dtypes",
                  -2: "operands unfit for the 16-byte path"}.get(rc)
        if reason is None:
            reason = lib.peclr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {reason}")


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
    path = _path_of(rows3, out)
    lib = _library()
    with torch.cuda.device(rows3.device):
        stream = torch.cuda.current_stream(rows3.device).cuda_stream
        rc = lib.peclr_shift_lerp_grouped(
            rows3.data_ptr(), _DTYPE_CODES[rows3.dtype], k.data_ptr(),
            f.data_ptr() if lerp else None, out.data_ptr(),
            _DTYPE_CODES[out_dtype], int(lerp), g, n, w, out_elems,
            int(path == "vec16"), stream,
        )
    _raise_on(rc, lib, "shift_lerp")
    fused_shift_lerp_grouped.last_path = path
    if lerp:
        fused_shift_lerp_grouped.launches += 1
    else:
        fused_shift_lerp_grouped.raw_launches += 1
    return out


fused_shift_lerp_grouped.launches = 0
fused_shift_lerp_grouped.raw_launches = 0
fused_shift_lerp_grouped.last_path = None


def shift_lerp_flat_plain(rows: torch.Tensor, k: torch.Tensor,
                          f: torch.Tensor, out_elems: int, c: int,
                          out_dtype: torch.dtype = torch.bfloat16
                          ) -> torch.Tensor:
    """PyTorch version of the flat kernel: pad, gather, lerp in f32."""
    n, w = rows.shape
    kk = k.to(torch.int64).clamp(-(out_elems // c + 2), w // c) * c
    # padded[p] = rows[p - pad]; taps u + kk and u + kk + c land in
    # [0, w + out_elems + c) of the padded row for the clamped k
    pad = (out_elems // c + 2) * c
    padded = F.pad(rows, (pad, out_elems + c))
    idx = kk[:, None] + pad + torch.arange(out_elems + c,
                                           device=rows.device)[None, :]
    window = torch.gather(padded, 1, idx).to(torch.float32)
    fr = f.to(torch.float32)[:, None]
    return (window[:, :-c] * (1.0 - fr) + window[:, c:] * fr).to(out_dtype)


def fused_shift_lerp(rows: torch.Tensor, k: torch.Tensor, f: torch.Tensor,
                     out_elems: int, c: int,
                     out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """rows (N, W*C) uint8/bf16/f32 flattened pixel rows; k (N,) int32 pixel
    shifts; f (N,) f32 fractions -> (N, out_elems) out_dtype (bf16 or f32).
    Any N, W, C and out_elems."""
    if rows.device.type == "cpu":
        return shift_lerp_flat_plain(rows, k, f, out_elems, c, out_dtype)
    if rows.device.type != "cuda":
        raise ValueError(f"no shift kernel for device {rows.device}")
    if rows.dim() != 2 or c < 1:
        raise ValueError(f"rows must be (N, W*C) with C >= 1, got "
                         f"{tuple(rows.shape)}, C = {c}")
    _check_cuda_operands(rows[None], k, f, out_elems, out_dtype, True, c)
    n, w = rows.shape
    out = torch.empty((n, out_elems), dtype=out_dtype, device=rows.device)
    path = _path_of(rows, out)
    lib = _library()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        rc = lib.peclr_shift_lerp_flat(
            rows.data_ptr(), _DTYPE_CODES[rows.dtype], k.data_ptr(),
            f.data_ptr(), out.data_ptr(), _DTYPE_CODES[out_dtype], n, w,
            out_elems, c, int(path == "vec16"), stream,
        )
    _raise_on(rc, lib, "shift_lerp_flat")
    fused_shift_lerp.last_path = path
    fused_shift_lerp.launches += 1
    return out


fused_shift_lerp.launches = 0
fused_shift_lerp.last_path = None


def shift_rows(images: torch.Tensor, offsets: torch.Tensor, out_w: int,
               lerp_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Counterpart of the reference's shift_rows_pallas: images (B, H, W, C),
    real offsets (B, H) -> (B, H, out_w, C) lerp_dtype, each row shifted by
    its offset through the flat kernel."""
    b, h, w, c = images.shape
    n = b * h
    k_true = torch.floor(offsets)
    # clamp before the int conversion; the kernel clamps to the same range
    k = k_true.clamp(-(out_w + 2), w).to(torch.int32).reshape(n)
    f = (offsets - k_true).to(torch.float32).reshape(n)
    out = fused_shift_lerp(images.reshape(n, w * c), k, f, out_w * c, c,
                           out_dtype=lerp_dtype)
    return out.reshape(b, h, out_w, c)
