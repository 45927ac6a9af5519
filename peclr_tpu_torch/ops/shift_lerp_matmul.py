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

The kernel first finds each tile's band, the range of u where the taps of
the tile's outputs are not zero (`tap_band`; tiles of BAND_M outputs for
bf16 taps, BAND_M_F32 for f32 taps), and multiplies only that range.

`fused_shift_lerp_matmul` launches the kernel for CUDA tensors and counts
each call in `fused_shift_lerp_matmul.launches` (a call is two launches,
the band pass and the product); CPU tensors take `shift_lerp_matmul_plain`:
the grouped shift's plain version, then a dense f32 einsum.  `tap_band` and
`tap_band_plain` give the band pass alone.
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

BAND_M = 32  # outputs m per band tile of bf16 taps (kBandM of the CUDA source)
BAND_M_F32 = 8  # outputs m per band tile of f32 taps (kF32TileM)


def band_tile(dtype: torch.dtype) -> int:
    """Outputs m per band tile for taps of this type."""
    return BAND_M if dtype == torch.bfloat16 else BAND_M_F32


def tap_band_plain(w_t: torch.Tensor, bm: int = BAND_M) -> torch.Tensor:
    """w_t (B, M, U) -> int32 (B, ceil(M / bm), 2): for each tile of bm
    outputs m, the first u where some tap of the tile is not zero and one
    past the last; (0, 0) for a tile whose taps are all zero."""
    b, m, u = w_t.shape
    tiles = -(-m // bm)
    nz = torch.zeros((b, tiles * bm, u), dtype=torch.bool, device=w_t.device)
    nz[:, :m] = w_t != 0
    per_tile = nz.reshape(b, tiles, bm, u).any(dim=2)  # (B, tiles, U)
    if u == 0:
        return torch.zeros((b, tiles, 2), dtype=torch.int32, device=w_t.device)
    has = per_tile.any(dim=2)
    lo = per_tile.to(torch.int32).argmax(dim=2)  # the first maximum
    hi = u - per_tile.flip(2).to(torch.int32).argmax(dim=2)
    band = torch.stack([lo, hi], dim=-1)
    return torch.where(has[..., None], band, 0).to(torch.int32)


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
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.peclr_tap_band.restype = ctypes.c_int
        lib.peclr_tap_band.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.peclr_cuda_error_string.restype = ctypes.c_char_p
        lib.peclr_cuda_error_string.argtypes = [ctypes.c_int]
        for name, want in (("peclr_tap_band_m", BAND_M),
                           ("peclr_tap_band_m_f32", BAND_M_F32)):
            getter = getattr(lib, name)
            getter.restype = ctypes.c_int
            getter.argtypes = []
            if getter() != want:
                raise RuntimeError(f"csrc/shift_lerp_matmul.cu tiles the band "
                                   f"by {getter()} outputs ({name}), not "
                                   f"{want}")
    return lib


def _band_scratch(w_t: torch.Tensor) -> torch.Tensor:
    b, m, _ = w_t.shape
    return torch.empty((b, -(-m // band_tile(w_t.dtype)), 2),
                       dtype=torch.int32, device=w_t.device)


def fused_shift_lerp_matmul(rows4: torch.Tensor, k: torch.Tensor,
                            f: torch.Tensor, w_t: torch.Tensor,
                            out_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """rows4 (G, B, R, W) uint8/bf16/f32; k (B*R,) int32 and f (B*R,) f32
    row shifts, R-major per image; w_t (B, M, U) bf16/f32 taps, transposed
    -> (G, B, M, R) out_dtype (bf16 or f32).  Any G, B, R, W, U and M.

    On the card only each tile's band of nonzero taps is multiplied, with
    bf16 and with f32 taps.  The skipped terms are taps of exactly zero, so
    the f32 sums are those of the dense product while the window is finite;
    a non-finite source value can propagate differently from the dense
    product (Inf * 0 is NaN there and skipped here)."""
    if rows4.device.type == "cpu":
        return shift_lerp_matmul_plain(rows4, k, f, w_t, out_dtype)
    if rows4.device.type != "cuda":
        raise ValueError(f"no shift+matmul kernel for device {rows4.device}")
    _check_cuda_operands(rows4, k, f, w_t, out_dtype)
    g, b, r, w = rows4.shape
    _, m, u = w_t.shape
    out = torch.empty((g, b, m, r), dtype=out_dtype, device=rows4.device)
    band = _band_scratch(w_t)
    lib = _library()
    with torch.cuda.device(rows4.device):
        stream = torch.cuda.current_stream(rows4.device).cuda_stream
        rc = lib.peclr_shift_lerp_matmul(
            rows4.data_ptr(), _DTYPE_CODES[rows4.dtype], k.data_ptr(),
            f.data_ptr(), w_t.data_ptr(), _DTYPE_CODES[w_t.dtype],
            band.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[out_dtype], g, b, r, w, u, m, stream,
        )
    if rc == -2:
        raise ValueError(f"grid of {g}x{b} planes too large for one launch")
    _raise_on(rc, lib, "shift_lerp_matmul")
    fused_shift_lerp_matmul.launches += 1
    return out


fused_shift_lerp_matmul.launches = 0


def tap_band(w_t: torch.Tensor) -> torch.Tensor:
    """The band pass alone (the first launch of a call): w_t (B, M, U) bf16
    or f32 -> int32 (B, ceil(M / T), 2) with T = band_tile(w_t.dtype), as
    tap_band_plain.  Counted in `tap_band.launches`."""
    if w_t.device.type == "cpu":
        return tap_band_plain(w_t, band_tile(w_t.dtype))
    if w_t.device.type != "cuda":
        raise ValueError(f"no band kernel for device {w_t.device}")
    if w_t.dim() != 3 or w_t.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError("w_t must be (B, M, U) bf16 or f32")
    if not w_t.is_contiguous():
        raise ValueError("w_t must be contiguous")
    if max(w_t.shape) > _INT32_MAX:
        raise ValueError("every dimension must fit int32")
    b, m, u = w_t.shape
    band = _band_scratch(w_t)
    lib = _library()
    with torch.cuda.device(w_t.device):
        stream = torch.cuda.current_stream(w_t.device).cuda_stream
        rc = lib.peclr_tap_band(w_t.data_ptr(), _DTYPE_CODES[w_t.dtype],
                                band.data_ptr(), b, m, u, stream)
    _raise_on(rc, lib, "tap_band")
    tap_band.launches += 1
    return band


tap_band.launches = 0
