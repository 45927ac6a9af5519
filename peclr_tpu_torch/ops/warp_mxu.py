"""Two-pass affine warp: per-row shifts plus banded tap matmuls (port of
peclr_tpu/ops/warp_mxu.py, :302-457, with its three routes).

  inverse map (out -> src):  x_s = A·i + B·j + TX ;  y_s = C·i + D·j + TY

  pass 1 (horizontal, per source row y): shift row y by β·y + γ (integer
      part + fractional 2-tap lerp, the CUDA kernel of ops/shift_lerp.py),
      then a per-image banded matmul W1[u, i] = tap(α·i − u),
      α = A − BC/D, β = B/D, γ = TX − B·TY/D (|rotation| < 90°);
  pass 2 (vertical, per output column i): shift column i by C·i + TY, then
      W2[v, j] = tap(D·j − v).

The interpolation is a lerp of lerps; the border is zero outside the source,
enforced by an exact validity mask from the direct inverse map.  The route
names which kernels run each pass:

  "grouped"  channels lead, each shift row is a single-channel pixel row:
             the grouped shift kernel, then torch.matmul (the reference's
             default TPU route);
  "matmul"   channels lead, the shift, lerp and tap matmul of each pass in
             one kernel (ops/shift_lerp_matmul.py) with transposed tap
             matrices (the reference's PECLR_SHIFT_FUSE=matmul);
  "nhwc"     pixels keep their channels, the flat shift kernel on (W*C)
             rows, then einsum (the reference's _shift_rows_any route).

Each shift pass, kernel or plain version, runs inside a `warp.shift` span
(utils/profiler.py:span), two a warp on every route.
"""

from __future__ import annotations

import torch

from peclr_tpu_torch.ops import shift_lerp
from peclr_tpu_torch.ops.shift_lerp import fused_shift_lerp_grouped
from peclr_tpu_torch.ops.shift_lerp_matmul import fused_shift_lerp_matmul
from peclr_tpu_torch.utils.profiler import span

ROUTES = ("grouped", "matmul", "nhwc")


def _inv3_affine(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a batch of 2D homogeneous affines (..., 3, 3)."""
    a, b, tx = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    c, d, ty = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    det = a * d - b * c
    zeros = torch.zeros_like(a)
    ones = torch.ones_like(a)
    rows = [
        [d / det, -b / det, (b * ty - d * tx) / det],
        [-c / det, a / det, (c * tx - a * ty) / det],
        [zeros, zeros, ones],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _tap_iotas(n_in: int, n_out: int, device, transposed: bool = False):
    """Broadcast iotas for the tap matrices: (B, n_in, n_out), or
    (B, n_out, n_in) when transposed (taps minor, the fused kernel's
    layout)."""
    i = torch.arange(n_out, dtype=torch.float32, device=device)
    u = torch.arange(n_in, dtype=torch.float32, device=device)
    if transposed:
        return i[None, :, None], u[None, None, :]
    return i[None, None, :], u[None, :, None]


def _tent_matrix(slopes: torch.Tensor, n_in: int, n_out: int,
                 transposed: bool = False) -> torch.Tensor:
    """(B, n_in, n_out) banded bilinear-tap matrix:
    M[b, u, i] = max(0, 1 − |slope_b·i − u|)."""
    i, u = _tap_iotas(n_in, n_out, slopes.device, transposed)
    pos = slopes[:, None, None] * i
    return torch.clamp_min(1.0 - torch.abs(pos - u), 0.0)


def _area_matrix(slopes: torch.Tensor, n_in: int, n_out: int,
                 transposed: bool = False) -> torch.Tensor:
    """(B, n_in, n_out) box-filter (cv2 INTER_AREA) matrix for downscaling:
    output pixel i averages source [s·i, s·(i+1)); the tent taps where
    s <= 1 (cv2's INTER_AREA is bilinear on upscale)."""
    i, u = _tap_iotas(n_in, n_out, slopes.device, transposed)
    s = slopes[:, None, None]
    overlap = torch.clamp(
        torch.minimum(s * (i + 1.0), u + 1.0) - torch.maximum(s * i, u),
        0.0, 1.0,
    )
    area = overlap / torch.clamp_min(s, 1e-6)
    tent = torch.clamp_min(1.0 - torch.abs(s * i - u), 0.0)
    return torch.where(s > 1.0, area, tent)


def pallas_window_sizes(out_hw, max_scale_x: float, max_scale_y: float,
                        xla_lerp: bool = False):
    """The (u_size, v_size) sampling windows of the kernel route, rounded up
    to 128 taps as on the TPU (the extra taps sit past every sampling
    position and contribute exact zeros).  `xla_lerp` adds the slack tap
    that the split lerp's zero top tap relies on."""
    out_h, out_w = out_hw
    u_size = int(max_scale_x * out_w) + 2
    v_size = int(max_scale_y * out_h) + 2
    slack = 1 if xla_lerp else 0
    return _round_up(u_size + slack, 128), _round_up(v_size + slack, 128)


def _shift_pass_cfirst(xc: torch.Tensor, offsets: torch.Tensor, window: int,
                       lerp_dtype: torch.dtype,
                       lerp_in_kernel: bool = True) -> torch.Tensor:
    """One shift pass on channel-leading data: xc (C, B, H, W) and real
    offsets (B, H) -> shifted (C, B, H, window) in lerp_dtype.

    lerp_in_kernel=False runs the kernel's raw mode (integer shift, input
    type kept) and lerps here in f32 with a zero-filled top tap; callers size
    `window` so that the last tap row is all zero (pallas_window_sizes'
    slack tap).  This is the reference's PECLR_SHIFT_LERP=xla route."""
    c, b, h, w = xc.shape
    rows3 = xc.reshape(c, b * h, w)
    k_true = torch.floor(offsets)
    # clamp before the int conversion; the kernel clamps to the same range
    k = k_true.clamp(-(window + 2), w).to(torch.int32).reshape(-1)
    f = (offsets - k_true).to(torch.float32).reshape(-1)
    if lerp_in_kernel:
        with span("warp.shift"):
            out = fused_shift_lerp_grouped(rows3, k, f, window,
                                           out_dtype=lerp_dtype)
        return out.reshape(c, b, h, window)
    with span("warp.shift"):
        raw = fused_shift_lerp_grouped(rows3, k, None, window, lerp=False)
        win = raw.reshape(c, b, h, window).to(torch.float32)
        hi = torch.cat([win[..., 1:], torch.zeros_like(win[..., :1])], dim=-1)
        f4 = f.reshape(1, b, h, 1)
        return (win * (1.0 - f4) + hi * f4).to(lerp_dtype)


def _default_compute_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card (uint8 inputs exact, as on the TPU); f32 on the CPU,
    like the reference's CPU backend."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def _warp_matmul(x, rows_off, cols_off, alpha, D, u_size, v_size, out_hw,
                 tap_matrix, compute_dtype):
    """Both passes through the fused shift+lerp+matmul kernel.  Pass 1 reads
    the (C, B, H, W) canvases and writes (C, B, out_w, H), transposed for
    pass 2; taps past row H read zero, so H needs no padding."""
    out_h, out_w = out_hw
    xc = x.permute(3, 0, 1, 2).contiguous()  # (C, B, H, W)

    def shifts(offsets, window, width):
        # clamp before the int conversion; the kernel clamps to the same range
        k_true = torch.floor(offsets)
        k = k_true.clamp(-(window + 2), width).to(torch.int32).reshape(-1)
        return k, (offsets - k_true).to(torch.float32).reshape(-1)

    k1, f1 = shifts(rows_off, u_size, xc.shape[3])
    w1_t = tap_matrix(alpha, u_size, out_w, transposed=True).to(compute_dtype)
    with span("warp.shift"):
        tmp = fused_shift_lerp_matmul(xc, k1, f1, w1_t,
                                      out_dtype=compute_dtype)
    k2, f2 = shifts(cols_off, v_size, tmp.shape[3])
    w2_t = tap_matrix(D, v_size, out_h, transposed=True).to(compute_dtype)
    with span("warp.shift"):
        # (C, B, out_h, out_w)
        out = fused_shift_lerp_matmul(tmp, k2, f2, w2_t,
                                      out_dtype=torch.float32)
    return out.permute(1, 2, 3, 0)


def _warp_nhwc(x, rows_off, cols_off, w1, w2, u_size, v_size, compute_dtype):
    """Both passes through the flat (NHWC) shift kernel, each followed by a
    per-image tap einsum."""
    with span("warp.shift"):
        shifted = shift_lerp.shift_rows(x, rows_off, u_size,
                                        compute_dtype)  # (B, H, U, C)
    tmp = torch.einsum("bhuc,bui->bhic", shifted, w1)  # compute_dtype
    tmp_t = tmp.transpose(1, 2)  # (B, out_w, H, C)
    with span("warp.shift"):
        shifted_v = shift_lerp.shift_rows(tmp_t, cols_off, v_size,
                                          compute_dtype)  # (B, out_w, V, C)
    # f32 products and sums of the compute-dtype operands
    return torch.einsum("bivc,bvj->bjic", shifted_v.to(torch.float32),
                        w2.to(torch.float32))  # (B, out_h, out_w, C)


def _warp_grouped(x, rows_off, cols_off, w1, w2, u_size, v_size,
                  compute_dtype, lerp_in_kernel):
    """Both passes through the grouped shift kernel on channel-leading
    planes, each followed by a torch.matmul with the tap matrix."""
    xc = x.permute(3, 0, 1, 2).contiguous()  # (C, B, H, W)
    shifted = _shift_pass_cfirst(xc, rows_off, u_size, compute_dtype,
                                 lerp_in_kernel)  # (C, B, H, U)
    tmp = torch.matmul(shifted, w1)  # (C, B, H, out_w), compute_dtype
    tmp_t = tmp.transpose(2, 3).contiguous()  # (C, B, out_w, H)
    shifted_v = _shift_pass_cfirst(tmp_t, cols_off, v_size, compute_dtype,
                                   lerp_in_kernel)  # (C, B, out_w, V)
    # f32 products and sums of the compute-dtype operands
    out = torch.matmul(shifted_v.to(torch.float32), w2.to(torch.float32))
    return out.permute(1, 3, 2, 0)  # (B, out_h, out_w, C)


def affine_warp_mxu(
    images: torch.Tensor, matrices: torch.Tensor, out_hw, fill_value=0.0,
    max_scale: float = 1.96, compute_dtype=None, interp: str = "linear",
    max_scale_x=None, max_scale_y=None, lerp_in_kernel: bool = True,
    route: str = "grouped",
) -> torch.Tensor:
    """images (B, H, W, C) uint8 or float, matrices (B, 3, 3) source -> out
    -> (B, out_h, out_w, C) float32.

    Rotations must stay within ±90°, and the horizontal slope |det/D| and
    the vertical slope |D| within max_scale_x / max_scale_y (in units of
    out-size): positions beyond the static windows contribute zero.
    `route` is one of ROUTES (module docstring); `lerp_in_kernel=False`
    (the grouped kernel's raw mode) applies to the grouped route only."""
    if route not in ROUTES:
        raise ValueError(f"route={route!r}, want one of {ROUTES}")
    if not lerp_in_kernel and route != "grouped":
        raise ValueError("lerp_in_kernel=False is a mode of the grouped route")
    device = images.device
    if compute_dtype is None:
        compute_dtype = _default_compute_dtype(device)
    max_scale_x = max_scale if max_scale_x is None else max_scale_x
    max_scale_y = max_scale if max_scale_y is None else max_scale_y
    bsz, src_h, src_w, c = images.shape
    out_h, out_w = out_hw
    # uint8 sources stay uint8 into the pass-1 kernel (a quarter of the bytes)
    x = images if images.dtype == torch.uint8 else images.to(compute_dtype)
    inv = _inv3_affine(matrices.to(device=device, dtype=torch.float32))
    A, B, TX = inv[:, 0, 0], inv[:, 0, 1], inv[:, 0, 2]
    C, D, TY = inv[:, 1, 0], inv[:, 1, 1], inv[:, 1, 2]
    D_safe = torch.where(D.abs() < 1e-6, torch.full_like(D, 1e-6), D)

    alpha = A - B * C / D_safe
    beta = B / D_safe
    gamma = TX - B * TY / D_safe

    u_size, v_size = pallas_window_sizes(out_hw, max_scale_x, max_scale_y,
                                         xla_lerp=not lerp_in_kernel)
    ar_h = torch.arange(src_h, dtype=torch.float32, device=device)
    ar_w = torch.arange(out_w, dtype=torch.float32, device=device)
    rows_off = beta[:, None] * ar_h[None, :] + gamma[:, None]
    cols_off = C[:, None] * ar_w[None, :] + TY[:, None]
    tap_matrix = _area_matrix if interp == "area" else _tent_matrix
    if route == "matmul":
        out = _warp_matmul(x, rows_off, cols_off, alpha, D, u_size, v_size,
                           out_hw, tap_matrix, compute_dtype)
    else:
        w1 = tap_matrix(alpha, u_size, out_w).to(compute_dtype)
        w2 = tap_matrix(D, v_size, out_h).to(compute_dtype)
        if route == "nhwc":
            out = _warp_nhwc(x, rows_off, cols_off, w1, w2, u_size, v_size,
                             compute_dtype)
        else:
            out = _warp_grouped(x, rows_off, cols_off, w1, w2, u_size,
                                v_size, compute_dtype, lerp_in_kernel)

    # exact border mask from the direct inverse map
    ys = torch.arange(out_h, dtype=torch.float32, device=device)
    gy, gx = torch.meshgrid(ys, ar_w, indexing="ij")
    sx = A[:, None, None] * gx + B[:, None, None] * gy + TX[:, None, None]
    sy = C[:, None, None] * gx + D[:, None, None] * gy + TY[:, None, None]
    valid = (sx > -1.0) & (sx < src_w) & (sy > -1.0) & (sy < src_h)
    return torch.where(valid[..., None], out, fill_value)
