"""The two-pass affine warp in plain PyTorch, written from its arithmetic
(the JAX package's warp_mxu, which the port follows).

The inverse map out -> src, x_s = A i + B j + TX, y_s = C i + D j + TY, is
split into a horizontal pass over each source row y (shift the row by
beta y + gamma: an integer part and a 2-tap lerp of the fraction, then
taps W1[u, i] = tap(alpha i - u), alpha = A - BC/D, beta = B/D, gamma = TX -
B TY / D) and a vertical pass over each output column i (shift by C i + TY,
then W2[v, j] = tap(D j - v)).  Taps are the box filter of cv2's INTER_AREA
on downscale (the tent where the slope is at most 1), or the tent
("linear").  Outside the source the image is zero; output pixels whose
direct inverse map falls outside (-1, W) x (-1, H) take the fill value.

`dtype` is the type the shifted rows and the first product are kept in:
the program's configuration states bf16 on the card (the lerp itself in
f32, rounded once), f32 elsewhere.  The shifts are gathers and the
products float32 matmuls.
"""

from __future__ import annotations

import torch


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _inverse(m):
    a, b, tx = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    c, d, ty = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    det = a * d - b * c
    return (d / det, -b / det, (b * ty - d * tx) / det,
            -c / det, a / det, (c * tx - a * ty) / det)


def taps(slopes, n_in, n_out, interp):
    """(B, n_in, n_out) tap matrix for output i at source slope * i."""
    i = torch.arange(n_out, dtype=torch.float32, device=slopes.device)
    u = torch.arange(n_in, dtype=torch.float32, device=slopes.device)
    i, u = i[None, None, :], u[None, :, None]
    s = slopes[:, None, None]
    tent = torch.clamp_min(1.0 - torch.abs(s * i - u), 0.0)
    if interp != "area":
        return tent
    overlap = torch.clamp(torch.minimum(s * (i + 1.0), u + 1.0)
                          - torch.maximum(s * i, u), 0.0, 1.0)
    return torch.where(s > 1.0, overlap / torch.clamp_min(s, 1e-6), tent)


def shift_rows(rows, offsets, window, dtype):
    """rows (C, N, W), offsets (N,) -> (C, N, window): out[u] = x[u + k] (1 -
    f) + x[u + k + 1] f with k = floor(offset) clamped to [-(window + 2), W],
    zero outside the row, computed in f32 and rounded to `dtype`."""
    c, n, w = rows.shape
    k_true = torch.floor(offsets)
    k = k_true.clamp(-(window + 2), w).long()
    f = (offsets - k_true).float()
    pad = window + 3
    padded = torch.zeros(c, n, w + 2 * pad, dtype=torch.float32,
                         device=rows.device)
    padded[:, :, pad:pad + w] = rows.float()
    idx = (pad + k)[:, None] + torch.arange(window, device=rows.device)[None]
    lo = padded.gather(2, idx.expand(c, n, window))
    hi = padded.gather(2, (idx + 1).expand(c, n, window))
    f = f[None, :, None]
    return (lo * (1.0 - f) + hi * f).to(dtype)


def two_pass_warp(images, matrices, out_hw, max_scale_x, max_scale_y,
                  interp="area", dtype=torch.float32, fill=0.0):
    """images (B, H, W, C) uint8 or float, matrices (B, 3, 3) source -> out
    -> (B, out_h, out_w, C) float32."""
    b, src_h, src_w, ch = images.shape
    out_h, out_w = out_hw
    dev = images.device
    A, B, TX, C, D, TY = _inverse(matrices.float())
    D_safe = torch.where(D.abs() < 1e-6, torch.full_like(D, 1e-6), D)
    alpha = A - B * C / D_safe
    beta = B / D_safe
    gamma = TX - B * TY / D_safe
    u_size = _round_up(int(max_scale_x * out_w) + 2, 128)
    v_size = _round_up(int(max_scale_y * out_h) + 2, 128)
    ar_h = torch.arange(src_h, dtype=torch.float32, device=dev)
    ar_w = torch.arange(out_w, dtype=torch.float32, device=dev)
    rows_off = beta[:, None] * ar_h[None, :] + gamma[:, None]  # (B, H)
    cols_off = C[:, None] * ar_w[None, :] + TY[:, None]  # (B, out_w)
    w1 = taps(alpha, u_size, out_w, interp).to(dtype).float()
    w2 = taps(D, v_size, out_h, interp).to(dtype).float()
    x = images if images.dtype == torch.uint8 else images.to(dtype)
    xc = x.permute(3, 0, 1, 2).reshape(ch, b * src_h, src_w)
    s1 = shift_rows(xc, rows_off.reshape(-1), u_size, dtype)
    s1 = s1.reshape(ch, b, src_h, u_size).float()
    tmp = torch.matmul(s1, w1).to(dtype)  # (C, B, H, out_w)
    tmp_t = tmp.transpose(2, 3).reshape(ch, b * out_w, src_h)
    s2 = shift_rows(tmp_t, cols_off.reshape(-1), v_size, dtype)
    s2 = s2.reshape(ch, b, out_w, v_size).float()
    out = torch.matmul(s2, w2).permute(1, 3, 2, 0)  # (B, out_h, out_w, C)
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, ar_w, indexing="ij")
    sx = A[:, None, None] * gx + B[:, None, None] * gy + TX[:, None, None]
    sy = C[:, None, None] * gx + D[:, None, None] * gy + TY[:, None, None]
    valid = (sx > -1.0) & (sx < src_w) & (sy > -1.0) & (sy < src_h)
    return torch.where(valid[..., None], out, fill)
