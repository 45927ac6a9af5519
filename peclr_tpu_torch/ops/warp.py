"""The gather warp (port of peclr_tpu/ops/warp.py): each output pixel maps
back through the inverse of its sample's affine and samples the source
bilinearly from four gathered neighbours, with a fill value outside.

It is the reference's `WARP_BACKEND = "gather"`, the `"gather"` route of
ops/augment.py.  Plain PyTorch in f32; no kernel of its own.  It is
bilinear, while the two-pass warp (ops/warp_mxu.py) is a lerp of lerps, so
the two agree only within interpolation tolerance.
"""

from __future__ import annotations

import torch


def affine_warp(images: torch.Tensor, matrices: torch.Tensor, out_hw,
                fill_value: float = 0.0) -> torch.Tensor:
    """images (B, H, W, C) float or uint8; matrices (B, 3, 3) map SOURCE
    pixel coords to DEST (x right, y down) -> (B, out_h, out_w, C) float32,
    bilinear, `fill_value` outside the source."""
    b, src_h, src_w, c = images.shape
    out_h, out_w = out_hw
    device = images.device
    flat = images.to(torch.float32).reshape(b, src_h * src_w, c)
    # inv_ex: no error check on the host, which would wait for the card
    inv = torch.linalg.inv_ex(
        matrices.to(device=device, dtype=torch.float32)).inverse

    ys = torch.arange(out_h, dtype=torch.float32, device=device)
    xs = torch.arange(out_w, dtype=torch.float32, device=device)
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")

    def coeff(i, j):
        return inv[:, i, j, None, None]

    src_x = coeff(0, 0) * grid_x + coeff(0, 1) * grid_y + coeff(0, 2)
    src_y = coeff(1, 0) * grid_x + coeff(1, 1) * grid_y + coeff(1, 2)
    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    wx = (src_x - x0)[..., None]
    wy = (src_y - y0)[..., None]

    def gather(yi, xi):
        """The source at integer coords, fill_value outside."""
        valid = (xi >= 0) & (xi < src_w) & (yi >= 0) & (yi < src_h)
        xi_c = xi.clamp(0, src_w - 1).to(torch.int64)
        yi_c = yi.clamp(0, src_h - 1).to(torch.int64)
        idx = (yi_c * src_w + xi_c).reshape(b, -1, 1).expand(-1, -1, c)
        vals = torch.gather(flat, 1, idx).reshape(b, out_h, out_w, c)
        return torch.where(valid[..., None], vals, fill_value)

    top = gather(y0, x0) * (1.0 - wx) + gather(y0, x0 + 1) * wx
    bot = gather(y0 + 1, x0) * (1.0 - wx) + gather(y0 + 1, x0 + 1) * wx
    return top * (1.0 - wy) + bot * wy
