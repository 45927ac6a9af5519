"""Operations and bytes from shapes, by operation, whatever kernel
implements it.

FLOPs count the model's convolutions and dense layers, a multiply-add as
2; BatchNorm, activations and the loss are not counted (the usual model
FLOPs).  A training step counts its forward and twice the forward for its
backward.  The warp's bytes count each shift pass's input read once, its
per-row shifts and fractions read once and its output written once: the
least traffic of the pass (see ops/warp_mxu.py for the passes).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

#: blocks per stage and block kind of the ResNets (He et al. 2016, table 1)
RESNET_STAGES = {"18": ("basic", (2, 2, 2, 2)), "34": ("basic", (3, 4, 6, 3)),
                 "50": ("bottleneck", (3, 4, 6, 3)),
                 "101": ("bottleneck", (3, 4, 23, 3)),
                 "152": ("bottleneck", (3, 8, 36, 3))}

#: published peaks of one H100 SXM (dense): bf16 and f32 without tensor
#: cores, FLOP/s, and HBM bytes/s
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_HBM = 3.35e12


def conv_out(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


def conv_flops(h: int, w: int, cin: int, cout: int, kernel: int,
               stride: int) -> Tuple[int, int, int]:
    """(FLOPs, out h, out w) of one image through a kernel x kernel conv
    with padding kernel // 2."""
    pad = kernel // 2
    ho, wo = conv_out(h, kernel, stride, pad), conv_out(w, kernel, stride, pad)
    return 2 * ho * wo * cout * cin * kernel * kernel, ho, wo


def resnet_trunk_flops(size: str, h: int, w: int) -> Tuple[int, int]:
    """(FLOPs of one h x w image through the stem and the four stages,
    width of the pooled embedding)."""
    kind, stages = RESNET_STAGES[size]
    total, h, w = conv_flops(h, w, 3, 64, 7, 2)
    h, w = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1)  # the stem's max-pool
    cin = 64
    expansion = 4 if kind == "bottleneck" else 1
    for stage, blocks in enumerate(stages):
        features = 64 * 2 ** stage
        for block in range(blocks):
            stride = 2 if stage > 0 and block == 0 else 1
            cout = features * expansion
            if block == 0 and (stride != 1 or cin != cout):
                f, _, _ = conv_flops(h, w, cin, cout, 1, stride)
                total += f
            if kind == "bottleneck":
                f1, _, _ = conv_flops(h, w, cin, features, 1, 1)
                f2, h2, w2 = conv_flops(h, w, features, features, 3, stride)
                f3, _, _ = conv_flops(h2, w2, features, cout, 1, 1)
                total += f1 + f2 + f3
            else:
                f1, h2, w2 = conv_flops(h, w, cin, features, 3, stride)
                f2, _, _ = conv_flops(h2, w2, features, features, 3, 1)
                total += f1 + f2
            h, w, cin = h2, w2, cout
    return total, cin


def dense_flops(layers: Iterable[Tuple[int, int]]) -> int:
    return sum(2 * i * o for i, o in layers)


def peclr_forward_flops(size: str, view: int, hidden: int = 512,
                        out: int = 128) -> int:
    """One view through the PeCLR encoder and projection head."""
    trunk, embed = resnet_trunk_flops(size, view, view)
    return trunk + dense_flops([(embed, hidden), (hidden, out)])


def rn25d_forward_flops(size: str, crop: int) -> int:
    """One crop through RN_25D_wMLPref: trunk, fc to 21 x 3 + 1, and the
    z-root MLP (64 -> 128 -> 128 -> 1)."""
    trunk, embed = resnet_trunk_flops(size, crop, crop)
    return trunk + dense_flops([(embed, 64), (64, 128), (128, 128), (128, 1)])


def train_flops(forward: int) -> int:
    """Forward plus a backward of twice the forward."""
    return 3 * forward


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def warp_windows(src_hw, out_hw, max_scale_x: float,
                 max_scale_y: float) -> Tuple[int, int]:
    """(U, V): the taps a row holds after each shift pass, as the two-pass
    warp sizes them (rounded up to 128)."""
    out_h, out_w = out_hw
    return (round_up(int(max_scale_x * out_w) + 2, 128),
            round_up(int(max_scale_y * out_h) + 2, 128))


def recipe_window_bounds(src: int, out: int, max_angle: float
                         ) -> Tuple[float, float]:
    """The slope bounds of the augmentation's warp (ops/augment.py
    :_warp_window_bounds) for a square source and view."""
    down = max(src / out, 1.0)
    cos = math.cos(math.radians(max_angle)) if max_angle else 1.0
    return down / cos + 0.05, down + 0.05


def warp_pass_bytes(images: int, src_hw, out_hw, channels: int,
                    src_bytes: int, mid_bytes: int, max_scale_x: float,
                    max_scale_y: float) -> Dict[str, int]:
    """Least bytes of the two shift passes of one warp of `images` images:
    pass 1 reads the sources (src_bytes an element) and writes (C, N, H, U)
    in mid_bytes; pass 2 reads the (C, N, out_w, H) product in mid_bytes and
    writes (C, N, out_w, V) in mid_bytes.  Each row's shift (int32) and
    fraction (f32) are read once."""
    src_h, src_w = src_hw
    out_h, out_w = out_hw
    u, v = warp_windows(src_hw, out_hw, max_scale_x, max_scale_y)
    rows1 = images * src_h
    rows2 = images * out_w
    pass1 = (channels * rows1 * src_w * src_bytes + rows1 * 8
             + channels * rows1 * u * mid_bytes)
    pass2 = (channels * rows2 * src_h * mid_bytes + rows2 * 8
             + channels * rows2 * v * mid_bytes)
    return {"pass1": pass1, "pass2": pass2}
