"""The two models in plain PyTorch, as functions of a dict of tensors.

* The PeCLR encoder (Spurr et al., ICCV 2021): a torchvision ResNet trunk
  (He et al. 2016: 7x7/2 stem, 3x3/2 max-pool, bottleneck stages with the
  stride on the 3x3 convolution, global mean pool), then the SimCLR
  projection head Linear(E, 512) -> BatchNorm1d -> ReLU -> Linear(512, 128,
  no bias).
* RN_25D_wMLPref (the PeCLR repository's src/models/rn_25D_wMLPref.py):
  the trunk and fc to 21 x 3 + 1 outputs read as 2.5D keypoints (the
  wrist's relative depth set to 0), back-projected through K^-1, and the
  closed-form z-root (Iqbal et al. 2018, eqs. 6-7) refined by an MLP
  (64 -> 128 -> 128 -> 1 with BatchNorm1d and LeakyReLU 0.01).

BatchNorm normalises with the batch's statistics in train mode (eps 1e-5)
and with the running ones in eval mode; a train-mode forward given a
`stats` dict records each BatchNorm's batch mean and biased variance
there, for the caller to fold into the running statistics.  Parameter
names are the state-dict keys the program loads, so one dict of seeded
tensors serves both sides.

`Precision` rounds the operands of every convolution and dense layer:
"f32" leaves them as they are; "tf32" rounds them to TF32's 10-bit
mantissa (what TF32 tensor cores read); "fp8" scales each tensor to
float8 e4m3's range and rounds it there.  The rounding is applied in the
forward pass and passed straight through in the backward, which then runs
on the rounded operands, as a training step in that precision would.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

STAGES = {"18": ("basic", (2, 2, 2, 2)), "34": ("basic", (3, 4, 6, 3)),
          "50": ("bottleneck", (3, 4, 6, 3)),
          "101": ("bottleneck", (3, 4, 23, 3)),
          "152": ("bottleneck", (3, 8, 36, 3))}
EPS = 1e-5
_FP8_MAX = 448.0

Leaf = Tuple[str, Tuple[int, ...], str]


class Precision:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "tf32", "fp8"):
            raise ValueError(f"precision {name!r}")
        self.name = name

    def _round(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            bits = x.contiguous().view(torch.int32)
            bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
            return bits.view(torch.float32)
        amax = x.abs().amax().clamp_min(1e-30)
        scale = _FP8_MAX / amax
        return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return x
        return x + (self._round(x.detach()) - x).detach()


# --------------------------------------------------------------------------
# layouts: (state-dict name, shape, kind) in a fixed order


def _bn_leaves(name: str, c: int) -> List[Leaf]:
    return [(f"{name}.weight", (c,), "bn_weight"),
            (f"{name}.bias", (c,), "bn_bias"),
            (f"{name}.running_mean", (c,), "bn_mean"),
            (f"{name}.running_var", (c,), "bn_var"),
            (f"{name}.num_batches_tracked", (), "count")]


def trunk_blocks(size: str):
    """[(stage, block, cin, features, cout, stride, downsample)]."""
    kind, stages = STAGES[size]
    expansion = 4 if kind == "bottleneck" else 1
    out, cin = [], 64
    for s, blocks in enumerate(stages):
        features = 64 * 2 ** s
        for b in range(blocks):
            stride = 2 if s > 0 and b == 0 else 1
            cout = features * expansion
            down = b == 0 and (stride != 1 or cin != cout)
            out.append((s, b, cin, features, cout, stride, down))
            cin = cout
    return out


def trunk_names(size: str, prefix: str, style: str):
    """(stem conv, stem bn, [block prefix per block]) under `prefix`:
    style "encoder" is the PeCLR checkpoint's Sequential (features.0/1,
    stages at features.4-7), "torchvision" is conv1/bn1/layer1-4."""
    if style == "encoder":
        stem = (f"{prefix}features.0", f"{prefix}features.1")
        blocks = [f"{prefix}features.{4 + s}.{b}"
                  for s, b, *_ in trunk_blocks(size)]
    else:
        stem = (f"{prefix}conv1", f"{prefix}bn1")
        blocks = [f"{prefix}layer{s + 1}.{b}" for s, b, *_ in trunk_blocks(size)]
    return stem, blocks


def trunk_layout(size: str, prefix: str, style: str) -> List[Leaf]:
    kind = STAGES[size][0]
    (stem_conv, stem_bn), names = trunk_names(size, prefix, style)
    leaves = [(f"{stem_conv}.weight", (64, 3, 7, 7), "conv_stem")]
    leaves += _bn_leaves(stem_bn, 64)
    for name, (s, b, cin, f, cout, stride, down) in zip(names,
                                                       trunk_blocks(size)):
        if kind == "bottleneck":
            convs = [("conv1", f, cin, 1), ("conv2", f, f, 3),
                     ("conv3", cout, f, 1)]
        else:
            convs = [("conv1", f, cin, 3), ("conv2", cout, f, 3)]
        last = convs[-1][0].replace("conv", "bn")
        for conv, co, ci, k in convs:
            bn = conv.replace("conv", "bn")
            leaves.append((f"{name}.{conv}.weight", (co, ci, k, k), "conv"))
            leaves += [(n, sh, "bn_weight_damped" if bn == last and
                        kd == "bn_weight" else kd)
                       for n, sh, kd in _bn_leaves(f"{name}.{bn}", co)]
        if down:
            leaves.append((f"{name}.downsample.0.weight", (cout, cin, 1, 1),
                           "conv"))
            leaves += [(n, sh, "bn_weight_damped" if kd == "bn_weight" else kd)
                       for n, sh, kd in _bn_leaves(f"{name}.downsample.1",
                                                   cout)]
    return leaves


def embed_dim(size: str) -> int:
    return trunk_blocks(size)[-1][4]


def peclr_layout(size: str, hidden: int = 512, out: int = 128) -> List[Leaf]:
    e = embed_dim(size)
    return (trunk_layout(size, "encoder.", "encoder")
            + [("projection_head.0.weight", (hidden, e), "dense"),
               ("projection_head.0.bias", (hidden,), "dense_bias")]
            + _bn_leaves("projection_head.1", hidden)
            + [("projection_head.3.weight", (out, hidden), "dense")])


def rn25d_layout(size: str) -> List[Leaf]:
    e = embed_dim(size)
    mlp = "zroot_ref.zroot_ref"
    return (trunk_layout(size, "backend_model.", "torchvision")
            + [("backend_model.fc.weight", (64, e), "fc_weight"),
               ("backend_model.fc.bias", (64,), "fc_bias"),
               (f"{mlp}.0.weight", (128, 64), "dense"),
               (f"{mlp}.0.bias", (128,), "dense_bias")]
            + _bn_leaves(f"{mlp}.1", 128)
            + [(f"{mlp}.3.weight", (128, 128), "dense"),
               (f"{mlp}.3.bias", (128,), "dense_bias")]
            + _bn_leaves(f"{mlp}.4", 128)
            + [(f"{mlp}.6.weight", (1, 128), "dense"),
               (f"{mlp}.6.bias", (1,), "dense_bias")])


# --------------------------------------------------------------------------
# forward passes


def _bn(x, p, name, train, stats=None):
    if train:
        if stats is not None:
            with torch.no_grad():
                dims = [0] + list(range(2, x.dim()))
                stats[name] = (x.mean(dims), x.var(dims, unbiased=False))
        return F.batch_norm(x, None, None, p[f"{name}.weight"],
                            p[f"{name}.bias"], True, 0.0, EPS)
    return F.batch_norm(x, p[f"{name}.running_mean"], p[f"{name}.running_var"],
                        p[f"{name}.weight"], p[f"{name}.bias"], False, 0.0,
                        EPS)


def _conv(x, w, stride, q):
    return F.conv2d(q(x), q(w), stride=stride, padding=w.shape[-1] // 2)


def _linear(x, p, name, q, bias=True):
    return F.linear(q(x), q(p[f"{name}.weight"]),
                    p[f"{name}.bias"] if bias else None)


def trunk(x, p, size, prefix, style, train, q, stats=None):
    """NCHW images -> the pooled (B, E) embedding."""
    kind = STAGES[size][0]
    (stem_conv, stem_bn), names = trunk_names(size, prefix, style)
    x = torch.relu(_bn(_conv(x, p[f"{stem_conv}.weight"], 2, q), p, stem_bn,
                       train, stats))
    x = F.max_pool2d(x, 3, 2, 1)
    for name, (s, b, cin, f, cout, stride, down) in zip(names,
                                                       trunk_blocks(size)):
        identity = x
        if down:
            identity = _bn(_conv(x, p[f"{name}.downsample.0.weight"], stride,
                                 q), p, f"{name}.downsample.1", train, stats)
        if kind == "bottleneck":
            y = torch.relu(_bn(_conv(x, p[f"{name}.conv1.weight"], 1, q), p,
                               f"{name}.bn1", train, stats))
            y = torch.relu(_bn(_conv(y, p[f"{name}.conv2.weight"], stride, q),
                               p, f"{name}.bn2", train, stats))
            y = _bn(_conv(y, p[f"{name}.conv3.weight"], 1, q), p,
                    f"{name}.bn3", train, stats)
        else:
            y = torch.relu(_bn(_conv(x, p[f"{name}.conv1.weight"], stride, q),
                               p, f"{name}.bn1", train, stats))
            y = _bn(_conv(y, p[f"{name}.conv2.weight"], 1, q), p,
                    f"{name}.bn2", train, stats)
        x = torch.relu(y + identity)
    return x.mean(dim=(2, 3))


def peclr_forward(images, p, size, q, train=True, stats=None):
    """(B, H, W, 3) normalised views -> (B, 128) projections."""
    e = trunk(images.permute(0, 3, 1, 2), p, size, "encoder.", "encoder",
              train, q, stats)
    h = torch.relu(_bn(_linear(e, p, "projection_head.0", q), p,
                       "projection_head.1", train, stats))
    return _linear(h, p, "projection_head.3", q, bias=False)


def zroot_refine(kp3d_unnorm, zrel, p, train, q, bone=(3, 8), eps=1e-8,
                 stats=None):
    """The closed-form scale-normalised root depth, clamped to [4, 50] and
    detached, plus the MLP's correction."""
    m, n = bone
    X_m, Y_m = kp3d_unnorm[:, m, 0], kp3d_unnorm[:, m, 1]
    X_n, Y_n = kp3d_unnorm[:, n, 0], kp3d_unnorm[:, n, 1]
    z_m, z_n = zrel[:, m, 0], zrel[:, n, 0]
    a = (X_n - X_m) ** 2 + (Y_n - Y_m) ** 2
    b = 2.0 * (z_n * (X_n ** 2 + Y_n ** 2 - X_n * X_m - Y_n * Y_m)
               + z_m * (X_m ** 2 + Y_m ** 2 - X_n * X_m - Y_n * Y_m))
    c = ((X_n * z_n - X_m * z_m) ** 2 + (Y_n * z_n - Y_m * z_m) ** 2
         + (z_n - z_m) ** 2 - 1.0)
    a = torch.clamp_min(a, eps)
    d = torch.clamp_min(b * b - 4.0 * a * c, eps)
    zroot = torch.clamp(((-b + torch.sqrt(d)) / (2.0 * a)).detach(), 4.0, 50.0)
    mlp = "zroot_ref.zroot_ref"
    h = torch.cat([zrel.reshape(-1, 21), kp3d_unnorm[..., :2].reshape(-1, 42),
                   zroot.reshape(-1, 1)], dim=1)
    h = F.leaky_relu(_bn(_linear(h, p, f"{mlp}.0", q), p, f"{mlp}.1", train,
                         stats), 0.01)
    h = F.leaky_relu(_bn(_linear(h, p, f"{mlp}.3", q), p, f"{mlp}.4", train,
                         stats), 0.01)
    return zroot + _linear(h, p, f"{mlp}.6", q)[:, 0]


def rn25d_forward(images, K, p, size, q, train, stats=None
                  ) -> Dict[str, torch.Tensor]:
    """(B, H, W, 3) normalised crops and (B, 3, 3) K -> kp25d (B, 21, 3) and
    kp3d (B, 21, 3)."""
    b = images.shape[0]
    e = trunk(images.permute(0, 3, 1, 2), p, size, "backend_model.",
              "torchvision", train, q, stats)
    out = _linear(e, p, "backend_model.fc", q)
    kp25d = out[:, :-1].reshape(b, 21, 3)
    wrist_z = torch.zeros(21, 3, dtype=torch.bool, device=images.device)
    wrist_z[0, 2] = True
    kp25d = torch.where(wrist_z, 0.0, kp25d)
    zrel = kp25d[..., 2:3]
    kp2d_h = torch.cat([kp25d[..., :2], torch.ones_like(zrel)], dim=2)
    K_inv = torch.linalg.inv(K)
    kp3d_unnorm = torch.einsum("bnj,bij->bni", kp2d_h, K_inv)
    zroot = zroot_refine(kp3d_unnorm, zrel, p, train, q, stats=stats)
    return {"kp25d": kp25d, "kp3d": kp3d_unnorm * (zrel + zroot[:, None, None])}
