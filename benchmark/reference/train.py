"""The training steps in plain PyTorch: the PeCLR pretrain step (two views
per image, encoder and projection head, the inverse transforms in
projection space, NT-Xent, gradient accumulation, LARS over Adam) and the
RN25D fine-tune step (one cropped view, the separated 2D and z L1 losses,
Adam).

The optimizer follows the PeCLR recipe as the reference repository's
optax chain writes it: lr = base_lr sqrt(batch * accum); LARS's schedule
is a linear warm-up from 0 then a cosine, Adam's a cosine from the peak;
per tensor, LARS's trust ratio eta ||p|| / (||g|| + wd ||p|| + eps),
clipped against the current lr (1 where a norm is 0), scales g + wd p
before Adam (b1 0.9, b2 0.999, eps 1e-8, bias correction in float32); no
decay on biases and BatchNorm parameters.

BatchNorm's running statistics follow flax: after each train-mode
forward, running = 0.9 running + 0.1 batch (mean, biased variance).

Each function returns what the comparison reads: each step's loss, the
first gradient as the optimizer gets it (g + wd p), the parameters after
the last step and the BatchNorm running statistics after it; of the first
step, the model's input of its first microbatch (the augmented views) and,
in pretraining, each microbatch's projections and view parameters.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np
import torch

from benchmark.reference import augment, models


def warmup_cosine(peak, warmup, total, end=0.0):
    warmup = max(warmup, 1)
    total = max(total, warmup + 1)
    alpha = 0.0 if peak == 0.0 else end / peak

    def lr(count):
        if count < warmup:
            return peak - peak * (1.0 - min(max(count, 0), warmup) / warmup)
        t = min(count - warmup, total - warmup)
        cos = 0.5 * (1.0 + math.cos(math.pi * t / (total - warmup)))
        return peak * ((1.0 - alpha) * cos + alpha)

    return lr


def cosine(peak, total):
    total = max(total, 1)
    return lambda count: peak * 0.5 * (1.0 + math.cos(
        math.pi * min(count, total) / total))


def schedule(opt: dict, batch: int, accum: int) -> Callable[[int], float]:
    peak = opt["base_lr"] * math.sqrt(batch * accum)
    total = opt["epochs"] * opt["steps_per_epoch"] // max(accum, 1)
    if opt["name"] == "LARS":
        return warmup_cosine(peak, opt["warmup_epochs"] * opt["steps_per_epoch"]
                             // max(accum, 1), total)
    return cosine(peak, total)


def decayed(name: str) -> bool:
    """Weights of convolutions and dense layers decay; biases and
    BatchNorm parameters do not."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf != "weight":
        return False
    return not is_bn_weight(name)


def is_bn_weight(name: str) -> bool:
    owner = name.rsplit(".", 1)[0]
    last = owner.rsplit(".", 1)[-1]
    return (last.startswith("bn") or owner.endswith("downsample.1")
            or owner in ("encoder.features.1", "projection_head.1",
                         "zroot_ref.zroot_ref.1", "zroot_ref.zroot_ref.4"))


class Optimizer:
    """[LARS ->] Adam -> -lr(count), on a dict of leaf tensors."""

    def __init__(self, params: Dict[str, torch.Tensor], opt: dict, lr,
                 wd: float):
        self.params, self.lr, self.lars = params, lr, opt["name"] == "LARS"
        self.wd = {n: (wd if decayed(n) else 0.0) for n in params}
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """One update; returns each leaf's g + wd p as the optimizer got
        it."""
        lr = self.lr(self.count)
        t = np.int32(self.count + 1)
        bc1 = float(np.float32(1.0) - np.float32(0.9) ** t)
        bc2 = float(np.float32(1.0) - np.float32(0.999) ** t)
        got = {}
        for n, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            upd = g + self.wd[n] * p
            got[n] = upd.clone()
            if self.lars:
                pn, gn = torch.linalg.vector_norm(p), torch.linalg.vector_norm(g)
                lamb = 0.001 * pn / (gn + self.wd[n] * pn + 1e-8)
                lamb = torch.clamp_max(lamb / max(lr, 1e-12), 1.0)
                lamb = torch.where((pn > 0) & (gn > 0), lamb, 1.0)
                upd = upd * lamb
            self.mu[n].mul_(0.9).add_(upd, alpha=0.1)
            self.nu[n].mul_(0.999).addcmul_(upd, upd, value=0.001)
            p.add_((self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + 1e-8),
                   alpha=-lr)
            p.grad = None
        self.count += 1
        return got


def l2_normalize(x, eps=1e-12):
    return x / torch.sqrt(torch.clamp_min((x * x).sum(dim=-1, keepdim=True),
                                          eps))


def equivariant(proj, view, image_size, augmentations):
    """L2-normalise, read as 64 points, undo the crop's translation (scaled
    by the detached extent; x by the height, y by the width, as the
    reference) and the rotation (about the detached centroid), flatten,
    renormalise."""
    b, d = proj.shape
    h, w = image_size
    pts = l2_normalize(proj).reshape(b, d // 2, 2)
    if "crop" in augmentations:
        ext = (pts.amax(dim=1) - pts.amin(dim=1)).detach()
        off = torch.stack([-view["jitter_x"] / float(h) * ext[:, 0],
                           -view["jitter_y"] / float(w) * ext[:, 1]], dim=-1)
        pts = pts + off[:, None, :]
    if "rotate" in augmentations:
        c = pts.mean(dim=1).detach()
        rot = augment.rotation_about_center(-view["angle"], c[:, 0], c[:, 1])
        hom = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
        pts = torch.einsum("bij,bnj->bni", rot, hom)[..., :2]
    return l2_normalize(pts.reshape(b, d))


def ntxent(z1, z2, temperature):
    z = torch.cat([z1, z2], dim=0).float()
    sim = torch.exp(z @ z.T / temperature)
    neg = sim.sum(dim=-1) - torch.diagonal(sim)
    pos = torch.exp((z1 * z2).sum(dim=-1) / temperature)
    return -torch.mean(torch.log(torch.cat([pos, pos]) / neg))


def _leaves(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The trainable leaves (BatchNorm running statistics and counts are
    buffers), as fresh f32 tensors that require gradients."""
    return {n: w.detach().clone().float().requires_grad_(True)
            for n, w in weights.items()
            if not n.endswith(("running_mean", "running_var",
                               "num_batches_tracked"))}


def _params_for_forward(leaves, weights):
    p = dict(weights)
    p.update(leaves)
    return p


def _running(weights):
    return {n: w.detach().clone().float() for n, w in weights.items()
            if n.endswith(("running_mean", "running_var"))}


@torch.no_grad()
def _fold(running, stats, momentum=0.1):
    for name, (mean, var) in stats.items():
        running[f"{name}.running_mean"].lerp_(mean.float(), momentum)
        running[f"{name}.running_var"].lerp_(var.float(), momentum)


def pretrain_steps(weights, batches: List[dict], generator, cfg: dict,
                   traffic: dict, precision: str, warp_dtype) -> dict:
    """len(batches) PeCLR steps from `weights`; each batch holds 'image'
    (accum B, H, W, 3) uint8 and 'joints25d'.  Draws come from `generator`
    in the program's order (one draw of 2B a microbatch)."""
    q = models.Precision(precision)
    leaves = _leaves(weights)
    accum, mb = traffic["accum"], traffic["microbatch"]
    opt = Optimizer(leaves, cfg["optimizer"], schedule(cfg["optimizer"], mb,
                                                       accum),
                    cfg["optimizer"]["weight_decay"])
    flags, params = cfg["augmentation"]["flags"], cfg["augmentation"]["params"]
    image_size = tuple(params["resize_shape"])
    augs = [k for k, v in flags.items() if v]
    losses, first = [], None
    running = _running(weights)
    views, projs, view_params = None, [], []
    for batch in batches:
        total = 0.0
        for i in range(accum):
            sl = slice(i * mb, (i + 1) * mb)
            img, jts = batch["image"][sl], batch["joints25d"][sl]
            d = augment.draw(generator, 2 * mb, flags, params)
            with torch.no_grad():
                both = augment.apply(torch.cat([img, img]),
                                     torch.cat([jts, jts]), d, flags, params,
                                     zero_jitter=not flags.get("crop"),
                                     warp_dtype=warp_dtype)
            p = _params_for_forward(leaves, weights)
            stats = {}
            proj = models.peclr_forward(both["images"], p, cfg["resnet"], q,
                                        stats=stats)
            _fold(running, stats)
            v1 = {k: both[k][:mb] for k in ("jitter_x", "jitter_y", "angle")}
            v2 = {k: both[k][mb:] for k in ("jitter_x", "jitter_y", "angle")}
            if first is None:
                views = both["images"] if views is None else views
                projs.append(proj.detach())
                view_params.append((v1, v2))
            z1 = equivariant(proj[:mb], v1, image_size, augs)
            z2 = equivariant(proj[mb:], v2, image_size, augs)
            loss = ntxent(z1, z2, cfg["temperature"])
            (loss / accum).backward()
            total += loss.item()
        got = opt.step()
        if first is None:
            first = got
        losses.append(total / accum)
    return {"losses": losses, "first_grad": first,
            "params": {n: t.detach() for n, t in leaves.items()},
            "running": running, "views": views, "projs": projs,
            "view_params": view_params}


@torch.no_grad()
def staged_loss(projs, view_params, cfg: dict) -> float:
    """The mean NT-Xent over microbatches of given projections (another
    side's), with the inverse transforms of the views' parameters."""
    flags, params = cfg["augmentation"]["flags"], cfg["augmentation"]["params"]
    image_size = tuple(params["resize_shape"])
    augs = [k for k, v in flags.items() if v]
    total = 0.0
    for proj, (v1, v2) in zip(projs, view_params):
        proj = proj.float()
        mb = proj.shape[0] // 2
        z1 = equivariant(proj[:mb], v1, image_size, augs)
        z2 = equivariant(proj[mb:], v2, image_size, augs)
        total += float(ntxent(z1, z2, cfg["temperature"]))
    return total / max(len(projs), 1)


def l1_loss_25d(pred, true, valid):
    weight = valid / valid.sum()
    err = (pred - true).abs()
    return (err[..., :2] * weight).sum() / 2.0, (err[..., 2:] * weight).sum()


def finetune_steps(weights, batches: List[dict], generator, cfg: dict,
                   traffic: dict, precision: str, warp_dtype) -> dict:
    """len(batches) RN25D fine-tune steps from `weights`: one view a row
    (draws of B a step), K' = T K, loss_2d + loss_z, one Adam update."""
    q = models.Precision(precision)
    leaves = _leaves(weights)
    b = traffic["batch"]
    opt = Optimizer(leaves, cfg["optimizer"], schedule(cfg["optimizer"], b, 1),
                    cfg["optimizer"]["weight_decay"])
    flags, params = cfg["augmentation"]["flags"], cfg["augmentation"]["params"]
    losses, first = [], None
    running = _running(weights)
    views = None
    for batch in batches:
        d = augment.draw(generator, b, flags, params)
        with torch.no_grad():
            out = augment.apply(batch["image"], batch["joints25d"], d, flags,
                                params, zero_jitter=False,
                                warp_dtype=warp_dtype)
            K = torch.einsum("bij,bjk->bik", out["matrix"], batch["K"].float())
        views = out["images"] if views is None else views
        p = _params_for_forward(leaves, weights)
        stats = {}
        pred = models.rn25d_forward(out["images"], K, p, cfg["resnet"], q,
                                    train=True, stats=stats)
        _fold(running, stats)
        l2d, lz = l1_loss_25d(pred["kp25d"], out["joints"],
                              batch["joints_valid"])
        loss = l2d + lz
        loss.backward()
        got = opt.step()
        if first is None:
            first = got
        losses.append(loss.item())
    return {"losses": losses, "first_grad": first,
            "params": {n: t.detach() for n, t in leaves.items()},
            "running": running, "views": views}
