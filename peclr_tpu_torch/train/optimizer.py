"""Optimizers of the pretrain recipe (port of peclr_tpu/train/optimizer.py):
LARS-wrapped Adam (optimizer="LARS") or Adam with masked weight decay
(optimizer="adam"), sqrt-batch lr scaling, and a schedule counted in
optimizer steps.

The arithmetic is that of the reference's optax chains:
  * lr = base_lr * sqrt(batch_size * accum);
  * "LARS": optax.warmup_cosine_decay_schedule from 0: linear to the peak
    over the warmup steps, then cosine to end_lr, where decay_steps counts
    the warmup too; per parameter tensor, LARS: lamb = eta * ||p|| / (||g||
    + wd * ||p|| + eps), clipped against the schedule's current lr
    (min(lamb / lr, 1)), 1 where either norm is 0; the update (g + wd * p)
    * lamb goes on to Adam;
  * "adam": optax.cosine_decay_schedule from the peak to 0; the decayed
    weights are added under the no-decay mask (g + wd * p) before Adam;
  * Adam as optax.scale_by_adam: b1 0.9, b2 0.999, eps 1e-8, eps_root 0,
    bias correction by count + 1 (in float32, as optax); the step is
    -lr(count) times its output.
The no-decay mask is by module type, not by name: every BatchNorm
parameter and every bias is not decayed (the reference masks flax paths
containing "bn" or ending in "bias", which are the same parameters).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

Schedule = Callable[[int], float]


def no_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """{parameter name: True if it is decayed}: False for biases and for
    every BatchNorm parameter."""
    mask = {}
    for mod_name, module in model.named_modules():
        is_bn = isinstance(module, nn.modules.batchnorm._BatchNorm)
        for p_name, _ in module.named_parameters(recurse=False):
            full = f"{mod_name}.{p_name}" if mod_name else p_name
            mask[full] = not (is_bn or p_name == "bias")
    return mask


def scaled_lr(base_lr: float, batch_size: int, accum: int) -> float:
    return base_lr * math.sqrt(batch_size * accum)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  end_lr: float = 0.0) -> Schedule:
    """Linear 0 -> peak over warmup_steps, cosine peak -> end over the rest
    of total_steps (which includes the warmup)."""
    warmup_steps = max(warmup_steps, 1)
    total_steps = max(total_steps, warmup_steps + 1)
    alpha = 0.0 if peak_lr == 0.0 else end_lr / peak_lr
    decay_steps = total_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return -peak_lr * frac + peak_lr
        t = min(count - warmup_steps, decay_steps)
        cos = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return peak_lr * ((1.0 - alpha) * cos + alpha)

    return schedule


def cosine(peak_lr: float, total_steps: int) -> Schedule:
    """Cosine peak -> 0 over total_steps, then 0 (optax's
    cosine_decay_schedule)."""
    total_steps = max(total_steps, 1)

    def schedule(count: int) -> float:
        t = min(count, total_steps)
        return peak_lr * 0.5 * (1.0 + math.cos(math.pi * t / total_steps))

    return schedule


OPTIMIZERS = ("LARS", "adam")


class PretrainOptimizer(torch.optim.Optimizer):
    """[LARS ->] Adam -> -lr(count), one update per `step()`; `lars=False`
    leaves the decayed gradient g + wd * p to Adam as it is (the "adam"
    chain).

    Two parameter groups: the decayed parameters (weight_decay) and the
    rest (0).  A parameter that does not require a gradient is frozen: it
    is left out and never moves (the reference zeroes such a subtree's final
    updates).  Every other one is updated, with or without a gradient."""

    def __init__(self, model: nn.Module, schedule: Schedule,
                 weight_decay: float = 1e-6,
                 trust_coefficient: float = 0.001, lars_eps: float = 1e-8,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, lars: bool = True):
        mask = no_decay_mask(model)
        named = {n: p for n, p in model.named_parameters() if p.requires_grad}
        groups = [
            {"params": [p for n, p in named.items() if mask[n]],
             "weight_decay": weight_decay},
            {"params": [p for n, p in named.items() if not mask[n]],
             "weight_decay": 0.0},
        ]
        super().__init__([g for g in groups if g["params"]],
                         dict(weight_decay=0.0))
        self.schedule = schedule
        self.trust_coefficient = trust_coefficient
        self.lars_eps = lars_eps
        self.betas = betas
        self.eps = eps
        self.lars = lars
        self.count = 0  # updates made so far

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("the pretrain optimizer takes no closure")
        lr = self.schedule(self.count)
        b1, b2 = self.betas
        # in float32 as optax takes them: 1 - 0.999**t is 1e-5 off in f32
        t = np.int32(self.count + 1)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
        for group in self.param_groups:
            params = group["params"]
            # a parameter the loss does not reach has a zero gradient, as
            # in jax.grad: its decayed weight still goes through Adam
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params]
            wd = group["weight_decay"]
            upd = torch._foreach_add(grads, params, alpha=wd)
            if self.lars:
                p_norm = torch.stack(torch._foreach_norm(params))
                g_norm = torch.stack(torch._foreach_norm(grads))
                lamb = self.trust_coefficient * p_norm / (
                    g_norm + wd * p_norm + self.lars_eps)
                lamb = torch.clamp_max(lamb / max(lr, 1e-12), 1.0)
                lamb = torch.where((p_norm > 0) & (g_norm > 0), lamb, 1.0)
                torch._foreach_mul_(upd, list(lamb.unbind()))
            mus, nus = [], []
            for p in params:
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                mus.append(state["mu"])
                nus.append(state["nu"])
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, upd, alpha=1.0 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, upd, upd, value=1.0 - b2)
            denom = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            steps = torch._foreach_div(mus, bc1)
            torch._foreach_div_(steps, denom)
            torch._foreach_add_(params, steps, alpha=-lr)
        self.count += 1

    def state_dict(self):
        out = super().state_dict()
        out["count"] = self.count
        return out

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = state_dict.pop("count")
        super().load_state_dict(state_dict)


def build_optimizer(model: nn.Module, base_lr: float, batch_size: int,
                    accum: int, steps_per_epoch: int, epochs: int,
                    warmup_epochs: int = 10, weight_decay: float = 1e-6,
                    optimizer: str = "LARS",
                    lr_max_epochs: Optional[int] = None
                    ) -> Tuple[PretrainOptimizer, Schedule]:
    """Returns (optimizer, schedule).  steps_per_epoch counts data
    iterations; optimizer-step counts divide by the accumulation factor."""
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"optimizer={optimizer!r}, want one of {OPTIMIZERS}")
    peak = scaled_lr(base_lr, batch_size, accum)
    sched_epochs = lr_max_epochs if lr_max_epochs is not None else epochs
    total_opt_steps = sched_epochs * steps_per_epoch // max(accum, 1)
    if optimizer == "LARS":
        warmup_steps = warmup_epochs * steps_per_epoch // max(accum, 1)
        schedule = warmup_cosine(peak, warmup_steps, total_opt_steps)
    else:
        schedule = cosine(peak, total_opt_steps)
    opt = PretrainOptimizer(model, schedule, weight_decay=weight_decay,
                            lars=optimizer == "LARS")
    return opt, schedule
