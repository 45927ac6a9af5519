"""The PeCLR pretrain step (port of peclr_tpu/train/step.py): augmentation
+ encoder + equivariant NT-Xent + gradient accumulation + one optimizer
update.

One step over accum microbatches of B canvases:

    for each microbatch:
        augment_pair  -> two views + their parameters   (the warp's kernels)
        encoder+head  -> projections of both views, one batch
        peclr_projections -> inverse transforms in projection space
        ntxent_loss   -> the microbatch's loss; backward adds loss/accum
    one optimizer update (LARS + Adam + schedule)

Loss and gradients are means over the microbatches.  The BatchNorm running
statistics chain through the microbatches with momentum 0.1 each, which is
what the reference's stats_accum="outside" closed form computes.  On the
card the model runs under bf16 autocast with f32 parameters and the warp in
bf16 (the reference's precision="bf16"); precision="f32", and the CPU, run
both in f32.

`make_peclr_eval_step` is the validation step: the same augmentation,
equivariance and loss on one batch, the model in eval mode, no update.

Data parallel (`mesh`, parallel/mesh.py): each rank holds its rows of every
microbatch (shard_batch's layout), and the step's result is the reference's
global-view step on the global batch, up to summation order:
  * every rank draws each microbatch's augmentation for the global 2B from
    the same generator stream and keeps its rows of both views, so W ranks
    see the single-process run's augmentation;
  * the BatchNorms take the global batch's statistics (models/batchnorm.py
    :set_mesh) and NT-Xent's negatives span the global 2B (gathered), so
    every rank's loss is the global one;
  * the model runs under DistributedDataParallel, whose one gradient
    all-reduce a step (`no_sync` on all microbatches but the last) takes
    the mean over W of the ranks' gradients: each is W times its rows'
    share (the gather's backward sums over the ranks), so the mean is the
    gradient of the global mean loss, and the update is the same on every
    rank.
The collectives run at every world size, 1 included.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from peclr_tpu_torch.config.defaults import AugmentationFlags, AugmentationParams
from peclr_tpu_torch.device import full_float32, on_cuda
from peclr_tpu_torch.losses.equivariance import peclr_projections
from peclr_tpu_torch.losses.ntxent import ntxent_loss
from peclr_tpu_torch.models.batchnorm import set_mesh
from peclr_tpu_torch.ops.augment import augment_pair, draw
from peclr_tpu_torch.parallel.collectives import all_gather
from peclr_tpu_torch.parallel.mesh import Mesh, shard_batch
from peclr_tpu_torch.train.optimizer import PretrainOptimizer
from peclr_tpu_torch.train.state import TrainState

PRECISIONS = ("bf16", "f32")


def projection_stats(proj: torch.Tensor, name: str) -> Dict[str, torch.Tensor]:
    """Per-axis mean, median, min and max of the (B, 64, 2) projection
    cloud, averaged over the batch.  The median averages the two middle
    values, as jnp.median does (torch.median would take the lower one)."""
    pts = proj.reshape(proj.shape[0], -1, 2)
    reductions = (
        ("mean", lambda p: p.mean(dim=1)),
        ("median", lambda p: torch.quantile(p, 0.5, dim=1)),
        ("min", lambda p: p.amin(dim=1)),
        ("max", lambda p: p.amax(dim=1)),
    )
    out = {}
    for rname, red in reductions:
        val = red(pts).mean(dim=0)
        out[f"{name}x_{rname}"] = val[0]
        out[f"{name}y_{rname}"] = val[1]
    return out


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision={precision!r}, want one of {PRECISIONS}")


def _rank_draws(mesh: Mesh, generator: Optional[torch.Generator], rows: int,
                flags: AugmentationFlags, aug_params: AugmentationParams,
                draws: Optional[Dict[str, torch.Tensor]]):
    """This rank's draws of a microbatch whose rank share is `rows`: the
    global 2B draws (`draws`, or fresh from the generator) cut to the
    rank's rows of both views."""
    n = 2 * rows * mesh.size
    if draws is None:
        draws = draw(generator, n, flags, aug_params)
    got = len(next(iter(draws.values())))
    if got != n:
        raise ValueError(f"draws of {got} samples for a global microbatch of "
                         f"{rows} rows on each of {mesh.size} ranks (want {n})")
    return shard_batch(mesh, draws, accum=2)


def make_peclr_train_step(
    model: nn.Module,
    optimizer: PretrainOptimizer,
    flags: AugmentationFlags,
    aug_params: AugmentationParams,
    accum: int = 1,
    temperature: float = 0.5,
    warp_route: str = "grouped",
    precision: str = "bf16",
    augmentations: Optional[Sequence[str]] = None,
    with_stats: bool = True,
    mesh: Optional[Mesh] = None,
):
    """Returns step(state, batch, generator, draws=None) -> (state, metrics).

    batch holds 'image' (accum*B, H, W, 3) uint8 and 'joints25d' (accum*B,
    21, 3) on the model's device.  `generator` (a torch.Generator on that
    device) makes each microbatch's augmentation draws, unless `draws` gives
    them: a list of accum dicts of 2B parameters each (ops/augment.py:draw),
    e.g. those the reference drew.  The step updates state.model and
    state.optimizer in place and advances state.step.  `warp_route` picks
    the warp (ops/augment.py:ROUTES: the two-pass warp's kernels, or the
    gather warp, which launches none).  metrics: the mean loss and,
    with_stats, the last microbatch's projection_stats, as the reference
    reports (the trainer's hot path runs without them).  Nothing in the
    step waits on the card: metrics stay device tensors.

    With a mesh (module docstring) the batch holds this rank's accum*B/W
    rows, `draws` the global 2B parameters of each microbatch, and the
    metrics are the global batch's.  For a model on the card TF32 is
    turned off (device.py:full_float32)."""
    if augmentations is None:
        augmentations = flags.active()
    _check_precision(precision)
    if on_cuda(model):
        full_float32()
    image_size = tuple(aug_params.resize_shape)
    forward = model
    if mesh is not None:
        set_mesh(model, mesh)
        forward = mesh.ddp(model)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator],
                   draws: Optional[List[Dict[str, torch.Tensor]]] = None):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer "
                             "than the step was made with")
        images, joints = batch["image"], batch["joints25d"]
        n = images.shape[0]
        if n % accum:
            raise ValueError(f"batch of {n} does not split into {accum} "
                             "microbatches")
        if draws is not None and len(draws) != accum:
            raise ValueError(f"{len(draws)} draws for {accum} microbatches")
        mb = n // accum
        device = images.device
        bf16 = device.type == "cuda" and precision == "bf16"
        compute_dtype = torch.bfloat16 if bf16 else torch.float32

        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), device=device)
        for i in range(accum):
            sl = slice(i * mb, (i + 1) * mb)
            mb_draws = None if draws is None else draws[i]
            if mesh is not None:
                mb_draws = _rank_draws(mesh, generator, mb, flags, aug_params,
                                       mb_draws)
            v1, v2 = augment_pair(
                generator, images[sl], joints[sl], flags, aug_params,
                draws=mb_draws, route=warp_route,
                compute_dtype=compute_dtype)
            # one gradient all-reduce a step, in the last microbatch's
            # backward
            sync = (forward.no_sync() if mesh is not None and i < accum - 1
                    else contextlib.nullcontext())
            with sync:
                with torch.autocast(device.type, dtype=torch.bfloat16,
                                    enabled=bf16):
                    out = forward(torch.cat([v1.images, v2.images]))
                proj = out["projection"]
                z1, z2 = peclr_projections(proj[:mb], proj[mb:], v1.params,
                                           v2.params, image_size=image_size,
                                           augmentations=augmentations)
                loss = ntxent_loss(z1, z2, temperature, mesh=mesh)
                (loss / accum).backward()
            loss_sum += loss.detach()
        stats = {}
        if with_stats:
            proj1, proj2 = proj[:mb].detach(), proj[mb:].detach()
            if mesh is not None:
                # the median does not decompose: the stats of the gathered
                # global projections
                proj1, proj2 = (all_gather(p.float(), mesh).to(p.dtype)
                                for p in (proj1, proj2))
            stats = {**projection_stats(proj1, "proj1"),
                     **projection_stats(proj2, "proj2")}
        optimizer.step()
        state.step += 1
        return state, {"loss": loss_sum / accum, **stats}

    return train_step


def make_peclr_eval_step(
    model: nn.Module,
    flags: AugmentationFlags,
    aug_params: AugmentationParams,
    temperature: float = 0.5,
    precision: str = "bf16",
    augmentations: Optional[Sequence[str]] = None,
    mesh: Optional[Mesh] = None,
):
    """Returns eval_step(state, batch, generator, draws=None) -> {'loss'}:
    the train step's augmentation, inverse transforms and NT-Xent on one
    batch of B canvases, one forward of the model in eval mode under
    torch.inference_mode, no update.  `draws` (2B parameters) replaces the
    generator's draws, as in the train step.  With a mesh the batch is this
    rank's B/W rows, `draws` the global 2B, and the loss the global
    batch's (the BatchNorms need nothing in eval mode).  For a model on the
    card TF32 is turned off, as in the train step."""
    if augmentations is None:
        augmentations = flags.active()
    _check_precision(precision)
    if on_cuda(model):
        full_float32()
    image_size = tuple(aug_params.resize_shape)

    @torch.inference_mode()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator],
                  draws: Optional[Dict[str, torch.Tensor]] = None):
        if state.model is not model:
            raise ValueError("the state holds another model than the step "
                             "was made with")
        images = batch["image"]
        b = images.shape[0]
        device = images.device
        bf16 = device.type == "cuda" and precision == "bf16"
        if mesh is not None:
            draws = _rank_draws(mesh, generator, b, flags, aug_params, draws)
        v1, v2 = augment_pair(
            generator, images, batch["joints25d"], flags, aug_params,
            draws=draws,
            compute_dtype=torch.bfloat16 if bf16 else torch.float32)
        model.eval()
        with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
            proj = model(torch.cat([v1.images, v2.images]))["projection"]
        z1, z2 = peclr_projections(proj[:b], proj[b:], v1.params, v2.params,
                                   image_size=image_size,
                                   augmentations=augmentations)
        return {"loss": ntxent_loss(z1, z2, temperature, mesh=mesh)}

    return eval_step
