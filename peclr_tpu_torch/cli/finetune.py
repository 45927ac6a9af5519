"""Supervised fine-tune CLI for the 2.5D pose model, RN25DPose (port of
peclr_tpu/cli/finetune.py, the same flags plus `--device`, default the
card).

Trains on the FreiHAND train split through the supervised sample (K' = T @
K), optionally starting the backbone from a PeCLR pretraining checkpoint:

  python -m peclr_tpu_torch.cli.finetune -pretrained <dir>/checkpoints/epoch_N

`-pretrained` takes a checkpoint directory of the port's pretraining CLI
(epoch_N, holding state.pt), that state.pt itself, or a .pth/.ckpt/.npz in
the reference's PeCLR layout (`encoder.features.*`).  `-resnet_size` takes
50 or 152, as in the reference.  Step i of epoch e draws its augmentation
from stream_seed(seed, e * steps + i) (train/loop.py).  Checkpoints (top-k
by the epoch's mean loss) go to <-workdir>/checkpoints/epoch_N/state.pt,
by default under SAVED_MODELS_BASE_PATH/rn25d.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="RN25D fine-tune (PyTorch)")
    p.add_argument("-batch_size", type=int, default=128)
    p.add_argument("-epochs", type=int, default=100)
    p.add_argument("-seed", type=int, default=5)
    p.add_argument("-lr", type=float, default=1e-4)
    p.add_argument("-optimizer", type=str, default="adam",
                   choices=["LARS", "adam"])
    p.add_argument("-train_ratio", type=float, default=0.9)
    p.add_argument("-resnet_size", type=str, default="50",
                   choices=["50", "152"])
    p.add_argument("-pretrained", type=str, default=None,
                   help="PeCLR checkpoint to start the backbone from: a "
                        "checkpoint directory of the pretraining CLI "
                        "(epoch_N), its state.pt, or a .pth/.ckpt/.npz")
    p.add_argument("-loss_3d_weight", type=float, default=0.0)
    p.add_argument("--use_palm", action="store_true")
    p.add_argument("--crop", action="store_true", default=True)
    p.add_argument("--rotate", action="store_true")
    p.add_argument("--color_jitter", action="store_true")
    p.add_argument("-crop_size", type=int, default=128)
    p.add_argument("-workdir", type=str, default=None)
    p.add_argument("-save_top_k", type=int, default=3)
    p.add_argument("-num_workers", type=int, default=8)
    p.add_argument("-steps_per_epoch", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (default: cuda)")
    return p


def load_pretrained_state(path: str):
    """A PeCLR state dict in the reference's layout from `path` (see the
    module docstring)."""
    from peclr_tpu_torch.train.checkpoint import (
        load_torch_checkpoint,
        model_state_dict,
    )

    if os.path.isdir(path) or path.endswith(".pt"):
        return model_state_dict(path)
    return load_torch_checkpoint(path)


def main(argv=None):
    """Fine-tune as the flags say.  Returns (state, per-epoch records)."""
    import torch

    from peclr_tpu_torch import constants
    from peclr_tpu_torch.config.defaults import (
        AugmentationFlags,
        AugmentationParams,
    )
    from peclr_tpu_torch.data.freihand import FreihandSource
    from peclr_tpu_torch.data.pipeline import (
        HostPipeline,
        cuda_copier,
        device_prefetch,
    )
    from peclr_tpu_torch.device import resolve_device
    from peclr_tpu_torch.models import RN25DPose
    from peclr_tpu_torch.train import finetune
    from peclr_tpu_torch.train.checkpoint import CheckpointManager
    from peclr_tpu_torch.train.loop import stream_generator
    from peclr_tpu_torch.train.optimizer import build_optimizer
    from peclr_tpu_torch.train.state import TrainState
    from peclr_tpu_torch.utils.logging import get_console_logger

    log = get_console_logger("peclr_tpu_torch.finetune")
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    src = FreihandSource(constants.FREIHAND_DATA, "train", seed=args.seed,
                         train_ratio=args.train_ratio)
    pipe = HostPipeline([src], batch_size=args.batch_size, canvas=224,
                        seed=args.seed, num_threads=args.num_workers)
    steps = args.steps_per_epoch or pipe.steps_per_epoch()

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = RN25DPose(size=args.resnet_size)
    if args.pretrained:
        finetune.load_pretrained_encoder(
            model, load_pretrained_state(args.pretrained))
        log.info(f"initialized backbone from {args.pretrained}")
    model.to(dev)

    opt, _ = build_optimizer(model, base_lr=args.lr,
                             batch_size=args.batch_size, accum=1,
                             steps_per_epoch=steps, epochs=args.epochs,
                             optimizer=args.optimizer)
    state = TrainState(model, opt)
    flags = AugmentationFlags(crop=args.crop, rotate=args.rotate,
                              color_jitter=args.color_jitter, resize=True)
    aug = AugmentationParams(resize_shape=(args.crop_size, args.crop_size))
    step = finetune.make_finetune_step(model, opt, flags, aug,
                                       use_palm=args.use_palm,
                                       loss_3d_weight=args.loss_3d_weight)
    workdir = args.workdir or os.path.join(constants.SAVED_MODELS_BASE_PATH,
                                           "rn25d")
    ckpt = CheckpointManager(workdir, save_top_k=args.save_top_k)
    cuda = dev.type == "cuda"
    copier = cuda_copier(dev) if cuda else None

    records = []
    for epoch in range(args.epochs):
        losses = []
        waited = 0.0
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t_start = t_wait = time.perf_counter()
        for i, batch in enumerate(device_prefetch(
                pipe.batches(steps, epoch=epoch), dev, copier=copier)):
            waited += time.perf_counter() - t_wait
            state, metrics = step(state, batch, stream_generator(
                dev, args.seed, epoch * steps + i))
            losses.append(metrics["loss"])
            t_wait = time.perf_counter()
        # the epoch's one wait on the card
        mean_loss = (float(np.mean(torch.stack(losses).cpu().numpy()))
                     if losses else float("nan"))
        seconds = time.perf_counter() - t_start
        record = {"epoch": epoch, "loss": mean_loss, "steps": len(losses),
                  "epoch_time_s": seconds, "data_wait_s": waited,
                  "images_per_sec": len(losses) * args.batch_size / seconds}
        if cuda:
            record["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
        records.append(record)
        log.info(f"epoch {epoch}: loss={mean_loss:.4f} "
                 f"({record['images_per_sec']:.0f} img/s)")
        ckpt.save(epoch, state, {"checkpoint_saving_loss": mean_loss})
    return state, records


if __name__ == "__main__":
    main()
