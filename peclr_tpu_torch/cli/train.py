"""PeCLR pretraining CLI (port of peclr_tpu/cli/train.py, the same flags).

The 11 augmentation flags, batch/epochs/seed/train_ratio/
accumulate_grad_batches, lr, optimizer {LARS, adam}, data sources, the
logging interval, checkpointing knobs, resnet size, lr_max_epochs and
use_palm, merged over config/defaults.py; `--device` picks the torch device
(default: the card).

The published PeCLR recipe:
  python -m peclr_tpu_torch.cli.train --rotate --crop --color_jitter --resize \\
      -sources freihand -sources youtube -batch_size 128 \\
      -accumulate_grad_batches 16 -epochs 100 -save_top_k 5 \\
      -resnet_size 50 -optimizer LARS

Data parallel, one rank a card over NCCL:
  python -m torch.distributed.run --nproc_per_node N \
      -m peclr_tpu_torch.cli.train ... -batch_size 128 ...
Under a launcher (WORLD_SIZE set) the CLI joins the process group
(parallel/mesh.py:make_mesh; `--device cpu` takes gloo), each rank decodes
and trains on its rows, and the group is destroyed on exit, errors
included.  -batch_size stays the global microbatch, as in the reference,
and must split evenly over the ranks.

Data and output paths come from peclr_tpu_torch.constants (DATA_PATH,
SAVED_MODELS_BASE_PATH, SAVED_META_INFO_PATH), read when main runs.
"""

from __future__ import annotations

import argparse
import os

from peclr_tpu_torch import constants
from peclr_tpu_torch.config.defaults import ModelConfig, TrainConfig

AUG_FLAGS = [
    "color_drop", "color_jitter", "crop", "cut_out", "flip", "gaussian_blur",
    "rotate", "random_crop", "resize", "sobel_filter", "gaussian_noise",
]


def build_parser(description: str = "PeCLR pretraining (PyTorch)"):
    p = argparse.ArgumentParser(description=description)
    for flag in AUG_FLAGS:
        p.add_argument(f"--{flag}", action="store_true",
                       help=f"enable {flag} augmentation")
    p.add_argument("-tag", action="append", default=[], help="experiment tag")
    p.add_argument("-batch_size", type=int, default=None)
    p.add_argument("-epochs", type=int, default=None)
    p.add_argument("-seed", type=int, default=None)
    p.add_argument("-num_workers", type=int, default=None)
    p.add_argument("-train_ratio", type=float, default=None)
    p.add_argument("-accumulate_grad_batches", type=int, default=None)
    p.add_argument("-lr", type=float, default=None)
    p.add_argument("-optimizer", type=str, default=None,
                   choices=["LARS", "adam"])
    p.add_argument("-sources", action="append", default=[],
                   choices=["freihand", "interhand", "mpii", "youtube"])
    p.add_argument("-log_interval", type=str, default="epoch",
                   choices=["step", "epoch"])
    p.add_argument("-experiment_key", type=str, default=None,
                   help="experiment key of a run whose checkpoints to restore")
    p.add_argument("-checkpoint", type=str, default="",
                   help="checkpoint name to restore (with -experiment_key): "
                        "'epoch=N.ckpt', 'epoch_N' or 'N'; default latest")
    p.add_argument("-meta_file", type=str, default=None)
    p.add_argument("-experiment_name", type=str, default="")
    p.add_argument("-save_period", type=int, default=1)
    p.add_argument("-save_top_k", type=int, default=3)
    p.add_argument("-resnet_size", type=str, default="50",
                   choices=["18", "34", "50", "101", "152"])
    p.add_argument("-lr_max_epochs", type=int, default=None)
    p.add_argument("--use_palm", action="store_true")
    p.add_argument("-profile_dir", type=str, default=None,
                   help="torch.profiler Chrome trace output dir (first "
                        "epoch); it holds the program's spans "
                        "(pretrain.step, pretrain.backward, warp.shift, ...) "
                        "beside torch's ops and the card's kernels")
    p.add_argument("-canvas", type=int, default=224,
                   help="host canvas size fed to the device augmenter")
    p.add_argument("-view_size", type=int, default=None,
                   help="augmented view size (overrides resize_shape, "
                        "default 128)")
    p.add_argument("-experiment_type", type=str, default="hybrid2",
                   choices=["hybrid2", "simclr"],
                   help="hybrid2 = PeCLR (equivariant); simclr = invariant "
                        "baseline (no inverse transforms in projection space)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (default: cuda)")
    return p


def configs_from_args(args) -> tuple[TrainConfig, ModelConfig]:
    train_cfg = TrainConfig()
    for field in ("batch_size", "epochs", "seed", "num_workers",
                  "accumulate_grad_batches"):
        v = getattr(args, field, None)
        if v is not None:
            setattr(train_cfg, field, v)
    if args.train_ratio is not None:
        # the reference's quirk: the ratio is taken as a percentage, mod 100
        train_cfg.train_ratio = (args.train_ratio * 100 % 100) / 100.0
    train_cfg.use_palm = bool(args.use_palm)
    for flag in AUG_FLAGS:
        if getattr(args, flag):
            setattr(train_cfg.augmentation_flags, flag, True)
    if args.sources:
        train_cfg.sources = tuple(args.sources)
    if getattr(args, "view_size", None):
        train_cfg.augmentation_params.resize_shape = (
            args.view_size, args.view_size,
        )

    model_cfg = ModelConfig()
    model_cfg.resnet_size = args.resnet_size
    model_cfg.batch_size = train_cfg.batch_size
    model_cfg.num_of_mini_batch = train_cfg.accumulate_grad_batches
    model_cfg.epochs = train_cfg.epochs
    if args.lr is not None:
        model_cfg.lr = args.lr
    if args.optimizer is not None:
        model_cfg.optimizer = args.optimizer
    model_cfg.lr_max_epochs = args.lr_max_epochs
    model_cfg.projection_head_input_dim = {
        "18": 512, "34": 512, "50": 2048, "101": 2048, "152": 2048
    }[args.resnet_size]
    model_cfg.augmentation = tuple(train_cfg.augmentation_flags.active())
    model_cfg.experiment_type = getattr(args, "experiment_type", "hybrid2")
    return train_cfg, model_cfg


def build_sources(train_cfg: TrainConfig, split: str):
    from peclr_tpu_torch.data.freihand import FreihandSource
    from peclr_tpu_torch.data.youtube import YoutubeSource

    sources = []
    for name in train_cfg.sources or ("freihand",):
        if name == "freihand":
            sources.append(FreihandSource(
                constants.FREIHAND_DATA, split, seed=train_cfg.seed,
                train_ratio=train_cfg.train_ratio,
            ))
        elif name == "youtube":
            sources.append(YoutubeSource(constants.YOUTUBE_DATA, split))
        else:
            raise NotImplementedError(
                f"source '{name}' is a CLI placeholder in the reference too"
            )
    return sources


def main(argv=None):
    """Train as the flags say; returns the trainer after fit.  Under a
    launcher (module docstring), data parallel over its ranks."""
    from peclr_tpu_torch.parallel.mesh import make_mesh

    args = build_parser().parse_args(argv)
    mesh = make_mesh(device=args.device) if "WORLD_SIZE" in os.environ else None
    try:
        return _train(args, mesh)
    finally:
        if mesh is not None:
            mesh.close()


def _train(args, mesh):
    from peclr_tpu_torch.data.pipeline import HostPipeline
    from peclr_tpu_torch.parallel.multihost import local_batch_size
    from peclr_tpu_torch.train.loop import PeCLRTrainer
    from peclr_tpu_torch.utils.logging import get_console_logger

    log = get_console_logger("peclr_tpu_torch.cli")
    train_cfg, model_cfg = configs_from_args(args)
    log.info(f"train config: {train_cfg}")
    log.info(f"model config: {model_cfg}")
    accum = train_cfg.accumulate_grad_batches
    if mesh is not None:
        local_batch_size(train_cfg.batch_size, mesh)
        log.info(f"data parallel: rank {mesh.rank} of {mesh.size} on "
                 f"{mesh.device} ({mesh.backend}), "
                 f"{train_cfg.batch_size // mesh.size} rows a microbatch")

    train_pipe = HostPipeline(
        build_sources(train_cfg, "train"),
        batch_size=train_cfg.batch_size * accum,
        canvas=args.canvas,
        seed=train_cfg.seed,
        num_threads=train_cfg.num_workers,
        mesh=mesh,
        accum=accum,
    )
    val_pipe = HostPipeline(
        build_sources(train_cfg, "val"),
        batch_size=train_cfg.batch_size,
        canvas=args.canvas,
        seed=train_cfg.seed,
        num_threads=train_cfg.num_workers,
        shuffle=False,
        mesh=mesh,
    )
    workdir = None
    if args.experiment_key:
        workdir = os.path.join(constants.SAVED_MODELS_BASE_PATH,
                               args.experiment_key)
    elif args.checkpoint:
        raise SystemExit(
            "-checkpoint needs -experiment_key to locate the run to restore"
        )
    trainer = PeCLRTrainer(
        train_cfg,
        model_cfg,
        train_pipe,
        val_pipe,
        device=args.device,
        workdir=workdir,
        experiment_name=args.experiment_name or None,
        save_top_k=args.save_top_k,
        save_period=args.save_period,
        log_interval=args.log_interval,
        meta_file=args.meta_file,
        tags=args.tag,
        profile_dir=args.profile_dir,
        restore_checkpoint=args.checkpoint,
        mesh=mesh,
    )
    trainer.fit()
    return trainer


if __name__ == "__main__":
    main()
