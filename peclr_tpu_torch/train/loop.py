"""PeCLR pretraining loop, the `trainer.fit` equivalent (port of
peclr_tpu/train/loop.py).

Host pipeline -> device_prefetch -> the pretrain step, with epoch-mean
metrics (`checkpoint_saving_loss` included), the validation loss, top-k
checkpoints, auto-resume or a named restore, and throughput and profiler
observability.  The trainer runs on the card unless `device` names another
(device.resolve_device, which also turns TF32 off).

Randomness: torch cannot replay the reference's jax.random keys, so every
generator is seeded by one formula, `stream_seed(a, b)`: the first 64-bit
word of numpy's SeedSequence((a, b)).  Train step i of epoch e draws its
augmentation from stream_seed(seed, e * steps_per_epoch + i), validation
batch i of epoch e from stream_seed(1000 + e, i); the weights are made by
torch's initialisers under torch.manual_seed(seed).  With the pipeline's
order keyed by the epoch and checkpoints holding the model, the optimizer
and the step, training interrupted at an epoch boundary and resumed is
bit-equal to training straight through (on the CPU; the card's bf16
backward is not bit-deterministic).  A mid-epoch interrupt resumes from the
last completed epoch and replays the partial one.  Multi-source
(balanced) sampling continues one stream and does not replay after a
resume, as in the reference.

Per-step metrics stay on the device until the epoch's end; only
`log_interval="step"` reads them every step.

Data parallel (`mesh`, parallel/mesh.py): each rank trains on its rows of
every batch (the pipelines given must be built with the same mesh) on the
mesh's device, with the same seeds and generator streams as one process;
the step's and the validation's losses are the global batch's, and
throughput counts global images.  Rank 0 alone writes the tracker's files,
the figures and the checkpoints; every rank restores.
"""

from __future__ import annotations

import importlib.util
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from peclr_tpu_torch import constants
from peclr_tpu_torch.config.defaults import ModelConfig, TrainConfig
from peclr_tpu_torch.data.pipeline import (
    HostPipeline,
    cuda_copier,
    device_prefetch,
)
from peclr_tpu_torch.device import DeviceLike, resolve_device
from peclr_tpu_torch.models import PeCLRModel
from peclr_tpu_torch.parallel.mesh import Mesh, replicated
from peclr_tpu_torch.train.checkpoint import CheckpointManager, save_experiment_key
from peclr_tpu_torch.train.optimizer import build_optimizer
from peclr_tpu_torch.train.state import TrainState
from peclr_tpu_torch.train.step import make_peclr_eval_step, make_peclr_train_step
from peclr_tpu_torch.utils.logging import (
    ExperimentLogger,
    NullLogger,
    get_console_logger,
    prepare_name,
)
from peclr_tpu_torch.utils.profiler import Throughput, trace

#: the validation streams are keyed by (VAL_SEED_BASE + epoch, batch)
VAL_SEED_BASE = 1000


def stream_seed(a: int, b: int) -> int:
    """The seed of random stream (a, b): the first uint64 word of
    np.random.SeedSequence((a, b))."""
    return int(np.random.SeedSequence((a, b)).generate_state(1, np.uint64)[0])


def stream_generator(device: torch.device, a: int, b: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(a, b))


class PeCLRTrainer:
    def __init__(
        self,
        train_cfg: TrainConfig,
        model_cfg: ModelConfig,
        train_pipeline: HostPipeline,
        val_pipeline: Optional[HostPipeline] = None,
        device: DeviceLike = None,
        workdir: Optional[str] = None,
        experiment_name: Optional[str] = None,
        save_top_k: int = 3,
        save_period: int = 1,
        log_interval: str = "epoch",
        meta_file: Optional[str] = None,
        tags: Sequence[str] = (),
        profile_dir: Optional[str] = None,
        auto_resume: bool = True,
        log_images: bool = True,
        restore_checkpoint: str = "",
        mesh: Optional[Mesh] = None,
    ):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        writer = mesh is None or mesh.rank == 0
        self.log = get_console_logger("peclr_tpu_torch.train")
        log_images = log_images and writer
        if log_images and importlib.util.find_spec("matplotlib") is None:
            # decided once, so a host without matplotlib augments no figure
            self.log.warning("pair figures off: matplotlib is not installed")
            log_images = False
        self.log_images = log_images
        # one pinned staging copier each for the train and val prefetch,
        # reused by every epoch
        self._copiers = ({"train": cuda_copier(self.device),
                          "val": cuda_copier(self.device)}
                         if self.device.type == "cuda" else {})
        self.train_cfg = train_cfg
        self.model_cfg = model_cfg
        self.pipeline = train_pipeline
        self.val_pipeline = val_pipeline
        self.profile_dir = profile_dir
        self.auto_resume = auto_resume

        flags = train_cfg.augmentation_flags
        # use_palm reaches the config but only supervised samples read it;
        # it is recorded for downstream runs
        self.use_palm = bool(train_cfg.use_palm)
        if self.use_palm:
            self.log.info("use_palm is recorded for downstream runs; the "
                          "contrastive objective itself does not read it")
        self.experiment_name = experiment_name or prepare_name(
            "hybrid2_", train_cfg.batch_size, flags.active()
        )
        if writer:
            self.tracker = ExperimentLogger(
                constants.SAVED_META_INFO_PATH, self.experiment_name,
                log_interval=log_interval,
            )
        if mesh is not None:  # every rank's checkpoints under rank 0's key
            key = mesh.broadcast_object(
                self.tracker.experiment_key if writer else None)
            if not writer:
                self.tracker = NullLogger(self.experiment_name, key,
                                          log_interval)
        self.tracker.log_parameters({
            "train": train_cfg.__dict__,
            "model": model_cfg.__dict__,
            # at epoch cadence the proj* stats are the first step's sample
            "projection_stats_cadence": (
                "per-step" if log_interval == "step"
                else "first-step-of-epoch sample"
            ),
        })
        self.tracker.add_tags(["pretraining", "HYBRID2", *tags])
        if meta_file is not None and writer:
            save_experiment_key(
                constants.SAVED_META_INFO_PATH, self.experiment_name,
                self.tracker.experiment_key, meta_file,
            )
        workdir = workdir or os.path.join(
            constants.SAVED_MODELS_BASE_PATH, self.tracker.experiment_key
        )
        self.ckpt = CheckpointManager(
            workdir, save_top_k=save_top_k, period=save_period, mesh=mesh
        )

        # ---- model + optimizer -------------------------------------------
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(train_cfg.seed)
            model = PeCLRModel(
                model_cfg.resnet_size,
                projection_hidden_dim=model_cfg.projection_head_hidden_dim,
                projection_dim=model_cfg.output_dim,
            )
        self.model = model.to(self.device)
        accum = train_cfg.accumulate_grad_batches
        self.steps_per_epoch = max(
            len(train_pipeline) // (train_cfg.batch_size * accum), 1
        )
        opt, self.schedule = build_optimizer(
            self.model,
            base_lr=model_cfg.lr,
            batch_size=train_cfg.batch_size,
            accum=accum,
            steps_per_epoch=self.steps_per_epoch * accum,
            epochs=train_cfg.epochs,
            warmup_epochs=model_cfg.warmup_epochs,
            weight_decay=model_cfg.opt_weight_decay,
            optimizer=model_cfg.optimizer,
            lr_max_epochs=model_cfg.lr_max_epochs,
        )
        self.state = TrainState(self.model, opt)
        if model_cfg.experiment_type == "simclr":
            augmentations = ()  # invariant baseline: no inverse transforms
        else:
            augmentations = model_cfg.augmentation or flags.active()
        step_kw = dict(accum=accum, augmentations=augmentations,
                       precision=train_cfg.precision, mesh=mesh)
        params = train_cfg.augmentation_params
        # the hot path runs without the projection statistics; the variant
        # with them runs on logged steps only
        self.train_step = make_peclr_train_step(
            self.model, opt, flags, params, with_stats=False, **step_kw)
        self._train_step_stats = make_peclr_train_step(
            self.model, opt, flags, params, with_stats=True, **step_kw)
        self.eval_step = make_peclr_eval_step(
            self.model, flags, params, augmentations=augmentations,
            precision=train_cfg.precision, mesh=mesh)

        self.start_epoch = 0
        if restore_checkpoint:
            # a named checkpoint beats auto-resume; a missing one raises
            epoch = self.ckpt.resolve_epoch(restore_checkpoint)
            self.ckpt.restore(self.state, epoch=epoch)
            self.start_epoch = epoch + 1
            self.log.info(f"restored checkpoint {restore_checkpoint!r} "
                          f"(epoch {epoch})")
        elif auto_resume:
            restored, epoch = self.ckpt.restore(self.state)
            if restored is not None:
                self.start_epoch = epoch + 1
                self.log.info(f"auto-resumed from epoch {epoch}")
        if mesh is not None:
            replicated(mesh, self.model)

    # ------------------------------------------------------------------
    def fit(self, epochs: Optional[int] = None) -> TrainState:
        try:
            return self._fit(epochs)
        finally:
            self.tracker.close()

    def _fit(self, epochs: Optional[int] = None) -> TrainState:
        cfg = self.train_cfg
        epochs = epochs if epochs is not None else cfg.epochs
        images_per_step = cfg.batch_size * cfg.accumulate_grad_batches
        cuda = self.device.type == "cuda"
        step_cadence = self.tracker.log_interval == "step"

        for epoch in range(self.start_epoch, epochs):
            meter = Throughput()
            epoch_metrics: List[Dict[str, torch.Tensor]] = []
            waited = 0.0
            if cuda:
                torch.cuda.reset_peak_memory_stats(self.device)
            t_start = time.perf_counter()
            batches = device_prefetch(
                self.pipeline.batches(self.steps_per_epoch, epoch=epoch),
                self.device, copier=self._copiers.get("train"), mesh=self.mesh,
            )
            with trace(self.profile_dir if epoch == self.start_epoch else None):
                t_wait = time.perf_counter()
                for i, batch in enumerate(batches):
                    waited += time.perf_counter() - t_wait
                    index = epoch * self.steps_per_epoch + i
                    if i == 0 and self.log_images:
                        self._log_pair_figure(batch, index, epoch)
                    step_fn = (self._train_step_stats
                               if step_cadence or i == 0 else self.train_step)
                    self.state, metrics = step_fn(
                        self.state, batch,
                        stream_generator(self.device, cfg.seed, index))
                    meter.tick(images_per_step)
                    epoch_metrics.append(metrics)
                    if step_cadence:
                        self.tracker.log_metrics(
                            {k: v.item() for k, v in metrics.items()},
                            step=self.state.step, epoch=epoch,
                        )
                    t_wait = time.perf_counter()

            mean_metrics = {
                k: float(np.mean(torch.stack(
                    [m[k] for m in epoch_metrics if k in m]).cpu().numpy()))
                for k in epoch_metrics[0]
            }
            mean_metrics["checkpoint_saving_loss"] = mean_metrics.get(
                "loss", np.inf)
            mean_metrics.update(meter.report())
            mean_metrics["lr"] = float(self.schedule(self.state.step))
            mean_metrics["steps"] = len(epoch_metrics)
            mean_metrics["epoch_time_s"] = time.perf_counter() - t_start
            mean_metrics["data_wait_s"] = waited
            if cuda:
                mean_metrics["peak_mem_bytes"] = torch.cuda.max_memory_allocated(
                    self.device)
            self.tracker.log_metrics(mean_metrics, epoch=epoch)
            self.log.info(
                f"epoch {epoch}: loss={mean_metrics['loss']:.4f} "
                f"({len(epoch_metrics) * images_per_step / mean_metrics['epoch_time_s']:.0f} img/s)"
            )

            if self.val_pipeline is not None:
                val = self.validate(epoch)
                self.tracker.log_metrics(val, epoch=epoch, context="val")

            self.ckpt.save(epoch, self.state, mean_metrics)
        return self.state

    def _log_pair_figure(self, batch: Dict[str, torch.Tensor], index: int,
                         epoch: int) -> None:
        """Save an augmented pair of the epoch's first sample as a figure.
        The sample is augmented where the batch lies, from the step's stream
        seed (on the card: two launches of the warp kernel); only the two
        views go to the host for the plot.  A failure is logged and training
        goes on."""
        try:
            from peclr_tpu_torch.ops.augment import augment_pair
            from peclr_tpu_torch.utils.visualize import plot_peclr_pair

            v1, v2 = augment_pair(
                stream_generator(self.device, self.train_cfg.seed, index),
                batch["image"][:1], batch["joints25d"][:1],
                self.train_cfg.augmentation_flags,
                self.train_cfg.augmentation_params,
            )
            params = {
                **{f"{k}_1": v.cpu().numpy() for k, v in v1.params.items()},
                **{f"{k}_2": v.cpu().numpy() for k, v in v2.params.items()},
            }
            path = plot_peclr_pair(
                v1.images[0].cpu().numpy(), v2.images[0].cpu().numpy(), params,
                out_dir=os.path.join(self.tracker.dir, "figures"),
                name=f"pair_epoch{epoch}.png",
            )
            if path is not None:
                self.tracker.log_figure(path, name=f"pair_epoch{epoch}")
        except Exception as e:  # a figure must never stop training
            self.log.warning(f"pair-figure logging failed: {e!r}")

    def validate(self, epoch: int, num_batches: Optional[int] = None
                 ) -> Dict[str, float]:
        """The mean eval-step loss over `num_batches` (default: the split's
        whole batches, at least one) of the validation pipeline."""
        n = num_batches or max(
            len(self.val_pipeline) // self.train_cfg.batch_size, 1
        )
        losses = []
        for i, batch in enumerate(device_prefetch(
                self.val_pipeline.batches(n, epoch=epoch), self.device,
                copier=self._copiers.get("val"), mesh=self.mesh)):
            gen = stream_generator(self.device, VAL_SEED_BASE + epoch, i)
            losses.append(self.eval_step(self.state, batch, gen)["loss"])
        return {"loss": float(np.mean(torch.stack(losses).cpu().numpy()))}
