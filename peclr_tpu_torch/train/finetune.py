"""Supervised fine-tuning of the 2.5D pose model, RN25DPose (port of
peclr_tpu/train/finetune.py).

One step: the supervised sample (eval/evaluate.py:supervised_sample_batch,
K' = T @ K), the model in train mode, the separated 2D / z L1 losses and,
weighted, the lifted-3D MAE, then one update of the pretrain recipe's
optimizer.  The model runs in float32, as the reference's RN25DPose does;
the warp takes its default compute type (bf16 on the card).  Pretrained
PeCLR encoders load into the backbone by a rename of keys
(models/port.py).

Spans (utils/profiler.py:span; recorded only under torch.profiler):
`finetune.step` holds `finetune.augment`, `.zero_grad`, `.forward`,
`.loss`, `.backward` and `.update`.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from peclr_tpu_torch.config.defaults import AugmentationFlags, AugmentationParams
from peclr_tpu_torch.device import full_float32, on_cuda
from peclr_tpu_torch.eval.evaluate import Draws, supervised_sample_batch
from peclr_tpu_torch.losses.supervised import l1_loss_25d, loss_3d
from peclr_tpu_torch.models.port import peclr_to_torchvision
from peclr_tpu_torch.train.optimizer import PretrainOptimizer
from peclr_tpu_torch.train.state import TrainState
from peclr_tpu_torch.utils.profiler import span


def make_finetune_step(
    model: nn.Module,
    optimizer: PretrainOptimizer,
    flags: AugmentationFlags,
    aug_params: AugmentationParams,
    use_palm: bool = False,
    loss_3d_weight: float = 0.0,
    compute_dtype: Optional[torch.dtype] = None,
):
    """Returns step(state, batch, generator, draws=None) -> (state, metrics).

    batch holds the pipeline's fields (image, joints25d, K, scale,
    joints_valid, joints3d, joints_raw) on the model's device; `generator`
    draws the augmentation unless `draws` gives it.  Total loss = loss_2d +
    loss_z (+ loss_3d_weight * loss_3d).  The step updates state.model and
    state.optimizer in place and advances state.step; its metrics stay
    device tensors (nothing waits on the card).  `compute_dtype` overrides
    the warp's default compute type.  For a model on the card TF32 is
    turned off (device.py:full_float32): the model runs in full float32."""
    if on_cuda(model):
        full_float32()

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator],
             draws: Optional[Draws] = None):
        with span("finetune.step"):
            return _step(state, batch, generator, draws)

    def _step(state, batch, generator, draws):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer "
                             "than the step was made with")
        with span("finetune.augment"):
            sample = supervised_sample_batch(
                generator, batch, flags, aug_params, use_palm=use_palm,
                draws=draws, compute_dtype=compute_dtype)
        model.train()
        with span("finetune.zero_grad"):
            optimizer.zero_grad(set_to_none=True)
        with span("finetune.forward"):
            out = model(sample["image"], K=sample["K"])
        with span("finetune.loss"):
            l2d, lz, lz_unscaled = l1_loss_25d(
                out["kp25d"], sample["joints"], sample["scale"],
                sample["joints_valid"])
            total = l2d + lz
            metrics = {"loss_2d": l2d, "loss_z": lz,
                       "loss_z_unscaled": lz_unscaled}
            if loss_3d_weight > 0:
                l3d = loss_3d(out["kp25d"], sample["joints3D"],
                              sample["scale"], sample["K"],
                              sample["joints_valid"])
                metrics["loss_3d"] = l3d
                total = total + loss_3d_weight * l3d
            metrics["loss"] = total
        with span("finetune.backward"):
            total.backward()
        with span("finetune.update"):
            optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def load_pretrained_encoder(model: nn.Module,
                            peclr_state_dict: Mapping[str, torch.Tensor]
                            ) -> nn.Module:
    """Initialise an RN25DPose's backbone (`backend_model.*` but fc) from a
    PeCLR checkpoint's encoder (`encoder.features.*`, the reference's
    layout); fc and the z-root MLP keep their weights.  Returns the model."""
    encoder = peclr_to_torchvision(peclr_state_dict, model.size)
    missing, unexpected = model.backend_model.load_state_dict(encoder,
                                                              strict=False)
    if unexpected or sorted(missing) != ["fc.bias", "fc.weight"]:
        raise KeyError(f"backbone keys: missing {missing}, unexpected "
                       f"{unexpected}")
    return model
