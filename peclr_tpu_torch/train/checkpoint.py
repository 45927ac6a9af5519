"""Checkpoints: save and restore with top-k retention on the monitored train
loss, latest-checkpoint discovery, reading torch checkpoints, and the .npz
exports in the reference's and torchvision's layouts (port of
peclr_tpu/train/checkpoint.py:30-131 and :157-191).

Policy (the reference's Lightning ModelCheckpoint): keep `save_top_k`
checkpoints, saved every `period` epochs, ranked by `checkpoint_saving_loss`
(the epoch-mean train loss).  Layout:
<workdir>/checkpoints/epoch_N/state.pt, one torch.save file holding the
model's and the optimizer's state_dicts (the optimizer's update count
included) and the step, beside <workdir>/checkpoints/index.json ({epoch:
score} of the kept checkpoints).

Data parallel (a `mesh`): rank 0 alone writes the checkpoints and the
index, every rank waits for it at a barrier, and every rank restores.  The
state dict is the model's own (the module DistributedDataParallel wraps), so
checkpoints stay loadable without a `module.` prefix.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from peclr_tpu_torch.models.port import peclr_mapping, peclr_to_torchvision

STATE_FILE = "state.pt"


class CheckpointManager:
    """Top-k (lowest monitored loss) and every-N-epochs checkpoint policy."""

    def __init__(
        self,
        directory: str,
        save_top_k: int = 3,
        period: int = 1,
        monitor: str = "checkpoint_saving_loss",
        mesh=None,
    ):
        self.mesh = mesh
        self.writer = mesh is None or mesh.rank == 0
        self.directory = os.path.join(directory, "checkpoints")
        os.makedirs(self.directory, exist_ok=True)
        self.save_top_k = save_top_k
        self.period = period
        self.monitor = monitor
        self._scores: Dict[int, float] = {}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._scores = {int(k): v for k, v in json.load(f).items()}

    @property
    def _index_path(self) -> str:
        return os.path.join(self.directory, "index.json")

    def _save_index(self) -> None:
        with open(self._index_path, "w") as f:
            json.dump(self._scores, f)

    def _epoch_dir(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch}")

    def path(self, epoch: int) -> str:
        """The state file of epoch's checkpoint."""
        return os.path.join(self._epoch_dir(epoch), STATE_FILE)

    def _epochs_on_disk(self):
        return sorted(int(m.group(1)) for d in os.listdir(self.directory)
                      if (m := re.fullmatch(r"epoch_(\d+)", d)))

    def save(self, epoch: int, state, metrics: Dict[str, float]) -> bool:
        """Save `state` (train/state.py:TrainState) if the period elapsed;
        keep only the best top-k.  Returns whether this process wrote (with
        a mesh, rank 0 writes and every rank returns after it has)."""
        if (epoch + 1) % self.period != 0:
            return False
        wrote = self.writer and self._write(epoch, state, metrics)
        if self.mesh is not None:
            self.mesh.barrier()
        return wrote

    def _write(self, epoch: int, state, metrics: Dict[str, float]) -> bool:
        score = float(metrics.get(self.monitor, np.inf))
        path = self._epoch_dir(epoch)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        tmp = os.path.join(path, STATE_FILE + ".tmp")
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": state.step}, tmp)
        os.replace(tmp, self.path(epoch))
        self._scores[epoch] = score
        if self.save_top_k > 0:
            keep = sorted(self._scores, key=lambda e: self._scores[e])[
                : self.save_top_k]
            for e in list(self._scores):
                if e not in keep:
                    del self._scores[e]
                    stale = self._epoch_dir(e)
                    if os.path.exists(stale):
                        shutil.rmtree(stale)
        self._save_index()
        return True

    def resolve_epoch(self, checkpoint: str) -> int:
        """A checkpoint name ('epoch=12.ckpt', 'epoch_12' or '12') -> its
        epoch.  Raises FileNotFoundError if that checkpoint is not on
        disk."""
        epoch = parse_checkpoint_name(checkpoint)
        if not os.path.exists(self._epoch_dir(epoch)):
            raise FileNotFoundError(
                f"checkpoint {checkpoint!r} (epoch {epoch}) not found under "
                f"{self.directory}; available epochs: {self._epochs_on_disk()}"
            )
        return epoch

    def latest_epoch(self) -> Optional[int]:
        epochs = self._epochs_on_disk()
        return epochs[-1] if epochs else None

    def restore(self, state, epoch: Optional[int] = None):
        """Load a checkpoint into state's model and optimizer (on the
        model's device) and set its step; `epoch=None` takes the newest.
        Returns (state, epoch), or (None, None) when there is none."""
        if epoch is None:
            epoch = self.latest_epoch()
        if epoch is None:
            return None, None
        device = next(state.model.parameters()).device
        payload = torch.load(self.path(epoch), map_location=device,
                             weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state, epoch


def parse_checkpoint_name(checkpoint: str) -> int:
    """'epoch=12.ckpt' | 'epoch_12' | '12' -> 12."""
    m = re.fullmatch(r"(?:epoch[=_])?(\d+)(?:\.ckpt)?", checkpoint.strip())
    if not m:
        raise ValueError(
            f"unrecognized checkpoint name {checkpoint!r} "
            "(expected 'epoch=N.ckpt', 'epoch_N' or 'N')"
        )
    return int(m.group(1))


def save_experiment_key(meta_dir: str, experiment_name: str,
                        experiment_key: str, filename: str = "default.csv"):
    """Append (name, key) to the experiment-key CSV registry."""
    os.makedirs(meta_dir, exist_ok=True)
    with open(os.path.join(meta_dir, filename), "a") as f:
        f.write(f"{experiment_name},{experiment_key}\n")


def model_state_dict(state) -> Dict[str, torch.Tensor]:
    """The model's state dict, on the CPU, of a TrainState, of a checkpoint
    directory (epoch_N, holding state.pt) or of a state.pt file."""
    if isinstance(state, str):
        path = os.path.join(state, STATE_FILE) if os.path.isdir(state) else state
        return torch.load(path, map_location="cpu", weights_only=True)["model"]
    return {k: v.detach().cpu() for k, v in state.model.state_dict().items()}


def save_npz(path: str, state_dict: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    """Write a state dict of CPU tensors as an .npz; returns it."""
    np.savez(path, **{k: v.numpy() for k, v in state_dict.items()})
    return state_dict


def export_torch_peclr(state, resnet_size: str, path: str
                       ) -> Dict[str, torch.Tensor]:
    """Write a PeCLR model's weights as an .npz with the reference
    checkpoint's keys (`encoder.features.*`, `projection_head.*`), the keys
    the port's PeCLRModel already has.  `state`: as model_state_dict.
    Returns what was written."""
    sd = model_state_dict(state)
    missing = [name for name, _, _, _ in peclr_mapping(resnet_size)
               if name not in sd]
    if missing:
        raise KeyError(f"not a PeCLR RN{resnet_size} state: missing "
                       f"{missing[:3]} ({len(missing)} in all)")
    return save_npz(path, sd)


def export_torchvision(state, resnet_size: str, path: str
                       ) -> Dict[str, torch.Tensor]:
    """Write a PeCLR model's encoder as an .npz with torchvision's keys
    (no fc).  `state`: as model_state_dict.  Returns what was written."""
    return save_npz(path, peclr_to_torchvision(model_state_dict(state),
                                               resnet_size))


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a torch .pth/.ckpt or an .npz into a flat state dict of CPU
    tensors (a lightning checkpoint's 'state_dict' payload is unwrapped)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: torch.from_numpy(z[k]) for k in z.files}
    payload = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(payload, dict) and "state_dict" in payload:
        payload = payload["state_dict"]
    return {k: v.detach().cpu() for k, v in payload.items()}
