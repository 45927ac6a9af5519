"""Carry weights across from the reference's flax variables (port of the
name tables of peclr_tpu/models/port.py:34-133 and :282-295).

Each table entry is (torch_name, collection, flax_path, kind) with kind
'conv' (HWIO -> OIHW), 'dense_w' ((in, out) -> (out, in)) or 'copy'.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from peclr_tpu_torch.models.resnet import RESNET_SPECS

Entry = Tuple[str, str, Tuple[str, ...], str]

_BN_FIELDS = (
    ("weight", "params", "scale"),
    ("bias", "params", "bias"),
    ("running_mean", "batch_stats", "mean"),
    ("running_var", "batch_stats", "var"),
)


def _bn_entries(torch_prefix: str, flax_path: Tuple[str, ...]) -> List[Entry]:
    return [(f"{torch_prefix}.{tf}", coll, flax_path + (ff,), "copy")
            for tf, coll, ff in _BN_FIELDS]


def resnet_mapping(size: str) -> List[Entry]:
    """Name table of a torchvision-style ResNet encoder (no fc)."""
    block_kind, stages = RESNET_SPECS[size]
    convs_per_block = 2 if block_kind == "basic" else 3
    entries: List[Entry] = [("conv1.weight", "params", ("conv1", "kernel"),
                             "conv")]
    entries += _bn_entries("bn1", ("bn1",))
    for stage_idx, num_blocks in enumerate(stages):
        for j in range(num_blocks):
            t_blk = f"layer{stage_idx + 1}.{j}"
            f_blk = f"layer{stage_idx + 1}_{j}"
            for k in range(1, convs_per_block + 1):
                entries.append((f"{t_blk}.conv{k}.weight", "params",
                                (f_blk, f"conv{k}", "kernel"), "conv"))
                entries += _bn_entries(f"{t_blk}.bn{k}", (f_blk, f"bn{k}"))
            if j == 0 and (stage_idx > 0 or block_kind == "bottleneck"):
                entries.append((f"{t_blk}.downsample.0.weight", "params",
                                (f_blk, "downsample_conv", "kernel"), "conv"))
                entries += _bn_entries(f"{t_blk}.downsample.1",
                                       (f_blk, "downsample_bn"))
    return entries


def zroot_mlp_mapping() -> List[Entry]:
    """Sequential(Linear, BN, LeakyReLU, Linear, BN, LeakyReLU, Linear) ->
    ZrootRefineMLP{lin1, bn1, lin2, bn2, lin3}."""
    return [
        ("0.weight", "params", ("lin1", "kernel"), "dense_w"),
        ("0.bias", "params", ("lin1", "bias"), "copy"),
        *_bn_entries("1", ("bn1",)),
        ("3.weight", "params", ("lin2", "kernel"), "dense_w"),
        ("3.bias", "params", ("lin2", "bias"), "copy"),
        *_bn_entries("4", ("bn2",)),
        ("6.weight", "params", ("lin3", "kernel"), "dense_w"),
        ("6.bias", "params", ("lin3", "bias"), "copy"),
    ]


def rn25d_mapping(size: str) -> List[Entry]:
    """Released RN_25D_wMLPref keys <-> RN25DPose flax variables."""
    backbone = [("backend_model." + tn, coll, ("backbone",) + fp, kind)
                for tn, coll, fp, kind in resnet_mapping(size)]
    fc = [
        ("backend_model.fc.weight", "params", ("fc", "kernel"), "dense_w"),
        ("backend_model.fc.bias", "params", ("fc", "bias"), "copy"),
    ]
    zroot = [("zroot_ref.zroot_ref." + tn, coll, ("zroot_ref",) + fp, kind)
             for tn, coll, fp, kind in zroot_mlp_mapping()]
    return backbone + fc + zroot


def flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], object]:
    """Nested mappings -> {path tuple: leaf}."""
    flat = {}
    for key, value in tree.items():
        path = prefix + (key,)
        if isinstance(value, Mapping):
            flat.update(flatten(value, path))
        else:
            flat[path] = value
    return flat


def _export_value(v, kind: str) -> np.ndarray:
    v = np.asarray(v, dtype=np.float32)
    if kind == "conv":
        return np.transpose(v, (3, 2, 0, 1))  # HWIO -> OIHW
    if kind == "dense_w":
        return np.transpose(v, (1, 0))  # (in, out) -> (out, in)
    return v


def rn25d_variables_to_state_dict(variables: Mapping, size: str
                                  ) -> Dict[str, torch.Tensor]:
    """RN25DPose flax variables ({'params', 'batch_stats'} nested dicts of
    numpy arrays) -> a state dict for the port's RN25DPose that loads with
    `load_state_dict(strict=True)`.  `num_batches_tracked` is set to 0."""
    flat = flatten(variables)
    out: Dict[str, torch.Tensor] = {}
    for torch_name, coll, flax_path, kind in rn25d_mapping(size):
        full = (coll,) + flax_path
        if full not in flat:
            raise KeyError(f"missing flax variable: {'/'.join(full)}")
        out[torch_name] = torch.tensor(_export_value(flat[full], kind))
        if torch_name.endswith("running_var"):
            out[torch_name.replace("running_var", "num_batches_tracked")] = (
                torch.zeros((), dtype=torch.int64))
    return out
