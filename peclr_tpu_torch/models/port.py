"""Carry weights across from the reference's flax variables (port of the
name tables of peclr_tpu/models/port.py:34-133, :184-197, :226-237 and
:282-295).

Each table entry is (torch_name, collection, flax_path, kind) with kind
'conv' (HWIO -> OIHW), 'dense_w' ((in, out) -> (out, in)) or 'copy'.

Between torch layouts (a PeCLR checkpoint's encoder and torchvision's
ResNet) the conversion is a rename of keys: `peclr_to_torchvision`,
`torchvision_to_peclr_encoder`.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

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


def resnet_mapping(size: str, fc_out: Optional[int] = None) -> List[Entry]:
    """Name table of a torchvision-style ResNet: the encoder alone, or with
    `fc_out` set the final fc layer too (pose models)."""
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
    if fc_out is not None:
        entries.append(("fc.weight", "params", ("fc", "kernel"), "dense_w"))
        entries.append(("fc.bias", "params", ("fc", "bias"), "copy"))
    return entries


def projection_head_mapping() -> List[Entry]:
    """Sequential(Linear, BatchNorm1d, ReLU, Linear-no-bias) ->
    ProjectionHead{lin1, bn, lin2}."""
    return [
        ("0.weight", "params", ("lin1", "kernel"), "dense_w"),
        ("0.bias", "params", ("lin1", "bias"), "copy"),
        *_bn_entries("1", ("bn",)),
        ("3.weight", "params", ("lin2", "kernel"), "dense_w"),
    ]


#: the reference's PeCLR encoder packs the backbone into a Sequential
#: `features`: 0 conv1, 1 bn1, 2 relu, 3 max pool, 4..7 layer1..layer4
_FEATURES_INDEX = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5",
                   "layer3": "6", "layer4": "7"}


def _features_name(torch_name: str) -> str:
    """torchvision name -> 'features.N.*' Sequential name."""
    head, rest = torch_name.split(".", 1)
    return f"features.{_FEATURES_INDEX[head]}.{rest}"


def peclr_mapping(size: str) -> List[Entry]:
    """Reference PeCLR checkpoint keys <-> PeCLRModel flax variables."""
    encoder = [("encoder." + _features_name(tn), coll, ("encoder",) + fp, kind)
               for tn, coll, fp, kind in resnet_mapping(size)]
    head = [("projection_head." + tn, coll, ("projection_head",) + fp, kind)
            for tn, coll, fp, kind in projection_head_mapping()]
    return encoder + head


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


def resnet_pose_mapping(size: str) -> List[Entry]:
    """ResNetPose's torchvision keys <-> the reference's ResNetPose flax
    variables: the encoder's under `encoder`, fc at the top."""
    return [(tn, coll, fp if tn.startswith("fc.") else ("encoder",) + fp,
             kind) for tn, coll, fp, kind in resnet_mapping(size, fc_out=64)]


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


def variables_to_state_dict(variables: Mapping, mapping: List[Entry]
                            ) -> Dict[str, torch.Tensor]:
    """Flax variables ({'params', 'batch_stats'} nested dicts of numpy
    arrays) -> a state dict named by `mapping`; `num_batches_tracked` is set
    to 0 beside each running variance."""
    flat = flatten(variables)
    out: Dict[str, torch.Tensor] = {}
    for torch_name, coll, flax_path, kind in mapping:
        full = (coll,) + flax_path
        if full not in flat:
            raise KeyError(f"missing flax variable: {'/'.join(full)}")
        out[torch_name] = torch.tensor(_export_value(flat[full], kind))
        if torch_name.endswith("running_var"):
            out[torch_name.replace("running_var", "num_batches_tracked")] = (
                torch.zeros((), dtype=torch.int64))
    return out


def rn25d_variables_to_state_dict(variables: Mapping, size: str
                                  ) -> Dict[str, torch.Tensor]:
    """RN25DPose flax variables -> a state dict for the port's RN25DPose
    that loads with `load_state_dict(strict=True)`."""
    return variables_to_state_dict(variables, rn25d_mapping(size))


def resnet_pose_variables_to_state_dict(variables: Mapping, size: str
                                        ) -> Dict[str, torch.Tensor]:
    """ResNetPose flax variables -> a state dict for the port's ResNetPose
    that loads with `load_state_dict(strict=True)`."""
    return variables_to_state_dict(variables, resnet_pose_mapping(size))


def denoiser_variables_to_state_dict(variables: Mapping
                                     ) -> Dict[str, torch.Tensor]:
    """Denoiser flax variables ({lin1, bn1, lin2, bn2, lin3}) -> a state
    dict for the port's Denoiser (the z-root MLP's table: the same layers at
    the same Sequential indices)."""
    return variables_to_state_dict(variables, zroot_mlp_mapping())


def peclr_variables_to_state_dict(variables: Mapping, size: str
                                  ) -> Dict[str, torch.Tensor]:
    """PeCLRModel flax variables -> a state dict for the port's PeCLRModel
    that loads with `load_state_dict(strict=True)`."""
    return variables_to_state_dict(variables, peclr_mapping(size))


# ---------------------------------------------------------------------------
# Key renames between torch state dicts (port of the reference's
# peclr_to_torchvision and torchvision_to_peclr_encoder, :226-259, which do
# the same over flax variables)


def _renamed(state_dict: Mapping[str, torch.Tensor], size: str,
             name_of) -> Dict[str, torch.Tensor]:
    """The encoder entries of resnet_mapping(size), each read from
    state_dict[name_of(torchvision name)] and stored under the torchvision
    name, with `num_batches_tracked` beside each running variance (0 where
    the source has none).  Raises KeyError for a missing entry."""
    out: Dict[str, torch.Tensor] = {}
    for tv_name, _, _, _ in resnet_mapping(size):
        key = name_of(tv_name)
        if key not in state_dict:
            raise KeyError(f"missing checkpoint key: {key}")
        out[tv_name] = torch.as_tensor(state_dict[key])
        if tv_name.endswith("running_var"):
            tv_count = tv_name.replace("running_var", "num_batches_tracked")
            count = state_dict.get(name_of(tv_count))
            out[tv_count] = (torch.zeros((), dtype=torch.int64) if count is None
                             else torch.as_tensor(count))
    return out


def peclr_to_torchvision(state_dict: Mapping[str, torch.Tensor], size: str
                         ) -> Dict[str, torch.Tensor]:
    """A PeCLR checkpoint's encoder (`encoder.features.N.*`) under the
    torchvision keys (`conv1`, `bn1`, `layer1..4.*`, no fc); the projection
    head is left out."""
    return _renamed(state_dict, size,
                    lambda name: "encoder." + _features_name(name))


def torchvision_to_peclr_encoder(state_dict: Mapping[str, torch.Tensor],
                                 size: str, prefix: str = ""
                                 ) -> Dict[str, torch.Tensor]:
    """torchvision weights (keys under `prefix`; fc is ignored) as the
    encoder of a PeCLR checkpoint: `encoder.features.N.*`."""
    tv = _renamed(state_dict, size, lambda name: prefix + name)
    return {"encoder." + _features_name(k): v for k, v in tv.items()}
