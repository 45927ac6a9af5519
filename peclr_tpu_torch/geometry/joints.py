"""Hand-joint orderings and permutations between them (the port's copy of
peclr_tpu/geometry/joints.py).

The canonical ("ait") order is wrist, then the five MCPs, PIPs, DIPs and
tips (thumb/index/middle/ring/pinky within each ring); FreiHAND (the
Zimmermann leaderboard order) lists each finger's four joints together;
InterHand lists each finger tip first and the wrist last; MANO is the
regressor's output order (16 regressed joints, then the 5 fingertips).
"""

from __future__ import annotations

import numpy as np
import torch

NUM_JOINTS = 21

_FINGERS = ("thumb", "index", "middle", "ring", "pinky")
_RINGS = ("mcp", "pip", "dip", "tip")

AIT_JOINT_NAMES = ("wrist",) + tuple(
    f"{finger}_{ring}" for ring in _RINGS for finger in _FINGERS
)

JOINT_ORDERS: dict[str, dict[str, int]] = {
    "ait": {name: i for i, name in enumerate(AIT_JOINT_NAMES)},
    "freihand": {
        "wrist": 0,
        **{
            f"{finger}_{ring}": 1 + 4 * fi + ri
            for fi, finger in enumerate(_FINGERS)
            for ri, ring in enumerate(_RINGS)
        },
    },
    "interhand": {
        "wrist": 20,
        **{
            f"{finger}_{ring}": 4 * fi + (3 - ri)
            for fi, finger in enumerate(_FINGERS)
            for ri, ring in enumerate(_RINGS)
        },
    },
    "mano": {
        "wrist": 0,
        "index_mcp": 1, "index_pip": 2, "index_dip": 3,
        "middle_mcp": 4, "middle_pip": 5, "middle_dip": 6,
        "pinky_mcp": 7, "pinky_pip": 8, "pinky_dip": 9,
        "ring_mcp": 10, "ring_pip": 11, "ring_dip": 12,
        "thumb_mcp": 13, "thumb_pip": 14, "thumb_dip": 15,
        "thumb_tip": 16, "index_tip": 17, "middle_tip": 18,
        "ring_tip": 19, "pinky_tip": 20,
    },
}

WRIST = JOINT_ORDERS["ait"]["wrist"]          # 0
INDEX_MCP = JOINT_ORDERS["ait"]["index_mcp"]  # 2
MIDDLE_MCP = JOINT_ORDERS["ait"]["middle_mcp"]  # 3
MIDDLE_PIP = JOINT_ORDERS["ait"]["middle_pip"]  # 8


def permutation(src: str, dst: str) -> np.ndarray:
    """Index array ``p`` such that ``joints_dst = joints_src[..., p, :]``."""
    src_map, dst_map = JOINT_ORDERS[src], JOINT_ORDERS[dst]
    p = np.zeros(NUM_JOINTS, dtype=np.int32)
    for name, d in dst_map.items():
        p[d] = src_map[name]
    return p


def reorder(joints, src: str, dst: str):
    """Joints (..., 21, C), numpy or torch, from order `src` to `dst`."""
    p = permutation(src, dst)
    if isinstance(joints, torch.Tensor):
        return joints[..., torch.from_numpy(p).long().to(joints.device), :]
    return joints[..., p, :]


def freihand_to_ait(joints):
    return reorder(joints, "freihand", "ait")


def ait_to_freihand(joints):
    """AIT -> FreiHAND/Zimmermann order (the leaderboard's)."""
    return reorder(joints, "ait", "freihand")


def mano_to_ait(joints):
    return reorder(joints, "mano", "ait")


def interhand_to_ait(joints):
    return reorder(joints, "interhand", "ait")
