"""Hand-joint orderings and permutations between them (the port's copy of
peclr_tpu/geometry/joints.py: JOINT_ORDERS, permutation, WRIST, INDEX_MCP).

The canonical ("ait") order is wrist, then the five MCPs, PIPs, DIPs and
tips (thumb/index/middle/ring/pinky within each ring); FreiHAND (the
Zimmermann leaderboard order) lists each finger's four joints together.
"""

from __future__ import annotations

import numpy as np

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
}

WRIST = JOINT_ORDERS["ait"]["wrist"]          # 0
INDEX_MCP = JOINT_ORDERS["ait"]["index_mcp"]  # 2


def permutation(src: str, dst: str) -> np.ndarray:
    """Index array ``p`` such that ``joints_dst = joints_src[..., p, :]``."""
    src_map, dst_map = JOINT_ORDERS[src], JOINT_ORDERS[dst]
    p = np.zeros(NUM_JOINTS, dtype=np.int32)
    for name, d in dst_map.items():
        p[d] = src_map[name]
    return p
