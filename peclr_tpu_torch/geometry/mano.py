"""MANO-mesh -> 21-joint extraction (port of peclr_tpu/geometry/mano.py).

A fixed 16 x 778 linear regressor maps the MANO mesh vertices to 16 joints;
the 5 fingertips are mesh vertices.  The 21 joints come out in "mano" order
(geometry/joints.py).  The regressor is the package's own copy,
`assets/mano_mesh_to_joints_mat.npy`.
"""

from __future__ import annotations

import os

import numpy as np

_ASSET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets",
    "mano_mesh_to_joints_mat.npy",
)

#: mesh-vertex indices of the five fingertips (thumb..pinky)
FINGERTIP_VERTICES = np.array([744, 320, 443, 555, 672], dtype=np.int32)

_MANO_MAT = None


def mano_regressor() -> np.ndarray:
    """The (16, 778) joint-regressor matrix (loaded once)."""
    global _MANO_MAT
    if _MANO_MAT is None:
        _MANO_MAT = np.load(_ASSET)
    return _MANO_MAT


def pseudo_joint_bound(vertices: np.ndarray) -> np.ndarray:
    """21 pseudo-joints spanning the mesh's bounding box, a weak label for
    YT3DH: 5 at the max corner, 5 at the min corner, 5 at (min x, max y,
    min z), 5 at (max x, min y, max z), then the centre."""
    max_v = np.max(vertices, axis=0)
    min_v = np.min(vertices, axis=0)
    center = (max_v + min_v) / 2.0
    return np.concatenate([
        np.tile(max_v, (5, 1)),
        np.tile(min_v, (5, 1)),
        np.tile([min_v[0], max_v[1], min_v[2]], (5, 1)),
        np.tile([max_v[0], min_v[1], max_v[2]], (5, 1)),
        center[None, :],
    ]).astype(np.float32)


def joints_from_mano_mesh(vertices: np.ndarray) -> np.ndarray:
    """(..., 778, 3) mesh vertices -> (..., 21, 3) joints in mano order."""
    vertices = np.asarray(vertices, dtype=np.float32)
    joints16 = np.einsum("jv,...vc->...jc", mano_regressor(), vertices)
    tips = vertices[..., FINGERTIP_VERTICES, :]
    return np.concatenate([joints16, tips], axis=-2)
