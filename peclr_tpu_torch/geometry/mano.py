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


def joints_from_mano_mesh(vertices: np.ndarray) -> np.ndarray:
    """(..., 778, 3) mesh vertices -> (..., 21, 3) joints in mano order."""
    vertices = np.asarray(vertices, dtype=np.float32)
    joints16 = np.einsum("jv,...vc->...jc", mano_regressor(), vertices)
    tips = vertices[..., FINGERTIP_VERTICES, :]
    return np.concatenate([joints16, tips], axis=-2)
