"""Shape aliases of the recurring tensors (port of peclr_tpu/types.py).

Tensors are annotated by convention, not by NewTypes; these aliases name
the recurring shapes so signatures describe themselves.
"""

from __future__ import annotations

from typing import Any

#: (..., 21, 3): pixel u, v and scale-normalized root-relative depth
JOINTS_25D = Any
#: (..., 21, 3): metric camera-space coordinates
JOINTS_3D = Any
#: (...,): metric wrist -> index_mcp bone length
SCALE = Any
#: (..., 3, 3): camera intrinsics
CAMERA_PARAM = Any
#: (..., 3, 3): homogeneous 2D affine (source -> destination pixels)
AFFINE = Any
#: (B, H, W, 3) uint8: raw image canvas
IMAGE_U8 = Any
