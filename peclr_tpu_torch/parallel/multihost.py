"""Feeding a data-parallel step (port of peclr_tpu/parallel/multihost.py).

In the reference each process loads its slice of the global batch and the
slices are assembled into one globally sharded array.  A torch process holds
only its rows: the host pipeline decodes this rank's rows
(data/pipeline.py:HostPipeline with a mesh), and they are put on the rank's
device as they are; there is no global array to assemble.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from peclr_tpu_torch.parallel.mesh import Mesh


def global_batch_from_host_local(mesh: Mesh, tree: Dict[str, np.ndarray],
                                 copier: Optional[Callable] = None):
    """Put this process's rows of a batch on its device -> (tensors,
    copy-done event or None).  On the card through `copier`
    (data/pipeline.py:cuda_copier: pinned staging, a side stream); on the
    CPU as torch.from_numpy, with no event."""
    if mesh.device.type == "cuda":
        if copier is None:
            raise ValueError("a card's batch goes through a cuda_copier")
        return copier(tree)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}, None


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    """Rows this process loads of each global batch (the reference's
    assertion, which holds under `python -O` too)."""
    if global_batch % mesh.size:
        raise AssertionError((global_batch, mesh.size))
    return global_batch // mesh.size
