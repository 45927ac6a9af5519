"""Data-parallel process groups (port of peclr_tpu/parallel/mesh.py).

The reference scales data-parallel over the "data" axis of a mesh: its step
is one jit over the global batch and XLA inserts the collectives.  Here a
rank is a process with one device (torch.distributed).  Each rank holds its
rows of every microbatch (`shard_batch`), and the step computes the
BatchNorm statistics, NT-Xent and the gradient over the global batch with
explicit collectives (parallel/collectives.py, DistributedDataParallel), so
its result equals the global-view step's up to summation order.

The "model" axis: the reference declares it but shards nothing over it, and
no caller passes it, so `make_mesh` refuses model > 1.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import warnings
from datetime import timedelta
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from peclr_tpu_torch.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass
class Mesh:
    """This process's place in the data axis: `rank` of `size`, its
    `device`, the process group and its backend; `owns_group` where
    make_mesh brought the group up (and `close` takes it down)."""

    group: dist.ProcessGroup
    rank: int
    size: int
    device: torch.device
    backend: str
    owns_group: bool = False
    _ddp: Dict[int, nn.Module] = dataclasses.field(default_factory=dict,
                                                   repr=False)

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)

    def broadcast_object(self, obj):
        """Rank 0's `obj` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group,
                                   device=self.device)
        return box[0]

    def ddp(self, model: nn.Module) -> nn.Module:
        """The one DistributedDataParallel wrapper of `model` on this mesh,
        made at the first call: one gradient all-reduce a sync backward
        (the caller skips the others with `no_sync()`); no buffer broadcast,
        since the BatchNorm running statistics are equal on every rank
        already; gradients are views of the all-reduce buckets."""
        wrapped = self._ddp.get(id(model))
        if wrapped is None or wrapped.module is not model:
            with warnings.catch_warnings():
                # newer torch names it forward_sync_buffers, and says to
                # keep broadcast_buffers=False until then
                warnings.filterwarnings("ignore", ".*broadcast_buffers",
                                        FutureWarning)
                wrapped = nn.parallel.DistributedDataParallel(
                    model,
                    device_ids=([self.device.index]
                                if self.device.type == "cuda" else None),
                    process_group=self.group, broadcast_buffers=False,
                    gradient_as_bucket_view=True)
            self._ddp[id(model)] = wrapped
        return wrapped

    def close(self) -> None:
        """Destroy the process group where make_mesh brought it up; one
        that the caller brought up is the caller's to destroy."""
        self._ddp.clear()
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def make_mesh(data: Optional[int] = None, model: int = 1,
              device: DeviceLike = None, backend: Optional[str] = None,
              rank: Optional[int] = None, init_method: str = "env://",
              timeout: Optional[float] = None) -> Mesh:
    """Join (or adopt, where it is up already) the default process group
    and return this rank's Mesh.

    data: the number of ranks; None reads the launcher's WORLD_SIZE (RANK
    and LOCAL_RANK too), as torch.distributed.run sets them.  device: None
    or "cuda" is the card LOCAL_RANK (through resolve_device, which keeps
    TF32 off); an indexed device is taken as it is.  backend: NCCL on the
    card, gloo on the CPU, unless asked for (gloo on CUDA tensors runs
    several ranks on one card, which NCCL refuses).  timeout: seconds a
    collective may wait before it fails."""
    if model != 1:
        raise ValueError(
            f"model={model}: the port has no model axis (the reference "
            "declares one but shards nothing over it, and no caller passes "
            "it); data parallelism is the only parallelism")
    env = os.environ
    if dist.is_initialized():
        size = dist.get_world_size() if data is None else data
        rank = dist.get_rank() if rank is None else rank
    else:
        if data is None and "WORLD_SIZE" not in env:
            raise ValueError("make_mesh(data=None) reads WORLD_SIZE, RANK and "
                             "LOCAL_RANK, which torch.distributed.run sets")
        size = int(env["WORLD_SIZE"]) if data is None else data
        rank = int(env.get("RANK", 0)) if rank is None else rank
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_size = int(env.get("LOCAL_WORLD_SIZE", size))
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and local_size > torch.cuda.device_count():
        raise ValueError(
            f"{local_size} ranks on this host and {torch.cuda.device_count()} "
            "cards: NCCL takes one card a rank (two ranks on one card fail "
            "with 'Duplicate GPU detected'); run one rank a card, or ask for "
            "backend='gloo'")
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    adopted = dist.is_initialized()
    if adopted:
        have = (dist.get_world_size(), dist.get_rank(), dist.get_backend())
        if have != (size, rank, backend):
            raise ValueError(f"the process group is up as (world, rank, "
                             f"backend) {have}, not {(size, rank, backend)}")
    else:
        dist.init_process_group(
            backend, init_method=init_method, world_size=size, rank=rank,
            timeout=None if timeout is None else timedelta(seconds=timeout))
    return Mesh(dist.group.WORLD, rank, size, dev, backend,
                owns_group=not adopted)


def local_rows(mesh: Mesh, n: int, accum: int = 1) -> np.ndarray:
    """The indices of this rank's rows of a global batch of n rows in accum
    microbatches of B = n / accum: rows [k·B + r·B/W, k·B + (r+1)·B/W) of
    each microbatch k, for rank r of W, in order."""
    if n % accum:
        raise ValueError(f"a batch of {n} rows does not split into {accum} "
                         "microbatches")
    micro = n // accum
    if micro % mesh.size:
        raise ValueError(f"a microbatch of {micro} rows does not split over "
                         f"{mesh.size} ranks: each rank must hold a whole "
                         "number of its rows")
    share = micro // mesh.size
    start = np.arange(accum)[:, None] * micro + mesh.rank * share
    return (start + np.arange(share)).reshape(-1)


def shard_batch(mesh: Mesh, batch: Dict, accum: int = 1) -> Dict:
    """This rank's rows of a global batch (numpy arrays or tensors with the
    same leading n), in the microbatch-interleaved layout of `local_rows`:
    the rank's microbatch k is its share of the global microbatch k.  A
    tensor is cut where it lies, by a strided view, with no index sent from
    the host (a copy from the host's memory would wait for the card).

    The reference's shard_batch splits the step's batch into contiguous
    blocks and XLA re-shards as the step needs; its global-view semantics
    make the result the same as this layout's."""
    n = len(next(iter(batch.values())))
    rows = local_rows(mesh, n, accum)  # checks that the rows split evenly
    share = len(rows) // accum
    out = {}
    for key, value in batch.items():
        if len(value) != n:
            raise ValueError(f"{key} has {len(value)} rows, not {n}")
        rest = tuple(value.shape[1:])
        out[key] = value.reshape((accum, mesh.size, share) + rest)[
            :, mesh.rank].reshape((accum * share,) + rest)
    return out


@torch.no_grad()
def replicated(mesh: Mesh, module: nn.Module) -> nn.Module:
    """Broadcast `module`'s parameters and buffers from rank 0, in place."""
    for tensor in itertools.chain(module.parameters(), module.buffers()):
        dist.broadcast(tensor, src=0, group=mesh.group)
    return module
