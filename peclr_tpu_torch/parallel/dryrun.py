"""The multi-process dry run, counterpart of
__graft_entry__.dryrun_multichip / _dryrun_impl, and `spawn`, which runs a
function once a rank in fresh processes joined into one process group.

    python -c "from peclr_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(2)"

It spawns n gloo processes and runs one data-parallel PeCLR step at the
reference's dry-run shapes: RN18, 64² canvases to 32² views, accum 2, 2 rows
a rank of each microbatch.  On the card every rank uses the card rank mod
the card count (gloo runs several ranks on one card, where NCCL refuses).
"""

from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

#: seconds a rank may wait in a collective, and the dry run may take
TIMEOUT_S = 600.0
#: seconds between spawn's looks at its ranks while it waits for results
_POLL_S = 1.0


def _rank_main(fn, rank, world, init_method, device, backend, timeout, args,
               results):
    import torch.distributed as dist

    from peclr_tpu_torch.parallel.mesh import make_mesh

    try:
        torch.set_num_threads(1)
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        mesh = make_mesh(data=world, rank=rank, device=dev, backend=backend,
                         init_method=init_method, timeout=timeout)
        results.put((rank, True, pickle.dumps(fn(mesh, *args))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence = (), device=None,
          backend: Optional[str] = None, timeout: float = TIMEOUT_S
          ) -> List[Any]:
    """Run fn(mesh, *args) in `world` fresh processes (the spawn start
    method), one a rank of a new process group that meets through a file in
    a temporary directory, and return their results by rank.  `device` is
    the card when None (device.py:resolve_device, which raises here, before
    any process starts, where there is none); an unindexed "cuda" gives rank
    r the card r mod the card count.  fn must be
    importable by name, and its arguments and result must pickle (numpy
    arrays and numbers; tensors go as torch pickles them).  A rank's
    exception re-raises here with its traceback and stops the other ranks;
    so does a run longer than `timeout` seconds, which also bounds each
    collective's wait."""
    import multiprocessing as mp

    from peclr_tpu_torch.device import resolve_device

    if device is None or torch.device(device).type == "cuda":
        resolve_device(device)  # raises without a card
        device = "cuda" if device is None else device
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = tempfile.mkdtemp(prefix="peclr_spawn_")
    init_method = "file://" + os.path.join(store, "rendezvous")
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, rank, world, init_method, str(device), backend, timeout,
        tuple(args), results)) for rank in range(world)]
    deadline = time.monotonic() + timeout
    out: List[Any] = [None] * world
    try:
        for proc in procs:
            proc.start()
        returned = set()
        while len(returned) < world:
            # wake each second to see whether a rank died without a result
            # (one that failed to start, or was killed)
            left = deadline - time.monotonic()
            try:
                rank, ok, payload = results.get(
                    timeout=max(min(left, _POLL_S), 0.0))
            except queue.Empty:
                dead = {i: p.exitcode for i, p in enumerate(procs)
                        if i not in returned and p.exitcode not in (None, 0)}
                if dead and results.empty():
                    raise RuntimeError(
                        f"spawn: ranks {sorted(dead)} exited with codes "
                        f"{list(dead.values())} before returning a "
                        "result") from None
                if left <= 0:
                    raise TimeoutError(
                        f"spawn: {world} ranks did not finish in {timeout} "
                        "s") from None
                continue
            returned.add(rank)
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{payload}")
            out[rank] = pickle.loads(payload)
        for proc in procs:
            proc.join(timeout=max(deadline - time.monotonic(), 1.0))
            if proc.is_alive():
                raise TimeoutError(f"spawn: rank process {proc.pid} did not "
                                   "exit after returning its result")
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10.0)
        results.close()
        shutil.rmtree(store, ignore_errors=True)
    return out


def dryrun_model(device):
    """The dry run's RN18 PeCLR model on `device`, its weights drawn from
    seed 0 as the reference's `model.init` draws them."""
    from peclr_tpu_torch.models import PeCLRModel
    from peclr_tpu_torch.models.init import init_as_reference

    return init_as_reference(PeCLRModel("18"), 0).to(device)


def _dryrun_rank(mesh):
    from peclr_tpu_torch.config.defaults import (
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.parallel.mesh import replicated, shard_batch
    from peclr_tpu_torch.train.optimizer import build_optimizer
    from peclr_tpu_torch.train.state import TrainState
    from peclr_tpu_torch.train.step import make_peclr_train_step

    model = replicated(mesh, dryrun_model(mesh.device))
    opt, _ = build_optimizer(model, base_lr=1e-4, batch_size=2 * mesh.size,
                             accum=2, steps_per_epoch=4, epochs=2,
                             warmup_epochs=1)
    state = TrainState(model, opt)
    step = make_peclr_train_step(
        model, opt, peclr_pretrain_flags(),
        AugmentationParams(resize_shape=(32, 32)), accum=2, precision="f32",
        mesh=mesh)
    rng = np.random.default_rng(0)
    n = mesh.size * 2 * 2  # accum 2 x 2 rows a rank
    batch = {
        "image": rng.integers(0, 256, size=(n, 64, 64, 3), dtype=np.uint8),
        "joints25d": np.concatenate([
            rng.uniform(16, 48, (n, 21, 2)).astype(np.float32),
            rng.normal(size=(n, 21, 1)).astype(np.float32)], axis=-1),
    }
    local = {k: torch.from_numpy(v).to(mesh.device)
             for k, v in shard_batch(mesh, batch, accum=2).items()}
    gen = torch.Generator(device=mesh.device).manual_seed(1)
    state, metrics = step(state, local, gen)
    return metrics["loss"].item(), state.step


def dryrun_multichip(n: int, device="cuda") -> float:
    """One data-parallel step over n gloo ranks at the dry-run shapes;
    asserts a finite loss, equal on every rank, and step 1, prints
    `dryrun_multichip(n): loss=… OK` and returns the loss."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    results = spawn(_dryrun_rank, n, device=device, backend="gloo")
    losses = [loss for loss, _ in results]
    if not (np.isfinite(losses[0]) and len(set(losses)) == 1):
        raise AssertionError(f"dryrun_multichip({n}): losses {losses}")
    if any(step != 1 for _, step in results):
        raise AssertionError(f"dryrun_multichip({n}): steps "
                             f"{[s for _, s in results]}")
    print(f"dryrun_multichip({n}): loss={losses[0]:.4f} OK", flush=True)
    return losses[0]
