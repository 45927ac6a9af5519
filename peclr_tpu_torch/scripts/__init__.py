"""The harnesses of the port, counterparts of the reference repository's
scripts/ of the same names:

    python -m peclr_tpu_torch.scripts.accuracy_proxy [...]
    python -m peclr_tpu_torch.scripts.downstream_chain [...]
    python -m peclr_tpu_torch.scripts.profile_step [...]
    python -m peclr_tpu_torch.scripts.bench_serving [...]
    python -m peclr_tpu_torch.scripts.bench_decode [...]
    python -m peclr_tpu_torch.scripts.bench_host_pipeline [...]
    python -m peclr_tpu_torch.scripts.bench_pred_pipeline [...]
    python -m peclr_tpu_torch.scripts.trace_buckets TRACE.json [top_n]
    python -m peclr_tpu_torch.scripts.bench_multichip [...]
    python -m peclr_tpu_torch.scripts.multihost_harness [...]
    python -m peclr_tpu_torch.scripts.bench_streams [...]
    python -m peclr_tpu_torch.scripts.bench_guard [...]

Each runs on the card unless given `--device cpu`.  The accuracy
harnesses write their artifacts under tests/fixtures/torch_accuracy/, the
measurement scripts under tests/fixtures/torch_bench/.  This module holds
what they share: the card's name for the records, the step loop, the
timed window that ends in the one wait on the card, and the count of the
host's waits inside such a window.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Callable, Dict, Optional, Tuple

import torch

# the accuracy scripts' name for it, kept importable from here
from peclr_tpu_torch.models.init import init_as_reference  # noqa: F401

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ARTIFACT_DIR = os.path.join(REPO_ROOT, "tests", "fixtures", "torch_accuracy")
BENCH_DIR = os.path.join(REPO_ROOT, "tests", "fixtures", "torch_bench")


def card_name(device: torch.device) -> str:
    """nvidia-smi's `name, power.limit` of the card the run used, or the
    device's type where it is not a card."""
    if device.type != "cuda":
        return device.type
    index = torch.cuda.current_device() if device.index is None else device.index
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def run_steps(step: Callable, state, steps: int,
              batch_at: Callable[[int], Dict[str, torch.Tensor]],
              generator: Optional[torch.Generator],
              after: Optional[Callable[[int, object], None]] = None
              ) -> Tuple[object, Dict[str, torch.Tensor]]:
    """`steps` calls of step(state, batch_at(i), generator), after(i + 1,
    state) after each; returns the state and the last step's metrics, which
    stay on the device.  Nothing here waits on the card."""
    metrics: Dict[str, torch.Tensor] = {}
    for i in range(steps):
        state, metrics = step(state, batch_at(i), generator)
        if after is not None:
            after(i + 1, state)
    return state, metrics


def sync(device: torch.device) -> None:
    """Wait for the work queued on `device` (nothing to wait for on the
    CPU, which runs each op when it is called)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def chained_seconds(run: Callable[[], object], device: torch.device) -> float:
    """Seconds from the call of run() until the card has done the work it
    queued, the queue empty at the start: one wait, at the end.  run() must
    not wait on the card itself (the card's harness watches this window
    for waits)."""
    sync(device)
    t0 = time.perf_counter()
    run()
    sync(device)
    return time.perf_counter() - t0


def host_waits(run: Callable[[], object]) -> list:
    """Run run() once under torch.cuda.set_sync_debug_mode("warn") and
    return each wait on the card that torch reports (a copy from pageable
    host memory, .item(), a checked linalg call, ...) as its innermost call
    sites in this repository, "file:line"; a wait in a backward pass is
    reported at its .backward().  Empty on the CPU, where nothing waits."""
    import traceback
    import warnings

    if not torch.cuda.is_available():
        run()
        return []
    waits = []

    def record(message, category, filename, lineno, file=None, line=None):
        # not the note that the debug mode is a prototype
        if "called a synchronizing CUDA operation" in str(message):
            waits.append([
                f"{os.path.relpath(fr.filename, REPO_ROOT)}:{fr.lineno}"
                for fr in traceback.extract_stack()[:-1]
                if fr.filename.startswith(REPO_ROOT)][-4:])

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return waits


def cpu_cores() -> int:
    """The cores this process may run on."""
    return len(os.sched_getaffinity(0))


def write_artifact(path: str, record: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {path}")
