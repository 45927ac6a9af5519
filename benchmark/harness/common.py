"""Discovery of the benchmark's data files and the timing helpers.

`chained_seconds`, `host_waits` and `card_name` are frozen copies of
peclr_tpu_torch/scripts/__init__.py at commit 9dfdca3; `route_launches`
and `check_launches` are the launch-count check of
peclr_tpu_torch/bench.py:check at the same commit.  They live here so that
a change to the program cannot change how it is measured.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
import warnings
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(BENCH_DIR)

#: top-level module names that no run may hold once its window has closed,
#: compared whole (the port's name begins with the JAX package's)
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "peclr_tpu"})


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def data_file(kind: str, name: str, root: str = BENCH_DIR) -> dict:
    """The JSON file `<root>/<kind>/<name>.json` (kind: configs, traffic,
    workloads)."""
    path = os.path.join(root, kind, f"{name}.json")
    if not os.path.isfile(path):
        raise SystemExit(f"benchmark: no {kind} file named {name!r} "
                         f"({path})")
    return read_json(path)


def load_module(path: str, name: str):
    """The Python file at `path` as a module named `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry_module(name: str, root: str = BENCH_DIR):
    path = os.path.join(root, "entries", f"{name}.py")
    if not os.path.isfile(path):
        raise SystemExit(f"benchmark: no entry named {name!r} ({path})")
    return load_module(path, f"_bench_entry_{name}")


def metric_readers(root: str = BENCH_DIR) -> Dict[str, object]:
    """{metric name: module} of every file under metrics/, named by the
    file's name without `.py`; a module has KIND (end_to_end or
    per_layer), UNIT and read(ctx)."""
    out = {}
    folder = os.path.join(root, "metrics")
    for fname in sorted(os.listdir(folder)):
        if fname.endswith(".py") and not fname.startswith("_"):
            name = fname[:-3]
            module = load_module(os.path.join(folder, fname),
                                 "_bench_metric_" + name.replace(".", "_")
                                 .replace("-", "_"))
            out[name] = module
    return out


def resolve_workload(name: str, root: str = BENCH_DIR) -> dict:
    """The cell's workload file with its config and traffic files read in."""
    spec = dict(data_file("workloads", name, root))
    spec["name"] = name
    spec["config_data"] = data_file("configs", spec["config"], root)
    spec["traffic_data"] = data_file("traffic", spec["traffic"], root)
    return spec


def forbidden_modules() -> List[str]:
    """Names in sys.modules whose top-level part is a forbidden one."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN_MODULES)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def chained_seconds(run: Callable[[], object], device) -> float:
    """Seconds from the call of run() until the card has done the work it
    queued, the queue empty at the start: one wait, at the end.  run() must
    not wait on the card itself."""
    sync(device)
    t0 = time.perf_counter()
    run()
    sync(device)
    return time.perf_counter() - t0


def host_waits(run: Callable[[], object]) -> list:
    """Run run() once under torch.cuda.set_sync_debug_mode("warn") and
    return each wait on the card that torch reports, as its innermost call
    sites in the checkout, "file:line".  Empty on the CPU."""
    import torch

    if not torch.cuda.is_available():
        run()
        return []
    waits = []

    def record(message, category, filename, lineno, file=None, line=None):
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


def card_name(device) -> str:
    """nvidia-smi's `name, power.limit` of the card, or the device type."""
    import torch

    if device.type != "cuda":
        return device.type
    index = torch.cuda.current_device() if device.index is None else device.index
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(index) + ", power limit unread"


#: the warp kernel each route launches (bench_multichip.ROUTE_KERNEL)
ROUTE_KERNEL = {"grouped": "shift_lerp_grouped", "nhwc": "shift_lerp_flat",
                "matmul": "shift_lerp_matmul"}


def route_launches() -> Dict[str, int]:
    """Each warp kernel's launches so far in this process, as the program
    counts them."""
    from peclr_tpu_torch.ops.shift_lerp import (
        fused_shift_lerp,
        fused_shift_lerp_grouped,
    )
    from peclr_tpu_torch.ops.shift_lerp_matmul import fused_shift_lerp_matmul

    return {"shift_lerp_grouped": fused_shift_lerp_grouped.launches,
            "shift_lerp_flat": fused_shift_lerp.launches,
            "shift_lerp_matmul": fused_shift_lerp_matmul.launches}


def check_launches(before: Dict[str, int], after: Dict[str, int],
                   units: int, route: str, per_unit: int):
    """(gap, note): the largest distance, over the warp kernels, of the
    launches a unit of work from those due (`per_unit` of the route's
    kernel, none of another), 0 where they are as due; the note says what
    ran a unit and what was due."""
    got = {k: (after[k] - before[k]) / max(units, 1) for k in after}
    want = {k: per_unit if k == ROUTE_KERNEL[route] else 0 for k in after}
    gap = max(abs(got[k] - want[k]) for k in after)
    return gap, f"launched {got} a unit, want {want}"

