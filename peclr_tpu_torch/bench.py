"""Benchmark: aug+train images/sec/chip of the PeCLR pretrain step on the
card (port of the reference repository's bench.py).

    python -m peclr_tpu_torch.bench                  # RN50 recipe, grouped
    python -m peclr_tpu_torch.bench --route matmul
    BENCH_RESNET=152 python -m peclr_tpu_torch.bench
    BENCH_RESNET=18 BENCH_BATCH=2 BENCH_ACCUM=1 BENCH_ITERS=2 \\
        python -m peclr_tpu_torch.bench --device cpu   # a tiny CPU run

Runs the trainer's hot path: the seeded recipe state
(train/recipe.py:build_pretrain_state), a synthetic batch of BENCH_BATCH
x BENCH_ACCUM canvases resident on the card (synthetic_pretrain_batch) and
make_peclr_train_step with the recipe's flags, 224² canvases to 128²
views, with_stats=False, bf16 autocast on the card.

Knobs, the reference's names and defaults: BENCH_BATCH (128), BENCH_ACCUM
(16), BENCH_ITERS (6), BENCH_WINDOWS (3), BENCH_RESNET (50).  --route
picks the warp (ops/augment.py:ROUTES) where the reference read its
PECLR_SHIFT* knobs; --device defaults to the card.  The reference's XLA
knobs (BENCH_UNROLL, BENCH_COMPILER_OPTIONS, BENCH_STATS_ACCUM,
JAX_COMPILATION_CACHE_DIR) have no counterpart: torch runs the step
eagerly.

The estimator is the reference's: WARMUP steps and one wait on the card,
then BENCH_WINDOWS windows of BENCH_ITERS steps chained state to state,
each timed by scripts.chained_seconds (one wait at each end); the value
is the best window's img/s.  The last two warm-up steps run under
scripts.host_waits, so a wait on the card inside the step is seen without
watching a timed window.  The draws come from one generator on the
device, seeded 0 (torch cannot replay jax.random's fold_in).

Stdout gets ONE JSON line with the reference's keys: metric, value, unit,
vs_baseline and estimator.  vs_baseline is null: the reference's 4,000
img/s is a TPU v4 target.  Before it, stderr gets the card's name and
power limit, then one JSON object: each window's seconds, the first
warm-up loss, each warp kernel's launches a step in the last window and
the peak memory.  A run exits nonzero when the card is missing, a kernel
does not build or launch, the first warm-up loss is not finite, a kernel
route does not launch its kernel 2 x accum times a step (or launches
another), or the host waits on the card inside the step.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Callable, Dict, Optional

import torch

from peclr_tpu_torch import scripts as common
from peclr_tpu_torch.ops.augment import ROUTES

#: the reference's knobs and their defaults (bench.py:25-30)
KNOBS = {"BENCH_BATCH": "128", "BENCH_ACCUM": "16", "BENCH_ITERS": "6",
         "BENCH_WINDOWS": "3", "BENCH_RESNET": "50"}
#: steps before the first window, as the reference's; the last
#: WATCHED_WARMUP of them run under scripts.host_waits
WARMUP = 3
WATCHED_WARMUP = 2


def knobs(environ: Optional[Dict[str, str]] = None) -> dict:
    """The BENCH_* knobs from `environ` (default os.environ)."""
    env = os.environ if environ is None else environ
    value = {k: env.get(k, default) for k, default in KNOBS.items()}
    return {"batch": int(value["BENCH_BATCH"]),
            "accum": int(value["BENCH_ACCUM"]),
            "iters": int(value["BENCH_ITERS"]),
            "windows": int(value["BENCH_WINDOWS"]),
            "resnet": value["BENCH_RESNET"]}


def build(resnet: str, batch: int, accum: int, route: str,
          device: torch.device):
    """(state, step, batch dict) of the recipe step at `batch` x `accum`
    on `route`, the batch resident on `device`."""
    from peclr_tpu_torch.scripts.profile_step import build as build_step
    from peclr_tpu_torch.train.recipe import synthetic_pretrain_batch

    state, step = build_step(batch, accum, resnet=resnet, route=route,
                             device=device)
    return state, step, synthetic_pretrain_batch(batch * accum, device=device)


def run(step: Callable, state, batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator], iters: int, windows: int,
        device: torch.device):
    """(state, report) after WARMUP steps and `windows` chained windows of
    `iters` steps: report holds each window's seconds, the first warm-up
    loss, the host's waits in the watched warm-up steps (call sites) and
    each warp kernel's launches a step in the last window."""
    from peclr_tpu_torch.scripts.bench_multichip import kernel_launches

    def steps(n):
        nonlocal state
        for _ in range(n):
            state, _ = step(state, batch, generator)

    state, metrics = step(state, batch, generator)
    first_loss = metrics["loss"]
    waits = common.host_waits(lambda: steps(WATCHED_WARMUP))
    common.sync(device)
    seconds = []
    for w in range(windows):
        if w == windows - 1:
            before = kernel_launches()
        seconds.append(common.chained_seconds(lambda: steps(iters), device))
    after = kernel_launches()
    return state, {
        "window_seconds": seconds,
        "first_warmup_loss": first_loss.item(),
        "host_waits": waits,
        "launches_per_step": {k: (after[k] - before[k]) / iters
                              for k in after},
    }


def check(report: dict, route: str, accum: int,
          device: torch.device) -> None:
    """Ends the run (SystemExit, nonzero) on a non-finite first loss, a
    wait on the card, or, on the card, launches off 2 x accum of the
    route's kernel and 0 of the others."""
    from peclr_tpu_torch.scripts.bench_multichip import ROUTE_KERNEL

    if not math.isfinite(report["first_warmup_loss"]):
        raise SystemExit(f"bench: first warm-up loss "
                         f"{report['first_warmup_loss']}")
    if report["host_waits"]:
        raise SystemExit(f"bench: the host waited on the card inside the "
                         f"step at {report['host_waits']}")
    if device.type == "cuda":  # the CPU runs the plain versions, uncounted
        got = report["launches_per_step"]
        want = {k: 2 * accum if k == ROUTE_KERNEL.get(route) else 0
                for k in got}
        if got != want:
            raise SystemExit(f"bench: {route} launched {got} a step, want "
                             f"{want}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--route", default="grouped", choices=ROUTES,
                    help="the warp's route (ops/augment.py:ROUTES)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Time the step, print the JSON line and return it as a dict."""
    from peclr_tpu_torch.device import resolve_device

    args = parse_args(argv)
    dev = resolve_device(args.device)
    k = knobs()
    if k["iters"] < 1 or k["windows"] < 1:
        raise SystemExit(f"bench: BENCH_ITERS {k['iters']} and "
                         f"BENCH_WINDOWS {k['windows']} must be at least 1")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state, step, batch = build(k["resnet"], k["batch"], k["accum"],
                               args.route, dev)
    generator = torch.Generator(device=dev).manual_seed(0)
    state, report = run(step, state, batch, generator, k["iters"],
                        k["windows"], dev)
    print(common.card_name(dev), file=sys.stderr, flush=True)
    print(json.dumps({
        "resnet": k["resnet"], "route": args.route, "device": str(dev),
        "precision": "bf16 autocast" if dev.type == "cuda" else "f32",
        **report, "host_waits": len(report["host_waits"]),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
    }), file=sys.stderr, flush=True)
    check(report, args.route, k["accum"], dev)
    img_per_sec = (k["batch"] * k["accum"] * k["iters"]
                   / min(report["window_seconds"]))
    record = {
        "metric": f"aug+train images/sec/chip (RN{k['resnet']} PeCLR, "
                  f"microbatch {k['batch']} x accum {k['accum']}, bf16)",
        "value": round(img_per_sec, 1),
        "unit": "images/sec/chip",
        # the reference's 4,000 img/s baseline is a TPU v4 target
        "vs_baseline": None,
        "estimator": f"min_of_{k['windows']}_windows_x_{k['iters']}_iters",
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
