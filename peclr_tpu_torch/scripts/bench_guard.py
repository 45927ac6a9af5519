"""Perf guard of the port: the reference's four phases re-measured on the
card in one process, serially, each held to the card's own reference
throughput within a band (port of the reference repository's
scripts/bench_guard.py).

    python -m peclr_tpu_torch.scripts.bench_guard     # on the card
    python -m peclr_tpu_torch.scripts.bench_guard --check
    python -m peclr_tpu_torch.scripts.bench_guard --calibrate RUN.json ...

Phases (scripts/profile_step.py's builds and its chained-window estimator):
`pretrain_rn50` and `pretrain_rn152`, the PeCLR recipe step at 128 x 16
under bf16 autocast on the grouped warp route (`build`, `chain_time`);
`finetune`, the RN25D fine-tune step at batch 128 of 224² (`run_finetune`);
`pred`, the two-pass predictor on a batch of 128 224² frames (`run_pred`).
Each phase's time is the best of --windows windows of --iters chained
iterations, each window after profile_step's warm-up.  For finetune and
pred the first window is also profiled (`profile_window`), so their
device busy ms a step is measured in the same run, beside the wall ms and
the gap between them.

REFERENCE holds the card's img/s from its first full runs, at least three
in turns: each phase's median, and its band, the lowest run over the
median rounded down to 0.01 and never above 0.98, so that each of those
runs passes (`--calibrate` computes both from the runs' artifacts).  The run writes tests/fixtures/torch_bench/bench_guard.json,
stamped with the card's name and power limit and a hash of the hot-path
sources (HOT_PATHS: Python, CUDA and C++), and exits 1 when a phase misses
its band.  `--check` reports whether that artifact is stale against the
tree (exit 1 when it is); the tests do not fail on a stale artifact.

The card runs it by default; `--device cpu` runs the same phases on the
CPU, whose rates are not the card's (no band holds there).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import statistics
import subprocess
import time
from typing import Optional, Sequence

import torch

from peclr_tpu_torch import scripts as common
from peclr_tpu_torch.scripts import profile_step as ps

REPO = common.REPO_ROOT
DEFAULT_OUT = os.path.join(common.BENCH_DIR, "bench_guard.json")

#: the card's img/s (the median of its first full runs) and each phase's
#: band (measured >= band * img_s), from --calibrate over those runs on an
#: "NVIDIA H100 80GB HBM3, 700.00 W" (PERF.md §6)
REFERENCE = {
    "pretrain_rn50": {"img_s": 3328.7, "band": 0.83},
    "pretrain_rn152": {"img_s": 1456.0, "band": 0.97},
    "finetune": {"img_s": 808.1, "band": 0.98},
    "pred": {"img_s": 1531.8, "band": 0.98},
}
#: the ResNet of each phase, and the phases whose busy ms is measured
PHASE_RESNET = {"pretrain_rn50": "50", "pretrain_rn152": "152",
                "finetune": "50", "pred": "50"}
PROFILED = ("finetune", "pred")
#: a band is never looser than the lowest run allows, nor tighter than this
MAX_BAND = 0.98

#: the port's device hot path: any change here makes the committed guard
#: artifact stale (`--check` recomputes this hash over the tree)
HOT_PATHS = [
    "peclr_tpu_torch/ops",
    "peclr_tpu_torch/csrc",
    "peclr_tpu_torch/build.py",
    "peclr_tpu_torch/losses",
    "peclr_tpu_torch/models/resnet.py",
    "peclr_tpu_torch/models/peclr.py",
    "peclr_tpu_torch/models/rn25d.py",
    "peclr_tpu_torch/models/heads.py",
    "peclr_tpu_torch/models/batchnorm.py",
    "peclr_tpu_torch/train/step.py",
    "peclr_tpu_torch/train/finetune.py",
    "peclr_tpu_torch/train/optimizer.py",
    "peclr_tpu_torch/train/state.py",
    "peclr_tpu_torch/train/recipe.py",
    "peclr_tpu_torch/eval/pred_fh.py",
]
#: the sources hashed: the kernels are CUDA and C++, not Python
HASHED = (".py", ".cu", ".cc")


def hot_path_hash(repo: str = REPO) -> str:
    """sha256 over the sorted (relpath, contents) of every hot-path
    source."""
    files = []
    for p in HOT_PATHS:
        full = os.path.join(repo, p)
        if os.path.isdir(full):
            for root, _, names in os.walk(full):
                files += [os.path.join(root, n) for n in names
                          if n.endswith(HASHED)]
        elif os.path.exists(full):
            files.append(full)
    h = hashlib.sha256()
    for f in sorted(files):
        h.update(os.path.relpath(f, repo).encode())
        with open(f, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def measure_phases(iters: int, windows: int, device=None, batch: int = 128,
                   accum: int = 16, resnet: Optional[str] = None) -> dict:
    """All four phases, serially: {phase: {seconds (a step or batch, the
    best window), img_per_s, images_per_step, resnet, and for finetune and
    pred busy_ms (a step, from the first window's profile; None where the
    device has no trace)}}.  `resnet` puts every phase on one size (a
    small run); by default each takes PHASE_RESNET's."""
    from peclr_tpu_torch.device import resolve_device
    from peclr_tpu_torch.train.recipe import synthetic_pretrain_batch

    dev = resolve_device(device)
    results = {}

    def record(name, images, seconds, **extra):
        results[name] = {"seconds": seconds, "img_per_s": images / seconds,
                         "images_per_step": images,
                         "resnet": resnet or PHASE_RESNET[name], **extra}
        print(f"{name}: {images / seconds:.1f} img/s "
              f"({seconds * 1e3:.1f} ms a step)", flush=True)

    pretrain_batch = synthetic_pretrain_batch(batch * accum, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for name in ("pretrain_rn50", "pretrain_rn152"):
        state, step = ps.build(batch, accum,
                               resnet=resnet or PHASE_RESNET[name], device=dev)
        record(name, batch * accum, min(
            ps.chain_time(step, state, pretrain_batch, gen, iters, dev)[0]
            for _ in range(windows)))
        del state, step
    del pretrain_batch
    for name, run in (("finetune", ps.run_finetune), ("pred", ps.run_pred)):
        ns = argparse.Namespace(batch=batch, iters=iters,
                                resnet=resnet or PHASE_RESNET[name])
        seconds, summary = run(ns, dev, "")
        for _ in range(windows - 1):
            seconds = min(seconds, run(ns, dev, None)[0])
        record(name, batch, seconds, busy_ms=summary.get("busy_ms"))
    return results


def verdict(measured: dict) -> dict:
    """Each phase against REFERENCE: img/s, the reference, the band, the
    ratio and whether it passes; for finetune and pred also the wall, busy
    and gap ms a step."""
    phases = {}
    for name, ref in REFERENCE.items():
        got = measured[name]
        ratio = got["img_per_s"] / ref["img_s"]
        phases[name] = {
            "img_per_sec": got["img_per_s"],
            "reference_img_per_sec": ref["img_s"], "band": ref["band"],
            "ratio": ratio, "pass": bool(ratio >= ref["band"]),
            "ms_per_step": got["seconds"] * 1e3,
            "images_per_step": got["images_per_step"],
            "resnet": got["resnet"],
        }
        if name in PROFILED:
            wall_ms, busy_ms = got["seconds"] * 1e3, got["busy_ms"]
            phases[name].update(
                wall_ms=wall_ms, trace_busy_ms=busy_ms,
                implied_gap_ms=None if busy_ms is None else wall_ms - busy_ms)
    return phases


def band_of(runs: Sequence[float]) -> float:
    """The band that a phase's img/s in `runs` (at least three full runs)
    allows: the lowest over the median, rounded down to 0.01, at most
    MAX_BAND."""
    if len(runs) < 3:
        raise ValueError(f"a band needs at least three runs, got {len(runs)}")
    ratio = min(runs) / statistics.median(runs)
    return min(math.floor(ratio * 100 + 1e-9) / 100, MAX_BAND)


def calibrate(paths: Sequence[str]) -> dict:
    """REFERENCE from full runs' artifacts (each phase's median img/s and
    band_of its runs), each phase beside its runs."""
    arts = []
    for path in paths:
        with open(path) as fh:
            arts.append(json.load(fh))
    out = {}
    for name in REFERENCE:
        runs = [a["phases"][name]["img_per_sec"] for a in arts]
        out[name] = {"img_s": statistics.median(runs), "band": band_of(runs),
                     "runs": runs}
    return out


def git_head() -> Optional[str]:
    """The commit of the checkout, or None outside a git checkout."""
    proc = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                          capture_output=True, text=True)
    return proc.stdout.strip() if proc.returncode == 0 else None


def check_fresh(path: str) -> dict:
    """Whether the artifact at `path` was made from this tree's hot
    path."""
    with open(path) as fh:
        art = json.load(fh)
    tree = hot_path_hash()
    return {"artifact": path, "artifact_hash": art["hot_path_hash"],
            "tree_hash": tree, "fresh": art["hot_path_hash"] == tree}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--git-head", default=None,
                    help="the commit to record (default: the checkout's)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--check", action="store_true",
                    help="report whether --out is stale against the tree")
    ap.add_argument("--calibrate", nargs="+", metavar="RUN",
                    help="print REFERENCE from these full runs' artifacts")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """The guard's run (its record), or with --check the staleness report,
    or with --calibrate the reference and bands of the runs given."""
    args = parse_args(argv)
    if args.check:
        report = check_fresh(args.out)
        print(json.dumps(report, indent=1))
        return report
    if args.calibrate:
        ref = calibrate(args.calibrate)
        print(json.dumps(ref, indent=1))
        return ref
    from peclr_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    t0 = time.time()
    phases = verdict(measure_phases(args.iters, args.windows, dev))
    record = {
        "backend": dev.type,
        "device": common.card_name(dev), "cpu_cores": common.cpu_cores(),
        "torch": torch.__version__,
        "estimator": f"min_of_{args.windows}_windows_x_{args.iters}_iters",
        "config": {"batch": 128, "accum": 16, "route": "grouped",
                   "precision": {p: ps.PRECISION[p.split("_")[0]]
                                 if dev.type == "cuda" else "f32"
                                 for p in REFERENCE}},
        "hot_path_hash": hot_path_hash(),
        "git_head": args.git_head or git_head(),
        "elapsed_s": time.time() - t0,
        "phases": phases,
        "ok": all(p["pass"] for p in phases.values()),
    }
    common.write_artifact(args.out, record)
    print(json.dumps({k: record[k] for k in ("ok", "phases")}, indent=1))
    return record


if __name__ == "__main__":
    result = main()
    raise SystemExit(0 if result.get("ok", result.get("fresh", True)) else 1)
