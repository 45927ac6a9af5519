"""Run one cell of the benchmark of peclr_tpu_torch once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's file, benchmark/workloads/<name>.json, names its configuration
(configs/), its traffic (traffic/), its entry (entries/, the loop it
drives), its chips and the limits of its comparison.  A run loads the
program, makes the weights and inputs from --seed on the card, warms up
(set-up, which for a training cell takes its first steps), measures for
--seconds with nothing but the program's own work on the card, and then,
once the window has closed and the peak memory is read, takes the compared
steps of a training cell (its own objects rewound to the seeded start),
frees the program's state and compares what the timed path produced with
the plain reference (reference/), and what it watched of the dispatch
(waits on the card, the warp's launches) with what is due.  With --trace 1 the run then profiles a short span
of the same loop and reports the per-layer metrics (the readers under
metrics/); with --trace 0 the end-to-end ones.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and with --trace 1 breakdown), then `checks`:
each number compared beside its limit, which also end standard error.
A run exits nonzero, and prints no result, without a card (or with fewer
than the cell asks for), when the program cannot be imported, or when
jax, jaxlib, flax or peclr_tpu (whole top-level names) are loaded once the
window has closed.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import checks, common, trace  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _num(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def main(argv=None, root: str = common.BENCH_DIR, device: str = None
         ) -> dict:
    """One run; returns the result it printed.  `root` holds the data
    files; `device` set (tests: "cpu") skips the look for a card."""
    import torch

    args = parse_args(argv)
    spec = common.resolve_workload(args.workload, root)
    chips = int(spec["chips"])
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("benchmark: no CUDA device is available")
        if torch.cuda.device_count() < chips:
            raise SystemExit(f"benchmark: the cell asks for {chips} cards, "
                             f"{torch.cuda.device_count()} are present")
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device(device)
    try:
        import peclr_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"benchmark: the program cannot be imported: {e}")
    from peclr_tpu_torch.device import resolve_device

    resolve_device(dev)
    entry = common.entry_module(spec["entry"])
    runner = entry.Runner(spec, args.seed, dev)
    readers = common.metric_readers()
    _log(f"card: {common.card_name(dev)}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)

    runner.setup()
    setup_s = time.perf_counter() - _T_START
    window = runner.window(args.seconds)
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    traced = None
    if args.trace:
        units = int(spec["traffic_data"]["trace_units"])
        captured = trace.profile(runner.traced(units), dev)
        traced = {**captured, "units": units}
    runner.finish()
    runner.release()
    readings = {**runner.check(), "host_waits": runner.waits,
                "launch_gap": runner.launch_gap}
    correct, compared = checks.judge(readings, {**spec["limits"],
                                                **checks.DISPATCH_LIMITS})
    found = common.forbidden_modules()
    if found:
        raise SystemExit(f"benchmark: forbidden modules loaded: {found}")

    ctx = {"kind": entry.KIND, "window": window, "setup_s": setup_s,
           "counts": runner.counts(), "trace": traced}
    want = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for name, module in readers.items():
        if module.KIND != want:
            continue
        value = module.read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": module.UNIT}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else dev.type),
                   "count": chips, "memory_peak_bytes": memory_peak}
    result = {"correct": bool(correct), "attempted": window["units"],
              "failed": 0, "metrics": metrics, "device": device_info}
    if traced is not None:
        s = traced["summary"]
        if "busy_ms" in s:
            device_info["busy_s"] = s["busy_ms"] / 1e3
            device_info["window_s"] = s["wall_ms"] / 1e3
            result["breakdown"] = trace.breakdown(s)
    result["checks"] = {k: {"value": _num(v["value"]), "limit": v["limit"]}
                        for k, v in compared.items()}
    _log(json.dumps({"window": {k: v for k, v in window.items()
                                if k != "latencies_s"},
                     "setup_s": setup_s, "launches": runner.launch_note,
                     "host_waits_in_a_step": runner.waits}))
    for k, v in compared.items():
        _log(f"check {k}: {_num(v['value'])} (limit {v['limit']})")
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
