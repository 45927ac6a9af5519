"""The program's spans in one cell, read from a capture of its own (not
part of a benchmark run).

    python3 benchmark/phases.py --workload <name> --seed <n> [--seconds 50]

A run sets the cell up as run.py does, runs a window of --seconds, then
captures the traffic's trace_units units under
torch.profiler with the CPU and, on the card, the CUDA activities, the
card's queue empty before and after, as harness/trace.py:profile does.
It prints one JSON line: for each of the program's spans the device ms
and the idle ms a unit credited to it (harness/spans.py), the share of
the captured device time credited to some span, the counters a unit, and
the figures below, named for what they read.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import common, spans  # noqa: E402
from benchmark.harness.counts import PEAK_HBM  # noqa: E402

#: by kind: figure -> (device_us or idle_us, the spans summed), in ms a unit
FIGURES = {
    "pretrain": {
        "augment_ms": ("device_us", ("pretrain.augment",)),
        "optimizer_ms": ("device_us", ("pretrain.zero_grad",
                                       "pretrain.update")),
        "backward_idle_ms": ("idle_us", ("pretrain.backward",)),
    },
    "finetune": {
        "optimizer_idle_ms": ("idle_us", ("finetune.zero_grad",
                                          "finetune.update")),
    },
    "pred": {
        "h2d_idle_ms": ("idle_us", ("pred.h2d",)),
    },
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    return ap.parse_args(argv)


def capture(run, device):
    """spans.read of a torch.profiler capture of run()."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    common.sync(device)
    with profile(activities=activities) as prof:
        run()
        common.sync(device)
    return spans.read(prof)


def figures(kind: str, program: dict, units: int, counts: dict) -> dict:
    """FIGURES of this kind, pinned_mb (the pinned_bytes counter in 1e6
    bytes) and, where the warp ran in warp.shift spans, warp_span_roofline:
    the least time of a unit's shift passes over their device time (%)."""
    out = {}
    for name, (field, names) in FIGURES.get(kind, {}).items():
        found = [program[field][n] for n in names if n in program[field]]
        if found:
            out[name] = sum(found) / 1e3 / units
    if "pinned_bytes" in program["counters"]:
        out["pinned_mb"] = program["counters"]["pinned_bytes"] / units / 1e6
    shift_us = program["device_us"].get("warp.shift", 0.0)
    if shift_us > 0 and "warp_bytes_per_unit" in counts:
        least_s = counts["warp_bytes_per_unit"] / PEAK_HBM
        out["warp_span_roofline"] = 100.0 * least_s / (shift_us / 1e6 / units)
    return out


def main(argv=None, root: str = common.BENCH_DIR, device: str = None
         ) -> dict:
    """One capture; returns the line it printed.  `device` set (tests:
    "cpu") skips the look for a card."""
    import torch

    args = parse_args(argv)
    spec = common.resolve_workload(args.workload, root)
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("phases: no CUDA device is available")
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    from peclr_tpu_torch.device import resolve_device

    resolve_device(dev)
    entry = common.entry_module(spec["entry"])
    runner = entry.Runner(spec, args.seed, dev)
    runner.setup()
    runner.window(args.seconds)
    units = int(spec["traffic_data"]["trace_units"])
    before = spans.program_counters()
    program = capture(runner.traced(units), dev)
    program["counters"] = {k: v - before.get(k, 0)
                           for k, v in program["counters"].items()}
    total = program["device_us_total"]
    line = {
        "workload": args.workload, "seed": args.seed, "units": units,
        "card": common.card_name(dev),
        "device_ms": {k: v / 1e3 / units
                      for k, v in program["device_us"].items()},
        "idle_ms": {k: v / 1e3 / units for k, v in program["idle_us"].items()},
        "device_ms_total": total / 1e3 / units,
        "idle_ms_total": program["idle_us_total"] / 1e3 / units,
        "credited_pct": (100.0 * program["device_us_credited"] / total
                         if total > 0 else None),
        "counters": {k: v / units for k, v in program["counters"].items()},
        "figures": figures(entry.KIND, program, units, runner.counts()),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
