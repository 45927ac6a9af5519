"""The readings that a cell's limits are set from, on the card at the
cell's own size (not part of a benchmark run).

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--faults half_batch] [--seconds 3] \
        [--precision f32]

Each reading runs as a benchmark run does, with a short window of
--seconds: set-up, the window, the compared steps of a training cell after
it, then the comparison.  For each seed: the program's readings against the
reference; for each control seed: the control's, the reference in the next
precision below the configuration's (fp8 below bf16, TF32 below f32) put
in the program's place; for each fault (harness/faults.py) and control
seed: the program's readings with that fault planted.  --precision runs
the program in another precision than the configuration states (the
pretrain step's "f32"), to read how far its own rounding reaches.  One JSON
line a reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import common, faults  # noqa: E402

LOWER = {"bf16": "fp8", "f32": "tf32"}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--precision", default=None)
    return ap.parse_args(argv)


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def one(entry, spec, seed, dev, seconds, fault=None, control=None):
    runner = entry.Runner(spec, seed, dev)
    t0 = time.perf_counter()
    with faults.plant(entry.KIND, fault):
        runner.setup()
        runner.window(seconds)
        runner.finish()
    runner.release()
    if control:
        readings = runner.control_readings(control)
    elif entry.KIND == "pred":
        readings = runner.check()
    else:
        readings = runner.readings("f32", details=True)
    readings.update(host_waits=runner.waits, launch_gap=runner.launch_gap)
    return {"seed": seed, "fault": fault, "control": control,
            "readings": readings, "seconds": time.perf_counter() - t0}


def main(argv=None) -> list:
    import torch

    from peclr_tpu_torch.device import resolve_device

    args = parse_args(argv)
    dev = resolve_device("cuda")
    spec = common.resolve_workload(args.workload)
    if args.precision:
        spec["config_data"]["precision"]["program"] = args.precision
    entry = common.entry_module(spec["entry"])
    lower = LOWER[spec["config_data"]["precision"]["program"]]
    print(common.card_name(dev), torch.__version__, file=sys.stderr,
          flush=True)
    rows = []
    jobs = [(s, None, None) for s in _seeds(args.seeds)]
    jobs += [(s, None, lower) for s in _seeds(args.control_seeds)]
    jobs += [(s, f, None) for f in filter(None, args.faults.split(","))
             for s in _seeds(args.control_seeds)]
    for seed, fault, control in jobs:
        row = one(entry, spec, seed, dev, args.seconds, fault, control)
        row["workload"] = args.workload
        row["precision"] = spec["config_data"]["precision"]["program"]
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
