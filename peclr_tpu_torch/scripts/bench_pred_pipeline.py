"""The leaderboard's dispatch pipelining, by depth (port of the reference
repository's scripts/bench_pred_pipeline.py).

eval/pred_fh.py:pipelined keeps `depth` batches in flight: batch i + 1 is
queued before batch i's kp3d is fetched to the host.  This measures the
wall rate of that loop at several depths over --num-batches distinct
batches of --batch 224² frames that are already on the card (the loop
of predict_leaderboard without the JPEG decode, whose overlap is the host
pipeline's question, bench_host_pipeline.py), through
make_two_pass_predictor, the best of --repeats loops a depth.  Every
depth must give the same kp3d, to the bit.

The device bound is measured, not carried over: trace_buckets' busy time
of one profiled batch (device_busy_ms_per_batch), and
device_bound_img_per_sec = batch / busy; best_depth, speedup_vs_serial
and fraction_of_device_bound follow from it.  Every loop's rate is kept
(repeats_img_per_sec): a depth beats another only beyond their spread.
--e2e N adds the whole predict_leaderboard on N synthetic evaluation
JPEGs (data/synthetic.py:generate_freihand_eval_like): serial with the
decode inline (depth 1) against the defaults (depth 2, the decode in a
producer thread).

The model is the port's leaderboard model, RN25DPose in f32, as
cli/pred_fh.py runs it (the reference's script ran bf16); the artifact
says so under `dtype`, beside the card's name and power limit.

    python -m peclr_tpu_torch.scripts.bench_pred_pipeline [--depths 1,2,3]
        [--num-batches 24] [--repeats 3] [--e2e 768] [--device cuda]

One JSON artifact (--out, default
tests/fixtures/torch_bench/pred_pipeline.json).
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from peclr_tpu_torch import scripts as common


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--num-batches", type=int, default=24)
    ap.add_argument("--depths", default="1,2,3")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--resnet", default="50")
    ap.add_argument("--e2e", type=int, default=0,
                    help="also run predict_leaderboard over N synthetic "
                    "eval JPEGs, serial against pipelined")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(common.BENCH_DIR,
                                                  "pred_pipeline.json"))
    return ap.parse_args(argv)


def run_loop(predict, batches, K, depth: int, device: torch.device):
    """predict_leaderboard's loop (eval/pred_fh.py:pipelined) over batches
    already on the device, `depth` in flight: (wall seconds, kp3d of
    every frame, numpy)."""
    from peclr_tpu_torch.eval.pred_fh import pipelined

    b = K.shape[0]
    feed = ((range(i * b, (i + 1) * b), 0, imgs, K)
            for i, imgs in enumerate(batches))
    t0 = time.perf_counter()
    outs = [kp3d for _, kp3d in pipelined(predict, feed, depth, device)]
    return time.perf_counter() - t0, np.concatenate(outs)


def pipeline_record(batch: int, num_batches: int,
                    walls: Dict[str, List[float]],
                    busy_ms: Optional[float]) -> dict:
    """The reference's record from the wall seconds of every loop of each
    depth (the best of them, and each loop's rate under
    repeats_img_per_sec, whose spread tells the depths apart from the
    noise) and the measured busy ms of one batch (None where the card's
    time was not measured: no device bound then)."""
    repeats = len(next(iter(walls.values())))
    depths = {d: {"wall_s": min(s),
                  "img_per_sec": batch * num_batches / min(s)}
              for d, s in walls.items()}
    best = max(depths, key=lambda d: depths[d]["img_per_sec"])
    serial = depths.get("1")
    bound = None if busy_ms is None else batch / (busy_ms / 1e3)
    return {
        "batch": batch,
        "num_batches": num_batches,
        "estimator": f"min_of_{repeats}_loops",
        "device_bound_img_per_sec": bound,
        "device_busy_ms_per_batch": busy_ms,
        "depths": depths,
        "best_depth": int(best),
        "speedup_vs_serial": (depths[best]["img_per_sec"]
                              / serial["img_per_sec"] if serial else None),
        "fraction_of_device_bound": (None if bound is None
                                     else depths[best]["img_per_sec"] / bound),
        "repeats_img_per_sec": {d: [batch * num_batches / w for w in s]
                                for d, s in walls.items()},
    }


def run_end_to_end(args, model, device) -> dict:
    """predict_leaderboard's wall time (JPEG decode -> two passes -> the
    CodaLab json) on args.e2e synthetic evaluation frames: serial (depth
    1, the decode inline) against the defaults (depth 2, the decode in a
    producer thread); one warm-up run of one batch before each."""
    from peclr_tpu_torch.data.synthetic import generate_freihand_eval_like
    from peclr_tpu_torch.eval.pred_fh import predict_leaderboard

    tmp = tempfile.mkdtemp(prefix="peclr_pred_e2e_")
    try:
        root = generate_freihand_eval_like(os.path.join(tmp, "fh"),
                                           num_images=args.e2e, seed=11)
        results = {}
        for label, depth, prefetch in (("serial", 1, False),
                                       ("pipelined", 2, True)):
            kw = dict(batch_size=args.batch, out_dir=tmp, depth=depth,
                      decode_prefetch=prefetch, device=device)
            predict_leaderboard(model, root, f"warm_{label}",
                                limit=args.batch, **kw)
            t0 = time.perf_counter()
            predict_leaderboard(model, root, f"e2e_{label}", **kw)
            dt = time.perf_counter() - t0
            results[label] = {"wall_s": dt, "img_per_sec": args.e2e / dt}
            print(f"e2e {label}: {results[label]['img_per_sec']:.1f} img/s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    results["speedup"] = (results["pipelined"]["img_per_sec"]
                          / results["serial"]["img_per_sec"])
    results["num_images"] = args.e2e
    return results


def main(argv=None) -> dict:
    from peclr_tpu_torch.data.synthetic import seeded_rn25d_variables
    from peclr_tpu_torch.device import resolve_device
    from peclr_tpu_torch.eval.pred_fh import make_two_pass_predictor
    from peclr_tpu_torch.models import RN25DPose
    from peclr_tpu_torch.models.port import rn25d_variables_to_state_dict
    from peclr_tpu_torch.scripts.profile_step import profile_window
    from peclr_tpu_torch.train.recipe import synthetic_supervised_batch

    args = parse_args(argv)
    dev = resolve_device(args.device)
    model = RN25DPose(args.resnet)
    model.load_state_dict(rn25d_variables_to_state_dict(
        seeded_rn25d_variables(args.resnet, 0), args.resnet), strict=True)
    predict = make_two_pass_predictor(model, device=dev)

    # distinct batches already on the card: only the kp3d fetch crosses to
    # the host inside the loop
    rng = np.random.default_rng(0)
    base = synthetic_supervised_batch(args.batch, device=dev)
    imgs0, K = base["image"].cpu().numpy(), base["K"]
    batches = [torch.from_numpy(
        imgs0 + rng.integers(0, 3, imgs0.shape, dtype=np.uint8)).to(dev)
        for _ in range(args.num_batches)]
    predict(batches[0], K).cpu()  # warm-up (cuDNN picks its kernels)

    profile = profile_window(lambda: predict(batches[0], K), dev, 1)
    busy_ms = profile.get("busy_ms")

    walls, first = {}, None
    for depth in args.depths.split(","):
        seconds = []
        for _ in range(args.repeats):
            wall, kp3d = run_loop(predict, batches, K, int(depth), dev)
            if first is None:
                first = kp3d
            elif not np.array_equal(kp3d, first):
                raise RuntimeError(f"depth {depth} gave another kp3d")
            seconds.append(wall)
        walls[depth] = seconds
        best = min(seconds)
        print(f"depth {depth}: {args.batch * args.num_batches / best:.1f}"
              f" img/s ({best:.3f} s)")

    record = {
        "backend": dev.type,
        **pipeline_record(args.batch, args.num_batches, walls, busy_ms),
        "device": common.card_name(dev),
        "dtype": "float32",
        "resnet": args.resnet,
        "cpu_cores": common.cpu_cores(),
        "torch": torch.__version__,
        "profile": profile,
    }
    if args.e2e:
        record["end_to_end"] = run_end_to_end(args, model, dev)
    print({k: record[k] for k in (
        "device_bound_img_per_sec", "best_depth", "speedup_vs_serial",
        "fraction_of_device_bound")})
    common.write_artifact(args.out, record)
    return record


if __name__ == "__main__":
    main()
