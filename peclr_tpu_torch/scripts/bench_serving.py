"""Serving latency of the fixed-shape inference session, by batch size
(port of the reference repository's scripts/bench_serving.py).

`eval/serving.py:InferenceSession` runs one batch shape a session
(pad or chunk at the edges).  For each batch size this measures:

  sync_ms     the synchronous request latency through the real request
              path (`InferenceSession.predict`: numpy in, the host's pad
              and chunk, the copy to the card, one RN25D forward, the
              outputs fetched to numpy), over --iters
              requests: p50 and p99;
  chained_ms  --iters back-to-back `_predict` calls on the same host
              arrays, the outputs left on the card, with one wait at the
              end: the throughput bound when requests queue back to back.
              On a card behind PCIe this needs no data-dependency chain
              (the reference's tunnel did).

    python -m peclr_tpu_torch.scripts.bench_serving [--batches 1,8,32,128]
        [--iters 30] [--image-size 128] [--resnet 50] [--device cuda]

Writes one JSON artifact with the reference's keys (--out, default
tests/fixtures/torch_bench/serving_latency.json), the card's name and
power limit under `device`, the host's cores under `cpu_cores`.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from peclr_tpu_torch import scripts as common


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", default="1,8,32,128")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--image-size", type=int, default=128)
    ap.add_argument("--resnet", default="50")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(common.BENCH_DIR,
                                                  "serving_latency.json"))
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from peclr_tpu_torch.data.synthetic import seeded_rn25d_variables
    from peclr_tpu_torch.device import resolve_device
    from peclr_tpu_torch.eval.serving import InferenceSession
    from peclr_tpu_torch.models import RN25DPose
    from peclr_tpu_torch.models.port import rn25d_variables_to_state_dict
    from peclr_tpu_torch.models.rn25d import K_DEFAULT

    args = parse_args(argv)
    dev = resolve_device(args.device)
    model = RN25DPose(args.resnet)
    model.load_state_dict(rn25d_variables_to_state_dict(
        seeded_rn25d_variables(args.resnet, 0), args.resnet), strict=True)
    rng = np.random.default_rng(0)
    size = args.image_size

    rows = []
    for batch in [int(b) for b in args.batches.split(",")]:
        sess = InferenceSession(model, batch_size=batch, image_size=size,
                                device=dev).warmup()
        images = rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
        K = np.broadcast_to(np.asarray(K_DEFAULT, np.float32),
                            (batch, 3, 3)).copy()
        sess._predict(images, K)  # the chained path's first call

        sync = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            sess.predict(images, K)
            sync.append((time.perf_counter() - t0) * 1e3)
        sync = np.array(sync)

        def chained():
            for _ in range(args.iters):
                sess._predict(images, K)

        chained_ms = common.chained_seconds(chained, dev) * 1e3 / args.iters
        rows.append({
            "batch": batch,
            "sync_ms_p50": float(np.percentile(sync, 50)),
            "sync_ms_p99": float(np.percentile(sync, 99)),
            "chained_ms": chained_ms,
            "chained_img_per_s": batch / (chained_ms / 1e3),
        })
        print(rows[-1])
        del sess

    artifact = {
        "backend": dev.type,
        "device": common.card_name(dev),
        "resnet": args.resnet,
        "image_size": size,
        "iters": args.iters,
        "rows": rows,
        "note": (
            "sync is the full InferenceSession.predict request path (numpy "
            "in, outputs fetched to numpy); chained is --iters _predict "
            "calls queued back to back on the same host arrays with one "
            "wait at the end, the queued-request bound; the model in f32"
        ),
        "cpu_cores": common.cpu_cores(),
        "torch": torch.__version__,
    }
    common.write_artifact(args.out, artifact)
    return artifact


if __name__ == "__main__":
    main()
