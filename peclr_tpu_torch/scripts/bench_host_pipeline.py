"""The host pipeline's balance of host, transfer and device, and the
sustained training rate (port of the reference repository's
scripts/bench_host_pipeline.py).

Four legs on one FreiHAND-layout root (--root, else --num-unique frames
x 4 versions written by data/synthetic.py:generate_freihand_like into a
temporary directory), at the pretrain recipe (--microbatch x --accum,
RN50, 224² canvases to --view² views, with_stats=False, bf16 on the
card):

  device-only  the recipe step on a batch already on the card: two
               warm-up steps, then --steps steps queued back to back with
               one wait at the end;
  host-only    data/pipeline.py:HostPipeline.batches (decode and collate)
               with nothing consuming them;
  transfer     device_prefetch copies of one host batch alone, through
               cuda_copier's pinned buffers on a side stream;
  sustained    HostPipeline -> device_prefetch -> the step, overlapped.

It reports overlap_efficiency = sustained / the slowest leg (1.0: the
host's work hides behind the card's), bound_by (the slowest of host,
device and transfer), the host's rate per core and the cores the host
would need to feed the card's rate, with the reference's keys, and the
card's name and power limit under `device`.

    python -m peclr_tpu_torch.scripts.bench_host_pipeline [--steps 6]
        [--threads 8] [--root DIR] [--device cuda]

One JSON artifact (--out, default
tests/fixtures/torch_bench/host_pipeline.json).
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import torch

from peclr_tpu_torch import scripts as common


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=None,
                    help="a FreiHAND-layout root; default: generate one")
    ap.add_argument("--num-unique", type=int, default=640)
    ap.add_argument("--microbatch", type=int, default=128)
    ap.add_argument("--accum", type=int, default=16)
    ap.add_argument("--resnet", default="50")
    ap.add_argument("--view", type=int, default=128)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(common.BENCH_DIR,
                                                  "host_pipeline.json"))
    return ap.parse_args(argv)


def balance(dev_rate: float, host_rate: float, host_per_core: float,
            xfer_rate: float, sus_rate: float) -> dict:
    """The derived numbers of the four legs' rates (img/s)."""
    rates = {"host": host_rate, "device": dev_rate, "transfer": xfer_rate}
    return {
        "overlap_efficiency": sus_rate / min(rates.values()),
        "bound_by": min(rates, key=rates.get),
        "host_cores_needed_for_device_rate": dev_rate / host_per_core,
    }


def main(argv=None) -> dict:
    from peclr_tpu_torch.config.defaults import (
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.data import native_loader
    from peclr_tpu_torch.data.freihand import FreihandSource
    from peclr_tpu_torch.data.pipeline import (
        HostPipeline,
        cuda_copier,
        device_prefetch,
    )
    from peclr_tpu_torch.data.synthetic import generate_freihand_like
    from peclr_tpu_torch.device import resolve_device
    from peclr_tpu_torch.train.recipe import (
        build_pretrain_state,
        synthetic_pretrain_batch,
    )
    from peclr_tpu_torch.train.step import make_peclr_train_step

    args = parse_args(argv)
    dev = resolve_device(args.device)
    tmp = None
    root = args.root
    if root is None:
        tmp = tempfile.mkdtemp(prefix="peclr_host_pipeline_")
        root = generate_freihand_like(tmp, num_unique=args.num_unique, seed=7)
    try:
        global_batch = args.microbatch * args.accum
        src = FreihandSource(root, "train", seed=5, train_ratio=0.999)
        pipe = HostPipeline([src], batch_size=global_batch, canvas=224,
                            seed=5, num_threads=args.threads)
        cores = common.cpu_cores()
        print(f"dataset: {len(src)} JPEGs, native loader: "
              f"{native_loader.available()}, threads {args.threads}, "
              f"{cores} cores")

        model, state, opt = build_pretrain_state(
            resnet=args.resnet, batch=args.microbatch, accum=args.accum,
            device=dev)
        step = make_peclr_train_step(
            model, opt, peclr_pretrain_flags(),
            AugmentationParams(resize_shape=(args.view, args.view)),
            accum=args.accum, with_stats=False)
        gen = torch.Generator(device=dev).manual_seed(0)

        # -- device-only: a batch on the card, steps queued back to back --
        dev_batch = synthetic_pretrain_batch(global_batch, canvas=224,
                                             device=dev)
        for _ in range(2):
            state, _ = step(state, dev_batch, gen)

        def device_steps():
            nonlocal state
            for _ in range(args.steps):
                state, _ = step(state, dev_batch, gen)

        dev_rate = global_batch * args.steps / common.chained_seconds(
            device_steps, dev)
        print(f"device-only: {dev_rate:.1f} img/s")

        # -- host-only: decode and collate, nothing consuming them --------
        t0 = time.perf_counter()
        n_host, host_batch = 0, None
        for batch in pipe.batches(args.steps, epoch=0):
            n_host += len(batch["image"])
            host_batch = batch
        host_rate = n_host / (time.perf_counter() - t0)
        host_per_core = host_rate / min(args.threads, cores)
        print(f"host-only:   {host_rate:.1f} img/s ({host_per_core:.1f} per "
              "core)")

        # -- transfer: one host batch copied alone, through pinned memory --
        copier = cuda_copier(dev) if dev.type == "cuda" else None
        copies = max(args.steps // 2, 2)
        t0 = time.perf_counter()
        for _ in device_prefetch(iter([host_batch] * copies), dev,
                                 copier=copier):
            pass
        common.sync(dev)
        xfer_rate = global_batch * copies / (time.perf_counter() - t0)
        batch_mb = sum(v.nbytes for v in host_batch.values()) / 1e6
        print(f"transfer:    {xfer_rate:.1f} img/s "
              f"({xfer_rate / global_batch * batch_mb:.1f} MB/s)")

        # -- sustained: host -> prefetch -> step, overlapped ---------------
        for b in device_prefetch(pipe.batches(1, epoch=1), dev,
                                 copier=copier):
            state, _ = step(state, b, gen)
        common.sync(dev)
        t0 = time.perf_counter()
        n_sus = 0
        for b in device_prefetch(pipe.batches(args.steps, epoch=2), dev,
                                 copier=copier):
            state, _ = step(state, b, gen)
            n_sus += global_batch
        common.sync(dev)
        sus_rate = n_sus / (time.perf_counter() - t0)
        print(f"sustained:   {sus_rate:.1f} img/s")
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)

    result = {
        "device_only_img_s": dev_rate,
        "host_only_img_s": host_rate,
        "host_per_core_img_s": host_per_core,
        "transfer_img_s": xfer_rate,
        "transfer_mb_s": xfer_rate / global_batch * batch_mb,
        "sustained_img_s": sus_rate,
        **balance(dev_rate, host_rate, host_per_core, xfer_rate, sus_rate),
        "native_loader": native_loader.available(),
        "cpu_cores": cores,
        "config": {**{k: v for k, v in vars(args).items() if k != "out"},
                   "with_stats": False,
                   "decode_paths": dict(pipe.decode_paths)},
        "backend": dev.type,
        "device": common.card_name(dev),
        "torch": torch.__version__,
    }
    print(result)
    common.write_artifact(args.out, result)
    return result


if __name__ == "__main__":
    main()
