"""Time and profile the PeCLR train step, the fine-tune step and two-pass
inference on the card (port of the reference repository's
scripts/profile_step.py).

    python -m peclr_tpu_torch.scripts.profile_step            # recipe step
    python -m peclr_tpu_torch.scripts.profile_step --batch 256 --accum 1
    python -m peclr_tpu_torch.scripts.profile_step --ablate noaug,adam,stats,augonly
    python -m peclr_tpu_torch.scripts.profile_step --trace    # + trace_buckets
    python -m peclr_tpu_torch.scripts.profile_step --route matmul
    python -m peclr_tpu_torch.scripts.profile_step --phase finetune  # RN25D 224²
    python -m peclr_tpu_torch.scripts.profile_step --phase pred      # two-pass

Phases: `pretrain` (build_pretrain_state, synthetic_pretrain_batch and
make_peclr_train_step at --batch x --accum, with_stats=False, bf16 on the
card), `finetune` (make_finetune_step on RN25DPose at 224², crop and
resize, Adam, f32 model) and `pred` (make_two_pass_predictor, f32).  The
ablations (pretrain only): noaug (every augmentation flag off), adam
(optimizer adam), stats (with_stats=True), augonly (augment_pair alone).
`--route` picks the warp's route (ops/augment.py:ROUTES) of the pretrain
variants, where the reference read its PECLR_SHIFT* knobs.

Timing is chain_time's: two warm-up steps, then --iters steps queued back
to back with one wait on the card at the end (ms/step is the wall clock
of that window).  With --trace a second window of --iters steps runs
under torch.profiler, opened after the warm-up, and trace_buckets
summarises it per step (busy, buckets, idle gaps, top kernels); the
profiler slows the host, so its span is not the step's time.  A DIR after
--trace also keeps the Chrome trace there.  One JSON artifact (--out,
default tests/fixtures/torch_bench/profile_<phase>[_<route>][_ablate].json)
holds every variant beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Callable, Optional, Tuple

import torch

from peclr_tpu_torch import scripts as common
from peclr_tpu_torch.scripts import trace_buckets

ABLATIONS = ("noaug", "adam", "stats", "augonly")
WARMUP = 2
#: the precision of each phase on the card (the CPU runs f32 throughout)
PRECISION = {"pretrain": "bf16 autocast, bf16 warp",
             "finetune": "f32 model, bf16 warp",
             "pred": "f32 model, bf16 warp"}


def chain_time(step: Callable, state, batch, generator, iters: int,
               device: torch.device, trace: Optional[str] = None
               ) -> Tuple[float, Optional[dict]]:
    """(seconds a step, trace summary or None): WARMUP steps, then `iters`
    state-chained steps with one wait at the end; with `trace` (None for
    no profile, "" for the summary only, else a directory for the Chrome
    trace too) another `iters` steps under the profiler, the window opened
    after the warm-up so that it holds exactly `iters` steps."""
    for _ in range(WARMUP):
        state, _ = step(state, batch, generator)

    def run():
        nonlocal state
        for _ in range(iters):
            state, _ = step(state, batch, generator)

    seconds = common.chained_seconds(run, device) / iters
    if trace is None:
        return seconds, None
    return seconds, profile_window(run, device, iters, trace)


def profile_window(run: Callable[[], object], device: torch.device,
                   iters: int, trace: str = "") -> dict:
    """trace_buckets' summary, per step, of run() (`iters` steps) under
    utils/profiler.py:trace (its Chrome trace kept in the directory
    `trace`, where given), the card's queue empty before and after."""
    from peclr_tpu_torch.utils.profiler import trace as capture

    common.sync(device)
    with capture(trace) as prof:
        run()
        common.sync(device)
    return trace_buckets.summarize_profile(prof, steps=iters)


def build(batch: int, accum: int, optimizer: str = "LARS",
          with_stats: bool = False, flags=None, resnet: str = "50",
          view: int = 128, route: str = "grouped", device=None):
    """(state, step) of the pretrain recipe at `batch` x `accum`, the
    reference's build with the port's warp route."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.train.recipe import build_pretrain_state
    from peclr_tpu_torch.train.step import make_peclr_train_step

    model, state, opt = build_pretrain_state(
        resnet=resnet, batch=batch, accum=accum, optimizer=optimizer,
        device=device)
    step = make_peclr_train_step(
        model, opt, flags or peclr_pretrain_flags(),
        AugmentationParams(resize_shape=(view, view)), accum=accum,
        warp_route=route, with_stats=with_stats)
    return state, step


def variants(ablate: str):
    """[(name, build overrides or None for augonly)]: the full step first,
    then each ablation asked for."""
    from peclr_tpu_torch.config.defaults import peclr_pretrain_flags

    out = [("full", {})]
    for name in filter(None, ablate.split(",")):
        if name == "noaug":
            f = peclr_pretrain_flags()
            off = {fld.name: False for fld in dataclasses.fields(f)}
            out.append(("noaug", {"flags": type(f)(**off)}))
        elif name == "adam":
            out.append(("adam", {"optimizer": "adam"}))
        elif name == "stats":
            out.append(("stats", {"with_stats": True}))
        elif name == "augonly":
            out.append(("augonly", None))
        else:
            raise SystemExit(f"unknown ablation: {name} (want {ABLATIONS})")
    return out


def run_augonly(args, batch, dev, trace):
    """augment_pair alone on one microbatch, `iters` calls queued back to
    back (bf16 on the card, as in the step)."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.ops.augment import augment_pair

    flags = peclr_pretrain_flags()
    params = AugmentationParams(resize_shape=(args.view, args.view))
    img, joints = batch["image"][: args.batch], batch["joints25d"][: args.batch]
    gen = torch.Generator(device=dev).manual_seed(0)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32

    def aug(_state, _batch, _gen):
        return None, augment_pair(gen, img, joints, flags, params,
                                  route=args.route, compute_dtype=dtype)

    return chain_time(aug, None, None, None, args.iters, dev, trace)


def run_finetune(args, dev, trace):
    """The supervised RN25D fine-tune step at 224² (crop and resize, the
    published fine-tune resolution), Adam, the model in f32."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationFlags,
        AugmentationParams,
    )
    from peclr_tpu_torch.data.synthetic import seeded_rn25d_variables
    from peclr_tpu_torch.models import RN25DPose
    from peclr_tpu_torch.models.port import rn25d_variables_to_state_dict
    from peclr_tpu_torch.train.finetune import make_finetune_step
    from peclr_tpu_torch.train.optimizer import build_optimizer
    from peclr_tpu_torch.train.recipe import synthetic_supervised_batch
    from peclr_tpu_torch.train.state import TrainState

    crop = 224
    model = RN25DPose(args.resnet)
    model.load_state_dict(rn25d_variables_to_state_dict(
        seeded_rn25d_variables(args.resnet, 0), args.resnet), strict=True)
    model.to(dev)
    opt, _ = build_optimizer(model, base_lr=1e-4, batch_size=args.batch,
                             accum=1, steps_per_epoch=1000, epochs=100,
                             optimizer="adam")
    step = make_finetune_step(model, opt,
                              AugmentationFlags(crop=True, resize=True),
                              AugmentationParams(resize_shape=(crop, crop)))
    batch = synthetic_supervised_batch(args.batch, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    return chain_time(step, TrainState(model, opt), batch, gen, args.iters,
                      dev, trace)


def run_pred(args, dev, trace):
    """The two-pass leaderboard predictor (eval/pred_fh.py) on one batch of
    224² frames, `iters` batches queued back to back."""
    from peclr_tpu_torch.data.synthetic import seeded_rn25d_variables
    from peclr_tpu_torch.eval.pred_fh import make_two_pass_predictor
    from peclr_tpu_torch.models import RN25DPose
    from peclr_tpu_torch.models.port import rn25d_variables_to_state_dict
    from peclr_tpu_torch.train.recipe import synthetic_supervised_batch

    model = RN25DPose(args.resnet)
    model.load_state_dict(rn25d_variables_to_state_dict(
        seeded_rn25d_variables(args.resnet, 0), args.resnet), strict=True)
    predict = make_two_pass_predictor(model, device=dev)
    batch = synthetic_supervised_batch(args.batch, device=dev)

    def pred(_state, _batch, _gen):
        return None, predict(batch["image"], batch["K"])

    return chain_time(pred, None, None, None, args.iters, dev, trace)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase", default="pretrain",
                    choices=["pretrain", "finetune", "pred"])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--accum", type=int, default=16)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--ablate", default="",
                    help="comma list of " + ", ".join(ABLATIONS))
    ap.add_argument("--trace", nargs="?", const="", default=None,
                    help="profile each variant (trace_buckets); a DIR keeps "
                    "the Chrome trace there")
    ap.add_argument("--resnet", default="50")
    ap.add_argument("--route", default="grouped",
                    choices=["grouped", "nhwc", "matmul", "gather"])
    ap.add_argument("--view", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def default_out(args) -> str:
    name = f"profile_{args.phase}"
    if args.phase == "pretrain" and args.route != "grouped":
        name += f"_{args.route}"
    if args.ablate:
        name += "_ablate"
    return os.path.join(common.BENCH_DIR, name + ".json")


def main(argv=None) -> dict:
    from peclr_tpu_torch.device import resolve_device
    from peclr_tpu_torch.train.recipe import synthetic_pretrain_batch

    args = parse_args(argv)
    dev = resolve_device(args.device)
    if args.ablate and args.phase != "pretrain":
        raise SystemExit("--ablate applies to the pretrain phase")
    images = args.batch * (args.accum if args.phase == "pretrain" else 1)
    runs = {}
    if args.phase == "finetune":
        runs["finetune"] = run_finetune(args, dev, args.trace)
    elif args.phase == "pred":
        runs["pred"] = run_pred(args, dev, args.trace)
    else:
        batch = synthetic_pretrain_batch(images, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        for name, overrides in variants(args.ablate):
            if overrides is None:
                runs[name] = run_augonly(args, batch, dev, args.trace)
                continue
            state, step = build(args.batch, args.accum, resnet=args.resnet,
                                view=args.view, route=args.route,
                                device=dev, **overrides)
            runs[name] = chain_time(step, state, batch, gen, args.iters,
                                    dev, args.trace)
            del state, step
    out = {}
    for name, (seconds, summary) in runs.items():
        n = args.batch if name == "augonly" else images
        out[name] = {"ms_per_step": seconds * 1e3, "img_per_s": n / seconds,
                     "images_per_step": n, "trace": summary}
        print(f"{name:8s} {seconds * 1e3:8.2f} ms/step   {n / seconds:8.0f} "
              "img/s")
        if summary is not None:
            trace_buckets.print_summary(summary)
    record = {
        "phase": args.phase, "backend": dev.type,
        "device": common.card_name(dev), "cpu_cores": common.cpu_cores(),
        "torch": torch.__version__,
        "precision": PRECISION[args.phase] if dev.type == "cuda" else "f32",
        "warmup_steps": WARMUP,
        "config": {k: v for k, v in vars(args).items() if k != "out"},
        "variants": out,
    }
    common.write_artifact(args.out or default_out(args), record)
    return record


if __name__ == "__main__":
    main()
