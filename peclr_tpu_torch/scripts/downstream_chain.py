"""The downstream accuracy chain on synthetic FreiHAND (port of the
reference repository's scripts/downstream_chain.py, function by function):

  pretrain (PeCLR at two step budgets, and a SimCLR control)
    -> fine-tune RN25DPose from each encoder (the head only, with
       --freeze-encoder)
    -> evaluate() (EPE and procrustes-aligned AUC on the val split)
    -> two-pass leaderboard inference (predict_leaderboard, json + zip)
    -> the PeCLR encoder through a torchvision-layout .pth and back,
       fine-tuned again: the same numbers

The data is the synthetic FreiHAND layout of data/synthetic.py, made from
the seed (no download).  Everything runs on the card unless given
`--device cpu`; pretraining runs the port's step in bf16, fine-tuning in
f32, both with kernel 1 in the warp.

    python -m peclr_tpu_torch.scripts.downstream_chain --freeze-encoder
    python -m peclr_tpu_torch.scripts.downstream_chain --device cpu \\
        --resnet 18 --crop 64 --num-unique 24 --pretrain-steps 4 \\
        --finetune-steps 4 --batch 8 --freeze-encoder --out chain.json

The artifact (tests/fixtures/torch_accuracy/downstream_chain.json by
default) has the reference's schema plus the card's name and power limit,
and per phase its seconds, kernel-1 launches and last loss.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from peclr_tpu_torch.scripts import (
    ARTIFACT_DIR,
    card_name,
    init_as_reference,
    run_steps,
)

StateDict = Dict[str, torch.Tensor]


def _kernel1_launches() -> int:
    from peclr_tpu_torch.ops.shift_lerp import fused_shift_lerp_grouped

    return fused_shift_lerp_grouped.launches


def _batch_on(dev: torch.device, pool: Dict[str, np.ndarray],
              idx: np.ndarray) -> Dict[str, torch.Tensor]:
    from peclr_tpu_torch.data.pipeline import host_to_device

    return {k: host_to_device(v[idx], dev) for k, v in pool.items()}


def _logged(log: Optional[dict], name: str, t0: float, launches0: int,
            loss: torch.Tensor) -> None:
    if log is not None:
        log[name] = {"seconds": time.time() - t0,
                     "kernel1_launches": _kernel1_launches() - launches0,
                     "last_loss": float(loss)}


def collect_pool(root, split, train_ratio, seed, batch=64):
    """All images and labels of a split as host arrays (224² canvases), in
    the split's order, and the source."""
    from peclr_tpu_torch.data.freihand import FreihandSource
    from peclr_tpu_torch.data.pipeline import HostPipeline

    src = FreihandSource(root, split, seed=seed, train_ratio=train_ratio)
    pipe = HostPipeline([src], batch_size=batch, canvas=224, seed=seed,
                        shuffle=False, num_threads=4)
    n = max(len(src) // batch, 1)
    batches = list(pipe.batches(n, epoch=0))
    return {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}, src


def pretrain_encoders(pool, steps, batch, seed, view, resnet, kinds_at,
                      device="cuda", log: Optional[dict] = None):
    """Pretrain once per kind; returns {name: PeCLRModel state dict on the
    CPU}.

    kinds_at: list of (name, kind, steps).  The budgets of one kind are
    snapshots of one run, so "quarter" is the "full" run stopped early.
    Snapshots are copied on the card during the run and to the CPU after
    it.  Step i's batch is pool[default_rng(77 * seed + i) indices], the
    reference's stream; the draws come from a torch.Generator seeded with
    `seed`."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationFlags,
        AugmentationParams,
    )
    from peclr_tpu_torch.device import resolve_device
    from peclr_tpu_torch.models import PeCLRModel
    from peclr_tpu_torch.train.optimizer import build_optimizer
    from peclr_tpu_torch.train.state import TrainState
    from peclr_tpu_torch.train.step import make_peclr_train_step

    dev = resolve_device(device)
    imgs, joints = pool["image"], pool["joints25d"]
    flags = AugmentationFlags(crop=True, rotate=True, resize=True,
                              color_jitter=True)
    aug = AugmentationParams(resize_shape=(view, view))
    out = {}
    for kind in sorted({k for _, k, s in kinds_at if s > 0}):
        snaps = {s: name for name, kk, s in kinds_at if kk == kind and s > 0}
        model = init_as_reference(PeCLRModel(resnet), seed).to(dev)
        opt, _ = build_optimizer(
            model, base_lr=1e-4, batch_size=batch, accum=1,
            steps_per_epoch=max(snaps), epochs=1, warmup_epochs=0,
            optimizer="adam",
        )
        augmentations = () if kind == "simclr" else ("crop", "rotate")
        step = make_peclr_train_step(model, opt, flags, aug, accum=1,
                                     augmentations=augmentations,
                                     with_stats=False, precision="bf16")
        on_card = {}

        def snapshot(done, _state, snaps=snaps, model=model, on_card=on_card):
            if done in snaps:
                on_card[snaps[done]] = {k: v.detach().clone()
                                        for k, v in model.state_dict().items()}

        def batch_at(i):
            idx = np.random.default_rng(77 * seed + i).integers(
                0, len(imgs), batch)
            return _batch_on(dev, {"image": imgs, "joints25d": joints}, idx)

        t0, launches0 = time.time(), _kernel1_launches()
        _, m = run_steps(step, TrainState(model, opt), max(snaps), batch_at,
                         torch.Generator(device=dev).manual_seed(seed),
                         snapshot)
        for name, sd in on_card.items():
            out[name] = {k: v.cpu() for k, v in sd.items()}
        _logged(log, f"pretrain_{kind}", t0, launches0, m["loss"])
        print(f"pretrain[{kind}] {max(snaps)} steps: "
              f"loss={float(m['loss']):.4f} ({time.time() - t0:.0f}s)")
    return out


def _frozen(name: str) -> bool:
    """The backbone of RN25DPose, whose fc is the head's (the reference's
    `backbone` subtree leaves its fc out)."""
    return name.startswith("backend_model.") and not name.startswith(
        "backend_model.fc.")


def finetune_and_eval(encoder_sd, pool_train, pool_val, steps, batch, seed,
                      crop, resnet, freeze_encoder=False, device="cuda",
                      log: Optional[dict] = None, name: str = "finetune"):
    """Fine-tune RN25DPose (from a PeCLR encoder's state dict, or from its
    initial weights when None) with Adam at base lr 1e-4; returns
    (evaluate()'s dict, model).

    freeze_encoder trains only the head (fc and the z-root MLP): the
    backbone's parameters leave the optimizer, so they never move, while
    its BatchNorm statistics update (train mode), as in the reference.
    Step i's batch is pool_train[default_rng(99 * seed + i) indices]; the
    draws come from a torch.Generator seeded with seed + 1."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationFlags,
        AugmentationParams,
    )
    from peclr_tpu_torch.device import resolve_device
    from peclr_tpu_torch.eval.evaluate import evaluate
    from peclr_tpu_torch.models import RN25DPose
    from peclr_tpu_torch.train.finetune import (
        load_pretrained_encoder,
        make_finetune_step,
    )
    from peclr_tpu_torch.train.optimizer import build_optimizer
    from peclr_tpu_torch.train.state import TrainState

    dev = resolve_device(device)
    model = init_as_reference(RN25DPose(resnet), seed)
    if encoder_sd is not None:
        load_pretrained_encoder(model, encoder_sd)
    model.to(dev)
    frozen = {}
    if freeze_encoder:
        for pname, p in model.named_parameters():
            if _frozen(pname):
                p.requires_grad_(False)
                frozen[pname] = p.detach().clone()
    opt, _ = build_optimizer(
        model, base_lr=1e-4, batch_size=batch, accum=1,
        steps_per_epoch=steps, epochs=1, warmup_epochs=0, optimizer="adam",
    )
    flags = AugmentationFlags(crop=True, resize=True)
    aug = AugmentationParams(resize_shape=(crop, crop))
    step = make_finetune_step(model, opt, flags, aug)
    n = len(pool_train["image"])

    def batch_at(i):
        idx = np.random.default_rng(99 * seed + i).integers(0, n, batch)
        return _batch_on(dev, pool_train, idx)

    t0, launches0 = time.time(), _kernel1_launches()
    _, m = run_steps(step, TrainState(model, opt), steps, batch_at,
                     torch.Generator(device=dev).manual_seed(seed + 1))
    _logged(log, f"finetune_{name}", t0, launches0, m["loss"])
    if log is not None and freeze_encoder:
        log[f"finetune_{name}"]["frozen_backbone_bitexact"] = all(
            torch.equal(p, frozen[pname])
            for pname, p in model.named_parameters() if pname in frozen)
    print(f"  finetune {steps} steps: loss={float(m['loss']):.3f} "
          f"({time.time() - t0:.0f}s)")

    @torch.inference_mode()
    def predict_25d(images, K):
        model.eval()
        return model(images, K=K)["kp25d"]

    class _PoolPipe:
        batch_size = batch

        def __len__(self):
            return len(pool_val["image"])

        def batches(self, num, epoch=0):
            for b in range(num):
                lo = (b * batch) % max(len(pool_val["image"]) - batch + 1, 1)
                yield {k: v[lo: lo + batch] for k, v in pool_val.items()}

    t0, launches0 = time.time(), _kernel1_launches()
    results = evaluate(
        predict_25d, _PoolPipe(), flags, aug,
        num_batches=max(len(pool_val["image"]) // batch, 1), device=dev,
    )
    if log is not None:
        log[f"evaluate_{name}"] = {
            "seconds": time.time() - t0,
            "kernel1_launches": _kernel1_launches() - launches0}
    return results, model


def pth_roundtrip(encoder_sd: StateDict, resnet, path):
    """Export the pretrained encoder to a torchvision-layout .pth
    (torch.save), read it back (train/checkpoint.py) and map it into a PeCLR
    state dict again; returns (that state dict, meta).  The projection head
    is not in a torchvision .pth and is carried over from encoder_sd (the
    fine-tune takes only the encoder).  The check goes both ways: every
    encoder entry comes back, and each equal to the bit."""
    from peclr_tpu_torch.models.port import (
        peclr_to_torchvision,
        torchvision_to_peclr_encoder,
    )
    from peclr_tpu_torch.train.checkpoint import load_torch_checkpoint

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(peclr_to_torchvision(encoder_sd, resnet), path)
    sd = load_torch_checkpoint(path)
    enc = torchvision_to_peclr_encoder(sd, resnet)
    expected = {k for k in encoder_sd if k.startswith("encoder.")}
    bitexact = set(enc) == expected and all(
        torch.equal(encoder_sd[k], v) for k, v in enc.items())
    merged = dict(encoder_sd)
    merged.update(enc)
    meta = {
        "pth_path": os.path.basename(path),
        "pth_bytes": os.path.getsize(path),
        "torch_keys": len(sd),
        "encoder_bitexact": bool(bitexact),
        "roundtripped_leaves": len(enc),
    }
    return merged, meta


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="the synthetic FreiHAND directory (made there if "
                    "it holds none); a temporary one by default")
    ap.add_argument("--num-unique", type=int, default=192)
    ap.add_argument("--pretrain-steps", type=int, default=600)
    ap.add_argument("--finetune-steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--finetune-labels", type=int, default=None,
                    help="fine-tune on only the first N labelled images "
                    "(pretraining still sees the whole pool)")
    ap.add_argument("--freeze-encoder", action="store_true",
                    help="train only the head (linear evaluation), so that "
                    "downstream accuracy measures the encoder")
    ap.add_argument("--crop", type=int, default=128)
    ap.add_argument("--resnet", default="50")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--train-ratio", type=float, default=0.9)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out",
                    default=os.path.join(ARTIFACT_DIR, "downstream_chain.json"))
    return ap.parse_args(argv)


def main(argv=None):
    """Run the chain and write its artifact; returns the artifact."""
    from peclr_tpu_torch.data.synthetic import (
        generate_freihand_eval_like,
        generate_freihand_like,
    )
    from peclr_tpu_torch.device import resolve_device
    from peclr_tpu_torch.eval.pred_fh import predict_leaderboard

    args = parse_args(argv)
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="peclr_chain_") as tmp:
        root = args.root or os.path.join(tmp, "freihand")
        if not os.path.exists(os.path.join(root, "training_xyz.json")):
            print(f"generating synthetic FreiHAND at {root}")
            generate_freihand_like(root, num_unique=args.num_unique,
                                   seed=args.seed)
            generate_freihand_eval_like(root, num_images=32,
                                        seed=args.seed + 1)

        pool_train, _ = collect_pool(root, "train", args.train_ratio,
                                     args.seed, args.batch)
        pool_val, _ = collect_pool(root, "val", args.train_ratio, args.seed,
                                   args.batch)
        print(f"pools: train {len(pool_train['image'])}, "
              f"val {len(pool_val['image'])}")

        S = args.pretrain_steps
        kinds_at = [
            ("none", "peclr", 0),
            ("peclr_quarter", "peclr", max(S // 4, 1)),
            ("peclr_full", "peclr", S),
            ("simclr_full", "simclr", S),
        ]
        log: dict = {}
        encoders = pretrain_encoders(pool_train, S, args.batch, args.seed,
                                     args.crop, args.resnet, kinds_at,
                                     device=dev, log=log)
        encoders["none"] = None

        pool_ft = pool_train
        if args.finetune_labels:
            pool_ft = {k: v[: args.finetune_labels]
                       for k, v in pool_train.items()}
            print(f"fine-tune restricted to {len(pool_ft['image'])} "
                  "labelled images")

        def tier(name, encoder_sd):
            return finetune_and_eval(
                encoder_sd, pool_ft, pool_val, args.finetune_steps,
                args.batch, args.seed, args.crop, args.resnet,
                freeze_encoder=args.freeze_encoder, device=dev, log=log,
                name=name)

        rows = []
        pred_json = pred_entries = rt_meta = None
        for name, _, psteps in kinds_at:
            print(f"== encoder {name} (pretrain steps {psteps})")
            results, model = tier(name, encoders[name])
            rows.append({"encoder": name, "pretrain_steps": psteps,
                         **{k: float(v) for k, v in results.items()}})
            print(f"  AUC_procrustes={results['auc_procrustes']:.4f} "
                  f"EPE3D={results['Mean_EPE_3D']:.4f}")
            if name != "peclr_full":
                continue
            # leaderboard inference end to end on the eval split
            t0, launches0 = time.time(), _kernel1_launches()
            path = predict_leaderboard(model, root, "chain",
                                       batch_size=args.batch, limit=32,
                                       out_dir=tmp, device=dev)
            log["leaderboard"] = {
                "seconds": time.time() - t0,
                "kernel1_launches": _kernel1_launches() - launches0}
            with open(path) as fh:
                pred_entries = len(json.load(fh)[0])
            pred_json = os.path.basename(path)
            print(f"  pred_fh -> {pred_json} ({pred_entries} entries, + .zip)")

            # the interop seam on the accuracy path: the trained encoder
            # through a .pth and back, fine-tuned again with the same seeds;
            # the numbers must not move
            rt_sd, rt_meta = pth_roundtrip(
                encoders["peclr_full"], args.resnet,
                os.path.join(tmp, "peclr_encoder_tv.pth"))
            print("== encoder peclr_full via .pth round trip "
                  f"(bitexact={rt_meta['encoder_bitexact']})")
            results_rt, _ = tier("peclr_full_pth_roundtrip", rt_sd)
            rows.append({"encoder": "peclr_full_pth_roundtrip",
                         "pretrain_steps": psteps,
                         **{k: float(v) for k, v in results_rt.items()}})
            print(f"  AUC_procrustes={results_rt['auc_procrustes']:.4f} "
                  f"(direct {results['auc_procrustes']:.4f})")

    artifact = {
        "config": {k: v for k, v in vars(args).items() if k != "out"},
        "backend": dev.type,
        "device": card_name(dev),
        "rows": rows,
        "pred_fh_json": pred_json,
        "pred_fh_entries": pred_entries,
        "port_roundtrip": rt_meta,
        "phases": log,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=1)
    print(f"wrote {args.out}")
    return artifact


if __name__ == "__main__":
    main()
