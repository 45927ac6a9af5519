"""Accuracy proxy: PeCLR (equivariant) against SimCLR (invariant) on
synthetic hand frames, judged by a linear probe of the frozen encoder for
2D keypoints (port of the reference repository's scripts/accuracy_proxy.py,
function by function).

With the same seeds, data, augmentations and optimizer, inverting the
geometric transforms in projection space (PeCLR) should give features from
which the hand's pose is more linearly decodable than SimCLR's.  The frames
(`hand_template`, `render_batch`) and the probe's ridge solve
(`linear_probe`) are the reference's numpy code; pretraining runs the
port's step on the card (bf16 autocast, kernel 1 in the warp), its
augmentation draws from a torch.Generator (they cannot replay jax.random).

    python -m peclr_tpu_torch.scripts.accuracy_proxy --resnet 18 --steps 800
    python -m peclr_tpu_torch.scripts.accuracy_proxy --resnet 50 \\
        --steps 640 --batch 128 --accum 16 --optimizer LARS --lr 1e-5 \\
        --view 128 --num-images 4096 --probe-train 3072 --probe-every 80 \\
        --curve-out tests/fixtures/torch_accuracy/accuracy_curves_rn50.json

One JSONL record per configuration goes to --out (a re-run replaces its
record), with the card's name and power limit; the curve mode writes its
artifact after every probe, `complete: false` until the end.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from peclr_tpu_torch.scripts import ARTIFACT_DIR, card_name, init_as_reference

# ---------------------------------------------------------------------------
# Synthetic hand frames: a 21-joint template under random similarity
# transforms, drawn with a colour per finger, so that an image carries its
# exact pose (the probe's signal).  The reference's numpy and cv2 calls, in
# the same order: the same frames from the same seed.

_TEMPLATE = None


def hand_template() -> np.ndarray:
    """(21, 2) canonical hand: wrist + 5 fingers x 4 joints, AIT order
    (wrist, 5 mcp, 5 pip, 5 dip, 5 tip)."""
    global _TEMPLATE
    if _TEMPLATE is None:
        wrist = np.array([[0.0, 0.0]])
        angles = np.deg2rad(np.array([-50, -25, 0, 25, 50]))
        dirs = np.stack([np.sin(angles), -np.cos(angles)], axis=1)
        rows = [wrist]
        for r in (0.35, 0.55, 0.72, 0.88):  # mcp, pip, dip, tip rings
            rows.append(dirs * r)
        _TEMPLATE = np.concatenate(rows, axis=0)
    return _TEMPLATE


_BONES = [(0, m) for m in range(1, 6)] + [
    (1 + 5 * k + f, 1 + 5 * (k + 1) + f) for k in range(3) for f in range(5)
]
_FINGER_COLORS = np.array(
    [[255, 60, 60], [60, 255, 60], [60, 60, 255], [255, 255, 60], [255, 60, 255]],
    np.float32,
)


def render_batch(rng: np.random.Generator, n: int, canvas: int = 128):
    """Returns (images uint8 (n, canvas, canvas, 3), joints25d (n, 21, 3))."""
    import cv2

    imgs = np.empty((n, canvas, canvas, 3), np.uint8)
    joints = np.empty((n, 21, 3), np.float32)
    t = hand_template()
    for i in range(n):
        scale = rng.uniform(0.22, 0.38) * canvas
        theta = rng.uniform(-np.pi, np.pi)
        c, s = np.cos(theta), np.sin(theta)
        rot = np.array([[c, -s], [s, c]])
        center = rng.uniform(0.3, 0.7, 2) * canvas
        pts = t @ rot.T * scale + center
        img = (rng.integers(0, 60, (canvas, canvas, 3))).astype(np.uint8)
        for a, b in _BONES:
            fid = (max(a, b) - 1) % 5
            col = tuple(int(v) for v in _FINGER_COLORS[fid])
            cv2.line(img, tuple(np.round(pts[a]).astype(int)),
                     tuple(np.round(pts[b]).astype(int)), col, 2)
        for j, p in enumerate(pts):
            col = (255, 255, 255) if j == 0 else tuple(
                int(v) for v in _FINGER_COLORS[(j - 1) % 5]
            )
            cv2.circle(img, tuple(np.round(p).astype(int)), 2, col, -1)
        imgs[i] = img
        joints[i, :, :2] = pts
        joints[i, :, 2] = 0.0
    return imgs, joints


# ---------------------------------------------------------------------------


def make_embed(model: torch.nn.Module):
    """embed(images_u8 (n, v, v, 3) host array) -> (n, E) float32 embeddings
    on the model's device: the model in eval mode, under bf16 autocast on
    the card (the reference's PeCLRModel in bf16), in f32 on the CPU."""
    from peclr_tpu_torch.data.pipeline import host_to_device
    from peclr_tpu_torch.ops.image import normalize_imagenet

    dev = next(model.parameters()).device
    bf16 = dev.type == "cuda"

    @torch.inference_mode()
    def embed(images_u8: np.ndarray) -> torch.Tensor:
        model.eval()
        x = normalize_imagenet(host_to_device(images_u8, dev).float() / 255.0)
        with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=bf16):
            return model(x)["embedding"].float()

    return embed


def pretrain(kind: str, imgs, joints, steps: int, batch: int, seed: int,
             view: int, resnet: str, accum: int = 1, optimizer: str = "adam",
             lr: float = 5e-5, probe_hook=None, probe_every: int = 0,
             device="cuda"):
    """Pretrain one model; returns (embed, losses, model).

    With accum/optimizer this scales to the published recipe's shape
    (microbatch 128 x accum 16, LARS).  `probe_hook` (if given) is called
    with (step_index, embed) every `probe_every` steps, and at step 0, to
    record a learning curve.  The pool stays on the device; each step's
    indices come from default_rng(1000 * seed + i), the reference's stream;
    the losses stay device tensors until the end."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationFlags,
        AugmentationParams,
    )
    from peclr_tpu_torch.data.pipeline import host_to_device
    from peclr_tpu_torch.device import resolve_device
    from peclr_tpu_torch.models import PeCLRModel
    from peclr_tpu_torch.scripts import run_steps
    from peclr_tpu_torch.train.optimizer import build_optimizer
    from peclr_tpu_torch.train.state import TrainState
    from peclr_tpu_torch.train.step import make_peclr_train_step

    dev = resolve_device(device)
    flags = AugmentationFlags(crop=True, rotate=True, resize=True,
                              color_jitter=True)
    aug = AugmentationParams(resize_shape=(view, view))
    model = init_as_reference(PeCLRModel(resnet), seed).to(dev)
    # steps_per_epoch counts data iterations (microbatches); the loop below
    # runs `steps` optimizer updates of `accum` microbatches each
    opt, _ = build_optimizer(
        model, base_lr=lr, batch_size=batch, accum=accum,
        steps_per_epoch=steps * accum, epochs=1,
        warmup_epochs=0.05 if optimizer == "LARS" else 0,
        optimizer=optimizer,
    )
    state = TrainState(model, opt)
    # the only difference between the two runs: SimCLR applies no inverse
    # transforms in projection space
    augmentations = () if kind == "simclr" else ("crop", "rotate")
    step = make_peclr_train_step(model, opt, flags, aug, accum=accum,
                                 augmentations=augmentations,
                                 with_stats=False, precision="bf16")
    embed = make_embed(model)
    generator = torch.Generator(device=dev).manual_seed(seed)
    n = imgs.shape[0]
    per_step = batch * accum
    imgs_d = host_to_device(imgs, dev)
    joints_d = host_to_device(joints, dev)
    losses = []

    def batch_at(i):
        idx = host_to_device(
            np.random.default_rng(1000 * seed + i).integers(0, n, per_step),
            dev)
        return {"image": imgs_d[idx], "joints25d": joints_d[idx]}

    def after(done, _state):
        if probe_hook and probe_every and done % probe_every == 0:
            probe_hook(done, embed)

    def counted(st, bd, gen):
        st, m = step(st, bd, gen)
        losses.append(m["loss"])  # a device scalar, fetched at the end
        return st, m

    t0 = time.time()
    if probe_hook and probe_every:
        probe_hook(0, embed)  # the random-init baseline of the curve
    state, _ = run_steps(counted, state, steps, batch_at, generator, after)
    losses = torch.stack(losses).tolist() if losses else []
    seconds = time.time() - t0
    print(f"  {kind}: loss {losses[0]:.4f} -> {np.mean(losses[-10:]):.4f} "
          f"({seconds:.0f}s)")
    return embed, losses, model


def linear_probe(embed, imgs, joints, view: int, train_n: int, seed: int):
    """Ridge-regress 2D keypoints from frozen embeddings; returns
    {"abs": EPE, "rel": EPE} in canvas pixels.

    "abs" targets absolute canvas coordinates (position and pose), "rel"
    wrist-centred ones (pose only, the wrist left out of the error).  The
    embeddings come from embed(chunk) in chunks of 256 frames resized to
    the view, one host copy a chunk; the solve is the reference's, in numpy
    float64."""
    import cv2

    canvas = imgs.shape[1]
    small = np.stack([cv2.resize(im, (view, view)) for im in imgs])
    feats = []
    for i in range(0, len(small), 256):
        feats.append(embed(small[i : i + 256]).cpu().numpy())
    f = np.concatenate(feats).astype(np.float64)
    f = (f - f[:train_n].mean(0)) / (f[:train_n].std(0) + 1e-6)
    f = np.concatenate([f, np.ones((len(f), 1))], axis=1)
    ftr = f[:train_n]
    solve_lhs = ftr.T @ ftr + 1e-3 * np.eye(f.shape[1])

    def fit(y):
        w = np.linalg.solve(solve_lhs, ftr.T @ y[:train_n])
        return (f[train_n:] @ w - y[train_n:])

    pts = joints[:, :, :2].astype(np.float64)
    y_abs = pts.reshape(len(f), -1) / canvas
    err = fit(y_abs).reshape(-1, 21, 2) * canvas
    epe_abs = float(np.sqrt((err ** 2).sum(-1)).mean())
    # wrist-centred, the wrist (identically 0) left out of the error
    y_rel = (pts - pts[:, :1]).reshape(len(f), -1) / canvas
    err_rel = fit(y_rel).reshape(-1, 21, 2)[:, 1:] * canvas
    epe_rel = float(np.sqrt((err_rel ** 2).sum(-1)).mean())
    return {"abs": epe_abs, "rel": epe_rel}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--num-images", type=int, default=2048)
    ap.add_argument("--probe-train", type=int, default=1536)
    ap.add_argument("--view", type=int, default=64)
    ap.add_argument("--resnet", default="18")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--optimizer", default="adam", choices=["adam", "LARS"])
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--probe-every", type=int, default=0,
                    help="record a probe-EPE learning curve every N steps")
    ap.add_argument("--curve-out", default=None,
                    help="JSON path for the learning-curve artifact")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out",
                    default=os.path.join(ARTIFACT_DIR, "accuracy_proxy.jsonl"))
    return ap.parse_args(argv)


def main(argv=None):
    from peclr_tpu_torch.device import resolve_device

    args = parse_args(argv)
    dev = resolve_device(args.device)
    device_name = card_name(dev)
    rng = np.random.default_rng(args.seed)
    imgs, joints = render_batch(rng, args.num_images)
    print(f"synthetic set: {imgs.shape}, probe train {args.probe_train}")

    def write_curves(curves, complete):
        """Write the curve artifact now, after every probe, so that a run
        cut short still leaves its measurements; `complete` is False until
        the last write, and a partial artifact is not to be committed."""
        if not args.curve_out:
            return
        os.makedirs(os.path.dirname(args.curve_out) or ".", exist_ok=True)
        with open(args.curve_out, "w") as fh:
            json.dump({
                "config": {k: v for k, v in vars(args).items()
                           if k not in ("out", "curve_out")},
                "backend": dev.type,
                "device": device_name,
                "complete": complete,
                "curves": curves,
            }, fh, indent=1)

    results = {}
    curves = {}
    for kind in ("peclr", "simclr"):
        curve = []
        probe_seconds = [0.0]

        def probe_hook(step_i, embed_fn, kind=kind, curve=curve,
                       probe_seconds=probe_seconds):
            t0 = time.time()
            e = linear_probe(embed_fn, imgs, joints, args.view,
                             args.probe_train, args.seed)
            probe_seconds[0] += time.time() - t0
            curve.append({"step": step_i, "probe_epe_px": e["abs"],
                          "probe_epe_rel_px": e["rel"]})
            print(f"  {kind} @ {step_i}: probe EPE {e['abs']:.2f} px "
                  f"(rel {e['rel']:.2f})")
            write_curves({**curves, kind: {"probe": curve}}, complete=False)

        t0 = time.time()
        embed, losses, _model = pretrain(
            kind, imgs, joints, args.steps, args.batch, args.seed,
            args.view, args.resnet, accum=args.accum,
            optimizer=args.optimizer, lr=args.lr,
            probe_hook=probe_hook, probe_every=args.probe_every, device=dev,
        )
        seconds = time.time() - t0 - probe_seconds[0]  # the steps' own
        if curve and curve[-1]["step"] == args.steps:
            epe = curve[-1]["probe_epe_px"]  # already probed at the last step
            epe_rel = curve[-1]["probe_epe_rel_px"]
        else:
            e = linear_probe(embed, imgs, joints, args.view,
                             args.probe_train, args.seed)
            epe, epe_rel = e["abs"], e["rel"]
            curve.append({"step": args.steps, "probe_epe_px": epe,
                          "probe_epe_rel_px": epe_rel})
        results[kind] = {"probe_epe_px": epe, "probe_epe_rel_px": epe_rel,
                         "final_loss": float(np.mean(losses[-10:])),
                         "pretrain_seconds": seconds,
                         "probe_seconds": probe_seconds[0],
                         "steps_per_s": args.steps / seconds}
        stride = max(len(losses) // 200, 1)
        curves[kind] = {
            "probe": curve,
            "loss_steps": list(range(0, len(losses), stride)),
            "loss": [float(np.mean(losses[max(0, i - stride + 1): i + 1]))
                     for i in range(0, len(losses), stride)],
        }
        print(f"  {kind}: probe EPE {epe:.2f} px")

    if args.curve_out:
        write_curves(curves, complete=True)
        print(f"wrote {args.curve_out}")

    record = {
        "config": {k: v for k, v in vars(args).items() if k != "out"},
        "backend": dev.type,
        "device": device_name,
        **results,
        "epe_ratio_peclr_over_simclr":
            results["peclr"]["probe_epe_px"] / results["simclr"]["probe_epe_px"],
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    # records are keyed by config: a re-run with the same settings replaces
    # its record instead of appending a duplicate
    existing = []
    if os.path.exists(args.out):
        with open(args.out) as fh:
            existing = [json.loads(line) for line in fh if line.strip()]
    existing = [r for r in existing if r.get("config") != record["config"]]
    existing.append(record)
    with open(args.out, "w") as fh:
        for r in existing:
            fh.write(json.dumps(r) + "\n")
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
