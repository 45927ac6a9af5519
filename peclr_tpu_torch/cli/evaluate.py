"""Downstream evaluation CLI: EPE/AUC/procrustes on the FreiHAND val split
(port of peclr_tpu/cli/evaluate.py, the same flags plus `--device`, default
the card).

  python -m peclr_tpu_torch.cli.evaluate -checkpoint <dir>/checkpoints/epoch_N

`-checkpoint` takes a .pth/.ckpt/.npz with the released RN_25D_wMLPref keys
(`backend_model.*`, `zroot_ref.zroot_ref.*`), or a checkpoint directory of
the fine-tune CLI (epoch_N, holding state.pt) or that state.pt.
`-resnet_size` takes 50 or 152, as in the reference.  The model runs in
eval mode under torch.inference_mode; the results dict is printed as JSON.
"""

from __future__ import annotations

import argparse
import json


def build_parser():
    p = argparse.ArgumentParser(description="Evaluate a 2.5D pose model")
    p.add_argument("-checkpoint", type=str, required=True,
                   help="fine-tune checkpoint directory (epoch_N) or its "
                        "state.pt, or a .pth/.ckpt/.npz")
    p.add_argument("-resnet_size", type=str, default="50",
                   choices=["50", "152"])
    p.add_argument("-batch_size", type=int, default=64)
    p.add_argument("-num_batches", type=int, default=None)
    p.add_argument("-train_ratio", type=float, default=0.9)
    p.add_argument("-seed", type=int, default=5)
    p.add_argument("-crop_size", type=int, default=128)
    p.add_argument("--no_procrustes", action="store_true")
    p.add_argument("--use_palm", action="store_true",
                   help="evaluate with the wrist moved to the palm midpoint "
                        "(labels and procrustes targets)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


def load_model(args):
    """An RN25DPose of -resnet_size with the weights of -checkpoint (on the
    CPU)."""
    from peclr_tpu_torch.models import RN25DPose
    from peclr_tpu_torch.train.checkpoint import (
        load_torch_checkpoint,
        model_state_dict,
    )

    model = RN25DPose(size=args.resnet_size)
    if args.checkpoint.endswith((".pth", ".npz", ".ckpt")):
        sd = load_torch_checkpoint(args.checkpoint)
    else:
        sd = model_state_dict(args.checkpoint)
    model.load_state_dict(sd, strict=True)
    return model


def main(argv=None):
    """Evaluate as the flags say; prints and returns the results dict."""
    import torch

    from peclr_tpu_torch import constants
    from peclr_tpu_torch.config.defaults import (
        AugmentationFlags,
        AugmentationParams,
    )
    from peclr_tpu_torch.data.freihand import FreihandSource
    from peclr_tpu_torch.data.pipeline import HostPipeline
    from peclr_tpu_torch.device import resolve_device
    from peclr_tpu_torch.eval.evaluate import evaluate

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    model = load_model(args).to(dev).eval()

    src = FreihandSource(constants.FREIHAND_DATA, "val", seed=args.seed,
                         train_ratio=args.train_ratio)
    pipe = HostPipeline([src], batch_size=args.batch_size, canvas=224,
                        shuffle=False)

    @torch.inference_mode()
    def predict_25d(images, K):
        return model(images, K=K)["kp25d"]

    results = evaluate(
        predict_25d, pipe, AugmentationFlags(crop=True, resize=True),
        AugmentationParams(resize_shape=(args.crop_size, args.crop_size)),
        use_procrustes=not args.no_procrustes, num_batches=args.num_batches,
        use_palm=args.use_palm, device=dev)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
