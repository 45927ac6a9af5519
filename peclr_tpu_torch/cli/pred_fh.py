"""FreiHAND leaderboard CLI (port of peclr_tpu/cli/pred_fh.py).

  python -m peclr_tpu_torch.cli.pred_fh --model_path .../rn50.pth [-ds_path ...]
      [--device cuda]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from peclr_tpu_torch.constants import FREIHAND_DATA
    from peclr_tpu_torch.eval.pred_fh import predict_leaderboard
    from peclr_tpu_torch.models import RN25DPose
    from peclr_tpu_torch.train.checkpoint import load_torch_checkpoint

    p = argparse.ArgumentParser(description="FreiHAND leaderboard inference")
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("-ds_path", type=str, default=FREIHAND_DATA)
    p.add_argument("-batch_size", type=int, default=120)
    p.add_argument("-limit", type=int, default=None)
    p.add_argument("-out_dir", type=str, default="out")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (default: cuda)")
    args = p.parse_args(argv)

    if "rn50" in args.model_path:
        size = "50"
    elif "rn152" in args.model_path:
        size = "152"
    else:
        raise SystemExit(
            "cannot infer model type from model_path (expect rn50/rn152 in "
            "the filename, like the released weights)"
        )
    model = RN25DPose(size=size)
    model.load_state_dict(load_torch_checkpoint(args.model_path), strict=True)
    out = predict_leaderboard(
        model, args.ds_path, f"rn{size}", batch_size=args.batch_size,
        limit=args.limit, out_dir=args.out_dir, device=args.device,
    )
    print(f"wrote {out} (+ .zip for CodaLab)")


if __name__ == "__main__":
    main()
