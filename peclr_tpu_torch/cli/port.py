"""Checkpoint conversion CLI (port of peclr_tpu/cli/port.py, the same four
formats): between the port's training checkpoints, the reference's PeCLR
checkpoint layout and torchvision state dicts.

  python -m peclr_tpu_torch.cli.port SRC DST.npz -format FORMAT [-resnet_size N]

  peclr_to_torchvision   a PeCLR .pth/.ckpt/.npz -> its encoder under
                         torchvision's keys (no fc)
  torchvision_to_peclr   torchvision weights -> the encoder of a PeCLR
                         checkpoint (`encoder.features.*`)
  orbax_to_peclr         a checkpoint directory of the port's pretraining
                         CLI (epoch_N, or its state.pt) -> the reference's
                         PeCLR layout
  orbax_to_torchvision   the same directory -> torchvision's keys

The two orbax_* formats keep the reference's names; here they read the
port's checkpoint directories, which take the place of orbax's.
"""

from __future__ import annotations

import argparse

FORMATS = ("peclr_to_torchvision", "torchvision_to_peclr", "orbax_to_peclr",
           "orbax_to_torchvision")


def build_parser():
    p = argparse.ArgumentParser(
        description="Checkpoint conversion; the orbax_* formats read a "
                    "checkpoint directory of the port's pretraining CLI "
                    "(epoch_N with its state.pt), or that state.pt")
    p.add_argument("src", help="source: .pth/.ckpt/.npz, or a checkpoint "
                               "directory (epoch_N) for the orbax_* formats")
    p.add_argument("dst", help="destination .npz path")
    p.add_argument("-format", required=True, choices=FORMATS)
    p.add_argument("-resnet_size", type=str, default="50",
                   choices=["18", "34", "50", "101", "152"])
    return p


def main(argv=None):
    """Convert as the flags say; returns the written state dict."""
    from peclr_tpu_torch.models import port
    from peclr_tpu_torch.train import checkpoint

    args = build_parser().parse_args(argv)
    size = args.resnet_size
    if args.format == "orbax_to_peclr":
        out = checkpoint.export_torch_peclr(args.src, size, args.dst)
    elif args.format == "orbax_to_torchvision":
        out = checkpoint.export_torchvision(args.src, size, args.dst)
    else:
        payload = checkpoint.load_torch_checkpoint(args.src)
        convert = (port.peclr_to_torchvision
                   if args.format == "peclr_to_torchvision"
                   else port.torchvision_to_peclr_encoder)
        out = checkpoint.save_npz(args.dst, convert(payload, size))
    print(f"wrote {len(out)} tensors -> {args.dst}")
    return out


if __name__ == "__main__":
    main()
