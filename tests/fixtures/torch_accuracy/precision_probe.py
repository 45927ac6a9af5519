"""Which part of the bf16 pretraining moves the accuracy proxy's
PeCLR/SimCLR ratio: one proxy record (accuracy_proxy.main) with one piece of
the run in f32 and the rest as the recipe has it (bf16 autocast on the
card).  A diagnostic kept beside the records it was asked about, not a
module of the package; its records go to --out, never to the committed
artifacts.  From the root of the repository:

    PYTHONPATH=. python tests/fixtures/torch_accuracy/precision_probe.py \\
        --variant bn_f32 --out out/bn_f32.jsonl -- \\
        --resnet 50 --seed 5 --steps 360

Variants: "bf16" (the recipe), "f32" (steps and probe embedding in f32),
"step_f32" (steps in f32, the probe's embedding in bf16), "embed_f32" (the
reverse), "warp_f32" (the augmentation's warp in f32), "bn_f32" (every
BatchNorm in f32, its input and output bf16), "head_f32" (the projection
head in f32).  Each piece is switched by replacing one function for the
run's length, so the package carries no option for it.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from peclr_tpu_torch.scripts import accuracy_proxy


@contextlib.contextmanager
def _patched(owner, name, make):
    """Replace owner.name by make(original) inside the context."""
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _step_f32():
    from peclr_tpu_torch.train import step

    def make(factory):
        def f32_factory(*args, **kwargs):
            return factory(*args, **{**kwargs, "precision": "f32"})
        return f32_factory
    return _patched(step, "make_peclr_train_step", make)


def _embed_f32():
    """accuracy_proxy.make_embed without its autocast."""
    from peclr_tpu_torch.data.pipeline import host_to_device
    from peclr_tpu_torch.ops.image import normalize_imagenet

    def make(_make_embed):
        def make_embed(model):
            dev = next(model.parameters()).device

            @torch.inference_mode()
            def embed(images_u8: np.ndarray) -> torch.Tensor:
                model.eval()
                x = normalize_imagenet(
                    host_to_device(images_u8, dev).float() / 255.0)
                return model(x)["embedding"].float()
            return embed
        return make_embed
    return _patched(accuracy_proxy, "make_embed", make)


def _warp_f32():
    from peclr_tpu_torch.train import step

    def make(pair):
        def f32_pair(*args, **kwargs):
            return pair(*args, **{**kwargs, "compute_dtype": torch.float32})
        return f32_pair
    return _patched(step, "augment_pair", make)


def _bn_f32():
    from peclr_tpu_torch.models.batchnorm import _ReferenceStats

    def make(forward):
        def f32_forward(self, x):
            with torch.autocast(x.device.type, enabled=False):
                return forward(self, x.float()).to(x.dtype)
        return f32_forward
    return _patched(_ReferenceStats, "forward", make)


def _head_f32():
    from peclr_tpu_torch.models.heads import ProjectionHead

    def make(forward):
        def f32_forward(self, x):
            with torch.autocast(x.device.type, enabled=False):
                return forward(self, x.float())
        return f32_forward
    return _patched(ProjectionHead, "forward", make)


#: variant -> the pieces it runs in f32
VARIANTS = {
    "bf16": (),
    "f32": (_step_f32, _embed_f32),
    "step_f32": (_step_f32,),
    "embed_f32": (_embed_f32,),
    "warp_f32": (_warp_f32,),
    "bn_f32": (_bn_f32,),
    "head_f32": (_head_f32,),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", choices=sorted(VARIANTS), required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("proxy_args", nargs="*",
                    help="accuracy_proxy's arguments, after --")
    args = ap.parse_args(argv)
    with contextlib.ExitStack() as stack:
        for piece in VARIANTS[args.variant]:
            stack.enter_context(piece())
        record = accuracy_proxy.main(args.proxy_args + ["--out", args.out])
    record["variant"] = args.variant
    with open(args.out, "w") as fh:
        fh.write(json.dumps(record) + "\n")
    return record


if __name__ == "__main__":
    main()
