"""Tests of the port that need an NVIDIA card and nvcc (marker `cuda`).

They skip where there is no card.  This file imports neither JAX nor the
reference package, so it also runs on a machine that has only the port's
requirements:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from peclr_tpu_torch.ops.shift_lerp import (
    fused_shift_lerp_grouped,
    shift_lerp_grouped_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    return torch.device("cuda")


def test_shift_kernel_matches_plain(card):
    """The CUDA kernel against the plain version on the card, at an odd N:
    raw bit-exact, lerp within 1e-3 in f32 and 1.0 in bf16 (0-255 scale)."""
    rng = np.random.default_rng(5)
    g, n, w, out = 3, 1001, 224, 768
    x = torch.from_numpy(rng.integers(0, 256, (g, n, w)).astype(np.uint8))
    k = torch.from_numpy(
        rng.integers(-(out + 12), w + 12, (n,)).astype(np.int32))
    f = torch.from_numpy(rng.uniform(0, 1, (n,)).astype(np.float32))
    x, k, f = x.to(card), k.to(card), f.to(card)
    launches = fused_shift_lerp_grouped.launches
    raw_launches = fused_shift_lerp_grouped.raw_launches
    for src in (x, x.to(torch.bfloat16), x.float()):
        for out_dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 1.0)):
            got = fused_shift_lerp_grouped(src, k, f, out, out_dtype)
            ref = shift_lerp_grouped_plain(src, k, f, out, out_dtype)
            torch.cuda.synchronize()
            assert (got.float() - ref.float()).abs().max().item() <= tol
        raw = fused_shift_lerp_grouped(src, k, None, out, lerp=False)
        assert torch.equal(raw, shift_lerp_grouped_plain(src, k, None, out,
                                                         lerp=False))
    assert fused_shift_lerp_grouped.launches == launches + 6
    assert fused_shift_lerp_grouped.raw_launches == raw_launches + 3


def test_two_pass_predictor_runs_through_the_kernel(card, monkeypatch):
    """RN18 two-pass inference on the card launches the kernel four times
    per call, and pass 1's keypoints agree within 1e-3 px with the same
    run through the plain shift on the card."""
    from peclr_tpu_torch.data.synthetic import (
        seeded_frames,
        seeded_intrinsics,
        seeded_rn25d_variables,
    )
    from peclr_tpu_torch.eval.pred_fh import (
        make_two_pass_predictor,
        run_two_pass,
    )
    from peclr_tpu_torch.models import RN25DPose
    from peclr_tpu_torch.models.port import rn25d_variables_to_state_dict
    from peclr_tpu_torch.ops import warp_mxu

    model = RN25DPose("18")
    model.load_state_dict(rn25d_variables_to_state_dict(
        seeded_rn25d_variables("18", seed=18), "18"), strict=True)
    images = torch.from_numpy(seeded_frames(8, seed=7))
    K = torch.from_numpy(seeded_intrinsics(8, seed=8))
    predict = make_two_pass_predictor(model, device=card)
    before = fused_shift_lerp_grouped.launches
    kp3d = predict(images, K)
    torch.cuda.synchronize()
    assert fused_shift_lerp_grouped.launches == before + 4
    assert kp3d.device.type == "cuda" and kp3d.shape == (8, 21, 3)
    assert torch.isfinite(kp3d).all()

    got = run_two_pass(model, images.to(card), K.to(card))
    monkeypatch.setattr(warp_mxu, "fused_shift_lerp_grouped",
                        shift_lerp_grouped_plain)
    ref = run_two_pass(model, images.to(card), K.to(card))
    assert (got["kp25d_1"] - ref["kp25d_1"]).abs().max().item() <= 1e-3
