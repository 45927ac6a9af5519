"""Tests of the port that need an NVIDIA card and nvcc (marker `cuda`).

They skip where there is no card.  This file imports neither JAX nor the
reference package, so it also runs on a machine that has only the port's
requirements:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import functools
import importlib

import numpy as np
import pytest
import torch

from peclr_tpu_torch.ops import shift_lerp
from peclr_tpu_torch.ops.shift_lerp import (
    VEC16_MAX_ROW_BYTES,
    fused_shift_lerp,
    fused_shift_lerp_grouped,
    shift_lerp_flat_plain,
    shift_lerp_grouped_plain,
)
from peclr_tpu_torch.ops.shift_lerp_matmul import (
    fused_shift_lerp_matmul,
    shift_lerp_matmul_plain,
    tap_band,
    tap_band_plain,
)
from peclr_tpu_torch.ops.warp_mxu import _area_matrix

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


def test_flat_shift_kernel_matches_plain(card):
    """Kernel 3 (NHWC rows, C = 3) against its plain version on the card, at
    an odd N with rows clamped at both ends: 1e-3 in f32, 1.0 in bf16."""
    rng = np.random.default_rng(6)
    n, w_px, c, out_w = 1001, 224, 3, 384
    k = torch.from_numpy(
        rng.integers(-(out_w + 12), w_px + 12, (n,)).astype(np.int32)).to(card)
    f = torch.from_numpy(rng.uniform(0, 1, (n,)).astype(np.float32)).to(card)
    x = torch.from_numpy(
        rng.integers(0, 256, (n, w_px * c)).astype(np.uint8)).to(card)
    launches = fused_shift_lerp.launches
    for src in (x, x.to(torch.bfloat16), x.float()):
        for out_dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 1.0)):
            got = fused_shift_lerp(src, k, f, out_w * c, c, out_dtype)
            ref = shift_lerp_flat_plain(src, k, f, out_w * c, c, out_dtype)
            torch.cuda.synchronize()
            assert (got.float() - ref.float()).abs().max().item() <= tol
    assert fused_shift_lerp.launches == launches + 6


_LERP_PAIRS = [(a, b) for a in (torch.uint8, torch.bfloat16, torch.float32)
               for b in (torch.bfloat16, torch.float32)]


def _shifts(rng, card, n, w, out, clamp_both=False):
    """k past both clamps (or, with clamp_both, rows clamped on both sides
    only), and fractions."""
    if clamp_both:
        k = np.concatenate([rng.integers(-5000, -(out + 2), n // 2),
                            rng.integers(w, 5000, n - n // 2)])
    else:
        k = rng.integers(-(out + 12), w + 12, n)
    return (torch.from_numpy(k.astype(np.int32)).to(card),
            torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)).to(card))


def _grouped_exact(src, k, f, out, out_dtype, lerp, path):
    got = fused_shift_lerp_grouped(src, k, f if lerp else None, out,
                                   out_dtype if lerp else None, lerp)
    ref = shift_lerp_grouped_plain(src, k, f if lerp else None, out,
                                   out_dtype if lerp else None, lerp)
    torch.cuda.synchronize()
    assert fused_shift_lerp_grouped.last_path == path
    assert torch.equal(got, ref)
    return got


@pytest.mark.parametrize("in_dtype,out_dtype", _LERP_PAIRS)
@pytest.mark.parametrize("w,out", [(224, 768), (224, 384), (224, 256)])
def test_shift_vec16_path_is_bit_exact(card, in_dtype, out_dtype, w, out):
    """The 16-byte path at the leaderboard's and the pretrain recipe's row
    widths, small N, every lerp type pair: bit for bit the plain version."""
    rng = np.random.default_rng(11)
    n = 96
    x = torch.from_numpy(rng.integers(0, 256, (3, n, w)).astype(np.uint8))
    k, f = _shifts(rng, card, n, w, out)
    _grouped_exact(x.to(card, in_dtype), k, f, out, out_dtype, True, "vec16")


@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,out", [(1001, 768), (1001, 100), (1001, 129)])
def test_shift_raw_mode_keeps_the_bits(card, dtype, n, out):
    """The raw mode (integer shift) on both paths, odd N and ragged tails:
    torch.equal with the plain version, in the input type."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.integers(0, 256, (3, n, 224)).astype(np.uint8))
    k, f = _shifts(rng, card, n, 224, out)
    path = ("vec16" if out * torch.empty((), dtype=dtype).element_size() % 16
            == 0 else "scalar")
    got = _grouped_exact(x.to(card, dtype), k, f, out, None, False, path)
    assert got.dtype == dtype


@pytest.mark.parametrize("in_dtype,out_dtype", _LERP_PAIRS)
@pytest.mark.parametrize("out", [100, 129])
def test_shift_ragged_tails_are_bit_exact(card, in_dtype, out_dtype, out):
    """Output rows that are not whole 16-byte runs (100 bf16 is 200 bytes,
    129 anything) take the scalar path; 100 f32 (400 bytes) the 16-byte
    one.  N = 1001."""
    rng = np.random.default_rng(13)
    n = 1001
    x = torch.from_numpy(rng.integers(0, 256, (3, n, 224)).astype(np.uint8))
    k, f = _shifts(rng, card, n, 224, out)
    row_bytes = out * torch.empty((), dtype=out_dtype).element_size()
    path = "vec16" if row_bytes % 16 == 0 else "scalar"
    _grouped_exact(x.to(card, in_dtype), k, f, out, out_dtype, True, path)


def test_shift_scalar_path_unaligned_and_odd_width(card):
    """The scalar path: an unaligned contiguous view (one byte into a
    buffer) and W = 130 (130-byte rows), bit for bit."""
    rng = np.random.default_rng(14)
    n, out = 1001, 768
    buf = torch.from_numpy(
        rng.integers(0, 256, 3 * n * 224 + 1).astype(np.uint8)).to(card)
    k, f = _shifts(rng, card, n, 224, out)
    view = buf[1:].view(3, n, 224)
    for lerp in (True, False):
        _grouped_exact(view, k, f, out, torch.bfloat16, lerp, "scalar")
    odd = torch.from_numpy(
        rng.integers(0, 256, (3, n, 130)).astype(np.uint8)).to(card)
    k, f = _shifts(rng, card, n, 130, out)
    for lerp in (True, False):
        _grouped_exact(odd, k, f, out, torch.float32, lerp, "scalar")


def test_shift_clamped_rows_are_zero(card):
    """Rows clamped on both sides read no source: exactly zero on both
    paths, lerp and raw."""
    rng = np.random.default_rng(15)
    n, out = 1001, 768
    x = torch.from_numpy(
        rng.integers(1, 256, (3, n, 224)).astype(np.uint8)).to(card)
    k, f = _shifts(rng, card, n, 224, out, clamp_both=True)
    for src, path in ((x, "vec16"), (x[:, :, :-1].contiguous(), "scalar")):
        for lerp in (True, False):
            got = _grouped_exact(src, k, f, out, torch.float32, lerp, path)
            assert got.abs().max().item() == 0


@pytest.mark.parametrize("c", [1, 3, 4])
def test_flat_shift_is_bit_exact(card, c):
    """Kernel 3 at C = 1, 3 and 4, every lerp type pair, N = 1001, with a
    ragged tail (out = 129 pixels), and rows clamped on both sides: bit for
    bit the plain version; the path follows the row bytes."""
    rng = np.random.default_rng(16 + c)
    n, w_px = 1001, 224
    x = torch.from_numpy(rng.integers(0, 256, (n, w_px * c)).astype(np.uint8))
    for out_w in (384, 129):
        k, f = _shifts(rng, card, n, w_px, out_w)
        for in_dtype, out_dtype in _LERP_PAIRS:
            src = x.to(card, in_dtype)
            got = fused_shift_lerp(src, k, f, out_w * c, c, out_dtype)
            ref = shift_lerp_flat_plain(src, k, f, out_w * c, c, out_dtype)
            torch.cuda.synchronize()
            assert fused_shift_lerp.last_path == shift_lerp._path_of(src, got)
            assert torch.equal(got, ref)
    k, f = _shifts(rng, card, n, w_px, 384, clamp_both=True)
    got = fused_shift_lerp(x.to(card), k, f, 384 * c, c, torch.float32)
    torch.cuda.synchronize()
    assert got.abs().max().item() == 0


def test_vec16_row_limit_matches_the_kernel(card):
    """The wrapper's widest 16-byte row is the kernel's; a wider row takes
    the scalar path and stays exact."""
    assert shift_lerp._library().peclr_shift_max_row_bytes() == VEC16_MAX_ROW_BYTES
    rng = np.random.default_rng(20)
    n, w, out = 40, VEC16_MAX_ROW_BYTES + 16, 256
    x = torch.from_numpy(rng.integers(0, 256, (1, n, w)).astype(np.uint8))
    k, f = _shifts(rng, card, n, w, out)
    _grouped_exact(x.to(card), k, f, out, torch.bfloat16, True, "scalar")


def test_shift_matmul_kernel_matches_plain(card):
    """Kernel 4 against its plain version on the card, bf16 taps on the
    tensor cores and f32 taps on the CUDA cores, ragged tiles: f32 out
    within 1e-2 (sum order), bf16 out within one bf16 step of 255."""
    rng = np.random.default_rng(7)
    g, b, r, w, u, m = 3, 5, 70, 224, 384, 130
    x = torch.from_numpy(
        rng.integers(0, 256, (g, b, r, w)).astype(np.uint8)).to(card)
    k = torch.from_numpy(
        rng.integers(-(u + 5), w + 5, (b * r,)).astype(np.int32)).to(card)
    f = torch.from_numpy(rng.uniform(0, 1, (b * r,)).astype(np.float32)).to(card)
    # taps of a resample: non-negative, each output's taps summing to 1
    taps = rng.uniform(0, 1, (b, m, u)).astype(np.float32)
    taps /= taps.sum(axis=2, keepdims=True)
    launches = fused_shift_lerp_matmul.launches
    for src in (x, x.to(torch.bfloat16)):
        for w_dtype in (torch.bfloat16, torch.float32):
            w_t = torch.from_numpy(taps).to(card, w_dtype)
            for out_dtype, tol in ((torch.float32, 1e-2),
                                   (torch.bfloat16, 1.0)):
                got = fused_shift_lerp_matmul(src, k, f, w_t, out_dtype)
                ref = shift_lerp_matmul_plain(src, k, f, w_t, out_dtype)
                torch.cuda.synchronize()
                assert got.shape == (g, b, m, r)
                assert (got.float() - ref.float()).abs().max().item() <= tol
    assert fused_shift_lerp_matmul.launches == launches + 8


def _band_inputs(rng, card, g, b, r, w, u, m, slopes):
    """uint8 rows, shifts past both clamps, the warp's area taps (bf16) at
    slopes drawn from `slopes`."""
    x = torch.from_numpy(
        rng.integers(0, 256, (g, b, r, w)).astype(np.uint8)).to(card)
    off = rng.uniform(-(u + 40), w + 40, (b * r,))
    k = torch.from_numpy(
        np.clip(np.floor(off), -(u + 2), w).astype(np.int32)).to(card)
    f = torch.from_numpy((off - np.floor(off)).astype(np.float32)).to(card)
    s = torch.from_numpy(rng.uniform(*slopes, (b,)).astype(np.float32))
    w_t = _area_matrix(s, u, m, transposed=True).to(card, torch.bfloat16)
    return x, k, f, w_t


@pytest.mark.parametrize("u,slopes", [(384, (1.0, 2.5)), (100, (0.5, 0.75))])
def test_band_kernel_matches_plain_at_recipe_slopes(card, u, slopes):
    """Kernel 4 with bf16 taps walks each tile's band only: against the
    dense plain version at area taps, ragged M, R and tiles (U = 100 stages
    its taps element by element): f32 out within 1e-2, bf16 within 1.0."""
    rng = np.random.default_rng(8)
    x, k, f, w_t = _band_inputs(rng, card, 3, 5, 70, 224, u, 130, slopes)
    launches = fused_shift_lerp_matmul.launches
    for src in (x, x.to(torch.bfloat16)):
        for out_dtype, tol in ((torch.float32, 1e-2), (torch.bfloat16, 1.0)):
            got = fused_shift_lerp_matmul(src, k, f, w_t, out_dtype)
            ref = shift_lerp_matmul_plain(src, k, f, w_t, out_dtype)
            torch.cuda.synchronize()
            assert got.shape == (3, 5, 130, 70)
            assert (got.float() - ref.float()).abs().max().item() <= tol
    assert fused_shift_lerp_matmul.launches == launches + 4


def test_band_kernel_zero_and_last_taps(card):
    """All-zero taps give exactly 0; a single tap at u = U - 1 (the band's
    last rounded chunk) matches the plain version."""
    rng = np.random.default_rng(9)
    x, k, f, w_t = _band_inputs(rng, card, 3, 5, 70, 224, 100, 130, (0.5, 0.75))
    zero = torch.zeros_like(w_t)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = fused_shift_lerp_matmul(x, k, f, zero, out_dtype)
        torch.cuda.synchronize()
        assert got.abs().max().item() == 0
    last = torch.zeros_like(w_t)
    last[..., -1] = 0.5
    got = fused_shift_lerp_matmul(x, k, f, last, torch.float32)
    ref = shift_lerp_matmul_plain(x, k, f, last, torch.float32)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-2


def test_tap_band_kernel_is_bit_exact(card):
    """The band pass against its plain version: sparse bf16 taps with empty
    tiles, U a multiple of 8 (16-byte loads) and not (scalar loads)."""
    rng = np.random.default_rng(10)
    for u in (384, 100):
        taps = rng.uniform(-1, 1, (5, 130, u)).astype(np.float32)
        taps[rng.uniform(0, 1, taps.shape) > 0.01] = 0
        taps[1, :64] = 0
        taps[2] = 0
        w_t = torch.from_numpy(taps).to(card, torch.bfloat16)
        launches = tap_band.launches
        got = tap_band(w_t)
        torch.cuda.synchronize()
        assert tap_band.launches == launches + 1
        assert torch.equal(got.cpu(), tap_band_plain(w_t.cpu()))


@pytest.mark.parametrize("route", ["grouped", "matmul"])
def test_pretrain_step_runs_on_the_card(card, route):
    """One RN18 pretrain step (64 -> 32 canvases, accum 2) on the card, in
    bf16: a finite loss, the route's kernel launched twice per microbatch,
    and the parameters on the card."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.train.recipe import (
        build_pretrain_state,
        synthetic_pretrain_batch,
    )
    from peclr_tpu_torch.train.step import make_peclr_train_step

    model, state, opt = build_pretrain_state("18", batch=4, accum=2,
                                             device=card)
    step = make_peclr_train_step(model, opt, peclr_pretrain_flags(),
                                 AugmentationParams(resize_shape=(32, 32)),
                                 accum=2, warp_route=route)
    batch = synthetic_pretrain_batch(8, canvas=64, seed=0, device=card)
    kernel = (fused_shift_lerp_grouped if route == "grouped"
              else fused_shift_lerp_matmul)
    before = kernel.launches
    state, metrics = step(state, batch, torch.Generator(card).manual_seed(0))
    torch.cuda.synchronize()
    assert kernel.launches == before + 4
    assert torch.isfinite(metrics["loss"]).item()
    assert state.step == 1
    assert all(p.device.type == "cuda" for p in model.parameters())


def test_train_cli_one_epoch_on_the_card(card, tmp_path, monkeypatch):
    """One epoch of the pretraining CLI at RN18 on the card (FreiHAND-layout
    data written to a temporary directory, canvas 64 -> 32 views, 8 x 2 a
    step): finite losses, the model on the card, TF32 off, kernel 1
    launched twice per microbatch, per validation batch and, where
    matplotlib is installed, for the epoch's pair figure; a checkpoint."""
    import json
    import os

    from peclr_tpu_torch import constants
    from peclr_tpu_torch.cli import train as cli
    from peclr_tpu_torch.data.synthetic import generate_freihand_like

    fh = generate_freihand_like(str(tmp_path / "fh"), num_unique=8, seed=7)
    monkeypatch.setattr(constants, "FREIHAND_DATA", fh)
    monkeypatch.setattr(constants, "SAVED_MODELS_BASE_PATH",
                        str(tmp_path / "models"))
    monkeypatch.setattr(constants, "SAVED_META_INFO_PATH", str(tmp_path / "meta"))
    before = fused_shift_lerp_grouped.launches
    trainer = cli.main([
        "--rotate", "--crop", "--color_jitter", "--resize", "-batch_size", "8",
        "-accumulate_grad_batches", "2", "-epochs", "1", "-resnet_size", "18",
        "-train_ratio", "0.75", "-sources", "freihand", "-canvas", "64",
        "-view_size", "32", "-num_workers", "2"])
    torch.cuda.synchronize()
    assert trainer.device.type == "cuda"
    assert all(p.device.type == "cuda" for p in trainer.model.parameters())
    assert not torch.backends.cudnn.allow_tf32
    # 24 samples: 1 step of 2 microbatches; 8 validation samples: 1 batch
    figure = 2 if trainer.log_images else 0
    assert fused_shift_lerp_grouped.launches == before + 2 * 2 + 2 + figure
    with open(os.path.join(trainer.tracker.dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["context"] for r in records] == ["train", "val"]
    assert all(np.isfinite(r["loss"]) for r in records)
    assert sorted(os.listdir(trainer.ckpt.directory)) == ["epoch_0",
                                                          "index.json"]


def test_prefetch_copier_reuses_its_pinned_buffers(card, monkeypatch):
    """One cuda_copier serves two device_prefetch calls: the batches arrive
    equal to the host's, and the second call stages them in the pinned
    buffers that the first one made."""
    from peclr_tpu_torch.data import pipeline

    rng = np.random.default_rng(0)
    host = [{"image": rng.integers(0, 256, (4, 8, 8, 3), dtype=np.uint8)}
            for _ in range(3)]
    pinned = []
    real_empty = torch.empty

    def empty(*args, **kwargs):
        out = real_empty(*args, **kwargs)
        if kwargs.get("pin_memory"):
            pinned.append(out)
        return out

    monkeypatch.setattr(torch, "empty", empty)
    copier = pipeline.cuda_copier(card)
    for _ in range(2):
        got = [b["image"].cpu().numpy() for b in
               pipeline.device_prefetch(iter(host), card, copier=copier)]
        assert all(np.array_equal(g, h["image"]) for g, h in zip(got, host))
    assert len(pinned) == 2  # two slots, pinned once


def test_prefetch_defaults_to_the_card(card):
    """device_prefetch with no device puts every batch on the card."""
    from peclr_tpu_torch.data import pipeline

    host = [{"image": np.full((2, 4, 4, 3), i, np.uint8)} for i in range(3)]
    got = list(pipeline.device_prefetch(iter(host)))
    assert len(got) == 3
    for i, batch in enumerate(got):
        assert batch["image"].is_cuda
        assert int(batch["image"][0, 0, 0, 0]) == i


def test_host_to_device_passes_a_card_tensor_to_an_unindexed_device(card):
    """A tensor already on the card goes through host_to_device for the
    device `cuda`, with no index, as for `cuda:0`: the same tensor, no
    copy (pred_pipeline's batches on the card)."""
    from peclr_tpu_torch.data import pipeline

    x = torch.arange(6, device=card).reshape(2, 3)
    for device in (torch.device("cuda"), card):
        assert pipeline.host_to_device(x, device) is x


def test_finetune_cli_one_epoch_on_the_card(card, tmp_path, monkeypatch):
    """One epoch of the fine-tune CLI at RN50 on the card (FreiHAND-layout
    data written to a temporary directory, 224² canvases to 64² crops, 2
    steps of 8): finite losses, the model on the card, TF32 off, kernel 1
    launched twice a step and the other kernels not at all; a
    checkpoint."""
    import os

    from peclr_tpu_torch import constants
    from peclr_tpu_torch.cli import finetune as cli
    from peclr_tpu_torch.data.synthetic import generate_freihand_like

    fh = generate_freihand_like(str(tmp_path / "fh"), num_unique=8, seed=7)
    monkeypatch.setattr(constants, "FREIHAND_DATA", fh)
    counts = (lambda: (fused_shift_lerp_grouped.launches,
                       fused_shift_lerp_grouped.raw_launches,
                       fused_shift_lerp.launches,
                       fused_shift_lerp_matmul.launches))
    before = counts()
    state, records = cli.main([
        "-batch_size", "8", "-epochs", "1", "-steps_per_epoch", "2",
        "-resnet_size", "50", "-crop_size", "64", "-train_ratio", "0.75",
        "-num_workers", "2", "-workdir", str(tmp_path / "ft")])
    torch.cuda.synchronize()
    after = counts()
    assert all(p.device.type == "cuda" for p in state.model.parameters())
    assert not torch.backends.cudnn.allow_tf32
    assert after[0] - before[0] == 2 * 2
    assert after[1:] == before[1:]
    assert records[0]["steps"] == 2 and np.isfinite(records[0]["loss"])
    assert os.path.exists(os.path.join(str(tmp_path / "ft"), "checkpoints",
                                       "epoch_0", "state.pt"))


#: per warp route: the module attribute its kernel is reached through, and
#: the kernel's plain version (the same arguments)
_ROUTE_KERNELS = {
    "grouped": ("peclr_tpu_torch.ops.warp_mxu", "fused_shift_lerp_grouped",
                shift_lerp_grouped_plain),
    "nhwc": ("peclr_tpu_torch.ops.shift_lerp", "fused_shift_lerp",
             shift_lerp_flat_plain),
    "matmul": ("peclr_tpu_torch.ops.warp_mxu", "fused_shift_lerp_matmul",
               shift_lerp_matmul_plain),
}


def _all_flags():
    from peclr_tpu_torch.config.defaults import AugmentationFlags

    return AugmentationFlags(rotate=True, crop=True, color_jitter=True,
                             resize=True, random_crop=True, sobel_filter=True,
                             cut_out=True, gaussian_blur=True,
                             gaussian_noise=True, color_drop=True)


@pytest.mark.parametrize("route", ["grouped", "nhwc", "matmul"])
def test_bf16_pass1_sources_match_plain(card, route, monkeypatch):
    """Under sobel, cut-out and blur the warp's first pass reads bf16
    sources (the f32 canvases in the compute dtype): captured from `apply`
    with all flags (16 canvases, 224 -> 128), kernels 1 and 3 bit-exact
    against their plain versions, kernel 4 within its bf16 bound of 1.0."""
    from peclr_tpu_torch.config.defaults import AugmentationParams
    from peclr_tpu_torch.ops import augment
    from peclr_tpu_torch.train.recipe import synthetic_pretrain_batch

    module_name, name, plain = _ROUTE_KERNELS[route]
    module = importlib.import_module(module_name)
    kernel = getattr(module, name)
    calls = []

    def capture(*args, **kw):
        calls.append((args, kw))
        return kernel(*args, **kw)

    # the flat kernel counts its launches on its module's name
    functools.update_wrapper(capture, kernel)
    monkeypatch.setattr(module, name, capture)
    batch = synthetic_pretrain_batch(16, canvas=224, seed=3, device=card)
    flags, params = _all_flags(), AugmentationParams()
    draws = augment.draw(torch.Generator(card).manual_seed(3), 16, flags,
                         params)
    out = augment.apply(batch["image"], batch["joints25d"], draws, flags,
                        params, route=route)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert torch.isfinite(out.images).all()
    assert len(calls) == 2
    args, kw = calls[0]
    assert args[0].dtype == torch.bfloat16
    got, ref = kernel(*args, **kw), plain(*args, **kw)
    torch.cuda.synchronize()
    if route == "matmul":
        assert (got.float() - ref.float()).abs().max().item() <= 1.0
    else:
        assert torch.equal(got, ref)
        assert kernel.last_path == "vec16"


@pytest.mark.parametrize("route", ["grouped", "gather"])
def test_all_flags_microbatch_on_the_card(card, route):
    """One RN18 microbatch with all flags (64 -> 32 canvases) on the card,
    in bf16: a finite loss; kernel 1 launched twice on the grouped route,
    no kernel on the gather route."""
    from peclr_tpu_torch.config.defaults import AugmentationParams
    from peclr_tpu_torch.train.recipe import (
        build_pretrain_state,
        synthetic_pretrain_batch,
    )
    from peclr_tpu_torch.train.step import make_peclr_train_step

    model, state, opt = build_pretrain_state("18", batch=4, accum=1,
                                             device=card)
    step = make_peclr_train_step(model, opt, _all_flags(),
                                 AugmentationParams(resize_shape=(32, 32)),
                                 accum=1, warp_route=route)
    batch = synthetic_pretrain_batch(4, canvas=64, seed=0, device=card)
    kernels = (fused_shift_lerp_grouped, fused_shift_lerp,
               fused_shift_lerp_matmul)
    before = [k.launches for k in kernels]
    state, metrics = step(state, batch, torch.Generator(card).manual_seed(0))
    torch.cuda.synchronize()
    launched = [k.launches - b for k, b in zip(kernels, before)]
    assert launched == ([2, 0, 0] if route == "grouped" else [0, 0, 0])
    assert torch.isfinite(metrics["loss"]).item()
    assert state.step == 1


def _rank_rows(rank, images, rows_an_image):
    """Rank `rank` of 2's images of a doubled microbatch of `images` (both
    views) and their rows, in parallel/mesh.py:shard_batch's layout."""
    from peclr_tpu_torch.parallel.mesh import Mesh, local_rows

    mesh = Mesh(None, rank, 2, torch.device("cpu"), "gloo")
    imgs = local_rows(mesh, images, accum=2)
    rows = (imgs[:, None] * rows_an_image + np.arange(rows_an_image)).reshape(-1)
    return torch.from_numpy(imgs), torch.from_numpy(rows)


@pytest.mark.parametrize("kernel", ["grouped", "flat", "matmul"])
def test_rank_rows_equal_the_whole_batch_rows(card, kernel):
    """Data parallel, each rank calls the warp's kernels on its own images'
    rows (the counterpart of the reference's _grouped_cp / _flat_cp
    partitioning rules): a rank's call of kernel 1, 3 or 4 equals those
    rows of the whole batch's call, bit for bit for kernels 1 and 3 and
    within kernel 4's bf16 bound of 1.0, at the recipe's first-pass widths
    (224² uint8 canvases to 384 columns, 16 images: 8 a view)."""
    rng = np.random.default_rng(9)
    n_img, r, w, c, out = 16, 224, 224, 3, 384
    k, f = _shifts(rng, card, n_img * r, w, out)
    for rank in range(2):
        imgs, rows = _rank_rows(rank, n_img, r)
        imgs, rows = imgs.to(card), rows.to(card)
        if kernel == "grouped":
            x = torch.from_numpy(rng.integers(0, 256, (3, n_img * r, w))
                                 .astype(np.uint8)).to(card)
            whole = fused_shift_lerp_grouped(x, k, f, out, torch.bfloat16)
            part = fused_shift_lerp_grouped(x[:, rows].contiguous(), k[rows],
                                            f[rows], out, torch.bfloat16)
            assert torch.equal(part, whole[:, rows])
        elif kernel == "flat":
            x = torch.from_numpy(rng.integers(0, 256, (n_img * r, w * c))
                                 .astype(np.uint8)).to(card)
            whole = fused_shift_lerp(x, k, f, out * c, c, torch.bfloat16)
            part = fused_shift_lerp(x[rows].contiguous(), k[rows], f[rows],
                                    out * c, c, torch.bfloat16)
            assert torch.equal(part, whole[rows])
        else:
            x = torch.from_numpy(rng.integers(0, 256, (3, n_img, r, w))
                                 .astype(np.uint8)).to(card)
            s = torch.from_numpy(rng.uniform(1.0, 2.5, (n_img,))
                                 .astype(np.float32))
            w_t = _area_matrix(s, out, 128, transposed=True).to(
                card, torch.bfloat16)
            whole = fused_shift_lerp_matmul(x, k, f, w_t, torch.bfloat16)
            part = fused_shift_lerp_matmul(x[:, imgs].contiguous(), k[rows],
                                           f[rows], w_t[imgs].contiguous(),
                                           torch.bfloat16)
            err = (part.float() - whole[:, imgs].float()).abs().max().item()
            assert err <= 1.0
        torch.cuda.synchronize()


def _rn18_step(dev, draws, mesh=None):
    """One RN18 pretrain step at the dry-run shape in f32 on `dev` (this
    rank's rows with a mesh), fed `draws`: its loss and BatchNorm running
    statistics."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.parallel.mesh import shard_batch
    from peclr_tpu_torch.train.recipe import (
        build_pretrain_state,
        synthetic_pretrain_batch,
    )
    from peclr_tpu_torch.train.step import make_peclr_train_step

    model, state, opt = build_pretrain_state("18", batch=4, accum=2,
                                             device=dev)
    step = make_peclr_train_step(model, opt, peclr_pretrain_flags(),
                                 AugmentationParams(resize_shape=(32, 32)),
                                 accum=2, precision="f32", mesh=mesh)
    batch = synthetic_pretrain_batch(8, canvas=64, seed=0, device=dev)
    if mesh is not None:
        batch = shard_batch(mesh, batch, accum=2)
    state, metrics = step(state, batch, None, draws=[
        {k: torch.from_numpy(v).to(dev) for k, v in d.items()} for d in draws])
    return metrics["loss"].item(), {
        k: v.cpu().numpy() for k, v in model.state_dict().items()
        if "running" in k}


def _rn18_rank(mesh, draws):
    return _rn18_step(mesh.device, draws, mesh)


def test_two_gloo_ranks_on_one_card_match_one_process(card):
    """Two gloo ranks on the one card (NCCL refuses two ranks on one card)
    run the RN18 dry-run step in f32 as one process on the card does, from
    the same weights and draws: loss and BatchNorm running statistics
    within 1e-3, the ranks equal."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.ops import augment
    from peclr_tpu_torch.parallel.dryrun import spawn

    gen = torch.Generator().manual_seed(3)
    draws = [{k: v.numpy() for k, v in augment.draw(
        gen, 8, peclr_pretrain_flags(),
        AugmentationParams(resize_shape=(32, 32))).items()} for _ in range(2)]
    loss, running = _rn18_step(card, draws)
    ranks = spawn(_rn18_rank, 2, args=(draws,), device="cuda:0",
                  backend="gloo", timeout=300.0)
    assert ranks[0][0] == ranks[1][0]
    assert abs(ranks[0][0] / loss - 1.0) <= 1e-3
    for key, ref in running.items():
        for got in (ranks[0][1][key], ranks[1][1][key]):
            err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)
            assert err <= 1e-3, key


def test_batchnorm_across_ranks_on_the_card(card):
    """The BatchNorm across two gloo ranks on the card (the fused kernels of
    SyncBatchNorm) against torch's on the whole batch in one process, as
    the CPU's written-out formulas are held in tests/test_torch_parallel.py,
    and against those formulas on the same ranks: f32 within 1e-5 of each
    tensor's scale."""
    from peclr_tpu_torch.parallel.dryrun import spawn
    # by the name pytest gives the file (tests/ is not a package)
    from test_torch_parallel import (
        _batchnorm_rank,
        batchnorm_inputs,
        check_batchnorm_ranks,
    )

    x, dy = batchnorm_inputs(n=8, c=64, hw=16)
    ranks = spawn(_batchnorm_rank, 2, args=(x, dy, ("cpu", "cuda:0")),
                  device="cuda:0", backend="gloo", timeout=300.0)
    check_batchnorm_ranks(ranks, x, dy, "cuda:0", rtol=1e-5)
    for out in ranks:
        for key, value in out["cpu"].items():
            scale = np.abs(value).max()
            np.testing.assert_allclose(out["cuda:0"][key], value, rtol=0,
                                       atol=1e-5 * scale, err_msg=key)


def _host_waits_rank(mesh):
    """The host's waits on the card in one RN18 step, counted by
    torch.cuda.set_sync_debug_mode("warn") (its warnings that an operation
    synchronised, not its note that the mode is a prototype), without a
    mesh and with this one NCCL rank's, each after two steps that make
    DDP's buckets and warm the libraries up."""
    import warnings

    from peclr_tpu_torch.config.defaults import (
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.parallel.mesh import shard_batch
    from peclr_tpu_torch.train.recipe import (
        build_pretrain_state,
        synthetic_pretrain_batch,
    )
    from peclr_tpu_torch.train.step import make_peclr_train_step

    counts = {}
    for name, with_mesh in (("plain", None), ("mesh", mesh)):
        model, state, opt = build_pretrain_state("18", batch=4, accum=2,
                                                 device=mesh.device)
        step = make_peclr_train_step(
            model, opt, peclr_pretrain_flags(),
            AugmentationParams(resize_shape=(32, 32)), accum=2,
            mesh=with_mesh)
        batch = synthetic_pretrain_batch(8, canvas=64, seed=0,
                                         device=mesh.device)
        if with_mesh is not None:
            batch = shard_batch(mesh, batch, accum=2)
        gen = torch.Generator(mesh.device).manual_seed(0)
        for _ in range(2):
            state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                state, metrics = step(state, batch, gen)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts[name] = sum("called a synchronizing CUDA operation"
                           in str(w.message) for w in caught)
    return counts


def test_data_parallel_step_adds_no_host_waits(card):
    """The data-parallel step (one NCCL rank: the collectives, the cross-
    rank BatchNorm, DDP, the rank's draws) makes the host wait on the card
    no more often than the single-process step, which makes no wait: each
    wait holds the next launches back behind the card's queue."""
    from peclr_tpu_torch.parallel.dryrun import spawn

    (counts,) = spawn(_host_waits_rank, 1, device="cuda:0", backend="nccl",
                      timeout=300.0)
    assert counts["mesh"] == counts["plain"] == 0, counts


def _f32_tap_inputs(rng, card, case):
    """Kernel 4's f32-tap cases: G = 3 planes of 5 images, uint8 or f32
    sources, shifts past both clamps, f32 taps."""
    g, b, r, w = 3, 5, 70, 224
    src, u, m, taps = {
        "area_u8": ("u8", 384, 130, "area"),
        "area_f32_source": ("f32", 256, 128, "area"),
        "tent_u8": ("u8", 384, 130, "tent"),
        "dense_f32_source": ("f32", 384, 64, "dense"),
        "zero_u8": ("u8", 384, 130, "zero"),
        "ragged_u100_m72_r40": ("u8", 100, 72, "area"),
    }[case]
    if case.startswith("ragged"):
        r = 40
    if src == "u8":
        x = torch.from_numpy(rng.integers(0, 256, (g, b, r, w)).astype(np.uint8))
    else:
        x = torch.from_numpy(rng.uniform(0, 255, (g, b, r, w)).astype(np.float32))
    off = rng.uniform(-(u + 40), w + 40, (b * r,))
    k = torch.from_numpy(np.clip(np.floor(off), -(u + 2), w).astype(np.int32))
    f = torch.from_numpy((off - np.floor(off)).astype(np.float32))
    if taps == "dense":
        w_t = rng.uniform(0, 1, (b, m, u)).astype(np.float32)
        w_t = torch.from_numpy(w_t / w_t.sum(axis=2, keepdims=True))
    elif taps == "zero":
        w_t = torch.zeros((b, m, u))
    else:
        from peclr_tpu_torch.ops.warp_mxu import _tent_matrix

        matrix = _area_matrix if taps == "area" else _tent_matrix
        slopes = (1.0, 2.5) if taps == "area" else (0.5, 1.0)
        s = torch.from_numpy(rng.uniform(*slopes, (b,)).astype(np.float32))
        w_t = matrix(s, u, m, transposed=True)
    return x.to(card), k.to(card), f.to(card), w_t.to(card)


@pytest.mark.parametrize("case", ["area_u8", "area_f32_source", "tent_u8",
                                  "dense_f32_source", "zero_u8",
                                  "ragged_u100_m72_r40"])
def test_f32_tap_kernel_matches_plain(card, case):
    """Kernel 4 with f32 taps (band-limited tiles of 8 outputs, CUDA-core
    FMAs) against its dense plain version on the card: f32 out within 1e-2
    (sum order), bf16 out within 1.0; zero taps give exactly 0; one counted
    launch a call."""
    rng = np.random.default_rng(12)
    x, k, f, w_t = _f32_tap_inputs(rng, card, case)
    launches = fused_shift_lerp_matmul.launches
    for out_dtype, tol in ((torch.float32, 1e-2), (torch.bfloat16, 1.0)):
        got = fused_shift_lerp_matmul(x, k, f, w_t, out_dtype)
        ref = shift_lerp_matmul_plain(x, k, f, w_t, out_dtype)
        torch.cuda.synchronize()
        assert got.shape == ref.shape and got.dtype == out_dtype
        assert bool(torch.isfinite(got).all())
        assert (got.float() - ref.float()).abs().max().item() <= tol
        if case == "zero_u8":
            assert got.abs().max().item() == 0
    assert fused_shift_lerp_matmul.launches == launches + 2


def test_f32_tap_band_kernel_is_bit_exact(card):
    """The band pass on f32 taps (tiles of BAND_M_F32 outputs) against its
    plain version: sparse taps with empty tiles, -0 as zero, U a multiple
    of 4 (16-byte loads) and not (scalar loads)."""
    from peclr_tpu_torch.ops.shift_lerp_matmul import BAND_M_F32

    rng = np.random.default_rng(13)
    for u in (384, 100, 37):
        taps = rng.uniform(-1, 1, (5, 130, u)).astype(np.float32)
        taps[rng.uniform(0, 1, taps.shape) > 0.02] = 0
        taps[1, :64] = -0.0
        taps[2] = 0
        w_t = torch.from_numpy(taps).to(card)
        launches = tap_band.launches
        got = tap_band(w_t)
        torch.cuda.synchronize()
        assert tap_band.launches == launches + 1
        assert got.shape == (5, -(-130 // BAND_M_F32), 2)
        assert torch.equal(got.cpu(), tap_band_plain(w_t.cpu(), BAND_M_F32))


_WAIT_PATHS = ([f"pretrain_{flags}_{route}_bf16"
                for flags in ("recipe", "all_flags")
                for route in ("grouped", "nhwc", "matmul", "gather")]
               + ["pretrain_recipe_matmul_f32", "finetune_step",
                  "run_two_pass", "inference_session"])


def _wait_path(name, dev):
    """One path of the port as a function of no argument, at a small size:
    the pretrain step (RN18, 64 -> 32, accum 2), the fine-tune step (RN18,
    96² to 64², batch 8, the lifted-3D loss), one two-pass batch of four
    224² frames (RN18) and one InferenceSession._predict (RN18, 4 x 64²)."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationFlags,
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.data.synthetic import (
        seeded_frames,
        seeded_intrinsics,
        seeded_rn25d_variables,
    )
    from peclr_tpu_torch.eval.pred_fh import run_two_pass
    from peclr_tpu_torch.eval.serving import InferenceSession
    from peclr_tpu_torch.models import RN25DPose
    from peclr_tpu_torch.models.port import rn25d_variables_to_state_dict
    from peclr_tpu_torch.train.finetune import make_finetune_step
    from peclr_tpu_torch.train.optimizer import build_optimizer
    from peclr_tpu_torch.train.recipe import (
        build_pretrain_state,
        synthetic_pretrain_batch,
        synthetic_supervised_batch,
    )
    from peclr_tpu_torch.train.state import TrainState
    from peclr_tpu_torch.train.step import make_peclr_train_step

    if name.startswith("pretrain_"):
        flags_name, route, precision = name[len("pretrain_"):].rsplit("_", 2)
        flags = (peclr_pretrain_flags() if flags_name == "recipe"
                 else _all_flags())
        model, state, opt = build_pretrain_state("18", batch=4, accum=2,
                                                 device=dev)
        step = make_peclr_train_step(
            model, opt, flags, AugmentationParams(resize_shape=(32, 32)),
            accum=2, warp_route=route, precision=precision)
        batch = synthetic_pretrain_batch(8, canvas=64, seed=0, device=dev)
        return functools.partial(step, state, batch,
                                 torch.Generator(dev).manual_seed(0))
    pose = RN25DPose("18")
    pose.load_state_dict(rn25d_variables_to_state_dict(
        seeded_rn25d_variables("18", 0), "18"), strict=True)
    pose.to(dev)
    if name == "finetune_step":
        opt, _ = build_optimizer(pose, base_lr=1e-4, batch_size=8, accum=1,
                                 steps_per_epoch=2, epochs=2, optimizer="adam")
        step = make_finetune_step(
            pose, opt, AugmentationFlags(crop=True, rotate=True, resize=True),
            AugmentationParams(resize_shape=(64, 64)), loss_3d_weight=0.1)
        batch = synthetic_supervised_batch(8, canvas=96, seed=1, device=dev)
        return functools.partial(step, TrainState(pose, opt), batch,
                                 torch.Generator(dev).manual_seed(0))
    if name == "run_two_pass":
        x = torch.from_numpy(seeded_frames(4, 7)).to(dev)
        K = torch.from_numpy(seeded_intrinsics(4, 8)).to(dev)
        return functools.partial(run_two_pass, pose.eval(), x, K)
    sess = InferenceSession(pose, batch_size=4, image_size=64, device=dev)
    frames = np.random.default_rng(3).integers(0, 256, (4, 64, 64, 3),
                                               dtype=np.uint8)
    return functools.partial(sess._predict, frames, seeded_intrinsics(4, 9))


@pytest.mark.parametrize("name", _WAIT_PATHS)
def test_paths_make_no_host_waits(card, name):
    """After one call that builds what the path builds on first use, the
    pretrain step (recipe and all flags, each route), the fine-tune step,
    one two-pass leaderboard batch and one serving batch make the host wait
    on the card nowhere: torch.cuda.set_sync_debug_mode("error") raises at
    the first wait."""
    fn = _wait_path(name, card)
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_step_factories_turn_tf32_off(card):
    """A model moved to the card by its caller, not through resolve_device:
    building the pretrain step, its eval step or the fine-tune step turns
    all three TF32 switches off."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationFlags,
        AugmentationParams,
    )
    from peclr_tpu_torch.models import PeCLRModel, RN25DPose
    from peclr_tpu_torch.train.finetune import make_finetune_step
    from peclr_tpu_torch.train.optimizer import build_optimizer
    from peclr_tpu_torch.train.step import (
        make_peclr_eval_step,
        make_peclr_train_step,
    )

    flags, params = AugmentationFlags(crop=True, resize=True), AugmentationParams()
    switches = (
        (torch.backends.cudnn, "allow_tf32"),
        (torch.backends.cuda.matmul, "allow_tf32"),
        (torch.backends.cuda.matmul,
         "allow_bf16_reduced_precision_reduction"),
    )
    peclr, rn25d = PeCLRModel("18").to(card), RN25DPose("18").to(card)
    builds = {
        "pretrain": lambda: make_peclr_train_step(
            peclr, build_optimizer(peclr, 1e-4, 8, 1, 10, 1)[0], flags,
            params),
        "pretrain_eval": lambda: make_peclr_eval_step(peclr, flags, params),
        "finetune": lambda: make_finetune_step(
            rn25d, build_optimizer(rn25d, 1e-4, 8, 1, 10, 1)[0], flags,
            params),
    }
    try:
        for name, build in builds.items():
            for module, attr in switches:
                setattr(module, attr, True)
            build()
            for module, attr in switches:
                assert getattr(module, attr) is False, (name, attr)
    finally:
        for module, attr in switches:
            setattr(module, attr, False)


@pytest.mark.parametrize("src_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tap_dtype", [torch.bfloat16, torch.float32])
def test_shift_matmul_kernel_keeps_nonfinite_windows(card, src_dtype,
                                                     tap_dtype):
    """Kernel 4 on float sources with Inf and NaN under zero taps and in
    rows of all-zero tiles: NaN, +Inf and -Inf exactly where its dense plain
    version has them, the other values within 1e-2 (sum order); rows past
    one block (R = 70) and images with finite rows beside the flagged ones;
    one counted launch a call."""
    rng = np.random.default_rng(14)
    g, b, r, w, u, m = 3, 4, 70, 224, 256, 130
    x = rng.uniform(0, 255, (g, b, r, w)).astype(np.float32)
    off = rng.uniform(-(u + 40), w + 40, (b * r,))
    k = np.clip(np.floor(off), -(u + 2), w).astype(np.int32)
    f = (off - np.floor(off)).astype(np.float32)
    for gi, bi, ri, col, val in ((0, 0, 3, 100, np.inf), (1, 0, 40, 7, -np.inf),
                                 (2, 1, 65, 200, np.nan), (0, 3, 33, 0, np.nan),
                                 (1, 2, 10, 223, np.inf)):
        x[gi, bi, ri, col] = val
        k[bi * r + ri] = col - 60  # within the row's window
    x[2, 2, 50, 120:122] = 3.4e38  # finite in f32, Inf once cast to bf16
    k[2 * r + 50] = 60
    s = torch.from_numpy(rng.uniform(1.0, 1.75, (b,)).astype(np.float32))
    w_t = _area_matrix(s, u, m, transposed=True)
    w_t[3] = 0  # image 3: every tile's band is (0, 0)
    x_d = torch.from_numpy(x).to(card, src_dtype)
    k_d, f_d = torch.from_numpy(k).to(card), torch.from_numpy(f).to(card)
    w_d = w_t.to(card, tap_dtype)
    launches = fused_shift_lerp_matmul.launches
    got = fused_shift_lerp_matmul(x_d, k_d, f_d, w_d, torch.float32)
    ref = shift_lerp_matmul_plain(x_d, k_d, f_d, w_d, torch.float32)
    torch.cuda.synchronize()
    assert fused_shift_lerp_matmul.launches == launches + 1
    assert bool(torch.isnan(ref).any()) and bool(torch.isnan(ref[:, 3]).any())
    for mask in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(mask(got), mask(ref)), mask.__name__
    finite = torch.isfinite(ref)
    assert (got[finite] - ref[finite]).abs().max().item() <= 1e-2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("offset", [0, 1], ids=["vec16", "scalar"])
def test_stream_kernels_match_plain(card, dtype, offset):
    """csrc/streams.cu against ops/streams.py's plain versions on the card:
    copy, add and bn_res_relu bit-exact, stats within 1e-5 of the float64
    sum relative to the channel's sum of |x| (of x² for the squares); on
    the 16-byte path and, one element into the buffers, the scalar path;
    a ragged element count (not a multiple of 8); one launch a call."""
    from peclr_tpu_torch.ops import streams

    rng = np.random.default_rng(15)
    shape, c = (3, 5, 7, 64), 64
    n = int(np.prod(shape))

    def tensor(seed):
        flat = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            n + 16).astype(np.float32)).to(card, dtype)
        return flat[offset:offset + n].view(shape)

    x, r = tensor(1), tensor(2)
    g = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)).to(card)
    b = torch.from_numpy(rng.uniform(-1, 1, c).astype(np.float32)).to(card)
    for kernel, plain, extras in (
            (streams.stream_copy, streams.copy_plain, ()),
            (streams.stream_add, streams.add_plain, (r,)),
            (streams.stream_bn_res_relu, streams.bn_res_relu_plain,
             (r, g, b))):
        launches = kernel.launches
        got = kernel(x, *extras)
        assert torch.equal(got, plain(x, *extras)), kernel.__name__
        assert kernel.launches == launches + 1
        assert kernel.last_path == ("vec16" if offset == 0 else "scalar")
    ragged = x.reshape(-1)[:n - 3]
    assert torch.equal(streams.stream_copy(ragged), ragged + 1)
    launches = streams.stream_stats.launches
    got = streams.stream_stats(x).double()
    assert streams.stream_stats.launches == launches + 2  # partials, sum
    xd = x.double().reshape(-1, c)
    want = torch.stack([xd.sum(0), (xd * xd).sum(0)])
    scale = torch.stack([xd.abs().sum(0), (xd * xd).sum(0)])
    assert ((got - want).abs() / scale).max().item() <= 1e-5
    assert streams.stream_stats.last_path == ("vec16" if offset == 0
                                              else "scalar")
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stream_kernels_match_plain_at_many_rows(card, dtype):
    """The stream kernels on their 16-byte path at the layer-1 fusion's
    width with 16,384 rows a channel, so that every stats thread walks
    its unrolled rows and the grid-stride tail: bn_res_relu bit-exact
    with bench_streams' g and b drawn per channel (a kernel that skipped
    them, or read another channel's, would differ), stats within
    bench_streams.STATS_TOL of the float64 sum, where one row dropped or
    counted twice costs about 6e-5 of a channel's sum of |x|."""
    from peclr_tpu_torch.ops import streams
    from peclr_tpu_torch.scripts import bench_streams

    shape = (16, 32, 32, 256)
    x, r = (torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(card, dtype) for seed in (3, 4))
    g, b = bench_streams.check_scale_shift(shape[-1], card)
    got = streams.stream_bn_res_relu(x, r, g, b)
    assert streams.stream_bn_res_relu.last_path == "vec16"
    assert torch.equal(got, streams.bn_res_relu_plain(x, r, g, b))
    rel, _ = bench_streams._stats_err(streams.stream_stats(x), x)
    assert streams.stream_stats.last_path == "vec16"
    assert rel <= bench_streams.STATS_TOL, rel
    torch.cuda.synchronize()


@pytest.mark.parametrize("route", ["nhwc", "matmul"])
def test_weak_scaling_runs_kernels_3_and_4_under_ddp(card, route, tmp_path):
    """bench_multichip's weak scaling at world 1 over NCCL (RN18, 64² to
    32², 8 rows, accum 2): kernel 3 or 4 inside the DDP step, 2 x accum
    launches a step and none of the others', the first step within 1e-3
    relative of the same step without a mesh (bf16: the BatchNorm across
    ranks rounds some activations the other side, and 2 microbatches of 16
    views average little of it away), no host wait in the timed window."""
    from peclr_tpu_torch.scripts import bench_multichip

    rec = bench_multichip.main([
        "--world", "1", "--resnet", "18", "--canvas", "64", "--view", "32",
        "--batch", "8", "--accum", "2", "--iters", "1", "--route", route,
        "--out", str(tmp_path / "weak.json")])
    got = rec["routes"][route]
    kname = bench_multichip.ROUTE_KERNEL[route]
    assert rec["collective_backend"] == "nccl"
    for launches in (got["launches_per_step_per_rank"][0],
                     got["no_mesh"]["launches_per_step"]):
        assert launches == {k: (4 if k == kname else 0) for k in launches}
    assert abs(got["loss_step1"] / got["no_mesh"]["loss_step1"] - 1) <= 1e-3
    assert got["host_waits_in_window"] == 0


@pytest.mark.parametrize("route", ["grouped", "nhwc", "matmul"])
def test_weak_scaling_f32_mesh_step_is_the_no_mesh_step(card, route,
                                                        tmp_path):
    """The case above in f32 with TF32 off: at world 1 the DDP step's first
    loss is the no-mesh step's within 1e-6 relative (the BatchNorm across
    ranks sums its statistics in another order, and f32 rounds it away;
    bf16 does not, the case above)."""
    from peclr_tpu_torch.scripts import bench_multichip

    rec = bench_multichip.main([
        "--world", "1", "--resnet", "18", "--canvas", "64", "--view", "32",
        "--batch", "8", "--accum", "2", "--iters", "1", "--route", route,
        "--precision", "f32", "--out", str(tmp_path / "weak.json")])
    got = rec["routes"][route]
    assert rec["config"]["precision"] == "f32"
    assert abs(got["loss_step1"] / got["no_mesh"]["loss_step1"] - 1) <= 1e-6


POISON_CASES = [
    "kernel1_ragged_vec16_u8_to_bf16", "kernel1_ragged_scalar_u8_to_bf16",
    "kernel2_raw_ragged_scalar_u8", "kernel3_ragged_scalar_u8_to_bf16",
    "kernel4_ragged_bf16_src_bf16_taps", "kernel4_ragged_bf16_src_f32_taps",
    "tap_band_ragged_bf16", "tap_band_ragged_f32",
    "stream_copy_ragged_bfloat16", "stream_add_ragged_bfloat16",
    "stream_bn_res_relu_ragged_bfloat16", "stream_stats_ragged_bfloat16"]


@pytest.mark.parametrize("name", POISON_CASES)
def test_poisoned_buffers_leave_the_output_unchanged(card, name):
    """chip_smoke.py's poison check (phase 7c) on each kernel's ragged
    case: launched as it is and after the allocator's free blocks were
    filled with 0x00, 0xFF and 0xA5, every buffer the wrapper allocates
    comes from the filled blocks, no filled byte outside them changes and
    every output is the first to the bit; the first holds to the plain
    version.  The check raises on a failure."""
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import chip_smoke

    ragged = [s for s in chip_smoke.STREAM_POISON_SHAPES if s[0] == "ragged"]
    cases = {n: (launch, plain) for n, launch, plain in
             chip_smoke.ragged_cases(torch, card)
             + chip_smoke.stream_cases(torch, card, ragged)}
    row = chip_smoke.poison_case(torch, card, name, *cases[name])
    assert row["differing_patterns"] == []
    assert row["poisoned_buffers"] == [f"{row['buffers']}/{row['buffers']}"] * 3
    assert row["bytes_written_outside"] == [0, 0, 0]
