"""The port's two-pass affine warp (peclr_tpu_torch/ops/warp_mxu.py) against
the reference's affine_warp_mxu, in f32 on the CPU.

The reference runs its XLA shifter (PECLR_SHIFT=xla, windows not rounded
to 128 taps) or its Pallas kernels in interpret mode (PECLR_SHIFT=pallas,
windows rounded to 128); the port always takes the rounded windows, whose
extra taps read exact zeros, so both must agree with it.  Tolerance: 1e-2
on the 0-255 scale, as the reference holds its own two routes to."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peclr_tpu.eval import pred_fh as jax_pred_fh
from peclr_tpu.ops import warp_mxu as jax_warp
from peclr_tpu_torch.eval.pred_fh import initial_affine
from peclr_tpu_torch.geometry.affine import affine_from_bbox
from peclr_tpu_torch.ops import warp_mxu

ATOL = 1e-2


def _rotations(rng, b):
    """Rotation + scale + translation within +-40 degrees (the reference
    test's matrices, test_pallas_kernels.py)."""
    theta = np.deg2rad(rng.uniform(-40, 40, b)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, b).astype(np.float32)
    mats = []
    for i in range(b):
        c_, s_ = np.cos(theta[i]) * scale[i], np.sin(theta[i]) * scale[i]
        tx, ty = rng.uniform(-10, 10, 2)
        mats.append([[c_, -s_, tx], [s_, c_, ty], [0, 0, 1]])
    return np.asarray(mats, np.float32)


def _pred_fh_matrices(rng, b):
    """The leaderboard geometry: pass 1's shared affine, then refined boxes
    of every size the second pass produces."""
    centre = rng.uniform(60, 164, (b - 1, 2))
    side = rng.uniform(30, 220, (b - 1, 1))
    boxes = np.concatenate([centre - side / 2, centre + side / 2], 1)
    refined = affine_from_bbox(boxes.astype(np.float32), 224, 0.7).numpy()
    return np.concatenate([initial_affine()[None], refined]).astype(np.float32)


def _jax_warp(images, mats, out_hw, **kw):
    return np.asarray(jax_warp.affine_warp_mxu(
        jnp.asarray(images), jnp.asarray(mats), out_hw,
        compute_dtype=jnp.float32, **kw))


def _port_warp(images, mats, out_hw, **kw):
    return warp_mxu.affine_warp_mxu(
        torch.from_numpy(images), torch.from_numpy(mats), out_hw,
        compute_dtype=torch.float32, **kw).numpy()


@pytest.mark.parametrize("lerp_in_kernel", [True, False])
def test_small_rotations_match_xla_route(rng, monkeypatch, lerp_in_kernel):
    monkeypatch.setenv("PECLR_SHIFT", "xla")
    images = rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    mats = _rotations(rng, 2)
    ref = _jax_warp(images, mats, (32, 32))
    got = _port_warp(images, mats, (32, 32), lerp_in_kernel=lerp_in_kernel)
    assert got.shape == ref.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shift_lerp", ["kernel", "xla"])
def test_small_rotations_match_pallas_interpret(rng, monkeypatch, shift_lerp):
    """PECLR_SHIFT=pallas in interpret mode (the reference test's
    monkeypatch); PECLR_SHIFT_LERP=xla is the raw kernel with the split
    lerp, which the port's lerp_in_kernel=False mirrors."""
    import peclr_tpu.ops.pallas.barrel_shift as bs

    orig = bs.fused_shift_lerp_grouped

    def interp_kernel(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(bs, "fused_shift_lerp_grouped", interp_kernel)
    monkeypatch.setenv("PECLR_SHIFT", "pallas")
    monkeypatch.setenv("PECLR_SHIFT_LERP", shift_lerp)
    images = rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    mats = _rotations(rng, 2)
    ref = _jax_warp(images, mats, (32, 32))
    got = _port_warp(images, mats, (32, 32),
                     lerp_in_kernel=shift_lerp == "kernel")
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_pred_fh_geometry_matches_xla_route(rng, monkeypatch):
    """224 -> 224 uint8 frames, max_scale 3 and the 0.485 border fill."""
    monkeypatch.setenv("PECLR_SHIFT", "xla")
    images = rng.integers(0, 256, (4, 224, 224, 3)).astype(np.uint8)
    mats = _pred_fh_matrices(rng, 4)
    kw = dict(fill_value=0.485, max_scale=3.0)
    ref = _jax_warp(images, mats, (224, 224), **kw)
    got = _port_warp(images, mats, (224, 224), **kw)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    # the border really is filled, and the crop really holds the frame
    assert (got == np.float32(0.485)).any() and (got > 1.0).any()


def test_area_taps_match(rng, monkeypatch):
    """interp='area' (the box filter for downscales) on a 2x downscale."""
    monkeypatch.setenv("PECLR_SHIFT", "xla")
    images = rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    mats = np.stack([np.diag([0.5, 0.5, 1.0])] * 2).astype(np.float32)
    mats[1, :2, 2] = (3.0, -2.0)
    ref = _jax_warp(images, mats, (32, 32), interp="area")
    got = _port_warp(images, mats, (32, 32), interp="area")
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("xla_lerp", [False, True])
def test_window_sizes_match(xla_lerp):
    for out_hw, sx, sy in (((224, 224), 3.0, 3.0), ((32, 32), 1.96, 1.96),
                           ((128, 96), 2.5, 1.2)):
        assert (warp_mxu.pallas_window_sizes(out_hw, sx, sy, xla_lerp)
                == jax_warp.pallas_window_sizes(out_hw, sx, sy, xla_lerp))


def test_tap_matrices_match(rng):
    slopes = rng.uniform(0.3, 3.0, 4).astype(np.float32)
    for port_fn, jax_fn in ((warp_mxu._tent_matrix, jax_warp._tent_matrix),
                            (warp_mxu._area_matrix, jax_warp._area_matrix)):
        got = port_fn(torch.from_numpy(slopes), 100, 40).numpy()
        ref = np.asarray(jax_fn(jnp.asarray(slopes), 100, 40))
        np.testing.assert_allclose(got, ref, atol=1e-6)


def test_inverse_affine_matches(rng):
    mats = _pred_fh_matrices(rng, 5)
    got = warp_mxu._inv3_affine(torch.from_numpy(mats)).numpy()
    ref = np.asarray(jax_warp._inv3_affine(jnp.asarray(mats)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_initial_affine_matches_reference():
    np.testing.assert_allclose(initial_affine(), jax_pred_fh.initial_affine(),
                               rtol=1e-6)


def test_default_compute_dtype_follows_device():
    assert warp_mxu._default_compute_dtype(torch.device("cpu")) == torch.float32
    assert (warp_mxu._default_compute_dtype(torch.device("cuda"))
            == torch.bfloat16)
