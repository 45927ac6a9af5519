"""The port's warp routes "matmul" (kernel 4) and "nhwc" (kernel 3) against
the reference's affine_warp_mxu, in f32 on the CPU.

The reference runs its Pallas kernels in interpret mode
(PECLR_SHIFT=pallas, PECLR_SHIFT_FUSE=matmul for the fused route) or its
XLA shifter (PECLR_SHIFT=xla).  Tolerance: 1e-2 on the 0-255 scale, as the
reference holds its own routes to each other."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import peclr_tpu.ops.pallas.barrel_shift as bs
from peclr_tpu.config.defaults import AugmentationParams as JaxParams
from peclr_tpu.ops import augment as jax_augment
from peclr_tpu.ops import warp_mxu as jax_warp
from peclr_tpu_torch.ops import warp_mxu

ATOL = 1e-2


def _rotations(rng, b):
    """Rotation + scale + translation within +-40 degrees."""
    theta = np.deg2rad(rng.uniform(-40, 40, b))
    scale = rng.uniform(0.5, 1.5, b)
    mats = []
    for i in range(b):
        c_, s_ = np.cos(theta[i]) * scale[i], np.sin(theta[i]) * scale[i]
        tx, ty = rng.uniform(-10, 10, 2)
        mats.append([[c_, -s_, tx], [s_, c_, ty], [0, 0, 1]])
    return np.asarray(mats, np.float32)


def _recipe_matrices(rng, b, src=224, out=128):
    """rotate (floor of U[-45, 45]) about a centre, crop a box around it,
    resize to the view: the pretrain recipe's maps."""
    mats = []
    for _ in range(b):
        angle = math.floor(rng.uniform(-45, 45))
        cx, cy = rng.uniform(70, 154, 2)
        side = rng.uniform(30, 110)
        a, s = math.cos(math.radians(angle)), math.sin(math.radians(angle))
        rot = np.array([[a, s, (1 - a) * cx - s * cy],
                        [-s, a, s * cx + (1 - a) * cy], [0, 0, 1]])
        ox, oy = max(cx - side, 0.0), max(cy - side, 0.0)
        fw = out / (min(ox + 2 * side, src) - ox)
        fh = out / (min(oy + 2 * side, src) - oy)
        m = rot.copy()
        m[0, 2] -= ox
        m[1, 2] -= oy
        m[0] *= fw
        m[1] *= fh
        mats.append(m)
    return np.asarray(mats, np.float32)


def _interpret(monkeypatch, name):
    """Route one of the reference's Pallas kernels through interpret mode
    and count its calls."""
    orig = getattr(bs, name)
    calls = []

    def interp_kernel(*args, **kwargs):
        calls.append(1)
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(bs, name, interp_kernel)
    return calls


def _jax_warp(images, mats, out_hw, **kw):
    return np.asarray(jax_warp.affine_warp_mxu(
        jnp.asarray(images), jnp.asarray(mats), out_hw,
        compute_dtype=jnp.float32, **kw))


def _port_warp(images, mats, out_hw, **kw):
    return warp_mxu.affine_warp_mxu(
        torch.from_numpy(images), torch.from_numpy(mats), out_hw,
        compute_dtype=torch.float32, **kw).numpy()


@pytest.mark.parametrize("interp", ["linear", "area"])
def test_matmul_route_matches_pallas_interpret(rng, monkeypatch, interp):
    calls = _interpret(monkeypatch, "fused_shift_lerp_matmul")
    monkeypatch.setenv("PECLR_SHIFT", "pallas")
    monkeypatch.setenv("PECLR_SHIFT_FUSE", "matmul")
    images = rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
    mats = _rotations(rng, 2)
    ref = _jax_warp(images, mats, (32, 32), interp=interp)
    assert len(calls) == 2  # the reference took its fused route
    got = _port_warp(images, mats, (32, 32), interp=interp, route="matmul")
    assert got.shape == ref.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_nhwc_route_matches_pallas_interpret(rng, monkeypatch):
    """A shape where the reference's channel-first gate fails (b * out_w =
    60 is not a multiple of 32) and its NHWC kernel takes pass 1 (b * h =
    128, W * 3 = 384): the flat kernel in interpret mode, then the XLA
    shifter for pass 2."""
    calls = _interpret(monkeypatch, "fused_shift_lerp")
    monkeypatch.setenv("PECLR_SHIFT", "pallas")
    images = rng.integers(0, 256, (2, 64, 128, 3)).astype(np.uint8)
    mats = _rotations(rng, 2)
    mats[:, 0, :] *= 0.4  # 128 wide -> about 30
    ref = _jax_warp(images, mats, (28, 30))
    assert len(calls) == 1
    got = _port_warp(images, mats, (28, 30), route="nhwc")
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    assert (got > 1.0).any()


def test_routes_match_xla_route_at_the_recipe_geometry(rng, monkeypatch):
    """224 -> 128 uint8 canvases, +-45 degree rotations about a keypoint
    centre, crops, area taps, the pretrain windows: every route of the port
    against the reference's XLA route."""
    monkeypatch.setenv("PECLR_SHIFT", "xla")
    images = rng.integers(0, 256, (3, 224, 224, 3)).astype(np.uint8)
    mats = _recipe_matrices(rng, 3)
    sx, sy = jax_augment._warp_window_bounds((224, 224), (128, 128),
                                             JaxParams(), True)
    kw = dict(interp="area", max_scale_x=sx, max_scale_y=sy)
    ref = _jax_warp(images, mats, (128, 128), **kw)
    assert (ref > 1.0).mean() > 0.5
    for route in warp_mxu.ROUTES:
        got = _port_warp(images, mats, (128, 128), route=route, **kw)
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0,
                                   err_msg=route)


def test_transposed_tap_matrices_match(rng):
    slopes = rng.uniform(0.3, 3.0, 4).astype(np.float32)
    for port_fn, jax_fn in ((warp_mxu._tent_matrix, jax_warp._tent_matrix),
                            (warp_mxu._area_matrix, jax_warp._area_matrix)):
        got = port_fn(torch.from_numpy(slopes), 100, 40, transposed=True)
        ref = np.asarray(jax_fn(jnp.asarray(slopes), 100, 40, transposed=True))
        assert got.shape == (4, 40, 100)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


def test_route_is_checked():
    images = torch.zeros((1, 8, 8, 3))
    mats = torch.eye(3)[None]
    with pytest.raises(ValueError, match="route"):
        warp_mxu.affine_warp_mxu(images, mats, (4, 4), route="gather")
    with pytest.raises(ValueError, match="grouped"):
        warp_mxu.affine_warp_mxu(images, mats, (4, 4), route="matmul",
                                 lerp_in_kernel=False)
