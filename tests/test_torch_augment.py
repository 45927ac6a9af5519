"""The port's augmentation (peclr_tpu_torch/ops/augment.py, ops/image.py
colour jitter, geometry/affine.py rotation) against the reference on the
CPU.

torch cannot replay jax.random, so `apply` is fed the parameters the
reference drew (AugmentOutput.params); `draw` is checked for its
distributions.  Joints and matrices agree to 1e-4.  Images agree to 1e-3 on
the 0-255 scale except where the colour jitter's floor (the reference's
uint8 round trip) turns a 1e-5 difference of the warp into a whole step of
H, S or V, which moves a channel by a few units: at least 99.9% of the
values agree to 1e-3 and every value to 10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peclr_tpu.config.defaults import AugmentationFlags as JaxFlags
from peclr_tpu.config.defaults import AugmentationParams as JaxParams
from peclr_tpu.config.defaults import peclr_pretrain_flags as jax_flags
from peclr_tpu.geometry import affine as jax_affine
from peclr_tpu.ops import augment as jax_augment
from peclr_tpu.ops import image as jax_image
from peclr_tpu_torch.config.defaults import (
    AugmentationFlags,
    AugmentationParams,
    peclr_pretrain_flags,
)
from peclr_tpu_torch.geometry.affine import rotation_about_center
from peclr_tpu_torch.ops import augment, image


def _batch(rng, n, canvas):
    images = rng.integers(0, 256, (n, canvas, canvas, 3)).astype(np.uint8)
    joints = np.concatenate([
        rng.uniform(0.27 * canvas, 0.71 * canvas, (n, 21, 2)),
        rng.normal(size=(n, 21, 1))], axis=-1).astype(np.float32)
    return images, joints


def _t(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


def _assert_images_close(got, ref):
    diff = np.abs(got * 255.0 - ref * 255.0)
    assert (diff <= 1e-3).mean() >= 0.999, (diff > 1e-3).mean()
    assert diff.max() <= 10.0, diff.max()


def test_config_matches_reference():
    assert AugmentationParams().__dict__ == JaxParams().__dict__
    assert AugmentationFlags().__dict__ == JaxFlags().__dict__
    assert peclr_pretrain_flags().active() == jax_flags().active()


def test_rotation_about_center_matches(rng):
    angle = rng.uniform(-90, 90, 5).astype(np.float32)
    cx, cy = rng.uniform(0, 224, (2, 5)).astype(np.float32)
    got = rotation_about_center(torch.from_numpy(angle), torch.from_numpy(cx),
                                torch.from_numpy(cy)).numpy()
    ref = np.asarray(jax_affine.rotation_about_center(angle, cx, cy))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)


def test_color_jitter_matches_exactly(rng):
    """Identical inputs: the HSV round trip with its quirks agrees to 1e-4,
    the floors included; grey and saturated pixels are in the mix."""
    x = rng.uniform(0, 255, (4, 16, 16, 3)).astype(np.float32)
    x[0, :4] = 128.0  # grey: delta 0
    x[1, :4, :, 0] = 0.0  # a zero channel
    x = np.floor(x)
    factors = [rng.uniform(lo, hi, 4).astype(np.float32)
               for lo, hi in ((0.01, 1), (0.01, 1), (0.5, 1), (5, 20))]
    got = image.color_jitter(torch.from_numpy(x),
                             *(torch.from_numpy(f) for f in factors)).numpy()
    ref = np.asarray(jax_image.color_jitter(jnp.asarray(x), *factors))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    h, s, v = image.rgb_to_hsv_cv2(torch.from_numpy(x))
    for a, b in zip((h, s, v), jax_image.rgb_to_hsv_cv2(jnp.asarray(x))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


@pytest.mark.parametrize("route", ["grouped", "matmul"])
def test_apply_matches_augment_batch(rng, route):
    """The recipe's flags, 64 -> 32 canvases, with the draws of the
    reference's augment_batch."""
    images, joints = _batch(rng, 6, 64)
    flags, jflags = peclr_pretrain_flags(), jax_flags()
    ref = jax_augment.augment_batch(
        jax.random.PRNGKey(3), jnp.asarray(images), jnp.asarray(joints),
        jflags, JaxParams(resize_shape=(32, 32)))
    got = augment.apply(torch.from_numpy(images), torch.from_numpy(joints),
                        _t(ref.params), flags,
                        AugmentationParams(resize_shape=(32, 32)), route=route)
    np.testing.assert_allclose(got.matrix.numpy(), np.asarray(ref.matrix),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.joints.numpy(), np.asarray(ref.joints),
                               rtol=1e-4, atol=1e-4)
    for key in ref.params:
        np.testing.assert_allclose(got.params[key].numpy(),
                                   np.asarray(ref.params[key]), atol=1e-6,
                                   err_msg=key)
    _assert_images_close(got.images.numpy(), np.asarray(ref.images))


def test_augment_pair_matches_at_the_recipe_geometry(rng):
    """augment_pair (normalised views) at 224 -> 128 on the reference's
    draws for the doubled batch."""
    images, joints = _batch(rng, 2, 224)
    params = JaxParams()
    r1, r2 = jax_augment.augment_pair(jax.random.PRNGKey(7),
                                      jnp.asarray(images),
                                      jnp.asarray(joints), jax_flags(), params)
    draws = {k: torch.cat([torch.from_numpy(np.array(r1.params[k])),
                           torch.from_numpy(np.array(r2.params[k]))])
             for k in r1.params}
    v1, v2 = augment.augment_pair(None, torch.from_numpy(images),
                                  torch.from_numpy(joints),
                                  peclr_pretrain_flags(), AugmentationParams(),
                                  draws=draws)
    std = np.asarray(jax_image.IMAGENET_STD)
    for got, ref in ((v1, r1), (v2, r2)):
        assert got.images.shape == (2, 128, 128, 3)
        np.testing.assert_allclose(got.joints.numpy(), np.asarray(ref.joints),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.matrix.numpy(), np.asarray(ref.matrix),
                                   rtol=1e-4, atol=1e-4)
        # back to [0, 1] before the 0-255 comparison
        _assert_images_close(got.images.numpy() * std,
                             np.asarray(ref.images) * std)


def test_draw_statistics():
    """angle = floor(U[-45, 45]); jitter = trunc(U[0, 15)), reported
    negated; the colour factors uniform on their ranges."""
    n = 20_000
    d = augment.draw(torch.Generator().manual_seed(0), n,
                     peclr_pretrain_flags(), AugmentationParams())
    angle = d["angle"].numpy()
    assert np.array_equal(angle, np.floor(angle))
    assert angle.min() == -45 and angle.max() == 44
    assert abs(angle.mean() + 0.5) < 0.5
    for key in ("jitter_x", "jitter_y"):
        jitter = -d[key].numpy()
        assert np.array_equal(jitter, np.trunc(jitter))
        assert set(np.unique(jitter)) == set(range(15))
        assert abs(jitter.mean() - 7.0) < 0.2
    for key, (lo, hi) in (("h", (0.01, 1.0)), ("s", (0.01, 1.0)),
                          ("a", (0.5, 1.0)), ("b", (5.0, 20.0))):
        v = d[key].numpy()
        assert v.min() >= lo and v.max() < hi
        assert abs(v.mean() - (lo + hi) / 2) < 0.02 * (hi - lo)
    assert (d["crop_margin_scale"].numpy() == 1.25).all()
    off = augment.draw(torch.Generator().manual_seed(0), 8,
                       AugmentationFlags(resize=True), AugmentationParams())
    assert not off["angle"].any() and not off["jitter_x"].any()


def test_window_bounds_and_crop_box_match(rng):
    for rotate in (True, False):
        assert (augment._warp_window_bounds((224, 224), (128, 128),
                                            AugmentationParams(), rotate)
                == jax_augment._warp_window_bounds(
                    (224, 224), (128, 128), JaxParams(), rotate))
    wide = AugmentationParams(min_angle=-85.0, max_angle=85.0)
    with pytest.raises(ValueError, match="80"):
        augment._warp_window_bounds((224, 224), (128, 128), wide, True)
    pts = rng.uniform(20, 200, (4, 21, 2)).astype(np.float32)
    jitter = np.trunc(rng.uniform(0, 15, (4, 2))).astype(np.float32)
    margin = np.full(4, 1.25, np.float32)
    got = augment._crop_box(*(torch.from_numpy(a) for a in (pts, jitter,
                                                            margin)))
    ref = jax_augment._crop_box(pts, jitter, margin)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("flag", augment.UNPORTED_FLAGS)
def test_unported_flags_raise(flag):
    flags = AugmentationFlags(**{flag: True})
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        augment.draw(torch.Generator(), 2, flags, AugmentationParams())
