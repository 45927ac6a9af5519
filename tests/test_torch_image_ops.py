"""The port's image ops outside the recipe (peclr_tpu_torch/ops/image.py),
its gather warp (ops/warp.py) and the exact projection shift
(losses/equivariance.py) against the reference on the CPU.

Tolerances, on the 0-255 scale of the images:
  * cut-out: bit for bit (a mask and a select);
  * grayscale, the Sobel filter, the blur and the noise: 1e-3.  XLA sums
    the three gray products as a chain of fused multiply-adds and its
    convolutions in an order of its own, so the last bits differ (up to
    ~1e-4 after the Sobel's 3x3 sum of gray values), though every product
    and clip is the same;
  * the gather warp: 1e-4 of the scale (255).  The two LAPACK inverses of
    the same 3x3 matrix differ in their last bits, which moves a sample
    point by ~1e-6 px;
  * the exact shift: 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peclr_tpu.losses import equivariance as jax_equivariance
from peclr_tpu.ops import image as jax_image
from peclr_tpu.ops import warp as jax_warp
from peclr_tpu_torch.losses.equivariance import translate_projections_exact
from peclr_tpu_torch.ops import image
from peclr_tpu_torch.ops.warp import affine_warp


def _images(rng, shape=(4, 40, 52, 3)):
    return rng.integers(0, 256, shape).astype(np.float32)


def test_grayscale_matches(rng):
    x = _images(rng)
    got = image.grayscale(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_image.grayscale(jnp.asarray(x)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    assert (got[..., 0] == got[..., 2]).all()


def test_sobel_filter_matches(rng):
    """The combined kx + ky kernel, zero padding, clipped, three channels;
    the kernel size is ignored, as in the reference."""
    x = _images(rng)
    got = image.sobel_filter(torch.from_numpy(x), ksize=5).numpy()
    ref = np.asarray(jax_image.sobel_filter(jnp.asarray(x), ksize=5))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    assert got.min() == 0.0 and got.max() == 255.0  # both clips reached


@pytest.mark.parametrize("shape", [(3, 40, 40, 3),    # width 5
                                   (3, 64, 64, 3),    # 6 -> 7
                                   (3, 30, 52, 3),    # non-square, from h
                                   (3, 224, 224, 3)])  # the recipe's 23
def test_gaussian_blur_matches(rng, shape):
    x = _images(rng, shape)
    sigma = rng.uniform(0.1, 2.0, shape[0]).astype(np.float32)
    got = image.gaussian_blur(torch.from_numpy(x),
                              torch.from_numpy(sigma)).numpy()
    ref = np.asarray(jax_image.gaussian_blur(jnp.asarray(x),
                                             jnp.asarray(sigma)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("h,width", [(40, 5), (64, 7), (70, 7), (224, 23),
                                     (30, 3)])
def test_blur_width_is_odd_and_from_h(h, width):
    assert image.blur_width(h) == width


def test_gaussian_kernel_matches(rng):
    sigma = rng.uniform(0.1, 2.0, 5).astype(np.float32)
    got = image.gaussian_kernel_1d(torch.from_numpy(sigma), 7).numpy()
    ref = np.asarray(jax_image.gaussian_kernel_1d(jnp.asarray(sigma), 7))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_cutout_matches_exactly(rng):
    """Anchors inside, on and past the border; the box's rows centre on x
    and its columns on y (the reference's swap)."""
    x = _images(rng)
    centre = np.array([[10.0, 20.0], [3.0, 50.0], [39.5, 5.0], [-4.0, 60.0]],
                      np.float32)
    fraction = np.array([0.16, 0.1, 0.05, 0.15], np.float32)
    fill = np.array([0.0, 17.0, 254.0, 128.0], np.float32)
    got = image.cutout(*(torch.from_numpy(a) for a in (x, centre, fraction,
                                                       fill))).numpy()
    ref = np.asarray(jax_image.cutout(*(jnp.asarray(a) for a in
                                        (x, centre, fraction, fill))))
    np.testing.assert_array_equal(got, ref)
    # sample 1: a 4 x 5 box, rows [1, 5) around x = 3, columns [47, 52)
    filled = (got[1] == 17.0).all(axis=-1)
    assert filled[1:5, 47:52].all() and filled.sum() == 20


def test_gaussian_noise_matches_and_saturates(rng):
    x = _images(rng)
    key = jax.random.PRNGKey(4)
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))
    got = image.gaussian_noise(torch.from_numpy(x), torch.from_numpy(noise),
                               25.0).numpy()
    ref = np.asarray(jax_image.gaussian_noise(jnp.asarray(x), key, 25.0))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    assert got.min() == 0.0 and got.max() == 255.0


def test_denormalize_inverts_normalize(rng):
    x = rng.uniform(0, 1, (2, 4, 4, 3)).astype(np.float32)
    got = image.denormalize_imagenet(image.normalize_imagenet(
        torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(got, x, atol=1e-6)
    ref = np.asarray(jax_image.denormalize_imagenet(jnp.asarray(x)))
    np.testing.assert_allclose(image.denormalize_imagenet(
        torch.from_numpy(x)).numpy(), ref, atol=1e-6)


def _affines(rng, b):
    """Rotations, scales and shifts, some reaching outside the source."""
    angle = np.radians(rng.uniform(-60, 60, b))
    scale = rng.uniform(0.5, 1.8, (b, 2))
    m = np.zeros((b, 3, 3), np.float32)
    m[:, 0, 0] = scale[:, 0] * np.cos(angle)
    m[:, 0, 1] = -scale[:, 0] * np.sin(angle)
    m[:, 1, 0] = scale[:, 1] * np.sin(angle)
    m[:, 1, 1] = scale[:, 1] * np.cos(angle)
    m[:, :2, 2] = rng.uniform(-20, 20, (b, 2))
    m[:, 2, 2] = 1.0
    return m


@pytest.mark.parametrize("dtype,fill", [(np.uint8, 0.0), (np.float32, 0.5)])
def test_gather_warp_matches(rng, dtype, fill):
    x = rng.integers(0, 256, (5, 40, 52, 3)).astype(dtype)
    m = _affines(rng, 5)
    got = affine_warp(torch.from_numpy(x), torch.from_numpy(m), (33, 29),
                      fill).numpy()
    ref = np.asarray(jax_warp.affine_warp(jnp.asarray(x), jnp.asarray(m),
                                          (33, 29), fill))
    assert got.dtype == np.float32 and got.shape == (5, 33, 29, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * 255)
    assert (got == fill).any()  # some samples fall outside the source


def test_translate_projections_exact_matches(rng):
    pts = rng.normal(size=(4, 64, 2)).astype(np.float32)
    tx, ty = rng.uniform(-0.2, 0.2, (2, 4)).astype(np.float32)
    got = translate_projections_exact(torch.from_numpy(pts),
                                      torch.from_numpy(tx),
                                      torch.from_numpy(ty)).numpy()
    ref = np.asarray(jax_equivariance.translate_projections_exact(
        jnp.asarray(pts), jnp.asarray(tx), jnp.asarray(ty)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
