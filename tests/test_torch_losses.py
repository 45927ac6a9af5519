"""The port's losses (peclr_tpu_torch/losses/) against the reference's, on
the CPU in f32: values and gradients (autograd against jax.grad) at 1e-5,
or 1e-4 where f32 sums of exponentials say so (each test states it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peclr_tpu.losses import equivariance as jax_eq
from peclr_tpu.losses.ntxent import ntxent_loss as jax_ntxent
from peclr_tpu_torch.losses import equivariance
from peclr_tpu_torch.losses.ntxent import ntxent_loss


def _params(rng, b):
    return {"jitter_x": np.trunc(rng.uniform(-15, 15, b)).astype(np.float32),
            "jitter_y": np.trunc(rng.uniform(-15, 15, b)).astype(np.float32),
            "angle": np.floor(rng.uniform(-45, 45, b)).astype(np.float32)}


def _value_and_grad(fn, *arrays):
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    value = fn(*leaves)
    value.backward()
    return value.detach().numpy(), [t.grad.numpy() for t in leaves]


def test_ntxent_matches(rng):
    z1 = rng.normal(size=(8, 16)).astype(np.float32)
    z2 = rng.normal(size=(8, 16)).astype(np.float32)
    z1 /= np.linalg.norm(z1, axis=1, keepdims=True)
    z2 /= np.linalg.norm(z2, axis=1, keepdims=True)
    for temperature in (0.5, 0.1):
        value, grads = _value_and_grad(
            lambda a, b: ntxent_loss(a, b, temperature), z1, z2)
        ref = jax.value_and_grad(
            lambda a, b: jax_ntxent(a, b, temperature), argnums=(0, 1))(
            jnp.asarray(z1), jnp.asarray(z2))
        np.testing.assert_allclose(value, np.asarray(ref[0]), rtol=1e-5)
        for got, want in zip(grads, ref[1]):
            # similarities up to e^(1/τ) = e^10 at τ = 0.1 cost f32 digits:
            # 2e-5 of the largest gradient
            want = np.asarray(want)
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("augmentations", [("crop", "rotate"), ("crop",),
                                           ("rotate",), ()])
def test_peclr_projections_and_loss_match(rng, augmentations):
    """The inverse transforms (detached extent and centroid, the jitter_x /
    height quirk) and the loss on top, through both views' gradients."""
    b, d = 6, 128
    proj1 = rng.normal(size=(b, d)).astype(np.float32)
    proj2 = rng.normal(size=(b, d)).astype(np.float32)
    p1, p2 = _params(rng, b), _params(rng, b)
    size = (128, 96)  # not square: the quirk shows

    def port_loss(a, c):
        z1, z2 = equivariance.peclr_projections(
            a, c, {k: torch.from_numpy(v) for k, v in p1.items()},
            {k: torch.from_numpy(v) for k, v in p2.items()}, size,
            augmentations)
        return ntxent_loss(z1, z2)

    def jax_loss(a, c):
        z1, z2 = jax_eq.peclr_projections(a, c, p1, p2, size, augmentations)
        return jax_ntxent(z1, z2)

    value, grads = _value_and_grad(port_loss, proj1, proj2)
    ref_value, ref_grads = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(proj1), jnp.asarray(proj2))
    np.testing.assert_allclose(value, np.asarray(ref_value), rtol=1e-5)
    for got, want in zip(grads, ref_grads):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-6)
    z1, _ = equivariance.peclr_projections(
        torch.from_numpy(proj1), torch.from_numpy(proj2),
        {k: torch.from_numpy(v) for k, v in p1.items()},
        {k: torch.from_numpy(v) for k, v in p2.items()}, size, augmentations)
    ref_z1, _ = jax_eq.peclr_projections(proj1, proj2, p1, p2, size,
                                         augmentations)
    np.testing.assert_allclose(z1.numpy(), np.asarray(ref_z1), rtol=1e-5,
                               atol=1e-6)


def test_transforms_detach_extent_and_centroid(rng):
    """Gradients of translate/rotate alone match jax.grad, where the
    reference stops the gradient through the extent and the centroid."""
    pts = rng.normal(size=(3, 64, 2)).astype(np.float32)
    w = rng.normal(size=(3, 64, 2)).astype(np.float32)
    tx, ty = rng.uniform(-0.2, 0.2, (2, 3)).astype(np.float32)
    angle = rng.uniform(-45, 45, 3).astype(np.float32)
    cases = (
        (lambda p: equivariance.translate_projections(
            p, torch.from_numpy(tx), torch.from_numpy(ty)),
         lambda p: jax_eq.translate_projections(p, tx, ty)),
        (lambda p: equivariance.rotate_projections(p, torch.from_numpy(angle)),
         lambda p: jax_eq.rotate_projections(p, angle)),
    )
    for port_fn, jax_fn in cases:
        value, (grad,) = _value_and_grad(
            lambda p: (port_fn(p) * torch.from_numpy(w)).sum(), pts)
        ref = jax.value_and_grad(lambda p: jnp.sum(jax_fn(p) * w))(
            jnp.asarray(pts))
        np.testing.assert_allclose(value, np.asarray(ref[0]), rtol=1e-5)
        np.testing.assert_allclose(grad, np.asarray(ref[1]), rtol=1e-5,
                                   atol=1e-6)
