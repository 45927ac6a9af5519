"""The port's procrustes alignment and evaluation metrics
(peclr_tpu_torch/geometry/procrustes.py, eval/metrics.py) against the
reference's on the same seeded inputs, on the CPU.

Procrustes: the aligned points within 1e-5 and the scale within 1e-5
relative; U and V are not compared (their signs are not unique), the
rotation only where it is determined.  Metrics: the EPE statistics within
1e-6 (f32), PCK and AUC within 1e-6.  The median is taken over an even
count, where jnp.median averages the two middle values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peclr_tpu.eval import metrics as jax_metrics
from peclr_tpu.geometry.procrustes import procrustes_align as jax_align
from peclr_tpu_torch.eval import metrics
from peclr_tpu_torch.geometry.procrustes import procrustes_align


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rotation(rng, proper=True):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if (np.linalg.det(q) > 0) != proper:
        q[:, 0] *= -1
    return q


def _pairs(rng, kind):
    """(X, Y) batches of 21 points for each case."""
    X = rng.normal(size=(6, 21, 3))
    if kind == "noisy_similarity":
        Y = np.stack([1.7 * x @ _rotation(rng).T for x in X])
        Y += rng.normal(size=(6, 1, 3)) + 0.05 * rng.normal(size=Y.shape)
    elif kind == "reflected":  # the best orthogonal map is a reflection
        Y = np.stack([x @ _rotation(rng, proper=False).T for x in X])
        Y += 0.01 * rng.normal(size=Y.shape)
    elif kind == "planar":  # rank-2 cross-covariance
        X[..., 2] = 0.0
        Y = np.stack([0.5 * x @ _rotation(rng).T for x in X]) + 0.3
    elif kind == "coincident":  # Y is one point (exact in f32, so Y0 == 0)
        Y = np.repeat(rng.integers(-8, 8, (6, 1, 3)) / 4.0, 21, axis=1)
    else:
        raise ValueError(kind)
    return X.astype(np.float32), Y.astype(np.float32)


@pytest.mark.parametrize("kind", ["noisy_similarity", "reflected", "planar",
                                  "coincident"])
def test_procrustes_matches_reference(rng, kind):
    X, Y = _pairs(rng, kind)
    got, R, scale, t = procrustes_align(torch.from_numpy(X),
                                        torch.from_numpy(Y))
    ref, ref_R, ref_scale, ref_t = jax_align(jnp.asarray(X), jnp.asarray(Y))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(scale.numpy(), np.asarray(ref_scale),
                               rtol=1e-5, atol=1e-6)
    if kind != "coincident":  # R of a zero cross-covariance is arbitrary
        np.testing.assert_allclose(R.numpy(), np.asarray(ref_R), atol=1e-4)
        np.testing.assert_allclose(t.numpy(), np.asarray(ref_t), atol=1e-4)
        assert np.allclose(np.linalg.det(R.numpy()), 1.0, atol=1e-5)
    if kind == "coincident":  # a zero cross-covariance: scale 0
        assert not scale.numpy().any()
        np.testing.assert_allclose(got.numpy(),
                                   np.broadcast_to(X.mean(1, keepdims=True),
                                                   X.shape), atol=1e-5)


def test_procrustes_zero_determinant_zeroes_the_last_column(monkeypatch):
    """sign(det) == 0 zeroes the last singular vector and value, as
    jnp.sign does: a NaN-free path where det(V Uᵀ) comes out 0."""
    X = np.random.default_rng(0).normal(size=(2, 21, 3)).astype(np.float32)
    real_det = torch.linalg.det
    monkeypatch.setattr(torch.linalg, "det", lambda a: real_det(a) * 0.0)
    got, R, _, _ = procrustes_align(torch.from_numpy(X), torch.from_numpy(X))
    assert torch.isfinite(got).all()
    # R = V' Uᵀ with V's last column zeroed: rank 2
    assert np.linalg.matrix_rank(R.numpy()[0], tol=1e-5) == 2


@pytest.mark.parametrize("dim", [2, 3])
def test_epe_statistics_match(rng, dim):
    """20 x 21 = 420 distances: an even count, so the median is the mean of
    the two middle values."""
    pred = rng.normal(size=(20, 21, 3)).astype(np.float32)
    gt = rng.normal(size=(20, 21, 3)).astype(np.float32)
    got = metrics.epe_statistics(torch.from_numpy(pred), torch.from_numpy(gt),
                                 dim=dim)
    ref = jax_metrics.epe_statistics(jnp.asarray(pred), jnp.asarray(gt),
                                     dim=dim)
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    flat = np.sort(got["euclidean_dist"].numpy().ravel())
    assert got["median"].item() == pytest.approx(
        (flat[209] + flat[210]) / 2, abs=1e-6)
    assert got["median"].item() != torch.median(got["euclidean_dist"]).item()


@pytest.mark.parametrize("per_joint", [False, True])
def test_pck_curve_matches(rng, per_joint):
    dist = rng.uniform(0, 0.6, (30, 21)).astype(np.float32)
    got, t = metrics.pck_curve(torch.from_numpy(dist), per_joint=per_joint)
    ref, ref_t = jax_metrics.pck_curve(dist, per_joint=per_joint)
    np.testing.assert_array_equal(t, ref_t)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_auc_matches(rng):
    dist = rng.uniform(0, 0.3, (30, 21)).astype(np.float32)
    np.testing.assert_allclose(metrics.auc_per_joint(dist),
                               jax_metrics.auc_per_joint(dist), atol=1e-6)
    assert metrics.auc(torch.from_numpy(dist)) == pytest.approx(
        jax_metrics.auc(dist), abs=1e-6)


@pytest.mark.parametrize("noise", [0.0, 0.01])
def test_procrustes_statistics_match(rng, noise):
    X = rng.normal(scale=0.05, size=(10, 21, 3)).astype(np.float32)
    Y = np.stack([1.3 * x @ _rotation(rng).T for x in X]) + 0.2
    Y = (Y + noise * rng.normal(size=Y.shape)).astype(np.float32)
    got = metrics.procrustes_statistics(Y, X)
    ref = jax_metrics.procrustes_statistics(Y, X)
    assert set(got) == set(ref)
    for key, value in ref.items():
        assert got[key] == pytest.approx(value, abs=1e-6), key
