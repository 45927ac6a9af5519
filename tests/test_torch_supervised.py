"""The port's supervised losses, supervised sample and evaluation
(peclr_tpu_torch/losses/supervised.py, eval/evaluate.py) against the
reference's on the same seeded inputs, on the CPU.

Losses and EPE metrics within 1e-6.  The supervised sample is handed the
augmentation parameters the reference drew: K', the labels, the recreated
3D and the procrustes targets within 1e-4 (tests/test_torch_augment.py's
tolerance for `apply`), the images as that file holds them (the colour
jitter's floors).  `evaluate` runs on both sides over the same batches with
the same draws and the same predictions: each result within 1e-5, also
with a Denoiser (the reference's flax one and the port's, from the same
weights) supplying the z-root.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peclr_tpu.config.defaults import AugmentationFlags as JaxFlags
from peclr_tpu.config.defaults import AugmentationParams as JaxParams
from peclr_tpu.data.freihand import FreihandSource as JaxSource
from peclr_tpu.data.pipeline import HostPipeline as JaxPipeline
from peclr_tpu.eval import evaluate as jax_evaluate
from peclr_tpu.losses import supervised as jax_supervised
from peclr_tpu.models.heads import Denoiser as JaxDenoiser
from peclr_tpu.ops.augment import augment_batch
from peclr_tpu_torch.config.defaults import AugmentationFlags, AugmentationParams
from peclr_tpu_torch.data.freihand import FreihandSource
from peclr_tpu_torch.data.pipeline import HostPipeline
from peclr_tpu_torch.data.synthetic import generate_freihand_like
from peclr_tpu_torch.eval.evaluate import evaluate, supervised_sample_batch
from peclr_tpu_torch.losses import supervised
from peclr_tpu_torch.models import Denoiser
from peclr_tpu_torch.models.port import denoiser_variables_to_state_dict
from peclr_tpu_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD

B = 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fh_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("supervised_fh"))
    return generate_freihand_like(root, num_unique=8, seed=13)


def _pipelines(fh_root):
    port = HostPipeline([FreihandSource(fh_root, "train", train_ratio=0.75)],
                        batch_size=B, canvas=224, num_threads=2)
    ref = JaxPipeline([JaxSource(fh_root, "train", train_ratio=0.75)],
                      batch_size=B, canvas=224, num_threads=2)
    return port, ref


def _losses_inputs(rng):
    pred = rng.normal(size=(6, 21, 3)).astype(np.float32)
    true = rng.normal(size=(6, 21, 3)).astype(np.float32)
    scale = rng.uniform(0.02, 0.1, 6).astype(np.float32)
    valid = (rng.uniform(size=(6, 21, 1)) > 0.2).astype(np.float32)
    return pred, true, scale, valid


@pytest.mark.parametrize("with_scale,with_valid", [(True, True),
                                                   (False, False)])
def test_l1_loss_25d_matches(rng, with_scale, with_valid):
    pred, true, scale, valid = _losses_inputs(rng)
    args = (scale if with_scale else None, valid if with_valid else None)
    got = supervised.l1_loss_25d(
        torch.from_numpy(pred), torch.from_numpy(true),
        *(None if a is None else torch.from_numpy(a) for a in args))
    ref = jax_supervised.l1_loss_25d(jnp.asarray(pred), jnp.asarray(true),
                                     *args)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.item(), float(r), rtol=1e-6, atol=1e-7)


def test_loss_3d_matches(rng):
    """A 2.5D prediction near real labels, lifted through the closed-form
    z-root, against the 3D ground truth; and with a given z-root."""
    joints3d = np.concatenate([rng.uniform(-0.1, 0.1, (6, 21, 2)),
                               rng.uniform(0.4, 0.6, (6, 21, 1))], -1)
    K = np.tile(np.array([[390.0, 0, 112], [0, 390, 112], [0, 0, 1]]),
                (6, 1, 1))
    uvw = np.einsum("bij,bnj->bni", K, joints3d)
    scale = np.linalg.norm(joints3d[:, 2] - joints3d[:, 0], axis=-1)
    z_rel = (joints3d[..., 2] - joints3d[:, :1, 2]) / scale[:, None]
    pred = np.concatenate([uvw[..., :2] / uvw[..., 2:], z_rel[..., None]], -1)
    pred = pred + rng.normal(scale=0.5, size=pred.shape)
    valid = (rng.uniform(size=(6, 21, 1)) > 0.2)
    arrays = [a.astype(np.float32) for a in (pred, joints3d, scale, K, valid)]
    z_root = rng.uniform(5, 10, 6).astype(np.float32)
    for zr in (None, z_root):
        got = supervised.loss_3d(*map(torch.from_numpy, arrays),
                                 z_root=None if zr is None
                                 else torch.from_numpy(zr))
        ref = jax_supervised.loss_3d(*map(jnp.asarray, arrays), z_root=zr)
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


def test_epe_metrics_match(rng):
    """6 x 21 = 126 distances: the median of an even count."""
    pred, true, _, _ = _losses_inputs(rng)
    got = supervised.epe_metrics(torch.from_numpy(pred),
                                 torch.from_numpy(true), prefix="val")
    ref = jax_supervised.epe_metrics(jnp.asarray(pred), jnp.asarray(true),
                                     prefix="val")
    assert set(got) == set(ref) == {"EPE_mean_val", "EPE_median_val"}
    for key, value in ref.items():
        np.testing.assert_allclose(got[key].item(), float(value), rtol=1e-6,
                                   err_msg=key)


def _pixels(normalized):
    """ImageNet-normalised images back on the 0-255 scale."""
    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    return (np.asarray(normalized) * std + mean) * 255.0


@pytest.mark.parametrize("use_palm", [False, True])
def test_supervised_sample_matches(fh_root, use_palm):
    batch = next(_pipelines(fh_root)[0].batches(1))
    jflags = JaxFlags(crop=True, rotate=True, color_jitter=True, resize=True)
    jparams = JaxParams(resize_shape=(64, 64))
    key = jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref = jax_evaluate.supervised_sample_batch(key, jbatch, jflags, jparams,
                                               use_palm=use_palm)
    drawn = augment_batch(key, jbatch["image"], jbatch["joints25d"], jflags,
                          jparams).params
    got = supervised_sample_batch(
        None, {k: torch.from_numpy(v) for k, v in batch.items()},
        AugmentationFlags(crop=True, rotate=True, color_jitter=True,
                          resize=True),
        AugmentationParams(resize_shape=(64, 64)), use_palm=use_palm,
        draws={k: torch.from_numpy(np.array(v)) for k, v in drawn.items()})
    assert set(got) == set(ref)
    for name in ref:
        if name == "image":
            diff = np.abs(_pixels(got[name].numpy()) - _pixels(ref[name]))
            assert (diff <= 1e-3).mean() >= 0.999, (diff > 1e-3).mean()
            assert diff.max() <= 10.0, diff.max()
            continue
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    # the labels lift back to the ground truth through K' = T @ K
    err = np.abs(got["joints3D_recreated"].numpy() - got["joints3D"].numpy())
    assert np.median(err) < 5e-3


class _Replay:
    """A predictor that returns the given prediction of each call in turn."""

    def __init__(self, predictions, wrap):
        self.predictions = list(predictions)
        self.wrap = wrap

    def __call__(self, images, K):
        assert images.shape[0] == K.shape[0] == B
        return self.wrap(self.predictions.pop(0))


def _reference_batches(ref_pipe, use_palm):
    """The draws and the noisy predictions of two batches, the eval CLI's
    flags (crop, resize): predictions are the reference's labels plus seeded
    noise (a few pixels, a few tenths of relative depth)."""
    jflags = JaxFlags(crop=True, resize=True)
    jparams = JaxParams(resize_shape=(64, 64))
    rng = np.random.default_rng(7)
    key = jax.random.PRNGKey(0)  # the reference's collect_predictions seed
    draws, predictions = [], []
    for i, raw in enumerate(ref_pipe.batches(2, epoch=0)):
        batch = {k: jnp.asarray(v) for k, v in raw.items()}
        k = jax.random.fold_in(key, i)
        draws.append({n: torch.from_numpy(np.array(v)) for n, v in
                      augment_batch(k, batch["image"], batch["joints25d"],
                                    jflags, jparams).params.items()})
        labels = np.asarray(jax_evaluate.supervised_sample_batch(
            k, batch, jflags, jparams, use_palm=use_palm)["joints"])
        noise = rng.normal(size=labels.shape) * np.array([2.0, 2.0, 0.2])
        predictions.append((labels + noise).astype(np.float32))
    return draws, predictions


def _check_evaluate(fh_root, use_palm, port_zroot, ref_zroot):
    port_pipe, ref_pipe = _pipelines(fh_root)
    jflags = JaxFlags(crop=True, resize=True)
    jparams = JaxParams(resize_shape=(64, 64))
    draws, predictions = _reference_batches(ref_pipe, use_palm)
    for got_raw, ref_raw in zip(port_pipe.batches(2), ref_pipe.batches(2)):
        for name in ref_raw:
            np.testing.assert_array_equal(got_raw[name], ref_raw[name])

    kw = dict(num_batches=2, use_palm=use_palm)
    ref = jax_evaluate.evaluate(_Replay(predictions, jnp.asarray), ref_pipe,
                                jflags, jparams, predict_zroot=ref_zroot, **kw)
    got = evaluate(_Replay(predictions, torch.from_numpy), port_pipe,
                   AugmentationFlags(crop=True, resize=True),
                   AugmentationParams(resize_shape=(64, 64)), device="cpu",
                   draws=draws, predict_zroot=port_zroot, **kw)
    assert set(got) == set(ref) and len(got) == 9
    for name, value in ref.items():
        assert np.isfinite(got[name]), name
        assert got[name] == pytest.approx(value, rel=1e-5, abs=1e-5), name


@pytest.mark.parametrize("use_palm,with_zroot", [(False, False),
                                                 (True, False),
                                                 (False, True)])
def test_evaluate_matches_reference(fh_root, use_palm, with_zroot):
    """The z-root override, where given, is a function of the prediction."""
    def zroot(pred, K):
        return 6.0 + 0.01 * pred[:, 0, 0]

    _check_evaluate(fh_root, use_palm, zroot if with_zroot else None,
                    zroot if with_zroot else None)


def _denoiser_input(pred, K):
    """(N, 64) from numpy (N, 21, 3) predictions and (N, 3, 3) K: the 21
    relative depths, the 42 pixel coords over 100 and the log focal length,
    the Denoiser's 21 + 42 + 1 layout."""
    n = pred.shape[0]
    return np.concatenate([pred[:, :, 2], pred[:, :, :2].reshape(n, 42) / 100.0,
                           np.log(K[:, 0, 0])[:, None]], axis=1)


def test_evaluate_with_a_denoiser_matches_reference(fh_root):
    """A Denoiser-backed predict_zroot on each side, in eval mode, from the
    same seeded weights: z-root = 6 + the Denoiser's output."""
    from peclr_tpu_torch.data.synthetic import _seeded_variables
    from peclr_tpu_torch.models.port import zroot_mlp_mapping

    shapes = {k: tuple(v.shape) for k, v in Denoiser().state_dict().items()}
    variables = _seeded_variables(shapes, zroot_mlp_mapping(), 9, last_bn="-")
    port = Denoiser()
    port.load_state_dict(denoiser_variables_to_state_dict(variables),
                         strict=True)
    port.eval()

    def port_zroot(pred, K):
        x = torch.from_numpy(_denoiser_input(pred.numpy(), K.numpy()))
        with torch.no_grad():
            return 6.0 + port(x)[:, 0]

    def ref_zroot(pred, K):
        x = jnp.asarray(_denoiser_input(np.asarray(pred), np.asarray(K)))
        return 6.0 + JaxDenoiser().apply(variables, x, train=False)[:, 0]

    _check_evaluate(fh_root, False, port_zroot, ref_zroot)
