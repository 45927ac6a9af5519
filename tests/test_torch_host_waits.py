"""The port makes the host wait for the card nowhere inside a pretrain step,
a fine-tune step, a two-pass leaderboard batch or a serving request: what
the CPU can show of it, against the reference.

On the card, torch.linalg.inv checks its result on the host (a wait), and
a tensor built from the host's numbers is a synchronising copy.  So the
port inverts with torch.linalg.inv_ex, which checks nothing and, like
jnp.linalg.inv, gives non-finite values for a singular matrix instead of
raising; and it builds its constant tensors once per device
(peclr_tpu_torch/device.py:device_constant).  The waits themselves are
counted on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peclr_tpu.geometry import affine as jax_affine
from peclr_tpu.geometry import camera as jax_camera
from peclr_tpu.models import RN25DPose as JaxRN25DPose
from peclr_tpu_torch import device as device_mod
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
from peclr_tpu_torch.device import device_constant
from peclr_tpu_torch.eval import pred_fh
from peclr_tpu_torch.eval.serving import InferenceSession
from peclr_tpu_torch.geometry import affine, camera
from peclr_tpu_torch.models import RN25DPose
from peclr_tpu_torch.models.port import rn25d_variables_to_state_dict
from peclr_tpu_torch.ops import image
from peclr_tpu_torch.train.finetune import make_finetune_step
from peclr_tpu_torch.train.optimizer import build_optimizer
from peclr_tpu_torch.train.recipe import (
    build_pretrain_state,
    synthetic_pretrain_batch,
    synthetic_supervised_batch,
)
from peclr_tpu_torch.train.state import TrainState
from peclr_tpu_torch.train.step import make_peclr_train_step

SINGULAR = 1  # the batch row whose matrix is singular


def _singular_intrinsics(n=3):
    """seeded intrinsics with row SINGULAR of rank 2 (its last row equals
    its first)."""
    K = seeded_intrinsics(n, seed=1)
    K[SINGULAR, 2] = K[SINGULAR, 0]
    return K


def _check_rows(got, ref, rtol, atol):
    """The other rows equal the reference's; the singular row is not finite
    in either."""
    got, ref = np.asarray(got), np.asarray(ref)
    keep = [i for i in range(len(ref)) if i != SINGULAR]
    np.testing.assert_allclose(got[keep], ref[keep], rtol=rtol, atol=atol)
    assert not np.isfinite(ref[SINGULAR]).all()
    assert not np.isfinite(got[SINGULAR]).all()


def _rn25d(size="18"):
    variables = seeded_rn25d_variables(size, seed=int(size))
    model = RN25DPose(size)
    model.load_state_dict(rn25d_variables_to_state_dict(variables, size),
                          strict=True)
    return variables, model.eval()


@pytest.mark.parametrize("what", ["rn25d_forward", "root_depth",
                                  "invert_affine"])
def test_singular_matrix_row_is_non_finite_as_in_the_reference(rng, what):
    """A singular matrix in one row of a batch: the port no longer raises;
    its other rows equal the reference's within the tolerances of their
    parity tests (tests/test_torch_models.py), and the singular row is not
    finite in either."""
    K = _singular_intrinsics()
    if what == "rn25d_forward":
        variables, model = _rn25d()
        images = rng.normal(0, 1, (3, 64, 64, 3)).astype(np.float32)
        ref = JaxRN25DPose(size="18").apply(
            variables, jnp.asarray(images), K=jnp.asarray(K), train=False)
        with torch.no_grad():
            got = model(torch.from_numpy(images), K=torch.from_numpy(K))
        np.testing.assert_allclose(got["kp25d"].numpy(),
                                   np.asarray(ref["kp25d"]), rtol=1e-4,
                                   atol=1e-4)
        _check_rows(got["kp3d"], ref["kp3d"], rtol=1e-3, atol=1e-5)
    elif what == "root_depth":
        joints25d = rng.uniform(20, 200, (3, 21, 3)).astype(np.float32)
        joints25d[..., 2] = rng.uniform(-0.5, 0.5, (3, 21))
        z_ref, inv_ref = jax_camera.root_depth(jnp.asarray(joints25d),
                                               jnp.asarray(K))
        z, inv = camera.root_depth(torch.from_numpy(joints25d),
                                   torch.from_numpy(K))
        _check_rows(inv, inv_ref, rtol=1e-5, atol=1e-6)
        _check_rows(z, z_ref, rtol=1e-4, atol=1e-4)
    else:
        mats = np.broadcast_to(np.eye(3, dtype=np.float32), (3, 3, 3)).copy()
        mats[:, :2] = rng.uniform(-2, 2, (3, 2, 3))
        mats[SINGULAR, 1] = 2 * mats[SINGULAR, 0]
        _check_rows(affine.invert_affine(torch.from_numpy(mats)),
                    jax_affine.invert_affine(jnp.asarray(mats)), rtol=1e-5,
                    atol=1e-5)


def _no_inv(*args, **kwargs):
    raise AssertionError("torch.linalg.inv checks its result on the host "
                         "(a wait on the card)")


def _pretrain_step():
    # the gather route (ops/warp.py) is the pretrain step's one inverse;
    # the two-pass routes invert in closed form
    model, state, opt = build_pretrain_state("18", batch=4, accum=2,
                                             device="cpu")
    step = make_peclr_train_step(model, opt, peclr_pretrain_flags(),
                                 AugmentationParams(resize_shape=(32, 32)),
                                 accum=2, warp_route="gather")
    batch = synthetic_pretrain_batch(8, canvas=64, seed=0, device="cpu")
    _, metrics = step(state, batch, torch.Generator().manual_seed(0))
    return metrics["loss"]


def _finetune_step():
    _, model = _rn25d()
    opt, _ = build_optimizer(model, base_lr=1e-4, batch_size=4, accum=1,
                             steps_per_epoch=2, epochs=2, optimizer="adam")
    step = make_finetune_step(
        model, opt, AugmentationFlags(crop=True, rotate=True, resize=True),
        AugmentationParams(resize_shape=(64, 64)), loss_3d_weight=0.1)
    batch = synthetic_supervised_batch(4, canvas=96, seed=2, device="cpu")
    _, metrics = step(TrainState(model, opt), batch,
                      torch.Generator().manual_seed(0))
    return metrics["loss"]


def _two_pass():
    _, model = _rn25d()
    out = pred_fh.run_two_pass(model, torch.from_numpy(seeded_frames(2, 7)),
                               torch.from_numpy(seeded_intrinsics(2, 8)))
    return out["kp3d"]


def _serving():
    _, model = _rn25d()
    sess = InferenceSession(model, batch_size=2, image_size=64, device="cpu")
    frames = np.random.default_rng(3).integers(0, 256, (3, 64, 64, 3),
                                               dtype=np.uint8)
    return torch.from_numpy(sess.predict(frames)["kp3d"])


@pytest.mark.parametrize("path", [_pretrain_step, _finetune_step, _two_pass,
                                  _serving],
                         ids=["pretrain_step_gather", "finetune_step",
                              "run_two_pass", "serving_request"])
def test_paths_never_call_the_checked_inverse(monkeypatch, path):
    """With torch.linalg.inv forbidden, one pretrain step at the dry-run
    shape (64 -> 32, accum 2), one fine-tune step, one two-pass batch of
    224² frames and one serving request run to finite outputs."""
    torch.manual_seed(0)
    monkeypatch.setattr(torch.linalg, "inv", _no_inv)
    out = path()
    assert bool(torch.isfinite(out).all())


def test_device_constants_are_built_once_per_device():
    """normalize_imagenet, grayscale, the Sobel filter and the RN25D's
    default K build their constants on the first call for a device and
    reuse them after; another device (or dtype) gets its own."""
    x = torch.rand(2, 8, 8, 3) * 255
    model = _rn25d()[1]
    with torch.no_grad():
        first = (image.normalize_imagenet(x / 255.0), image.grayscale(x),
                 image.sobel_filter(x), model(x[:, :64, :64] / 255.0)["kp3d"])
    built = device_mod._constant.cache_info().currsize
    with torch.no_grad():
        again = (image.normalize_imagenet(x / 255.0), image.grayscale(x),
                 image.sobel_filter(x), model(x[:, :64, :64] / 255.0)["kp3d"])
    assert device_mod._constant.cache_info().currsize == built
    for a, b in zip(first, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    mean = device_constant(image.IMAGENET_MEAN, "cpu")
    assert mean is device_constant(list(image.IMAGENET_MEAN),
                                   torch.device("cpu"))
    assert device_constant(image.IMAGENET_MEAN, "meta") is not mean
    assert device_constant(image.IMAGENET_MEAN, "cpu",
                           torch.float64).dtype == torch.float64
    # built under inference mode, it is still a normal tensor that autograd
    # may save (normalize_imagenet's division saves it)
    with torch.inference_mode():
        std = device_constant((0.5, 0.25, 0.125), "cpu")
    assert not std.is_inference()
    y = torch.ones(3, requires_grad=True)
    (y / std).sum().backward()
    torch.testing.assert_close(y.grad, 1.0 / std)
    np.testing.assert_array_equal(mean.numpy(),
                                  np.asarray(image.IMAGENET_MEAN, np.float32))


def test_device_constant_keeps_jax_parity_of_the_normalisation():
    """The cached statistics give the reference's normalisation."""
    from peclr_tpu.ops import image as jax_image

    x = np.random.default_rng(1).uniform(0, 1, (2, 4, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        image.normalize_imagenet(torch.from_numpy(x)).numpy(),
        np.asarray(jax_image.normalize_imagenet(jnp.asarray(x))), rtol=1e-6)
    assert jax.default_backend() == "cpu"
