"""The port's fine-tune step (peclr_tpu_torch/train/finetune.py) against
the reference's make_finetune_step: two steps of RN25DPose at RN18, batch 8
of 224² canvases cropped to 64², the CLI's "adam" chain (base lr 1e-6,
below), the lifted-3D loss at weight 0.1, in f32 on the CPU.

Both start from the same seeded weights; the port is handed the
augmentation parameters the reference drew.  As in
tests/test_torch_train_step.py, the reference's jitted step would fuse the
colour jitter with its neighbours and flip a few of its floors, so its
supervised sample runs op by op through a jax.pure_callback; nothing else
of its step changes.  The reference's gradients come out of its own step:
a transform at the head of its optax chain records them.

Two faults of the port are pinned here: the z-root MLP's BatchNorm updated
its running variance with the unbiased batch variance (torch's), where flax
takes the biased one; and the optimizer skipped parameters without a
gradient, where the reference's chain moves the decayed weights of the
z-root MLP, which the loss does not reach, by about lr a step.

Tolerances, and why:
  * the backbone's gradients of this random RN18 are ill-conditioned: a
    1e-4 degree change of the rotation moves some by 2% (BatchNorm in
    train mode over 32 values a channel at layer4), so the two sides'
    gradients agree per tensor to 5e-2 of its norm, not to f32 rounding;
  * Adam's first updates are about lr times the gradient's sign, and where
    a gradient is near 0 that sign is not determined by its digits.  At
    the CLI's base lr 1e-4 (lr 2.8e-4) such an element is 5.7e-4 off; at
    base lr 1e-6 (lr 2.8e-6) every element stays within 2e-5 over two
    steps, and each parameter's update agrees to 0.25 of its norm;
  * losses 1e-5 relative, both steps; BatchNorm running statistics 1e-4 of
    each tensor's scale;
  * the z-root MLP, which no gradient reaches, moves the same way on both
    sides to 1e-2 of lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from peclr_tpu.config.defaults import AugmentationFlags as JaxFlags
from peclr_tpu.config.defaults import AugmentationParams as JaxParams
from peclr_tpu.eval.evaluate import supervised_sample_batch as jax_sample
from peclr_tpu.models import RN25DPose as JaxRN25D
from peclr_tpu.ops.augment import augment_batch
from peclr_tpu.train import finetune as jax_finetune
from peclr_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from peclr_tpu.train.state import TrainState as JaxState
from peclr_tpu_torch.config.defaults import AugmentationFlags, AugmentationParams
from peclr_tpu_torch.data.freihand import FreihandSource
from peclr_tpu_torch.data.pipeline import HostPipeline
from peclr_tpu_torch.data.synthetic import (
    generate_freihand_like,
    seeded_peclr_variables,
    seeded_rn25d_variables,
)
from peclr_tpu_torch.models import PeCLRModel, RN25DPose
from peclr_tpu_torch.models.port import (
    flatten,
    peclr_variables_to_state_dict,
    rn25d_mapping,
    rn25d_variables_to_state_dict,
)
from peclr_tpu_torch.train.finetune import (
    load_pretrained_encoder,
    make_finetune_step,
)
from peclr_tpu_torch.train.optimizer import build_optimizer
from peclr_tpu_torch.train.state import TrainState

B, CROP, SIZE, W3D = 8, 64, "18", 0.1
FLAGS = dict(crop=True, rotate=True, color_jitter=True, resize=True)
OPT = dict(base_lr=1e-6, batch_size=B, accum=1, steps_per_epoch=2, epochs=2,
           optimizer="adam")
_KINDS = {t: kind for t, _, _, kind in rn25d_mapping(SIZE)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _record_grads():
    """An optax transform that passes the updates on and keeps them in its
    state: the gradients the reference's step hands its optimizer."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _op_by_op_sample(key, batch, flags, params, use_palm=False):
    """The reference's supervised sample, run op by op from inside its
    jitted step (module docstring)."""
    def host(k, b):
        out = jax_sample(jnp.asarray(k), {n: jnp.asarray(v) for n, v in b.items()},
                         flags, params, use_palm)
        return {n: np.asarray(v) for n, v in out.items()}

    shapes = jax.eval_shape(
        lambda k, b: jax_sample(k, b, flags, params, use_palm), key, batch)
    return jax.pure_callback(host, shapes, key, batch)


def _by_torch_name(tree, coll):
    flat = {"/".join(k): np.asarray(v) for k, v in flatten(tree).items()}
    out = {}
    for name, c, path, kind in rn25d_mapping(SIZE):
        if c != coll:
            continue
        value = flat["/".join(path)]
        if kind == "conv":  # HWIO -> OIHW
            value = np.transpose(value, (3, 2, 0, 1))
        elif kind == "dense_w":  # (in, out) -> (out, in)
            value = value.T
        out[name] = value
    return out


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("finetune_fh"))
    generate_freihand_like(root, num_unique=4, seed=11)
    pipe = HostPipeline([FreihandSource(root, "train", train_ratio=0.75)],
                        batch_size=B, canvas=224, num_threads=2)
    return next(pipe.batches(1))


@pytest.fixture(scope="module")
def runs(batch):
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_finetune, "supervised_sample_batch", _op_by_op_sample)
    try:
        yield _run_both(batch)
    finally:
        patch.undo()


def _run_both(batch):
    variables = seeded_rn25d_variables(SIZE, seed=1)
    jflags, jparams = JaxFlags(**FLAGS), JaxParams(resize_shape=(CROP, CROP))
    tx, _ = jax_build_optimizer(variables["params"], **OPT)
    tx = optax.chain(_record_grads(), tx)
    jax_state = JaxState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                                tx)
    jax_step = jax_finetune.make_finetune_step(
        JaxRN25D(size=SIZE), tx, jflags, jparams, loss_3d_weight=W3D,
        donate=False)

    model = RN25DPose(SIZE)
    model.load_state_dict(rn25d_variables_to_state_dict(variables, SIZE),
                          strict=True)
    opt, _ = build_optimizer(model, **OPT)
    state = TrainState(model, opt)
    step = make_finetune_step(model, opt, AugmentationFlags(**FLAGS),
                              AugmentationParams(resize_shape=(CROP, CROP)),
                              loss_3d_weight=W3D)
    torch_batch = {k: torch.from_numpy(v) for k, v in batch.items()}

    out = []
    for s in range(2):
        key = jax.random.PRNGKey(20 + s)
        drawn = augment_batch(key, jnp.asarray(batch["image"]),
                              jnp.asarray(batch["joints25d"]), jflags,
                              jparams).params
        jax_state, jax_metrics = jax_step(jax_state, batch, key)
        state, metrics = step(state, torch_batch, None, draws={
            k: torch.from_numpy(np.array(v)) for k, v in drawn.items()})
        out.append(dict(
            metrics=({k: v.item() for k, v in metrics.items()},
                     {k: float(v) for k, v in jax_metrics.items()}),
            grads=({n: None if p.grad is None else p.grad.numpy().copy()
                    for n, p in model.named_parameters()},
                   _by_torch_name(jax_state.opt_state[0], "params")),
            state=({k: v.detach().numpy().copy()
                    for k, v in model.state_dict().items()},
                   {**_by_torch_name(jax_state.params, "params"),
                    **_by_torch_name(jax_state.batch_stats, "batch_stats")}),
        ))
    return variables, out, state


@pytest.mark.parametrize("s", [0, 1])
def test_metrics_match(runs, s):
    got, ref = runs[1][s]["metrics"]
    assert set(got) == set(ref) == {"loss", "loss_2d", "loss_z",
                                    "loss_z_unscaled", "loss_3d"}
    for key, value in ref.items():
        assert np.isfinite(got[key])
        np.testing.assert_allclose(got[key], value, rtol=1e-5, err_msg=key)


def test_grads_match(runs):
    """Per parameter, 5e-2 of its gradient's norm, over the first step
    (module docstring); the z-root MLP, which the loss does not reach, has
    none (the reference's are zeros)."""
    grads, ref = runs[1][0]["grads"]
    for name, r in ref.items():
        g = grads[name]
        if name.startswith("zroot_ref."):
            assert g is None and not np.any(r), name
            continue
        err = np.linalg.norm(g - r)
        assert err <= 5e-2 * np.linalg.norm(r) + 1e-9, (name, err)


@pytest.mark.parametrize("s", [0, 1])
def test_params_and_stats_after_each_step(runs, s):
    variables, out, _ = runs
    initial = rn25d_variables_to_state_dict(variables, SIZE)
    got, ref = out[s]["state"]
    for name, r in ref.items():
        if "running" in name:
            tol = 1e-4 * np.abs(r).max() + 1e-7
        else:
            tol = 2e-5
            # every parameter the loss reaches moves (the z-root MLP's:
            # test_zroot_weights_move_as_the_reference)
            assert (name.startswith("zroot_ref.") or not np.array_equal(
                got[name], initial[name].numpy())), name
        np.testing.assert_allclose(got[name], r, rtol=0, atol=tol,
                                   err_msg=f"{name} step {s + 1}")
        if "running" not in name and not name.startswith("zroot_ref."):
            start = initial[name].numpy()
            want = r - start
            assert (np.linalg.norm((got[name] - start) - want)
                    <= 0.25 * np.linalg.norm(want)), (name, s)


def test_zroot_running_var_matches_flax(runs):
    """The z-root MLP's BatchNorms (train mode in the step) update their
    running variance with the biased batch variance, as flax does."""
    got, ref = runs[1][0]["state"]
    for name in ("zroot_ref.zroot_ref.1.running_var",
                 "zroot_ref.zroot_ref.4.running_var"):
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-5,
                                   err_msg=name)


def test_zroot_weights_move_as_the_reference(runs):
    """The loss does not reach the z-root MLP; its decayed weights still
    move by about lr a step through Adam, and its biases and BatchNorm
    parameters stay, as in the reference's chain (to 1e-2 of lr, or an ulp
    of the weight)."""
    variables, out, state = runs
    initial = rn25d_variables_to_state_dict(variables, SIZE)
    lr = OPT["base_lr"] * np.sqrt(B)
    got, ref = out[1]["state"]
    for name in ref:
        if not name.startswith("zroot_ref.") or "running" in name:
            continue
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-6,
                                   atol=1e-2 * lr, err_msg=name)
        moved = np.abs(got[name] - initial[name].numpy()).max()
        decayed = _KINDS[name] == "dense_w"
        assert (moved > 0.5 * lr) if decayed else moved == 0.0, (name, moved)
    assert state.step == 2 and state.optimizer.count == 2


def test_load_pretrained_encoder_matches_reference():
    """A PeCLR checkpoint's encoder goes into the backbone; fc and the
    z-root MLP keep their weights."""
    variables = seeded_rn25d_variables(SIZE, seed=2)
    peclr_sd = peclr_variables_to_state_dict(seeded_peclr_variables(SIZE, 3),
                                             SIZE)
    ref = jax_finetune.load_pretrained_encoder(
        variables, {k: v.numpy() for k, v in peclr_sd.items()}, SIZE)
    model = RN25DPose(SIZE)
    model.load_state_dict(rn25d_variables_to_state_dict(variables, SIZE),
                          strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_pretrained_encoder(model, peclr_sd)
    want = rn25d_variables_to_state_dict(ref, SIZE)
    got = model.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].numpy(), value.numpy(),
                                      err_msg=name)
        if not name.startswith("backend_model.") or ".fc." in name:
            assert torch.equal(got[name], before[name]), name
    encoder = PeCLRModel(SIZE)
    encoder.load_state_dict(peclr_sd, strict=True)
    conv = got["backend_model.layer2.0.conv1.weight"]
    assert torch.equal(conv, encoder.encoder.features[5][0].conv1.weight)
    assert not torch.equal(conv, before["backend_model.layer2.0.conv1.weight"])
