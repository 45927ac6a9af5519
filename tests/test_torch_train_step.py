"""The port's PeCLR pretrain step (peclr_tpu_torch/train/step.py) against
the reference's make_peclr_train_step, two steps at the dry-run shape of
__graft_entry__ (RN18, 64 -> 32 canvases, accum 2, the LARS schedule of
steps_per_epoch 4, epochs 2, warmup 1), in f32 on the CPU.

Both start from the same seeded weights.  The port is handed the
augmentation parameters the reference drew (its step splits the key into
one per microbatch and calls augment_pair with each).  The reference's
gradients come out of its own step: a transform at the head of its optax
chain records them in the optimizer state.

The views: inside the reference's jitted step XLA fuses the colour jitter
with its neighbours, and a few of its floors (the uint8 round trip) land a
whole step away from the same function run op by op; the gradients of this
tiny RN18 move by 10% with them (0.3% without the colour jitter).  The port
reproduces the op-by-op views exactly (tests/test_torch_augment.py), so the
reference's step here computes its views op by op, through a
jax.pure_callback around its own augment_pair; nothing else of its step
changes.  Tolerances, and why:
  * loss 1e-4 relative, gradients 1e-3 relative norm per parameter: f32
    convolutions, BatchNorm and NT-Xent summed in another order;
  * BatchNorm running statistics 1e-4 of each tensor's scale: two
    sequential momentum-0.1 updates per step against the reference's
    closed form, over activations that carry the differences above;
  * parameters: step 1 runs at lr 0 and moves nothing, in either.  Step 2
    moves each element by about lr (Adam's normalised update), so the
    update of each parameter agrees to 1e-2 of its norm, and each element
    to one lr: where a gradient is near 0, its normalised update is not
    determined by the gradient's digits.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from peclr_tpu.config.defaults import AugmentationParams as JaxParams
from peclr_tpu.config.defaults import peclr_pretrain_flags as jax_flags
from peclr_tpu.models import PeCLRModel as JaxPeCLR
from peclr_tpu.ops.augment import AugmentOutput
from peclr_tpu.ops.augment import augment_pair as jax_augment_pair
from peclr_tpu.train import step as jax_step_module
from peclr_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from peclr_tpu.train.state import TrainState as JaxState
from peclr_tpu.train.step import make_peclr_train_step as jax_make_step
from peclr_tpu_torch.config.defaults import (
    AugmentationParams,
    peclr_pretrain_flags,
)
from peclr_tpu_torch.data.synthetic import seeded_peclr_variables
from peclr_tpu_torch.models import PeCLRModel
from peclr_tpu_torch.models.port import (
    flatten,
    peclr_mapping,
    peclr_variables_to_state_dict,
)
from peclr_tpu_torch.ops.image import IMAGENET_STD
from peclr_tpu_torch.train import step as step_module
from peclr_tpu_torch.train.optimizer import build_optimizer
from peclr_tpu_torch.train.recipe import synthetic_pretrain_batch
from peclr_tpu_torch.train.state import TrainState
from peclr_tpu_torch.train.step import make_peclr_train_step
from tests.test_torch_augment import _assert_images_close

#: ImageNet std: normalised views times it are back on the [0, 1] scale
_STD = np.asarray(IMAGENET_STD, np.float32)

MB, ACCUM, CANVAS, VIEW = 4, 2, 64, 32
OPT = dict(base_lr=1e-4, batch_size=MB, accum=ACCUM, steps_per_epoch=4,
           epochs=2, warmup_epochs=1)
#: the accuracy recipe's LARS schedule (scripts/accuracy_proxy.py
#: :make_pretrain_step: base lr 1e-5, warmup_epochs 0.05 of one epoch of
#: steps * accum microbatches) for a run of 40 steps: 2 warmup steps, so
#: RECIPE_STEPS steps cross into the cosine decay
RECIPE_OPT = dict(base_lr=1e-5, batch_size=MB, accum=ACCUM,
                  steps_per_epoch=40 * ACCUM, epochs=1, warmup_epochs=0.05)
RECIPE_STEPS = 4


def _record_grads():
    """An optax transform that passes the updates on and keeps them in its
    state: the gradients the reference's step hands its optimizer."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _op_by_op_augment_pair(key, images, joints, flags, params,
                           normalize=True, views_out=None):
    """The reference's augment_pair, run op by op from inside its jitted
    step (module docstring); each call's two views are appended to
    `views_out` where given."""
    def host(k, im, jt):
        v1, v2 = jax_augment_pair(jnp.asarray(k), jnp.asarray(im),
                                  jnp.asarray(jt), flags, params, normalize)
        if views_out is not None:
            views_out.append((np.asarray(v1.images), np.asarray(v2.images)))
        return tuple((np.asarray(v.images), np.asarray(v.joints),
                      np.asarray(v.matrix),
                      {n: np.asarray(p) for n, p in v.params.items()})
                     for v in (v1, v2))

    shapes = jax.eval_shape(lambda k, im, jt: tuple(
        (v.images, v.joints, v.matrix, v.params)
        for v in jax_augment_pair(k, im, jt, flags, params, normalize)),
        key, images, joints)
    views = jax.pure_callback(host, shapes, key, images, joints)
    return tuple(AugmentOutput(*view) for view in views)


def _reference_draws(key, batch, jflags, extra_draws=None):
    """The parameters the reference's step draws: split(key, accum), then
    augment_pair on each microbatch; as 2B-sample draws for the port.
    `extra_draws(key, n, params)`, where given, adds the draws of the flags
    outside the recipe that augment_pair makes from each microbatch's key."""
    keys = jax.random.split(key, ACCUM)
    params = JaxParams(resize_shape=(VIEW, VIEW))
    draws = []
    for i in range(ACCUM):
        sl = slice(i * MB, (i + 1) * MB)
        v1, v2 = jax_augment_pair(keys[i], jnp.asarray(batch["image"][sl]),
                                  jnp.asarray(batch["joints25d"][sl]),
                                  jflags, params)
        extra = {} if extra_draws is None else extra_draws(keys[i], 2 * MB,
                                                           params)
        draws.append({**extra, **{k: torch.from_numpy(np.concatenate(
            [np.asarray(v1.params[k]), np.asarray(v2.params[k])]))
            for k in v1.params}})
    return draws


def _by_torch_name(tree, coll):
    flat = {"/".join(k): np.asarray(v) for k, v in flatten(tree).items()}
    return {t: flat["/".join(p)] for t, c, p, _ in peclr_mapping("18")
            if c == coll}


_KINDS = {t: kind for t, _, _, kind in peclr_mapping("18")}


def _as_torch_layout(name, value):
    if _KINDS[name] == "conv":  # HWIO -> OIHW
        return np.transpose(value, (3, 2, 0, 1))
    if _KINDS[name] == "dense_w":  # (in, out) -> (out, in)
        return value.T
    return value


def op_by_op_runs(jflags, flags, extra_draws=None, share_views=False,
                  opt=OPT, steps=2):
    """_run_both with the reference's step computing its views op by op.

    share_views: the port's step computes its views and checks them
    against the reference's at tests/test_torch_augment.py's image
    tolerance, then trains on the reference's, so that a colour-jitter floor
    a rounding apart does not move the tiny RN18's gradients."""
    patch = pytest.MonkeyPatch()
    views = []
    patch.setattr(jax_step_module, "augment_pair", functools.partial(
        _op_by_op_augment_pair, views_out=views))
    if share_views:
        real = step_module.augment_pair

        def port_pair(*args, **kw):
            pair = real(*args, **kw)
            out = []
            for got, ref in zip(pair, views.pop(0)):
                _assert_images_close(got.images.numpy() * _STD, ref * _STD)
                out.append(dataclasses.replace(
                    got, images=torch.from_numpy(np.array(ref))))
            return tuple(out)

        patch.setattr(step_module, "augment_pair", port_pair)
    try:
        return _run_both(jflags, flags, extra_draws, opt, steps)
    finally:
        patch.undo()


@pytest.fixture(scope="module")
def runs():
    return op_by_op_runs(jax_flags(), peclr_pretrain_flags())


def _run_both(jflags, flags, extra_draws=None, opt=OPT, steps=2):
    variables = seeded_peclr_variables("18", seed=0)
    batch = {k: v.numpy() for k, v in synthetic_pretrain_batch(
        MB * ACCUM, canvas=CANVAS, seed=0, device="cpu").items()}

    model = JaxPeCLR(resnet_size="18", dtype=jnp.float32)
    tx, _ = jax_build_optimizer(variables["params"], optimizer="LARS", **opt)
    tx = optax.chain(_record_grads(), tx)
    jax_state = JaxState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                                tx)
    jax_step = jax_make_step(model, tx, jflags,
                             JaxParams(resize_shape=(VIEW, VIEW)),
                             accum=ACCUM, donate=False)

    port = PeCLRModel("18")
    port.load_state_dict(peclr_variables_to_state_dict(variables, "18"),
                         strict=True)
    optimizer, _ = build_optimizer(port, **opt)
    state = TrainState(port, optimizer)
    step = make_peclr_train_step(port, optimizer, flags,
                                 AugmentationParams(resize_shape=(VIEW, VIEW)),
                                 accum=ACCUM)
    torch_batch = {k: torch.from_numpy(v) for k, v in batch.items()}

    out = []
    for s in range(steps):
        key = jax.random.PRNGKey(10 + s)
        jax_state, jax_metrics = jax_step(jax_state, batch, key)
        state, metrics = step(state, torch_batch, None,
                              draws=_reference_draws(key, batch, jflags,
                                                     extra_draws))
        grads = {n: p.grad.numpy().copy() for n, p in port.named_parameters()}
        out.append(dict(
            loss=(metrics["loss"].item(), float(jax_metrics["loss"])),
            grads=(grads, _by_torch_name(jax_state.opt_state[0], "params")),
            params=({k: v.detach().numpy().copy()
                     for k, v in port.state_dict().items()},
                    _by_torch_name(jax_state.params, "params")),
            stats=(None, _by_torch_name(jax_state.batch_stats, "batch_stats")),
            metrics=(metrics, jax_metrics),
        ))
    return variables, out, state


def check_loss(runs, s):
    got, ref = runs[1][s]["loss"]
    assert np.isfinite(got)
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def check_grads(runs, s):
    """Per parameter, 1e-3 of its gradient's norm; the bias of the head's
    first Linear feeds a BatchNorm, so its gradient is 0 up to rounding
    (1e-8) and is held to 1e-6 of the gradients' largest norm instead."""
    grads, ref = runs[1][s]["grads"]
    assert set(grads) == set(ref)
    largest = max(np.linalg.norm(r) for r in ref.values())
    for name, g in grads.items():
        r = _as_torch_layout(name, ref[name])
        err = np.linalg.norm(g - r)
        assert err <= 1e-3 * np.linalg.norm(r) + 1e-6 * largest, (
            name, err, np.linalg.norm(r))


def check_batch_stats(runs, s):
    params, _ = runs[1][s]["params"]
    _, ref = runs[1][s]["stats"]
    for name, r in ref.items():
        np.testing.assert_allclose(params[name], r, rtol=0,
                                   atol=1e-4 * np.abs(r).max() + 1e-7,
                                   err_msg=name)


def check_params_after_each_update(runs):
    variables, out, state = runs
    initial = peclr_variables_to_state_dict(variables, "18")
    lr_step2 = 1e-4 * np.sqrt(MB * ACCUM) * 0.5  # warmup: half the peak
    for s in range(2):
        params, ref = out[s]["params"]
        for name, r in ref.items():
            got = params[name]
            r = _as_torch_layout(name, r)
            if s == 0:  # lr 0: nothing moves
                np.testing.assert_array_equal(got, initial[name].numpy(),
                                              err_msg=name)
            np.testing.assert_allclose(got, r, rtol=0, atol=lr_step2,
                                       err_msg=f"{name} step {s + 1}")
            # the head's first bias has a gradient of rounding noise only
            # (test_grads_match): its update has no digits to compare
            if s == 1 and name != "projection_head.0.bias":
                start = initial[name].numpy()
                want = r - start
                assert (np.linalg.norm((got - start) - want)
                        <= 1e-2 * np.linalg.norm(want)), name
        moved = [name for name in ref
                 if not np.array_equal(params[name], initial[name].numpy())]
        assert bool(moved) == (s == 1)
    assert state.step == 2 and state.optimizer.count == 2


def check_projection_stats(runs):
    """The last microbatch's stats, as the reference reports them; the
    median averages the two middle values, as jnp.median does.  1e-4 of
    the projections' scale (the forward's f32 summation order)."""
    metrics, ref = runs[1][1]["metrics"]
    assert set(metrics) == set(ref)
    scale = max(abs(float(v)) for v in ref.values())
    for key, value in ref.items():
        np.testing.assert_allclose(metrics[key].item(), float(value),
                                   rtol=0, atol=1e-4 * scale, err_msg=key)


@pytest.mark.parametrize("s", [0, 1])
def test_loss_matches(runs, s):
    check_loss(runs, s)


@pytest.mark.parametrize("s", [0, 1])
def test_grads_match(runs, s):
    check_grads(runs, s)


@pytest.mark.parametrize("s", [0, 1])
def test_batch_stats_match(runs, s):
    check_batch_stats(runs, s)


def test_params_after_each_update(runs):
    check_params_after_each_update(runs)


def test_projection_stats_match(runs):
    check_projection_stats(runs)


@pytest.fixture(scope="module")
def recipe_runs():
    return op_by_op_runs(jax_flags(), peclr_pretrain_flags(), opt=RECIPE_OPT,
                         steps=RECIPE_STEPS)


def test_recipe_schedule_crosses_its_warmup():
    """Both schedules: 0 at the first update, the peak at the third (the
    warmup's end), then the cosine, equal at every count the runs take."""
    _, ref = jax_build_optimizer(
        seeded_peclr_variables("18", seed=0)["params"], optimizer="LARS",
        **RECIPE_OPT)
    _, got = build_optimizer(PeCLRModel("18"), **RECIPE_OPT)
    peak = 1e-5 * np.sqrt(MB * ACCUM)
    lrs = [got(c) for c in range(RECIPE_STEPS)]
    want = [float(ref(c)) for c in range(RECIPE_STEPS)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6)
    assert lrs[0] == 0.0 and lrs[1] < lrs[2] and lrs[3] < lrs[2]
    np.testing.assert_allclose(lrs[2], peak, rtol=1e-6)


@pytest.mark.parametrize("s", range(RECIPE_STEPS))
def test_loss_matches_across_the_warmup(recipe_runs, s):
    check_loss(recipe_runs, s)


#: the steps whose gradients are held: from the fourth on, the parameters
#: the two sides reach differ by ~1e-7 (the head's first bias apart, whose
#: update is rounding noise), and this tiny RN18's gradients part by more
#: than 1e-3 under a random 1e-7 change of every parameter
#: (test_gradients_part_under_a_1e_7_change); its updates and losses stay
#: held at every step
GRAD_STEPS = 3


@pytest.mark.parametrize("s", range(GRAD_STEPS))
def test_grads_match_across_the_warmup(recipe_runs, s):
    check_grads(recipe_runs, s)


def test_gradients_part_under_a_1e_7_change():
    """Why GRAD_STEPS stops short of RECIPE_STEPS: the port alone, twice
    from one state and one draw stream under RECIPE_OPT, the second run with
    every parameter moved by a random 1e-7 before its last step; that step's
    gradients part by more than check_grads' 1e-3 in some parameter."""
    variables = seeded_peclr_variables("18", seed=0)
    batch = synthetic_pretrain_batch(MB * ACCUM, canvas=CANVAS, seed=0,
                                     device="cpu")
    grads = []
    for nudge in (0.0, 1e-7):
        port = PeCLRModel("18")
        port.load_state_dict(peclr_variables_to_state_dict(variables, "18"))
        optimizer, _ = build_optimizer(port, **RECIPE_OPT)
        state = TrainState(port, optimizer)
        step = make_peclr_train_step(
            port, optimizer, peclr_pretrain_flags(),
            AugmentationParams(resize_shape=(VIEW, VIEW)), accum=ACCUM)
        generator = torch.Generator().manual_seed(3)
        noise = torch.Generator().manual_seed(1)
        for s in range(RECIPE_STEPS):
            if s == RECIPE_STEPS - 1:
                with torch.no_grad():
                    for p in port.parameters():
                        p.add_(torch.randn(p.shape, generator=noise) * nudge)
            state, _ = step(state, batch, generator)
        grads.append({n: p.grad.clone() for n, p in port.named_parameters()})
    parted = max(float((grads[1][n] - g).norm() / g.norm())
                 for n, g in grads[0].items()
                 if n != "projection_head.0.bias")
    assert parted > 1e-3, parted


@pytest.mark.parametrize("s", range(RECIPE_STEPS))
def test_batch_stats_match_across_the_warmup(recipe_runs, s):
    check_batch_stats(recipe_runs, s)


@pytest.mark.parametrize("s", range(1, RECIPE_STEPS))
def test_updates_match_across_the_warmup(recipe_runs, s):
    """Each LARS update (the warmup's second, the peak, the cosine's
    first): each parameter's update within 1e-2 of its norm, but the
    head's first bias, whose update is rounding noise (test_grads_match).
    No element is held alone: an element's update is at most about one lr,
    so a bound of that size would pass any update."""
    _, out, _ = recipe_runs
    got_before, ref_before = out[s - 1]["params"]
    params, ref = out[s]["params"]
    for name, r in ref.items():
        if name == "projection_head.0.bias":
            continue
        got_up = params[name] - got_before[name]
        ref_up = (_as_torch_layout(name, r)
                  - _as_torch_layout(name, ref_before[name]))
        assert (np.linalg.norm(got_up - ref_up)
                <= 1e-2 * np.linalg.norm(ref_up)), (name, s)


def test_params_after_the_warmup(recipe_runs):
    """After the last update each parameter's total LARS update agrees with
    the reference's to 1e-2 of its norm, the head's first bias apart
    (test_updates_match_across_the_warmup)."""
    variables, out, state = recipe_runs
    initial = peclr_variables_to_state_dict(variables, "18")
    params, ref = out[-1]["params"]
    for name, r in ref.items():
        if name == "projection_head.0.bias":
            continue
        got, r = params[name], _as_torch_layout(name, r)
        start = initial[name].numpy()
        assert (np.linalg.norm((got - start) - (r - start))
                <= 1e-2 * np.linalg.norm(r - start)), name
    assert state.step == RECIPE_STEPS
    assert state.optimizer.count == RECIPE_STEPS
