"""The port's ResNetPose and Denoiser (peclr_tpu_torch/models/resnet.py,
models/heads.py), their weight tables (models/port.py), the synthetic
supervised batch (train/recipe.py), the shape aliases (types.py) and the
figure helpers (utils/visualize.py) against the reference on the CPU.

Weights are made from a seed in the reference's flax layout and carried
into the port.  Outputs within 1e-5 of their scale (f32 layers summed in
another order); the BatchNorm running statistics of a train-mode call
within 1e-5 of each tensor's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peclr_tpu import types as jax_types
from peclr_tpu.models import ResNetPose as JaxResNetPose
from peclr_tpu.models.heads import Denoiser as JaxDenoiser
from peclr_tpu.models.port import resnet_mapping as jax_resnet_mapping
from peclr_tpu.train.recipe import (
    synthetic_supervised_batch as jax_supervised_batch,
)
from peclr_tpu_torch import types
from peclr_tpu_torch.data.synthetic import _last_bn, _seeded_variables
from peclr_tpu_torch.models import Denoiser, ResNetPose
from peclr_tpu_torch.models.port import (
    denoiser_variables_to_state_dict,
    flatten,
    resnet_mapping,
    resnet_pose_mapping,
    resnet_pose_variables_to_state_dict,
    zroot_mlp_mapping,
)
from peclr_tpu_torch.train.recipe import synthetic_supervised_batch


def _close(got, ref, scale_of=None):
    ref = np.asarray(ref)
    scale = np.abs(ref if scale_of is None else scale_of).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * max(scale, 1e-6))


def _pose_variables(size, seed):
    shapes = {k: tuple(v.shape) for k, v in ResNetPose(size).state_dict().items()}
    return _seeded_variables(shapes, resnet_pose_mapping(size), seed,
                             _last_bn(size))


def _denoiser_variables(seed):
    shapes = {k: tuple(v.shape) for k, v in Denoiser().state_dict().items()}
    return _seeded_variables(shapes, zroot_mlp_mapping(), seed, last_bn="-")


@pytest.mark.parametrize("size", ["18", "50"])
def test_resnet_mapping_with_fc_matches_reference(size):
    assert resnet_mapping(size, fc_out=64) == [
        (t, c, tuple(p), k) for t, c, p, k in jax_resnet_mapping(size, 64)]
    assert resnet_mapping(size) == [
        (t, c, tuple(p), k) for t, c, p, k in jax_resnet_mapping(size)]


def test_resnet_pose_matches_flax(rng):
    """Eval mode: the (B, 64) output; the weight table covers every flax
    variable of the reference's ResNetPose."""
    variables = _pose_variables("18", seed=3)
    flax_init = JaxResNetPose(size="18").init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    assert ({"/".join(k) for k in flatten(variables)}
            == {"/".join(k) for k in flatten(jax.tree_util.tree_map(
                np.asarray, dict(flax_init)))})
    images = rng.normal(0, 1, (3, 48, 48, 3)).astype(np.float32)
    ref = JaxResNetPose(size="18").apply(variables, jnp.asarray(images),
                                         train=False)
    model = ResNetPose("18")
    model.load_state_dict(resnet_pose_variables_to_state_dict(variables, "18"),
                          strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(images)).numpy()
    assert got.shape == (3, 64)
    _close(got, ref)


def _denoiser_input(rng, n):
    return rng.normal(0, 1, (n, 64)).astype(np.float32)


def test_denoiser_matches_flax(rng):
    """Eval mode, then one train-mode call: the output and the running
    statistics it leaves (flax's biased variance, momentum 0.9)."""
    variables = _denoiser_variables(seed=4)
    x = _denoiser_input(rng, 16)
    model = Denoiser()
    model.load_state_dict(denoiser_variables_to_state_dict(variables),
                          strict=True)
    ref = JaxDenoiser().apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (16, 1)
    _close(got, ref)

    ref_train, updates = JaxDenoiser().apply(
        variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got_train = model.train()(torch.from_numpy(x)).numpy()
    _close(got_train, ref_train)
    state = model.state_dict()
    for name, coll, path, _ in zroot_mlp_mapping():
        if coll != "batch_stats":
            continue
        want = np.asarray(flatten(jax.tree_util.tree_map(
            np.asarray, dict(updates)))[("batch_stats",) + path])
        _close(state[name].numpy(), want)


def test_supervised_batch_matches_reference():
    got = synthetic_supervised_batch(4, canvas=64, seed=2, device="cpu")
    ref = jax_supervised_batch(4, canvas=64, seed=2)
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["image"].numpy(), np.asarray(ref["image"]))
    for key in ("joints25d", "joints3d", "K", "scale", "joints_valid"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


def test_types_match_reference():
    names = [n for n in dir(jax_types) if n.isupper()]
    assert names and all(hasattr(types, n) for n in names)


def test_figures_render(tmp_path, rng):
    """Every figure helper writes its PNG (the card's host has no
    matplotlib: each imports it when called)."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from peclr_tpu_torch.utils.visualize import (
        plot_hand,
        plot_pairwise_pair,
        plot_simclr_pair,
        plot_truth_vs_prediction,
    )

    img = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    joints = rng.uniform(5, 59, (21, 3)).astype(np.float32)
    out = str(tmp_path)
    paths = [plot_truth_vs_prediction(joints, joints + 1, img, out_dir=out),
             plot_simclr_pair(img, img[::-1], out_dir=out),
             plot_pairwise_pair(img, img, joints, joints - 1, out_dir=out)]
    assert all(p and (tmp_path / p.rsplit("/", 1)[-1]).exists() for p in paths)
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    plot_hand(ax, joints, plot_3d=True)
    assert len(ax.lines) == 20
    plt.close(fig)
