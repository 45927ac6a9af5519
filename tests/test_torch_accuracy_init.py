"""The port's initial weights (peclr_tpu_torch/models/init.py
:init_as_reference, which the accuracy scripts import from
peclr_tpu_torch/scripts) against the reference's `model.init` (flax's
default initialisers), parameter by parameter, on the CPU: the draw itself
at each ResNet size, and the models that each caller builds for a run: the
trainer (PeCLRTrainer), the fine-tune CLI (RN25DPose, fresh and from a
pretrained encoder) and the data-parallel dry run.

The numbers differ (torch's generator is not jax.random's); what must agree
is each tensor's distribution: every parameter and statistic the flax model
has, of the same shape; the constant ones (biases, BatchNorm scale, bias,
running mean and variance) equal; each drawn weight's mean, standard
deviation and largest magnitude those of a normal truncated at 2 standard
deviations, within the sampling error of its size.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from peclr_tpu.models import PeCLRModel as JaxPeCLR
from peclr_tpu.models import RN25DPose as JaxRN25D
from peclr_tpu_torch.models import PeCLRModel
from peclr_tpu_torch.models.port import (
    peclr_variables_to_state_dict,
    rn25d_variables_to_state_dict,
)
from peclr_tpu_torch.scripts import init_as_reference

#: sample standard deviations within this many standard errors of each other
STD_ERRORS = 6.0
#: the standard deviation of a unit normal truncated at +-2
TRUNC_STD = 0.87962566103423978
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "torch_freihand_like", "freihand_dataset")


def _numpy(state_dict):
    # torch's BatchNorm step counter has no flax counterpart
    return {k: v.numpy() for k, v in state_dict.items()
            if not k.endswith("num_batches_tracked")}


def _both(size, seed):
    variables = JaxPeCLR(resnet_size=size, dtype=jnp.bfloat16).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)), train=False)
    want = peclr_variables_to_state_dict(variables, size)
    got = init_as_reference(PeCLRModel(size), seed).state_dict()
    return _numpy(got), _numpy(want)


def _assert_reference_distributions(got, want):
    """Each tensor of `want` (a flax init carried to the port's keys) has
    its counterpart in `got`, equal where flax's is a constant, else of its
    distribution.  Returns how many were drawn."""
    drawn = 0
    for key in want:
        g, w = got[key], want[key].astype(np.float32)
        assert g.shape == w.shape, key
        if np.all(w == w.flat[0]):
            # a constant of the flax init: zero biases, BatchNorm 1 / 0
            np.testing.assert_array_equal(g, w, err_msg=key)
            continue
        drawn += 1
        n = w.size
        assert abs(g.std() / w.std() - 1.0) < STD_ERRORS / np.sqrt(2 * n), (
            key, g.std(), w.std())
        mean_tol = 2 * STD_ERRORS * w.std() / np.sqrt(n)
        assert abs(g.mean() - w.mean()) < mean_tol, (key, g.mean(), w.mean())
        # cut at 2 standard deviations of the normal before truncation
        bound = 2.0 * w.std() / TRUNC_STD * (1.0 + STD_ERRORS / np.sqrt(2 * n))
        assert np.abs(g).max() <= bound and np.abs(w).max() <= bound, key
    return drawn


@pytest.mark.parametrize("size", ["18", "50", "152"])
def test_initial_weights_have_the_reference_distributions(size):
    got, want = _both(size, seed=5)
    assert sorted(got) == sorted(want)
    drawn = _assert_reference_distributions(got, want)
    # the drawn tensors are the convolutions' and dense layers' weights
    assert drawn == sum(1 for v in want.values() if v.ndim > 1), drawn


# ---------------------------------------------------------------------------
# The callers: each builds its fresh model with the reference's draw


def _trainer_model(tmp_path, monkeypatch):
    from peclr_tpu_torch import constants
    from peclr_tpu_torch.config.defaults import ModelConfig, TrainConfig
    from peclr_tpu_torch.data.freihand import FreihandSource
    from peclr_tpu_torch.data.pipeline import HostPipeline
    from peclr_tpu_torch.train.loop import PeCLRTrainer

    monkeypatch.setattr(constants, "SAVED_META_INFO_PATH",
                        str(tmp_path / "meta"))
    pipe = HostPipeline([FreihandSource(FIXTURE, "train", seed=5,
                                        train_ratio=0.75)],
                        batch_size=4, canvas=64, seed=5, num_threads=1)
    trainer = PeCLRTrainer(
        TrainConfig(batch_size=4, seed=5, precision="f32"),
        ModelConfig(resnet_size="18", projection_head_input_dim=512), pipe,
        device="cpu", workdir=str(tmp_path / "run"), log_images=False)
    return trainer.model, 5


def _flax_peclr18(seed):
    variables = JaxPeCLR(resnet_size="18").init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)), train=False)
    return _numpy(peclr_variables_to_state_dict(variables, "18"))


def _flax_rn25d18(seed):
    variables = JaxRN25D(size="18").init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)), train=False)
    return _numpy(rn25d_variables_to_state_dict(variables, "18"))


def _pretrained_peclr18(tmp_path):
    """A PeCLR RN18 checkpoint in the reference's layout, and its weights."""
    from peclr_tpu_torch.data.synthetic import seeded_peclr_variables
    from peclr_tpu_torch.train import checkpoint

    sd = peclr_variables_to_state_dict(seeded_peclr_variables("18", seed=4),
                                       "18")
    path = str(tmp_path / "peclr18.npz")
    checkpoint.save_npz(path, sd)
    return path, sd


@pytest.mark.parametrize("caller", ["trainer", "finetune",
                                    "finetune_pretrained", "dryrun"])
def test_callers_draw_the_reference_distributions(caller, tmp_path,
                                                  monkeypatch):
    """PeCLRTrainer's model against flax's PeCLRModel.init, the fine-tune
    CLI's RN25DPose (cli/finetune.py:initial_model, the CLI's build; RN18,
    which its flags do not offer) against flax's RN25DPose.init (the
    z-root MLP, fc, zero biases, the BatchNorm constants), from a
    pretrained encoder too (the backbone equal to the encoder, fc and the
    z-root MLP still the draw), and the dry run's model against
    PeCLRModel.init."""
    from peclr_tpu_torch.cli import finetune
    from peclr_tpu_torch.models.batchnorm import BatchNorm1d
    from peclr_tpu_torch.parallel import dryrun

    if caller == "trainer":
        model, seed = _trainer_model(tmp_path, monkeypatch)
        want = _flax_peclr18(seed)
    elif caller == "dryrun":
        model, want = dryrun.dryrun_model("cpu"), _flax_peclr18(0)
    else:
        pretrained, encoder = ("", None)
        if caller == "finetune_pretrained":
            pretrained, encoder = _pretrained_peclr18(tmp_path)
        model = finetune.initial_model("18", 5, pretrained)
        want = _flax_rn25d18(5)
        # the z-root MLP's BatchNorms are the port's (flax's statistics)
        assert all(isinstance(model.zroot_ref.zroot_ref[i], BatchNorm1d)
                   for i in (1, 4))
        assert model.backend_model.fc.out_features == 21 * 3 + 1
    got = _numpy(model.state_dict())
    assert sorted(got) == sorted(want)
    if caller == "finetune_pretrained":
        from peclr_tpu_torch.models.port import peclr_to_torchvision

        backbone = _numpy(peclr_to_torchvision(encoder, "18"))
        assert len(backbone) == sum(
            k.startswith("backend_model.") and ".fc." not in k for k in got)
        for key, value in backbone.items():
            np.testing.assert_array_equal(
                got["backend_model." + key], value, err_msg=key)
        want = {k: v for k, v in want.items()
                if not k.startswith("backend_model.")
                or k.startswith("backend_model.fc.")}
    drawn = _assert_reference_distributions(got, want)
    assert drawn == sum(1 for v in want.values() if v.ndim > 1), drawn
