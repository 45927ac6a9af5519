"""The port's entry point (peclr_tpu_torch/entry.py) against the
reference's __graft_entry__.entry() on the CPU: the same weights (the
reference's init, carried across) and the same seeded images through both
forwards in float32, the projection within a stated tolerance; the example
arguments' shapes and types; and the card as the default device."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from peclr_tpu.models import PeCLRModel as JaxPeCLR
from peclr_tpu_torch import entry as port_entry
from peclr_tpu_torch.models import PeCLRModel
from peclr_tpu_torch.models.port import peclr_variables_to_state_dict

#: the projection's largest difference over its largest magnitude (both
#: float32; the two sum the convolutions in other orders)
RTOL = 1e-3


def test_example_args_are_the_references():
    fn, (model, images) = port_entry.entry("cpu")
    _, (_, _, ref_images) = __graft_entry__.entry()
    assert isinstance(model, PeCLRModel) and model.resnet_size == "50"
    assert not model.training
    assert tuple(images.shape) == ref_images.shape == (8, 128, 128, 3)
    assert images.dtype == torch.float32 and not images.any()
    out = fn(model, images)
    assert tuple(out.shape) == (8, 128) and out.dtype == torch.float32


def test_projection_matches_the_reference():
    _, (params, batch_stats, _) = __graft_entry__.entry()
    variables = {"params": params, "batch_stats": batch_stats}
    images = np.random.default_rng(0).standard_normal(
        port_entry.EXAMPLE_SHAPE).astype(np.float32)
    want = np.asarray(JaxPeCLR(resnet_size="50", dtype=jnp.float32).apply(
        variables, jnp.asarray(images), train=False)["projection"])

    fn, (model, _) = port_entry.entry("cpu")
    model.load_state_dict(peclr_variables_to_state_dict(variables, "50"),
                          strict=True)
    got = fn(model, torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (8, 128)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= RTOL, err


def test_entry_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()


def test_dryrun_multichip_is_the_parallel_one():
    from peclr_tpu_torch.parallel import dryrun

    assert port_entry.dryrun_multichip is dryrun.dryrun_multichip
