"""The port's pretrain model (PeCLRModel, the ResNet encoder in train mode,
ProjectionHead, the reference-statistics BatchNorm, the stem pool's
gradient) against the reference's flax modules on the CPU in f32.

Weights are made from a seed in the reference's flax layout
(seeded_peclr_variables) and carried into the port by
peclr_variables_to_state_dict.  Train-mode outputs agree at rtol 5e-3 (f32
convolutions summed in another order, then normalised by small-batch
statistics, which amplifies the differences; the reference's own torch
oracle is held to the same bound); one BatchNorm's running statistics after
one update at 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.linen as fnn

from peclr_tpu.models import PeCLRModel as JaxPeCLR
from peclr_tpu.models import port as jax_port
from peclr_tpu.models.heads import ProjectionHead as JaxHead
from peclr_tpu.ops import pooling as jax_pooling
from peclr_tpu_torch.data.synthetic import seeded_peclr_variables
from peclr_tpu_torch.models import PeCLRModel
from peclr_tpu_torch.models.batchnorm import BatchNorm1d, BatchNorm2d
from peclr_tpu_torch.models.heads import ProjectionHead
from peclr_tpu_torch.models.port import (
    flatten,
    peclr_mapping,
    peclr_variables_to_state_dict,
)
from peclr_tpu_torch.ops.pooling import max_pool_3x3s2p1


def _flat_stats(stats):
    return {"/".join(k): np.asarray(v) for k, v in flatten(stats).items()}


@pytest.mark.parametrize("size", ["18", "50"])
def test_train_mode_forward_and_stats_match(rng, size):
    variables = seeded_peclr_variables(size, seed=int(size))
    images = rng.normal(0, 1, (4, 64, 64, 3)).astype(np.float32)
    model = JaxPeCLR(resnet_size=size, dtype=jnp.float32)
    ref, mutated = jax.jit(lambda v, x: model.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables,
                                                    jnp.asarray(images))
    port = PeCLRModel(size)
    port.load_state_dict(peclr_variables_to_state_dict(variables, size),
                         strict=True)
    port.train()
    with torch.no_grad():
        got = port(torch.from_numpy(images))
    for key in ("embedding", "projection"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=5e-3, atol=5e-3 * np.abs(
                                       np.asarray(ref[key])).max(),
                                   err_msg=key)
    # one momentum-0.1 update with the biased batch variance.  The stem's
    # BN sees the same conv output to 1e-6 and agrees at 1e-5, which
    # separates the biased update from torch's unbiased one (n = 4,096: 2.4e-5
    # apart).  Deeper layers carry the f32 drift of the convolutions above
    # them, up to 1e-3 of each tensor's scale at RN50's layer4, where n = 16
    # puts the unbiased update 0.7% away.
    state = port.state_dict()
    new_stats = _flat_stats(mutated["batch_stats"])
    for torch_name, coll, path, _ in peclr_mapping(size):
        if coll != "batch_stats":
            continue
        got_stat, ref_stat = state[torch_name].numpy(), new_stats["/".join(path)]
        if torch_name.startswith("encoder.features.1."):
            np.testing.assert_allclose(got_stat, ref_stat, rtol=1e-5,
                                       atol=1e-5, err_msg=torch_name)
        else:
            np.testing.assert_allclose(
                got_stat, ref_stat, rtol=0,
                atol=1e-3 * np.abs(ref_stat).max() + 1e-6, err_msg=torch_name)


def test_state_dict_is_the_reference_checkpoint_layout():
    """Keys and values equal the reference's variables_to_peclr_checkpoint,
    which loads strictly."""
    variables = seeded_peclr_variables("18", seed=1)
    exported = jax_port.variables_to_peclr_checkpoint(variables, "18")
    state = PeCLRModel("18").state_dict()
    assert set(exported) == set(state)
    mine = peclr_variables_to_state_dict(variables, "18")
    for key, value in exported.items():
        np.testing.assert_array_equal(np.asarray(value), mine[key].numpy(),
                                      err_msg=key)
    PeCLRModel("18").load_state_dict(
        {k: torch.from_numpy(np.asarray(v)) for k, v in exported.items()},
        strict=True)


@pytest.mark.parametrize("cls, shape", [(BatchNorm1d, (256, 16)),
                                        (BatchNorm2d, (8, 16, 5, 5))])
def test_batchnorm_updates_stats_with_the_biased_variance(rng, cls, shape):
    """flax nn.BatchNorm (momentum 0.9, eps 1e-5) in train mode: the same
    output and running stats at 1e-5, and not torch's unbiased update
    (0.4% apart at 256 rows)."""
    x = rng.normal(0.3, 2.0, shape).astype(np.float32)
    c = shape[1]
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.1, c).astype(np.float32)
    mean0 = rng.normal(0, 0.1, c).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    x_nhwc = np.moveaxis(x, 1, -1)
    ref, mutated = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                                 epsilon=1e-5).apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(x_nhwc), mutable=["batch_stats"])
    bn = cls(c)
    bn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean0),
                        "running_var": torch.from_numpy(var0),
                        "num_batches_tracked": torch.tensor(0)})
    out = bn.train()(torch.from_numpy(x))
    np.testing.assert_allclose(np.moveaxis(out.detach().numpy(), 1, -1),
                               np.asarray(ref), rtol=1e-5, atol=1e-5)
    stats = mutated["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), stats["var"],
                               rtol=1e-5, atol=1e-6)
    torch_bn = getattr(torch.nn, cls.__name__)(c)
    torch_bn.load_state_dict(bn.state_dict())
    torch_bn.running_mean.copy_(torch.from_numpy(mean0))
    torch_bn.running_var.copy_(torch.from_numpy(var0))
    torch_bn.train()(torch.from_numpy(x))
    assert not np.allclose(torch_bn.running_var.numpy(), stats["var"],
                           rtol=1e-4, atol=0)
    # eval mode is torch's: the running statistics
    torch_bn.load_state_dict(bn.state_dict())
    np.testing.assert_array_equal(
        bn.eval()(torch.from_numpy(x)).detach().numpy(),
        torch_bn.eval()(torch.from_numpy(x)).detach().numpy())


def test_projection_head_matches_train_mode(rng):
    x = rng.normal(0, 1, (16, 64)).astype(np.float32)
    head = JaxHead(hidden_dim=32, output_dim=8)
    variables = head.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    ref, mutated = head.apply(variables, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    sd = jax_port.export_state_dict(variables,
                                    jax_port.projection_head_mapping())
    port = ProjectionHead(64, 32, 8)
    port.load_state_dict({k: torch.from_numpy(np.asarray(v))
                          for k, v in sd.items()}, strict=True)
    got = port.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port[1].running_var.numpy(),
                               mutated["batch_stats"]["bn"]["var"], rtol=1e-5)


def test_max_pool_gradient_routes_ties_like_the_reference(rng):
    """Post-ReLU maps full of exact-zero ties: autograd of F.max_pool2d
    sends each output gradient to one window position, the one the
    reference's pool gradient picks."""
    x = np.maximum(rng.normal(size=(2, 16, 16, 4)), 0).astype(np.float32)
    x[:, 4:12, 4:12, :] = 0.0
    g = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    ref = jax.vjp(jax_pooling.max_pool_3x3s2p1, jnp.asarray(x))[1](
        jnp.asarray(g))[0]
    xt = torch.tensor(np.moveaxis(x, -1, 1), requires_grad=True)
    max_pool_3x3s2p1(xt).backward(torch.from_numpy(np.moveaxis(g, -1, 1)))
    np.testing.assert_array_equal(np.moveaxis(xt.grad.numpy(), 1, -1),
                                  np.asarray(ref))
