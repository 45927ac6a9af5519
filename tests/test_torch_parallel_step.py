"""The port's data-parallel pretrain step on two gloo ranks against the
reference's step on a two-device JAX mesh (make_mesh(data=2), the batch
placed by its shard_batch), two chained steps at the dry-run shape of
tests/test_torch_train_step.py (RN18, 64 -> 32 canvases, accum 2, a global
microbatch of 4, 2 rows a rank), in f32 on the CPU.

The setup and the tolerances are that file's, and for its reasons: the
same seeded weights, the port's ranks handed the parameters the reference
drew (`_reference_draws`, on the global batch; each rank keeps its rows of
both views), the reference's views computed op by op inside its jitted step,
its gradients recorded at the head of its optax chain; loss 1e-4 relative,
gradients 1e-3 of each parameter's norm, BatchNorm running statistics 1e-4
of each tensor's scale, parameters by the per-update rule.  The port's
ranks report rank 0's state, equal to the bit to rank 1's.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from peclr_tpu.config.defaults import AugmentationParams as JaxParams
from peclr_tpu.config.defaults import peclr_pretrain_flags as jax_flags
from peclr_tpu.models import PeCLRModel as JaxPeCLR
from peclr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from peclr_tpu.parallel.mesh import replicated as jax_replicated
from peclr_tpu.parallel.mesh import shard_batch as jax_shard_batch
from peclr_tpu.train import step as jax_step_module
from peclr_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from peclr_tpu.train.state import TrainState as JaxState
from peclr_tpu.train.step import make_peclr_train_step as jax_make_step
from peclr_tpu_torch.data.synthetic import seeded_peclr_variables
from peclr_tpu_torch.parallel.dryrun import spawn
from tests.test_torch_parallel import (
    TIMEOUT_S,
    WORLD,
    _pretrain_rank,
    assert_ranks_bit_equal,
    pretrain_batch,
)
from tests.test_torch_train_step import (
    ACCUM,
    OPT,
    VIEW,
    _by_torch_name,
    _op_by_op_augment_pair,
    _record_grads,
    _reference_draws,
    check_batch_stats,
    check_grads,
    check_loss,
    check_params_after_each_update,
    check_projection_stats,
)


@pytest.fixture(scope="module")
def runs():
    variables = seeded_peclr_variables("18", seed=0)
    batch = pretrain_batch()
    jflags = jax_flags()

    mesh = jax_make_mesh(data=WORLD, devices=jax.devices()[:WORLD])
    model = JaxPeCLR(resnet_size="18", dtype=jnp.float32)
    tx, _ = jax_build_optimizer(variables["params"], optimizer="LARS", **OPT)
    tx = optax.chain(_record_grads(), tx)
    jax_state = jax.device_put(
        JaxState.create(jax.tree_util.tree_map(jnp.asarray, variables), tx),
        jax_replicated(mesh))
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_step_module, "augment_pair", functools.partial(
        _op_by_op_augment_pair, views_out=None))
    try:
        jax_step = jax_make_step(model, tx, jflags,
                                 JaxParams(resize_shape=(VIEW, VIEW)),
                                 accum=ACCUM, donate=False)
        sharded = jax_shard_batch(mesh, batch)
        ref, steps_draws = [], []
        for s in range(2):
            key = jax.random.PRNGKey(10 + s)
            jax_state, jax_metrics = jax_step(jax_state, sharded, key)
            ref.append(dict(
                loss=float(jax_metrics["loss"]),
                grads=_by_torch_name(jax_state.opt_state[0], "params"),
                params=_by_torch_name(jax_state.params, "params"),
                stats=_by_torch_name(jax_state.batch_stats, "batch_stats"),
                metrics=jax_metrics))
            steps_draws.append([{k: v.numpy() for k, v in d.items()}
                                for d in _reference_draws(key, batch, jflags)])
    finally:
        patch.undo()

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ranks = spawn(_pretrain_rank, WORLD, args=(steps_draws,),
                      timeout=TIMEOUT_S)
    finally:
        torch.set_num_threads(threads)
    assert_ranks_bit_equal(ranks)
    out = []
    for got, want in zip(ranks[0], ref):
        out.append(dict(
            loss=(got["loss"], want["loss"]),
            grads=(got["grads"], want["grads"]),
            params=(got["state"], want["params"]),
            stats=(None, want["stats"]),
            metrics=({k: np.float64(v) for k, v in got["metrics"].items()},
                     want["metrics"])))
    last = ranks[0][-1]
    state = types.SimpleNamespace(
        step=last["step"], optimizer=types.SimpleNamespace(count=last["count"]))
    return variables, out, state


@pytest.mark.parametrize("s", [0, 1])
def test_loss_matches_the_mesh_step(runs, s):
    check_loss(runs, s)


@pytest.mark.parametrize("s", [0, 1])
def test_grads_match_the_mesh_step(runs, s):
    check_grads(runs, s)


@pytest.mark.parametrize("s", [0, 1])
def test_batch_stats_match_the_mesh_step(runs, s):
    check_batch_stats(runs, s)


def test_params_after_each_update_match_the_mesh_step(runs):
    check_params_after_each_update(runs)


def test_projection_stats_match_the_mesh_step(runs):
    check_projection_stats(runs)
