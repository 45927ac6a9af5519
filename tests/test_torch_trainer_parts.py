"""The trainer's parts in the port against the reference's, on the CPU:
the CLI's config merge, experiment and checkpoint names, the optimizer's
"adam" chain, the checkpoint retention policy and the eval step."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from peclr_tpu.cli import train as jax_cli
from peclr_tpu.train import checkpoint as jax_ckpt
from peclr_tpu.train import optimizer as jax_opt
from peclr_tpu.utils import logging as jax_logging
from peclr_tpu_torch.cli import train as cli
from peclr_tpu_torch.train import checkpoint, optimizer
from peclr_tpu_torch.train.state import TrainState
from peclr_tpu_torch.utils import logging as port_logging

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These small models run as fast on one CPU thread as on many, and one
    thread keeps them fast beside the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RECIPE = ["--rotate", "--crop", "--color_jitter", "--resize",
          "-sources", "freihand", "-sources", "youtube", "-batch_size", "128",
          "-accumulate_grad_batches", "16", "-epochs", "100", "-save_top_k",
          "5", "-resnet_size", "50", "-optimizer", "LARS"]


@pytest.mark.parametrize("argv", [
    RECIPE,
    [],
    ["-train_ratio", "0.75"],
    ["-train_ratio", "1.0"],
    ["-train_ratio", "75"],
    ["--crop", "-canvas", "64", "-view_size", "48", "-resnet_size", "18"],
    ["-experiment_type", "simclr", "-lr", "3e-4", "-lr_max_epochs", "7",
     "--use_palm", "-seed", "3", "-num_workers", "2", "-optimizer", "adam",
     "--sobel_filter", "--flip", "-log_interval", "step"],
], ids=["recipe", "defaults", "ratio_0.75", "ratio_1.0", "ratio_75",
        "view_size", "simclr"])
def test_configs_from_args_match(argv):
    """Equal dataclass fields, the reference's train_ratio quirk included
    (the ratio is taken as a percentage mod 100: 1.0 and 75 give 0)."""
    args = cli.build_parser().parse_args(argv)
    ref_args = jax_cli.build_parser().parse_args(argv)
    assert {k: v for k, v in vars(args).items() if k != "device"} == vars(
        ref_args)
    assert args.device == "cuda"
    got, ref = cli.configs_from_args(args), jax_cli.configs_from_args(ref_args)
    for g, r in zip(got, ref):
        assert type(g).__name__ == type(r).__name__
        assert dataclasses.asdict(g) == dataclasses.asdict(r)


def test_config_defaults_match():
    from peclr_tpu.config import defaults as jax_defaults
    from peclr_tpu_torch.config import defaults

    for name in ("TrainConfig", "ModelConfig", "AugmentationFlags",
                 "AugmentationParams"):
        assert (dataclasses.asdict(getattr(defaults, name)())
                == dataclasses.asdict(getattr(jax_defaults, name)())), name
    assert defaults.TrainConfig().train_ratio == 0.9999999999
    assert defaults.TrainConfig().precision == "bf16"


def test_names_match():
    for flags in ([], ["crop", "rotate", "color_jitter", "resize"],
                  ["flip", "sobel_filter", "cut_out", "random_crop"]):
        for prefix, batch in (("hybrid2_", 128), ("simclr_", 7)):
            assert (port_logging.prepare_name(prefix, batch, flags)
                    == jax_logging.prepare_name(prefix, batch, flags))
    assert port_logging.prepare_name(
        "hybrid2_", 128, ["crop", "rotate", "color_jitter", "resize"]
    ) == "hybrid2_128C_CJ_Re_Ro"
    for name in ("epoch=7.ckpt", "epoch_7", "7", " 12 ", "epoch=0.ckpt"):
        assert (checkpoint.parse_checkpoint_name(name)
                == jax_ckpt.parse_checkpoint_name(name))
    for bad in ("best.ckpt", "epoch-3", ""):
        with pytest.raises(ValueError):
            checkpoint.parse_checkpoint_name(bad)
        with pytest.raises(ValueError):
            jax_ckpt.parse_checkpoint_name(bad)


def test_cosine_schedule_matches_optax():
    """f64 on the host against optax's f32: 1e-6 relative."""
    for peak, total in ((0.14, 12), (1.0, 1), (2.8e-3, 6250), (0.5, 0)):
        got = optimizer.cosine(peak, total)
        ref = jax_opt.cosine(peak, total)
        for count in (0, 1, 2, total // 2, total - 1, total, total + 3):
            np.testing.assert_allclose(got(count), float(ref(count)),
                                       rtol=1e-6, atol=1e-9,
                                       err_msg=f"{peak} {total} {count}")


class _Tiny(nn.Module):
    """conv1 (decayed), bn1 (not), fc.weight (decayed), fc.bias (not)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 4, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(4)
        self.fc = nn.Linear(4, 5)


_NAMES = {"conv1.weight": ("conv1", "kernel"), "bn1.weight": ("bn1", "scale"),
          "bn1.bias": ("bn1", "bias"), "fc.weight": ("fc", "kernel"),
          "fc.bias": ("fc", "bias")}


def test_adam_chain_matches_optax(rng):
    """Five updates of optimizer="adam" (masked decay before Adam, the
    cosine schedule from the peak, counted in optimizer steps) against the
    reference's optax chain with the same gradients: parameters within 1e-6
    after every update, weight decay large enough for the mask to show."""
    torch.manual_seed(0)
    model = _Tiny()
    with torch.no_grad():
        model.bn1.weight.uniform_(0.5, 1.5)
        model.bn1.bias.normal_()
    params = dict(model.named_parameters())
    tree = {a: {} for a, _ in _NAMES.values()}
    for n, (a, b) in _NAMES.items():
        tree[a][b] = jnp.asarray(params[n].detach().numpy().copy())
    kw = dict(base_lr=0.05, batch_size=4, accum=2, steps_per_epoch=6,
              epochs=3, warmup_epochs=1, weight_decay=0.3)
    tx, ref_schedule = jax_opt.build_optimizer(tree, optimizer="adam", **kw)
    opt_state = tx.init(tree)
    opt, schedule = optimizer.build_optimizer(model, optimizer="adam", **kw)
    assert not opt.lars
    for count in range(12):
        np.testing.assert_allclose(schedule(count), float(ref_schedule(count)),
                                   rtol=1e-6, atol=1e-9)
    for step in range(5):
        grads = {n: rng.normal(size=p.shape).astype(np.float32)
                 for n, p in params.items()}
        for n, p in params.items():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
        g_tree = {a: {} for a in tree}
        for n, (a, b) in _NAMES.items():
            g_tree[a][b] = jnp.asarray(grads[n])
        updates, opt_state = tx.update(g_tree, opt_state, tree)
        tree = optax.apply_updates(tree, updates)
        for n, (a, b) in _NAMES.items():
            np.testing.assert_allclose(params[n].detach().numpy(),
                                       np.asarray(tree[a][b]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{n} step {step}")
    assert opt.count == 5
    with pytest.raises(ValueError, match="optimizer"):
        optimizer.build_optimizer(model, optimizer="sgd", **kw)


def _tiny_state():
    model = nn.Linear(3, 2)
    opt, _ = optimizer.build_optimizer(model, 1e-3, 4, 1, steps_per_epoch=2,
                                       epochs=2, warmup_epochs=1)
    return TrainState(model, opt)


@pytest.mark.parametrize("top_k,period", [(2, 1), (3, 2), (0, 1), (1, 3)])
def test_checkpoint_retention_matches(tmp_path, top_k, period):
    """The same monitored losses through both managers: the same epochs
    saved and kept, and the same index.json."""
    losses = [5.0, 3.0, 4.0, 2.0, 6.0, 1.0, 3.5]
    ref = jax_ckpt.CheckpointManager(str(tmp_path / "ref"), save_top_k=top_k,
                                     period=period)
    got = checkpoint.CheckpointManager(str(tmp_path / "got"),
                                       save_top_k=top_k, period=period)
    state = _tiny_state()
    for epoch, loss in enumerate(losses):
        metrics = {"checkpoint_saving_loss": loss, "loss": loss}
        assert got.save(epoch, state, metrics) == ref.save(
            epoch, {"w": np.full((2,), loss, np.float32)}, metrics)
        assert sorted(os.listdir(got.directory)) == sorted(
            os.listdir(ref.directory))
        if "index.json" in os.listdir(ref.directory):  # after a first save
            with open(os.path.join(got.directory, "index.json")) as a, \
                    open(os.path.join(ref.directory, "index.json")) as b:
                assert json.load(a) == json.load(b)
    assert got.latest_epoch() == ref.latest_epoch()
    kept = got.latest_epoch()
    assert got.resolve_epoch(f"epoch={kept}.ckpt") == kept
    with pytest.raises(FileNotFoundError, match="available epochs"):
        got.resolve_epoch("epoch_99")
    again = checkpoint.CheckpointManager(str(tmp_path / "got"),
                                         save_top_k=top_k, period=period)
    assert again._scores == got._scores  # the index is read back


def test_checkpoint_restores_model_optimizer_and_step(tmp_path):
    state = _tiny_state()
    state.model(torch.ones(1, 3)).sum().backward()
    state.optimizer.step()
    state.optimizer.step()
    state.step = 2
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    mgr.save(0, state, {"checkpoint_saving_loss": 1.0})
    fresh = _tiny_state()
    assert mgr.restore(fresh, epoch=None) == (fresh, 0)
    assert fresh.step == 2 and fresh.optimizer.count == 2
    for a, b in zip(fresh.model.state_dict().values(),
                    state.model.state_dict().values()):
        assert torch.equal(a, b)
    for p, q in zip(fresh.model.parameters(), state.model.parameters()):
        for key in ("mu", "nu"):
            assert torch.equal(fresh.optimizer.state[p][key],
                               state.optimizer.state[q][key])
    empty = checkpoint.CheckpointManager(str(tmp_path / "none"))
    assert empty.restore(_tiny_state()) == (None, None)


def test_save_experiment_key_matches(tmp_path):
    for mod, sub in ((checkpoint, "got"), (jax_ckpt, "ref")):
        mod.save_experiment_key(str(tmp_path / sub), "hybrid2_128", "abc", "k.csv")
        mod.save_experiment_key(str(tmp_path / sub), "run2", "def", "k.csv")
    with open(tmp_path / "got" / "k.csv") as a, open(tmp_path / "ref" / "k.csv") as b:
        assert a.read() == b.read()


# ---- the eval step --------------------------------------------------------

@pytest.mark.parametrize("experiment", ["hybrid2", "simclr"])
def test_eval_step_matches(experiment):
    """RN18, 64 -> 32, f32, eval-mode BatchNorm on the seeded running
    statistics: the loss within 1e-4 relative of the reference's eval step
    on the reference's draws (f32 convolutions summed in another order).
    The draws are the parameters of the reference's augment_pair under jit,
    as its jitted eval step draws them."""
    from peclr_tpu.config.defaults import AugmentationParams as JaxParams
    from peclr_tpu.config.defaults import peclr_pretrain_flags as jax_flags
    from peclr_tpu.models import PeCLRModel as JaxPeCLR
    from peclr_tpu.ops.augment import augment_pair as jax_augment_pair
    from peclr_tpu.train import step as jax_step
    from peclr_tpu.train.state import TrainState as JaxState
    from peclr_tpu_torch.config.defaults import (
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.data.synthetic import seeded_peclr_variables
    from peclr_tpu_torch.models import PeCLRModel
    from peclr_tpu_torch.models.port import peclr_variables_to_state_dict
    from peclr_tpu_torch.train.recipe import synthetic_pretrain_batch
    from peclr_tpu_torch.train.step import make_peclr_eval_step

    augmentations = () if experiment == "simclr" else None
    variables = seeded_peclr_variables("18", seed=1)
    batch = {k: v.numpy() for k, v in synthetic_pretrain_batch(
        6, canvas=64, seed=2, device="cpu").items()}
    jparams = JaxParams(resize_shape=(32, 32))
    model = JaxPeCLR(resnet_size="18", dtype=jnp.float32)
    jstate = JaxState.create(jax.tree_util.tree_map(jnp.asarray, variables),
                             optax.identity())
    ref_step = jax_step.make_peclr_eval_step(model, jax_flags(), jparams,
                                             augmentations=augmentations)

    port = PeCLRModel("18")
    port.load_state_dict(peclr_variables_to_state_dict(variables, "18"),
                         strict=True)
    opt, _ = optimizer.build_optimizer(port, 1e-4, 6, 1, 4, 2)
    step = make_peclr_eval_step(port, peclr_pretrain_flags(),
                                AugmentationParams(resize_shape=(32, 32)),
                                augmentations=augmentations)
    draw = jax.jit(lambda k, im, jt: tuple(v.params for v in jax_augment_pair(
        k, im, jt, jax_flags(), jparams)))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    for seed in (3, 4):
        key = jax.random.PRNGKey(seed)
        p1, p2 = draw(key, batch["image"], batch["joints25d"])
        draws = {k: torch.from_numpy(np.concatenate(
            [np.asarray(p1[k]), np.asarray(p2[k])])) for k in p1}
        ref = float(ref_step(jstate, batch, key)["loss"])
        got = step(TrainState(port, opt),
                   {k: torch.from_numpy(v) for k, v in batch.items()}, None,
                   draws=draws)["loss"]
        assert np.isfinite(ref)
        np.testing.assert_allclose(got.item(), ref, rtol=1e-4)
    for k, v in port.state_dict().items():  # eval mode: nothing updated
        assert torch.equal(v, before[k]), k
