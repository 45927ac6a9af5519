"""The port's data parallelism (peclr_tpu_torch/parallel/) on the CPU, two
gloo ranks in spawned processes against one process.

  * shard_batch's microbatch-interleaved rows, local_batch_size's assertion,
    make_mesh refusing a model axis and more NCCL ranks than cards, and the
    host pipeline decoding only a rank's rows;
  * the collectives' forward and backward against the one-process values:
    the gather is exact, and each backward is the gradient of the sum of
    the ranks' losses;
  * two pretrain steps at the dry-run shape (RN18, 64 -> 32 canvases, accum
    2, a global microbatch of 4, so 2 rows a rank) on two ranks against the
    same steps in one process, from the same weights and draws.  Tolerances:
    loss 1e-5 relative, gradients 1e-4 of each parameter's norm (the head's
    first bias feeds a BatchNorm, so its gradient is rounding noise, held to
    1e-6 of the largest norm), BatchNorm running statistics 1e-5 of each
    tensor's scale: the same f32 arithmetic summed in another order
    (per-rank sums, then the all-reduce; flax's E[x²] - E[x]² against
    torch's fused statistics).  Both ranks' states are equal to the bit.
    The same step with each rank's BatchNorm statistics its own misses
    those bounds: its ranks' running means differ from the global ones by
    more than 1e-2 of their scale.

The worker functions here are what the spawned ranks run (tests/
test_torch_parallel_step.py and test_torch_parallel_cli.py use them too);
this file imports neither JAX nor the reference, so the ranks start fast.
"""

import os
import time

import numpy as np
import pytest
import torch

from peclr_tpu_torch.config.defaults import (
    AugmentationParams,
    peclr_pretrain_flags,
)
from peclr_tpu_torch.data.synthetic import seeded_peclr_variables
from peclr_tpu_torch.models import PeCLRModel
from peclr_tpu_torch.models.batchnorm import set_mesh
from peclr_tpu_torch.models.port import peclr_variables_to_state_dict
from peclr_tpu_torch.ops import augment
from peclr_tpu_torch.parallel import collectives
from peclr_tpu_torch.parallel.dryrun import spawn
from peclr_tpu_torch.parallel.mesh import (
    Mesh,
    local_rows,
    make_mesh,
    shard_batch,
)
from peclr_tpu_torch.parallel.multihost import local_batch_size
from peclr_tpu_torch.train.optimizer import build_optimizer
from peclr_tpu_torch.train.recipe import synthetic_pretrain_batch
from peclr_tpu_torch.train.state import TrainState
from peclr_tpu_torch.train.step import make_peclr_train_step

WORLD = 2
MB, ACCUM, CANVAS, VIEW = 4, 2, 64, 32
OPT = dict(base_lr=1e-4, batch_size=MB, accum=ACCUM, steps_per_epoch=4,
           epochs=2, warmup_epochs=1)
#: a hung collective fails the test instead of stalling the suite
TIMEOUT_S = 240.0


def _fake_mesh(rank, size=WORLD):
    return Mesh(None, rank, size, torch.device("cpu"), "gloo")


# --------------------------------------------------------------------------
# what the spawned ranks run


def _collectives_rank(mesh, xs, ws):
    """The rank's x through all_gather and all_reduce_sum, each into a loss
    weighted by the rank's own w; returns the outputs and x's gradients."""
    out = {}
    for name, fn in (("gather", collectives.all_gather),
                     ("reduce", collectives.all_reduce_sum)):
        x = torch.from_numpy(xs[mesh.rank]).requires_grad_(True)
        y = fn(x, mesh)
        (y * torch.from_numpy(ws[name][mesh.rank])).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    return out


def _batchnorm_rank(mesh, x, dy, devices):
    """One BatchNorm2d across the ranks on each of `devices`, on this rank's
    rows of x (channels last, as the model's activations): its output, the
    gradients of Σ y·dy and the running statistics, as numpy."""
    from peclr_tpu_torch.models.batchnorm import BatchNorm2d

    rows = torch.from_numpy(local_rows(mesh, len(x)))
    out = {}
    for dev in devices:
        bn = BatchNorm2d(x.shape[1]).to(dev)
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, x.shape[1]))
            bn.bias.copy_(torch.linspace(-0.2, 0.2, x.shape[1]))
        set_mesh(bn, mesh)
        xr = torch.from_numpy(x)[rows].to(dev).to(
            memory_format=torch.channels_last).requires_grad_(True)
        y = bn(xr)
        (y * torch.from_numpy(dy)[rows].to(dev)).sum().backward()
        out[dev] = {k: v.detach().cpu().numpy() for k, v in (
            ("y", y), ("dx", xr.grad), ("dw", bn.weight.grad),
            ("db", bn.bias.grad), ("mean", bn.running_mean),
            ("var", bn.running_var))}
    return out


def batchnorm_inputs(n=6, c=5, hw=7, seed=2):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, c, hw, hw)) * 3 + 1).astype(np.float32)
    return x, rng.normal(size=x.shape).astype(np.float32)


def check_batchnorm_ranks(ranks, x, dy, device, rtol):
    """Each rank's BatchNorm against torch's on the whole batch in one
    process: its rows of y and dx, the ranks' summed weight and bias
    gradients, the running statistics (flax's: momentum 0.1, biased)."""
    xt = torch.from_numpy(x).requires_grad_(True)
    w = torch.linspace(0.5, 1.5, x.shape[1]).requires_grad_(True)
    b = torch.linspace(-0.2, 0.2, x.shape[1]).requires_grad_(True)
    y = torch.nn.functional.batch_norm(xt, None, None, w, b, True, 0.0, 1e-5)
    (y * torch.from_numpy(dy)).sum().backward()
    ref = {"y": y.detach().numpy(), "dx": xt.grad.numpy()}
    mean = x.mean(axis=(0, 2, 3))
    var = x.var(axis=(0, 2, 3))

    def close(got, want, what):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                                   err_msg=what)

    for r, out in enumerate(ranks):
        rows = local_rows(_fake_mesh(r), len(x))
        got = out[device]
        close(got["y"], ref["y"][rows], f"rank {r} y")
        close(got["dx"], ref["dx"][rows], f"rank {r} dx")
        close(got["mean"], 0.1 * mean, f"rank {r} running mean")
        close(got["var"], 0.9 + 0.1 * var, f"rank {r} running var")
    close(sum(out[device]["dw"] for out in ranks), w.grad.numpy(), "dw")
    close(sum(out[device]["db"] for out in ranks), b.grad.numpy(), "db")


def pretrain_model():
    model = PeCLRModel("18")
    model.load_state_dict(peclr_variables_to_state_dict(
        seeded_peclr_variables("18", seed=0), "18"), strict=True)
    return model


def pretrain_batch():
    return {k: v.numpy() for k, v in synthetic_pretrain_batch(
        MB * ACCUM, canvas=CANVAS, seed=0, device="cpu").items()}


def run_pretrain_steps(steps_draws, mesh=None, local_stats=False):
    """Pretrain steps at the dry-run shape (module docstring) from the
    seeded RN18, each fed its draws (accum dicts of global 2B parameters as
    numpy); with a mesh, on this rank's rows.  Returns each step's loss,
    projection statistics, gradients and state dict, as numpy."""
    torch.manual_seed(0)
    model = pretrain_model()
    opt, _ = build_optimizer(model, **OPT)
    state = TrainState(model, opt)
    step = make_peclr_train_step(
        model, opt, peclr_pretrain_flags(),
        AugmentationParams(resize_shape=(VIEW, VIEW)), accum=ACCUM,
        mesh=mesh)
    if local_stats:
        set_mesh(model, None)
    batch = pretrain_batch()
    if mesh is not None:
        batch = shard_batch(mesh, batch, ACCUM)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for draws in steps_draws:
        state, metrics = step(state, batch, None, draws=[
            {k: torch.from_numpy(v) for k, v in d.items()} for d in draws])
        out.append(dict(
            loss=metrics["loss"].item(),
            metrics={k: v.item() for k, v in metrics.items()},
            grads={n: p.grad.numpy().copy()
                   for n, p in model.named_parameters()},
            state={k: v.detach().numpy().copy()
                   for k, v in model.state_dict().items()},
            step=state.step, count=opt.count))
    return out


def _pretrain_rank(mesh, steps_draws):
    return run_pretrain_steps(steps_draws, mesh)


def _steps_and_local_rank(mesh, steps_draws):
    """Two steps across the ranks, then, from the same start, the first
    step with each rank's BatchNorm statistics its own."""
    return (run_pretrain_steps(steps_draws, mesh),
            run_pretrain_steps(steps_draws[:1], mesh, local_stats=True))


def seeded_draws(steps=2, seed=11):
    gen = torch.Generator().manual_seed(seed)
    flags = peclr_pretrain_flags()
    params = AugmentationParams(resize_shape=(VIEW, VIEW))
    return [[{k: v.numpy() for k, v in augment.draw(
        gen, 2 * MB, flags, params).items()} for _ in range(ACCUM)]
        for _ in range(steps)]


# --------------------------------------------------------------------------
# checks


def assert_ranks_bit_equal(per_rank):
    """Every rank's state dict after every step equal to the bit."""
    for s, first in enumerate(per_rank[0]):
        for other in per_rank[1:]:
            for key, value in first["state"].items():
                np.testing.assert_array_equal(other[s]["state"][key], value,
                                              err_msg=f"step {s} {key}")


def bn_stat_errors(got, ref):
    """Worst error of each running statistic, over its scale."""
    return {k: np.abs(got[k] - r).max() / (np.abs(r).max() + 1e-12)
            for k, r in ref.items() if "running" in k}


def check_against_one_process(got, ref, loss_rtol, grad_rtol, stat_rtol):
    """The ranks' steps (got) against one process's (ref)."""
    for s, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g["loss"], r["loss"], rtol=loss_rtol,
                                   err_msg=f"step {s}")
        largest = max(np.linalg.norm(v) for v in r["grads"].values())
        for name, rg in r["grads"].items():
            err = np.linalg.norm(g["grads"][name] - rg)
            assert err <= grad_rtol * np.linalg.norm(rg) + 1e-6 * largest, (
                s, name, err, np.linalg.norm(rg))
        worst = bn_stat_errors(g["state"], r["state"])
        assert max(worst.values()) <= stat_rtol, (
            s, max(worst, key=worst.get), max(worst.values()))
        scale = max(abs(v) for v in r["metrics"].values())
        for key, value in r["metrics"].items():
            np.testing.assert_allclose(g["metrics"][key], value, rtol=0,
                                       atol=loss_rtol * scale, err_msg=key)


# --------------------------------------------------------------------------
# (i) layout and refusals


def test_shard_batch_interleaves_microbatches():
    """Rank r's microbatch k is rows [k·B + r·B/W, k·B + (r+1)·B/W)."""
    n, accum = 12, 3
    assert local_rows(_fake_mesh(0), n, accum).tolist() == [0, 1, 4, 5, 8, 9]
    assert local_rows(_fake_mesh(1), n, accum).tolist() == [2, 3, 6, 7, 10, 11]
    rng = np.random.default_rng(0)
    batch = {"image": rng.integers(0, 256, (n, 5, 5, 3), dtype=np.uint8),
             "joints25d": rng.normal(size=(n, 21, 3)).astype(np.float32)}
    parts = [shard_batch(_fake_mesh(r), batch, accum) for r in range(WORLD)]
    for key, value in batch.items():
        blocks = value.reshape(accum, WORLD, -1, *value.shape[1:])
        for r, part in enumerate(parts):
            np.testing.assert_array_equal(
                part[key], blocks[:, r].reshape(-1, *value.shape[1:]))
            on_torch = shard_batch(_fake_mesh(r), {key: torch.from_numpy(
                value)}, accum)[key]
            np.testing.assert_array_equal(on_torch.numpy(), part[key])
    with pytest.raises(ValueError, match="whole number"):
        shard_batch(_fake_mesh(0, size=3), batch, accum)
    with pytest.raises(ValueError, match="microbatches"):
        local_rows(_fake_mesh(0), 13, accum)


def test_local_batch_size_keeps_the_reference_assertion():
    assert local_batch_size(128, _fake_mesh(1)) == 64
    with pytest.raises(AssertionError) as err:
        local_batch_size(127, _fake_mesh(0))
    assert err.value.args == ((127, 2),)


def test_make_mesh_refuses_a_model_axis():
    with pytest.raises(ValueError, match="no model axis"):
        make_mesh(data=1, model=2, device="cpu")


@pytest.mark.parametrize("cards", [0, 1])
def test_make_mesh_refuses_more_nccl_ranks_than_cards(monkeypatch, cards):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    for key, value in (("WORLD_SIZE", "2"), ("RANK", "0"),
                       ("LOCAL_RANK", "0"), ("LOCAL_WORLD_SIZE", "2")):
        monkeypatch.setenv(key, value)
    with pytest.raises(ValueError, match="Duplicate GPU"):
        make_mesh(backend="nccl")
    with pytest.raises(ValueError, match="Duplicate GPU"):
        make_mesh(device="cuda:0", backend="nccl")


def test_host_pipeline_decodes_only_the_rank_rows():
    """Each rank's batch is its rows of the one-process batch, and it
    decodes no other."""
    import os

    from peclr_tpu_torch.data import pipeline
    from peclr_tpu_torch.data.freihand import FreihandSource

    root = os.path.join(os.path.dirname(__file__), "fixtures",
                        "torch_freihand_like", "freihand_dataset")

    def batches(mesh=None):
        src = FreihandSource(root, "train", seed=5, train_ratio=0.75)
        pipe = pipeline.HostPipeline([src], batch_size=8, canvas=224, seed=5,
                                     num_threads=2, mesh=mesh, accum=2)
        return list(pipe.batches(2, epoch=1)), pipe

    whole, _ = batches()
    for r in range(WORLD):
        mesh = _fake_mesh(r)
        got, pipe = batches(mesh)
        for g, w in zip(got, whole):
            want = shard_batch(mesh, w, accum=2)
            assert set(g) == set(w)
            for key in w:
                np.testing.assert_array_equal(g[key], want[key], err_msg=key)
        assert len(got[0]["image"]) == 4
        prefetched = list(pipeline.device_prefetch(iter(got), mesh=mesh))
        for p, g in zip(prefetched, got):
            np.testing.assert_array_equal(p["image"].numpy(), g["image"])


# --------------------------------------------------------------------------
# (ii) the collectives


def test_spawn_defaults_to_the_card(monkeypatch):
    """spawn with no device asks for the card (device.py:resolve_device):
    without one it raises before it starts any process."""
    import multiprocessing

    started = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(multiprocessing, "get_context",
                        lambda *a, **k: started.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn(_collectives_rank, WORLD, args=([], {}))
    assert started == []


def _dead_rank(mesh):
    os._exit(3)


def test_spawn_fails_fast_when_a_rank_dies():
    """A rank that exits without a result (killed, or failed to start)
    fails spawn at once, not at its timeout."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"exited with codes \[3, 3\]"):
        spawn(_dead_rank, WORLD, device="cpu", timeout=TIMEOUT_S)
    assert time.monotonic() - t0 < 60.0


def test_collectives_match_one_process():
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(3, 4)).astype(np.float32) for _ in range(WORLD)]
    ws = {"gather": [rng.normal(size=(3 * WORLD, 4)).astype(np.float32)
                     for _ in range(WORLD)],
          "reduce": [rng.normal(size=(3, 4)).astype(np.float32)
                     for _ in range(WORLD)]}
    got = spawn(_collectives_rank, WORLD, args=(xs, ws), device="cpu",
                timeout=TIMEOUT_S)
    gathered = np.concatenate(xs)
    summed = np.sum(xs, axis=0, dtype=np.float32)
    w_gather, w_reduce = sum(ws["gather"]), sum(ws["reduce"])
    for r, out in enumerate(got):
        y, dx = out["gather"]
        np.testing.assert_array_equal(y, gathered)  # exact: x + 0 is x
        np.testing.assert_allclose(dx, w_gather[3 * r:3 * (r + 1)],
                                   rtol=1e-6, atol=1e-6)
        y, dx = out["reduce"]
        np.testing.assert_allclose(y, summed, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(dx, w_reduce, rtol=1e-6, atol=1e-6)


def test_batchnorm_across_ranks_matches_the_whole_batch():
    x, dy = batchnorm_inputs()
    ranks = spawn(_batchnorm_rank, WORLD, args=(x, dy, ("cpu",)),
                  device="cpu", timeout=TIMEOUT_S)
    check_batchnorm_ranks(ranks, x, dy, "cpu", rtol=1e-5)


# --------------------------------------------------------------------------
# (iv) two ranks against one process


@pytest.fixture(scope="module")
def runs():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        draws = seeded_draws()
        ranks = spawn(_steps_and_local_rank, WORLD, args=(draws,),
                      device="cpu", timeout=TIMEOUT_S)
        return ([r[0] for r in ranks], [r[1] for r in ranks],
                run_pretrain_steps(draws))
    finally:
        torch.set_num_threads(threads)


def test_two_ranks_are_bit_equal(runs):
    ranks, local, _ = runs
    assert_ranks_bit_equal(ranks)
    assert ranks[0][1]["loss"] == ranks[1][1]["loss"]


@pytest.mark.parametrize("s", [0, 1])
def test_two_ranks_match_one_process(runs, s):
    ranks, _, one = runs
    check_against_one_process(ranks[0][s:s + 1], one[s:s + 1],
                              loss_rtol=1e-5, grad_rtol=1e-4, stat_rtol=1e-5)
    assert ranks[0][s]["step"] == ranks[0][s]["count"] == s + 1


def test_two_ranks_update_as_one_process(runs):
    """Step 1 runs at lr 0 and moves nothing; step 2 moves each element by
    about lr (Adam's normalised update), so the ranks' parameters agree
    with one process's to one lr an element."""
    ranks, _, one = runs
    initial = pretrain_model().state_dict()
    lr_step2 = OPT["base_lr"] * np.sqrt(MB * ACCUM) * 0.5  # half the peak
    for s in range(2):
        for name, ref in one[s]["state"].items():
            if "running" in name or "num_batches" in name:
                continue
            got = ranks[0][s]["state"][name]
            if s == 0:
                np.testing.assert_array_equal(got, initial[name].numpy(),
                                              err_msg=name)
            np.testing.assert_allclose(got, ref, rtol=0, atol=lr_step2,
                                       err_msg=f"{name} step {s + 1}")


def test_local_statistics_would_miss(runs):
    """With each rank's BatchNorm statistics its own, the first step's
    running means differ from the global ones by more than 1e-2 of their
    scale, on both ranks, and the step misses the bounds above."""
    ranks, local, one = runs
    for r in range(WORLD):
        means = {k: v for k, v in bn_stat_errors(
            local[r][0]["state"], ranks[r][0]["state"]).items()
            if k.endswith("running_mean")}
        assert max(means.values()) > 1e-2, (r, max(means.values()))
        with pytest.raises(AssertionError):
            check_against_one_process(local[r], one[:1], loss_rtol=1e-5,
                                      grad_rtol=1e-4, stat_rtol=1e-5)
