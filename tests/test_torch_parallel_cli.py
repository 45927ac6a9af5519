"""The pretraining CLI on two gloo ranks on the CPU, over the committed
FreiHAND-layout fixture (RN18, a global microbatch of 8 over 3
microbatches, 64² canvases to 32² views, LARS, one step an epoch), and the
multi-process dry run.

  * rank 0 alone writes the checkpoints and the tracker's files; both ranks
    end equal to the bit;
  * a run stopped after epoch 0 and resumed by experiment key equals the
    run straight through to the bit (gloo's CPU sums run in a fixed order,
    so the resumed epoch repeats the straight one's arithmetic);
  * the two-rank run equals the one-process CLI within
    tests/test_torch_parallel.py's bounds: epoch losses 1e-5 relative,
    BatchNorm running statistics 1e-5 of their scale; its parameters
    within two lr an element of each update: Adam's first normalised update
    is ±lr an element, and where a gradient is near 0 the gradient's digits
    do not fix its sign;
  * dryrun_multichip(2) on the CPU.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from peclr_tpu_torch import constants
from peclr_tpu_torch.parallel.dryrun import dryrun_multichip, spawn
from tests.test_torch_parallel import TIMEOUT_S, WORLD, bn_stat_errors

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_freihand_like", "freihand_dataset")
ARGV = ["--rotate", "--crop", "--color_jitter", "--resize",
        "-batch_size", "8", "-accumulate_grad_batches", "3",
        "-resnet_size", "18", "-train_ratio", "0.75", "-sources", "freihand",
        "-optimizer", "LARS", "-canvas", "64", "-view_size", "32",
        "-num_workers", "2", "-save_top_k", "2", "--device", "cpu"]


def _point_constants(root):
    constants.FREIHAND_DATA = FIXTURE
    constants.SAVED_MODELS_BASE_PATH = os.path.join(root, "models")
    constants.SAVED_META_INFO_PATH = os.path.join(root, "meta")


def _state(trainer):
    return {k: v.detach().numpy().copy()
            for k, v in trainer.model.state_dict().items()}


def _digest(state):
    h = hashlib.sha256()
    for key in sorted(state):
        h.update(key.encode())
        h.update(np.ascontiguousarray(state[key]).tobytes())
    return h.hexdigest()


def _records(trainer):
    with open(os.path.join(trainer.tracker.dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _cli_rank(mesh, root):
    """The CLI as a launcher starts it on this rank: straight through two
    epochs, then one epoch and a resume to two by experiment key."""
    from peclr_tpu_torch.cli import train as cli
    from peclr_tpu_torch.train import checkpoint

    os.environ.update(WORLD_SIZE=str(mesh.size), RANK=str(mesh.rank),
                      LOCAL_RANK=str(mesh.rank),
                      LOCAL_WORLD_SIZE=str(mesh.size))
    _point_constants(root)
    writes = []
    save = checkpoint.CheckpointManager.save

    def counted(self, *args, **kwargs):
        wrote = save(self, *args, **kwargs)
        writes.append(wrote)
        return wrote

    checkpoint.CheckpointManager.save = counted
    straight = cli.main(ARGV + ["-epochs", "2"])
    first = cli.main(ARGV + ["-epochs", "1"])
    resumed = cli.main(ARGV + ["-epochs", "2", "-experiment_key",
                               first.tracker.experiment_key])
    out = {"writes": writes, "start_epoch": resumed.start_epoch,
           "steps": resumed.state.step,
           "digests": [_digest(_state(t)) for t in (straight, resumed)],
           "keys": [t.tracker.experiment_key for t in (straight, first)]}
    if mesh.rank == 0:
        out.update(state=_state(straight), records=_records(straight),
                   resumed_records=_records(resumed))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("parallel_cli"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ranks = spawn(_cli_rank, WORLD, args=(root,), device="cpu",
                      timeout=TIMEOUT_S)
        from peclr_tpu_torch.cli import train as cli

        one_root = str(tmp_path_factory.mktemp("one_process_cli"))
        patch = pytest.MonkeyPatch()
        try:
            for name in ("FREIHAND_DATA", "SAVED_MODELS_BASE_PATH",
                         "SAVED_META_INFO_PATH"):
                patch.setattr(constants, name, getattr(constants, name))
            patch.delenv("WORLD_SIZE", raising=False)
            _point_constants(one_root)
            one = cli.main(ARGV + ["-epochs", "2"])
        finally:
            patch.undo()
    finally:
        torch.set_num_threads(threads)
    return root, ranks, one


def test_rank_zero_alone_writes(runs):
    root, ranks, _ = runs
    # two epochs, one, then one more: rank 0 writes each, rank 1 none
    assert ranks[0]["writes"] == [True] * 4
    assert ranks[1]["writes"] == [False] * 4
    assert ranks[0]["keys"] == ranks[1]["keys"]
    # three runs tracked, each once
    assert len(os.listdir(os.path.join(root, "meta"))) == 3
    assert [r["context"] for r in ranks[0]["records"]] == ["train", "val"] * 2
    assert ranks[0]["digests"] == ranks[1]["digests"]


def test_resume_equals_straight_run(runs):
    _, ranks, _ = runs
    for rank in ranks:
        assert rank["start_epoch"] == 1 and rank["steps"] == 2
        straight, resumed = rank["digests"]
        assert straight == resumed
    straight = ranks[0]["records"]
    resumed = ranks[0]["resumed_records"]
    assert resumed[0]["epoch"] == 1
    assert resumed[0]["loss"] == straight[2]["loss"]


def test_two_ranks_match_one_process(runs):
    _, ranks, one = runs
    got = ranks[0]["records"]
    want = _records(one)
    assert [(r["context"], r["epoch"]) for r in got] == [
        (r["context"], r["epoch"]) for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        assert g.get("steps") == w.get("steps")
    ref = _state(one)
    worst = bn_stat_errors(ranks[0]["state"], ref)
    assert max(worst.values()) <= 1e-5, max(worst.items(), key=lambda kv: kv[1])
    lr = sum(one.schedule(c) for c in range(one.state.optimizer.count))
    for name, value in ref.items():
        if "running" not in name and "num_batches" not in name:
            np.testing.assert_allclose(ranks[0]["state"][name], value, rtol=0,
                                       atol=2 * lr + 1e-7, err_msg=name)


def test_dryrun_multichip_on_the_cpu(capsys):
    loss = dryrun_multichip(WORLD, device="cpu")
    assert np.isfinite(loss)
    assert f"dryrun_multichip({WORLD}): loss={loss:.4f} OK" in (
        capsys.readouterr().out)
