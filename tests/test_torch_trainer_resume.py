"""The port's trainer on the CPU: interrupting at an epoch boundary and
resuming is bit-equal to training straight through, with the recipe's
flags and with all ten augmentation flags the CLI takes; the projection
statistics run only on logged steps; `experiment_type="simclr"` drops the
inverse transforms; and the pretraining CLI runs end to end."""

import json
import os

import numpy as np
import pytest
import torch

from peclr_tpu_torch import constants
from peclr_tpu_torch.config.defaults import (
    AugmentationFlags,
    AugmentationParams,
    ModelConfig,
    TrainConfig,
    peclr_pretrain_flags,
)
from peclr_tpu_torch.data.freihand import FreihandSource
from peclr_tpu_torch.data.pipeline import HostPipeline
from peclr_tpu_torch.data.synthetic import generate_freihand_like
from peclr_tpu_torch.train import loop


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These small models run as fast on one CPU thread as on many, and one
    thread keeps them fast beside the other test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fh_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("freihand_resume")
    return generate_freihand_like(str(root), num_unique=16, seed=3)


@pytest.fixture
def paths(tmp_path, monkeypatch):
    monkeypatch.setattr(constants, "SAVED_META_INFO_PATH", str(tmp_path / "meta"))
    monkeypatch.setattr(constants, "SAVED_MODELS_BASE_PATH",
                        str(tmp_path / "models"))
    return tmp_path


#: every augmentation flag the CLI takes but flip (a no-op)
ALL_FLAGS = ("--rotate", "--crop", "--color_jitter", "--resize",
             "--random_crop", "--sobel_filter", "--cut_out",
             "--gaussian_blur", "--gaussian_noise", "--color_drop")


def _all_flags():
    return AugmentationFlags(**{f[2:]: True for f in ALL_FLAGS})


def _cfgs(flags=None, **model_kw):
    augmentation = (("crop", "rotate", "color_jitter", "resize")
                    if flags is None else tuple(flags.active()))
    train_cfg = TrainConfig(
        batch_size=8, accumulate_grad_batches=2, epochs=3, seed=5,
        precision="f32", augmentation_flags=flags or peclr_pretrain_flags(),
        augmentation_params=AugmentationParams(resize_shape=(32, 32)),
    )
    model_cfg = ModelConfig(resnet_size="18", lr=5e-4, warmup_epochs=1,
                            augmentation=augmentation, **model_kw)
    return train_cfg, model_cfg


def _trainer(fh_root, workdir, flags=None, **kw):
    src = FreihandSource(fh_root, "train", seed=5, train_ratio=0.75)
    pipe = HostPipeline([src], batch_size=16, canvas=64, seed=5,
                        num_threads=2)
    model_kw = kw.pop("model_kw", {})
    return loop.PeCLRTrainer(*_cfgs(flags, **model_kw), pipe, device="cpu",
                             workdir=str(workdir), log_images=False, **kw)


def test_stream_seed_formula():
    import numpy as np

    assert loop.stream_seed(5, 7) == int(
        np.random.SeedSequence((5, 7)).generate_state(1, np.uint64)[0])
    assert len({loop.stream_seed(a, b) for a in range(4) for b in range(4)}) == 16


def _check_resume(fh_root, paths, flags=None):
    """3 epochs straight against 1 epoch, a new trainer auto-resumed, 2 more:
    every tensor of the model's and the optimizer's state is bit-equal,
    and so are the step and the logged epoch losses."""
    full = _trainer(fh_root, paths / "full", flags,
                    experiment_name="traj_full", auto_resume=False)
    assert full.steps_per_epoch == 3  # 48 samples, 16 a step (8 x 2)
    full.fit(epochs=3)

    work = paths / "interrupted"
    first = _trainer(fh_root, work, flags, experiment_name="traj_a")
    first.fit(epochs=1)
    resumed = _trainer(fh_root, work, flags, experiment_name="traj_b")
    assert resumed.start_epoch == 1
    resumed.fit(epochs=3)

    assert resumed.state.step == full.state.step == 9
    got, want = resumed.model.state_dict(), full.model.state_dict()
    assert len(want) > 10
    for k in want:
        assert torch.equal(got[k], want[k]), k
    got_opt, want_opt = (resumed.state.optimizer.state_dict(),
                         full.state.optimizer.state_dict())
    assert got_opt["count"] == want_opt["count"] == 9
    for idx, state in want_opt["state"].items():
        for key in ("mu", "nu"):
            assert torch.equal(got_opt["state"][idx][key], state[key]), idx

    def losses(trainer):
        with open(os.path.join(trainer.tracker.dir, "metrics.jsonl")) as f:
            return {r["epoch"]: r["loss"] for r in map(json.loads, f)
                    if r["context"] == "train"}

    assert losses(resumed) == {e: losses(full)[e] for e in (1, 2)}
    assert losses(first)[0] == losses(full)[0]


def test_resume_trajectory_equivalence(fh_root, paths):
    _check_resume(fh_root, paths)


def test_resume_trajectory_equivalence_all_flags(fh_root, paths):
    """The same with every flag on: the draws of the flags outside the
    recipe come from the same per-step generator, after the recipe's."""
    _check_resume(fh_root, paths, _all_flags())


def test_stats_gated_on_log_cadence(fh_root, paths):
    """The hot path runs without the projection statistics; the variant
    with them runs on the first step of each epoch (epoch cadence) or on
    every step (step cadence)."""
    for cadence, want in (("epoch", ["stats", "hot", "hot", "stats", "hot",
                                     "hot"]), ("step", ["stats"] * 6)):
        trainer = _trainer(fh_root, paths / cadence, log_interval=cadence,
                           auto_resume=False)
        calls = []
        hot, stats = trainer.train_step, trainer._train_step_stats
        trainer.train_step = lambda *a: calls.append("hot") or hot(*a)
        trainer._train_step_stats = lambda *a: calls.append("stats") or stats(*a)
        trainer.fit(epochs=2)
        assert calls == want, (cadence, calls)
        with open(os.path.join(trainer.tracker.dir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        per_step = [r for r in records if r["step"] is not None]
        assert len(per_step) == (6 if cadence == "step" else 0)
        assert all("proj2y_max" in r for r in per_step)
        epoch_rec = [r for r in records if r["step"] is None]
        assert all("proj1x_mean" in r for r in epoch_rec)
    metrics = hot(trainer.state,
                  {k: torch.from_numpy(v) for k, v in
                   next(iter(trainer.pipeline.batches(1))).items()},
                  torch.Generator().manual_seed(0))[1]
    assert set(metrics) == {"loss"}


def test_simclr_drops_the_inverse_transforms(fh_root, paths, monkeypatch):
    seen = []
    real = loop.make_peclr_train_step

    def spy(*args, **kw):
        seen.append(kw["augmentations"])
        return real(*args, **kw)

    monkeypatch.setattr(loop, "make_peclr_train_step", spy)
    _trainer(fh_root, paths / "s", model_kw={"experiment_type": "simclr"},
             auto_resume=False)
    _trainer(fh_root, paths / "h", auto_resume=False)
    recipe = ("crop", "rotate", "color_jitter", "resize")
    assert seen == [(), (), recipe, recipe]  # the hot and the stats step


def test_train_cli_on_the_cpu(fh_root, paths, monkeypatch):
    """The CLI smoke of the verify skill, `-optimizer adam`, on the CPU:
    the experiment is tracked, checkpoints written, and a named restore by
    experiment key replays epoch 1 from epoch 0's checkpoint."""
    from peclr_tpu_torch.cli import train as cli

    monkeypatch.setattr(constants, "FREIHAND_DATA", fh_root)
    argv = ["--rotate", "--crop", "--color_jitter", "--resize",
            "-batch_size", "8", "-epochs", "2", "-resnet_size", "18",
            "-train_ratio", "0.75", "-sources", "freihand", "-optimizer",
            "adam", "-canvas", "64", "-view_size", "32", "-num_workers", "2",
            "-save_top_k", "2", "--device", "cpu"]
    trainer = cli.main(argv)
    assert trainer.model_cfg.optimizer == "adam"
    assert not trainer.state.optimizer.lars
    assert trainer.state.step == 2 * 6  # 48 samples, 8 a step
    with open(os.path.join(trainer.tracker.dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["context"] for r in records] == ["train", "val"] * 2
    key = trainer.tracker.experiment_key
    saved = os.listdir(os.path.join(str(paths / "models"), key, "checkpoints"))
    assert sorted(saved) == ["epoch_0", "epoch_1", "index.json"]

    replay = cli.main(argv + ["-experiment_key", key, "-checkpoint", "epoch_0"])
    assert replay.start_epoch == 1 and replay.state.step == 2 * 6
    with open(os.path.join(replay.tracker.dir, "metrics.jsonl")) as f:
        again = [json.loads(line) for line in f]
    assert again[0]["epoch"] == 1
    assert again[0]["loss"] == records[2]["loss"]  # epoch 1, bit for bit
    with pytest.raises(SystemExit, match="experiment_key"):
        cli.main(argv + ["-checkpoint", "epoch_0"])


def test_train_cli_with_every_flag_on_the_cpu(fh_root, paths, monkeypatch):
    """The CLI with all ten flags for an epoch: the flags in the configs,
    finite training and validation losses."""
    from peclr_tpu_torch.cli import train as cli

    monkeypatch.setattr(constants, "FREIHAND_DATA", fh_root)
    argv = list(ALL_FLAGS) + [
        "-batch_size", "8", "-epochs", "1", "-resnet_size", "18",
        "-train_ratio", "0.75", "-sources", "freihand", "-optimizer", "adam",
        "-canvas", "64", "-view_size", "32", "-num_workers", "2",
        "--device", "cpu"]
    trainer = cli.main(argv)
    assert trainer.train_cfg.augmentation_flags == _all_flags()
    assert set(trainer.model_cfg.augmentation) == {f[2:] for f in ALL_FLAGS}
    with open(os.path.join(trainer.tracker.dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["context"] for r in records] == ["train", "val"]
    assert all(np.isfinite(r["loss"]) for r in records)
