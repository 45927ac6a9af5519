"""The port's trainer end to end on the CPU (the cases of
tests/test_end_to_end.py): a FreiHAND-layout dataset on disk -> HostPipeline
-> device_prefetch -> PeCLRTrainer.fit (RN18, canvas 64 -> 32 views) ->
the loss falls, top-k checkpoints, auto-resume and named restore."""

import json
import os

import pytest
import torch

from peclr_tpu_torch import constants
from peclr_tpu_torch.config.defaults import (
    AugmentationParams,
    ModelConfig,
    TrainConfig,
    peclr_pretrain_flags,
)
from peclr_tpu_torch.data.freihand import FreihandSource
from peclr_tpu_torch.data.pipeline import HostPipeline
from peclr_tpu_torch.data.synthetic import generate_freihand_like
from peclr_tpu_torch.train.loop import PeCLRTrainer


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
    root = tmp_path_factory.mktemp("freihand_trainer")
    return generate_freihand_like(str(root), num_unique=32, seed=3)


@pytest.fixture
def cfgs():
    train_cfg = TrainConfig(
        batch_size=16, accumulate_grad_batches=1, epochs=3, seed=5,
        precision="f32", augmentation_flags=peclr_pretrain_flags(),
        augmentation_params=AugmentationParams(resize_shape=(32, 32)),
    )
    model_cfg = ModelConfig(
        resnet_size="18", projection_head_input_dim=512, lr=5e-4,
        warmup_epochs=1, optimizer="LARS",
        augmentation=("crop", "rotate", "color_jitter", "resize"),
    )
    return train_cfg, model_cfg


@pytest.fixture
def paths(tmp_path, monkeypatch):
    monkeypatch.setattr(constants, "SAVED_META_INFO_PATH", str(tmp_path / "meta"))
    monkeypatch.setattr(constants, "SAVED_MODELS_BASE_PATH",
                        str(tmp_path / "models"))
    return tmp_path


def _pipe(fh_root, batch_size=16):
    src = FreihandSource(fh_root, "train", seed=5, train_ratio=0.75)
    return HostPipeline([src], batch_size=batch_size, canvas=64, seed=5,
                        num_threads=2)


def _trainer(fh_root, cfgs, workdir, **kw):
    return PeCLRTrainer(*cfgs, _pipe(fh_root), device="cpu",
                        workdir=str(workdir), **kw)


def _records(trainer):
    with open(os.path.join(trainer.tracker.dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_full_slice(fh_root, cfgs, paths):
    src = FreihandSource(fh_root, "train", seed=5, train_ratio=0.75)
    assert len(src) == 96  # 24 unique x 4 versions
    trainer = _trainer(fh_root, cfgs, paths / "work",
                       experiment_name="e2e_test", save_top_k=2,
                       auto_resume=False)
    assert trainer.device == torch.device("cpu")
    assert trainer.steps_per_epoch == 6
    state = trainer.fit(epochs=3)
    assert state.step == 18 and state.optimizer.count == 18

    epochs = [r for r in _records(trainer)
              if r["context"] == "train" and r["step"] is None]
    assert [r["epoch"] for r in epochs] == [0, 1, 2]
    losses = [r["loss"] for r in epochs]
    assert losses[-1] < losses[0], losses
    for r in epochs:
        assert r["checkpoint_saving_loss"] == r["loss"]
        assert r["steps"] == 6
        assert r["lr"] == pytest.approx(trainer.schedule(6 * (r["epoch"] + 1)))
        assert "proj1x_median" in r and "images_per_sec" in r
    assert os.path.exists(os.path.join(trainer.tracker.dir, "figures",
                                       "pair_epoch0.png"))

    kept = sorted(d for d in os.listdir(trainer.ckpt.directory)
                  if d.startswith("epoch_"))
    assert 1 <= len(kept) <= 2
    assert os.path.exists(os.path.join(trainer.ckpt.directory, "index.json"))

    fresh = _trainer(fh_root, cfgs, paths / "elsewhere", auto_resume=False)
    restored, epoch = trainer.ckpt.restore(fresh.state)
    assert restored is fresh.state and epoch == int(kept[-1].split("_")[1])
    want = torch.load(trainer.ckpt.path(epoch), weights_only=True)
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, want["model"][k]), k
    assert fresh.state.step == want["step"]


def test_auto_resume(fh_root, cfgs, paths):
    """An interrupted run resumes from its newest checkpoint."""
    work = paths / "work"
    t1 = _trainer(fh_root, cfgs, work, experiment_name="resume_test",
                  save_top_k=2, log_images=False)
    assert t1.start_epoch == 0
    t1.fit(epochs=2)
    t2 = _trainer(fh_root, cfgs, work, experiment_name="resume_test",
                  save_top_k=2, log_images=False)
    assert t2.start_epoch == 2
    assert t2.state.step == 12 and t2.state.optimizer.count == 12
    assert torch.equal(t2.model.encoder.features[0].weight,
                       t1.model.encoder.features[0].weight)


def test_named_checkpoint_restore(fh_root, cfgs, paths):
    """-checkpoint restores that epoch (not the newest); a missing name
    raises."""
    work = paths / "work"
    t1 = _trainer(fh_root, cfgs, work, experiment_name="named_restore",
                  save_top_k=3, auto_resume=False, log_images=False)
    t1.fit(epochs=2)
    epoch0 = torch.load(t1.ckpt.path(0), weights_only=True)

    t2 = _trainer(fh_root, cfgs, work, experiment_name="named_restore",
                  save_top_k=3, restore_checkpoint="epoch=0.ckpt",
                  log_images=False)
    assert t2.start_epoch == 1
    for k, v in t2.model.state_dict().items():
        assert torch.equal(v, epoch0["model"][k]), k
    assert t2.state.step == 6

    with pytest.raises(FileNotFoundError, match="available epochs"):
        _trainer(fh_root, cfgs, work, experiment_name="named_restore",
                 restore_checkpoint="epoch=9.ckpt")


def test_pair_figure_is_off_without_matplotlib(fh_root, cfgs, paths,
                                               monkeypatch):
    """Where matplotlib does not import, the trainer turns the pair figure
    off when it is built, so no epoch augments a sample for it."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    trainer = _trainer(fh_root, cfgs, paths / "work", auto_resume=False)
    assert trainer.log_images is False
    monkeypatch.delitem(sys.modules, "matplotlib")
    assert _trainer(fh_root, cfgs, paths / "other",
                    auto_resume=False).log_images is True
