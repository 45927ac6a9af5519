"""The port's fine-tune, evaluate and port CLIs on the CPU (`--device cpu`),
at the size of the reference's CLI tests: RN50, 48² / 64² crops, batch 8,
on a FreiHAND-layout dataset written to a temporary directory.

The fine-tune CLI starts from a checkpoint of the port's own pretraining
CLI; the evaluate CLI reads the fine-tuned checkpoint; the port CLI's
conversions equal the reference's for the same weights.  Without a card
the CLIs raise unless given `--device cpu`.
"""

import contextlib
import io
import json
import os
import shutil
import types

import numpy as np
import pytest
import torch

from peclr_tpu.data.freihand import FreihandSource as JaxSource
from peclr_tpu.data.pipeline import HostPipeline as JaxPipeline
from peclr_tpu.models import port as jax_port
from peclr_tpu.train import checkpoint as jax_checkpoint
from peclr_tpu_torch import constants
from peclr_tpu_torch.cli import evaluate as evaluate_cli
from peclr_tpu_torch.cli import finetune as finetune_cli
from peclr_tpu_torch.cli import port as port_cli
from peclr_tpu_torch.cli import train as train_cli
from peclr_tpu_torch.data.freihand import FreihandSource
from peclr_tpu_torch.data.pipeline import HostPipeline
from peclr_tpu_torch.data.synthetic import (
    generate_freihand_eval_like,
    generate_freihand_like,
    seeded_peclr_variables,
)
from peclr_tpu_torch.models import PeCLRModel
from peclr_tpu_torch.models.port import peclr_variables_to_state_dict
from peclr_tpu_torch.models.resnet import ResNet
from peclr_tpu_torch.train import checkpoint, finetune

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def drop_outputs(tmp_path):
    """An RN50 checkpoint holds ~0.3 GB: each test's outputs go when it
    ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def fh_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_fh") / "freihand_dataset")
    generate_freihand_like(root, num_unique=4, seed=7)
    generate_freihand_eval_like(root, num_images=4, seed=8)
    return root


@pytest.fixture
def paths(fh_root, tmp_path, monkeypatch):
    monkeypatch.setattr(constants, "FREIHAND_DATA", fh_root)
    monkeypatch.setattr(constants, "SAVED_MODELS_BASE_PATH",
                        str(tmp_path / "models"))
    monkeypatch.setattr(constants, "SAVED_META_INFO_PATH",
                        str(tmp_path / "meta"))
    return tmp_path


@pytest.fixture(scope="module")
def pretrained(fh_root, tmp_path_factory):
    """epoch_0 of one epoch of the port's pretraining CLI at RN50 (canvas 64
    -> 48 views, 12 training samples: one step of 8)."""
    root = tmp_path_factory.mktemp("pretrain")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(constants, "FREIHAND_DATA", fh_root)
        mp.setattr(constants, "SAVED_MODELS_BASE_PATH", str(root / "models"))
        mp.setattr(constants, "SAVED_META_INFO_PATH", str(root / "meta"))
        trainer = train_cli.main([
            "--rotate", "--crop", "--resize", "-batch_size", "8", "-epochs",
            "1", "-resnet_size", "50", "-train_ratio", "0.75", "-num_workers",
            "2", "-optimizer", "adam", "-canvas", "64", "-view_size", "48",
            "-save_top_k", "1", "-sources", "freihand", *CPU])
    yield os.path.dirname(trainer.ckpt.path(0))
    shutil.rmtree(root, ignore_errors=True)


def test_steps_per_epoch_matches_reference(fh_root):
    for batch in (3, 8, 64):
        port = HostPipeline([FreihandSource(fh_root, "train", train_ratio=0.75)],
                            batch_size=batch)
        ref = JaxPipeline([JaxSource(fh_root, "train", train_ratio=0.75)],
                          batch_size=batch)
        assert port.steps_per_epoch() == ref.steps_per_epoch() == 12 // batch


def test_finetune_from_pretrained_then_evaluate(paths, pretrained,
                                                monkeypatch):
    """Fine-tune (crop 48) from the pretraining CLI's checkpoint: the
    backbone equals the pretrained encoder before the first step; then the
    evaluate CLI on the fine-tuned checkpoint."""
    loaded = []
    real = finetune.load_pretrained_encoder

    def spy(model, state_dict):
        out = real(model, state_dict)
        loaded.append({k: v.clone() for k, v in
                       model.backend_model.state_dict().items()})
        return out

    monkeypatch.setattr(finetune, "load_pretrained_encoder", spy)
    workdir = str(paths / "ft")
    state, records = finetune_cli.main([
        "-batch_size", "8", "-epochs", "1", "-steps_per_epoch", "1",
        "-resnet_size", "50", "-crop_size", "48", "-train_ratio", "0.75",
        "-num_workers", "2", "-workdir", workdir, "-optimizer", "adam",
        "-pretrained", pretrained, *CPU])
    encoder = checkpoint.model_state_dict(pretrained)
    backbone = loaded[0]
    assert torch.equal(backbone["layer4.2.conv3.weight"],
                       encoder["encoder.features.7.2.conv3.weight"])
    assert torch.equal(backbone["bn1.running_var"],
                       encoder["encoder.features.1.running_var"])
    assert state.step == 1 and records[0]["steps"] == 1
    assert np.isfinite(records[0]["loss"])
    ckpt = os.path.join(workdir, "checkpoints", "epoch_0")
    assert os.path.exists(os.path.join(ckpt, checkpoint.STATE_FILE))

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = evaluate_cli.main([
            "-checkpoint", ckpt, "-resnet_size", "50", "-batch_size", "4",
            "-num_batches", "1", "-train_ratio", "0.75", "-crop_size", "48",
            *CPU])
    assert json.loads(buf.getvalue()) == results
    assert len(results) == 9 and all(np.isfinite(v) for v in results.values())


def test_finetune_and_evaluate_cli(paths):
    """The reference's CLI test: fine-tune from scratch (crop 64, two epochs
    of one step, top-1 kept), evaluate an exported .npz of the
    checkpoint."""
    workdir = str(paths / "ft")
    state, records = finetune_cli.main([
        "-batch_size", "8", "-epochs", "2", "-steps_per_epoch", "1",
        "-resnet_size", "50", "-crop_size", "64", "-train_ratio", "0.75",
        "-num_workers", "2", "-workdir", workdir, "-save_top_k", "1", *CPU])
    assert [r["steps"] for r in records] == [1, 1]
    assert state.optimizer.count == 2
    kept = [d for d in os.listdir(os.path.join(workdir, "checkpoints"))
            if d.startswith("epoch_")]
    assert len(kept) == 1
    weights = str(paths / "rn25d.npz")
    checkpoint.save_npz(weights, checkpoint.model_state_dict(
        os.path.join(workdir, "checkpoints", kept[0])))
    with contextlib.redirect_stdout(io.StringIO()):
        results = evaluate_cli.main([
            "-checkpoint", weights, "-batch_size", "4", "-num_batches", "1",
            "-train_ratio", "0.75", "-crop_size", "64", "--no_procrustes",
            *CPU])
    assert "AUC" in results and "Mean_EPE_2D" in results
    assert np.isfinite(results["Mean_EPE_3D"])
    assert "auc_procrustes" not in results


@pytest.mark.parametrize("cli", [finetune_cli, evaluate_cli])
def test_cli_needs_a_card_unless_told_cpu(paths, monkeypatch, cli):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = (["-checkpoint", "x.npz"] if cli is evaluate_cli
            else ["-epochs", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def _seeded_peclr18():
    variables = seeded_peclr_variables("18", seed=4)
    return variables, peclr_variables_to_state_dict(variables, "18")


def _assert_same(got, ref):
    assert set(got) == set(ref)
    for name, value in ref.items():
        np.testing.assert_array_equal(np.asarray(got[name]), value,
                                      err_msg=name)


def test_port_cli_peclr_to_torchvision_matches_reference(tmp_path):
    variables, sd = _seeded_peclr18()
    src = str(tmp_path / "peclr18.npz")
    checkpoint.save_npz(src, sd)
    dst = str(tmp_path / "tv18.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        port_cli.main([src, dst, "-format", "peclr_to_torchvision",
                       "-resnet_size", "18"])
    ref = jax_port.peclr_to_torchvision(
        jax_port.peclr_checkpoint_to_variables(
            checkpoint.load_torch_checkpoint(src), "18"), "18")
    with np.load(dst) as z:
        _assert_same({k: z[k] for k in z.files}, ref)
    net = ResNet("18")
    net.fc = torch.nn.Identity()
    net.load_state_dict(checkpoint.load_torch_checkpoint(dst), strict=True)

    # and back: the encoder of a PeCLR checkpoint, under its own keys
    back = str(tmp_path / "peclr18_encoder.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        port_cli.main([dst, back, "-format", "torchvision_to_peclr",
                       "-resnet_size", "18"])
    encoder = {k: v for k, v in sd.items() if k.startswith("encoder.")}
    _assert_same(checkpoint.load_torch_checkpoint(back),
                 {k: v.numpy() for k, v in encoder.items()})


@pytest.mark.parametrize("fmt", ["orbax_to_peclr", "orbax_to_torchvision"])
def test_port_cli_reads_the_pretraining_checkpoint(pretrained, tmp_path, fmt):
    """The orbax_* formats read the port's checkpoint directory; what they
    write equals the reference's export of the same weights."""
    dst = str(tmp_path / "out.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        out = port_cli.main([pretrained, dst, "-format", fmt])
    sd = checkpoint.model_state_dict(pretrained)
    model = PeCLRModel("50")
    model.load_state_dict(sd, strict=True)
    ref_path = str(tmp_path / "ref.npz")
    variables = jax_port.peclr_checkpoint_to_variables(
        {k: v.numpy() for k, v in sd.items()}, "50")
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    export = (jax_checkpoint.export_torch_peclr if fmt == "orbax_to_peclr"
              else jax_checkpoint.export_torchvision)
    export(state, "50", ref_path)
    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files}
    # the reference has no BatchNorm counter and writes 0
    got = {k: (np.zeros((), np.int64) if k.endswith("num_batches_tracked")
               else v.numpy()) for k, v in out.items()}
    _assert_same(got, ref)
