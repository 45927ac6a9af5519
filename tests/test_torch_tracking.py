"""The port's experiment tracking and instrumentation
(peclr_tpu_torch/utils/{logging,profiler,io}.py) against the reference's:
the same files and the same remote calls for the same events, the
PECLR_TRACKER selection, Throughput on the same clock, and a
torch.profiler trace."""

import json
import os
import sys
import types

import torch

from peclr_tpu.utils import io as jax_io
from peclr_tpu.utils import logging as jax_logging
from peclr_tpu.utils import profiler as jax_profiler
from peclr_tpu_torch.utils import io, profiler
from peclr_tpu_torch.utils import logging as port_logging


class FakeExperiment:
    def __init__(self, **kwargs):
        self.kwargs = kwargs
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("_") or name in ("kwargs", "calls"):
            raise AttributeError(name)
        return lambda *a, **k: self.calls.append((name, a, k))


def _fake_comet():
    mod = types.ModuleType("comet_ml")
    mod.Experiment = FakeExperiment
    return mod


def _drive(logger):
    logger.log_parameters({"train": {"lr": 1e-4, "flags": ["crop"]}, "seed": 5})
    logger.add_tags(["pretraining", "HYBRID2"])
    logger.log_metrics({"loss": 1.5, "lr": torch.tensor(0.25)}, step=3, epoch=0)
    logger.log_metrics({"loss": 1.2}, epoch=0, context="val")
    logger.log_figure("/tmp/fig.png", name="pair_epoch0")
    logger.close()
    logger.log_metrics({"loss": 1.0}, epoch=1)  # reopens after close
    logger.close()


def _files(logger):
    out = {}
    for name in sorted(os.listdir(logger.dir)):
        with open(os.path.join(logger.dir, name)) as f:
            if name.endswith(".jsonl"):
                recs = [json.loads(line) for line in f]
                for r in recs:
                    r.pop("t")
                out[name] = recs
            else:
                meta = json.load(f)
                meta.pop("created")
                meta.pop("experiment_key")
                out[name] = meta
    return out


def test_logger_writes_what_the_reference_writes(tmp_path):
    got = port_logging.ExperimentLogger(
        str(tmp_path / "got"), "exp", remote=port_logging.CometRemote(
            "exp", comet_module=_fake_comet()))
    ref = jax_logging.ExperimentLogger(
        str(tmp_path / "ref"), "exp", remote=jax_logging.CometRemote(
            "exp", comet_module=_fake_comet()))
    got_exp, ref_exp = got.remote._exp, ref.remote._exp
    _drive(got)
    _drive(ref)
    assert _files(got) == _files(ref)
    assert set(_files(got)) == {"experiment.json", "metrics.jsonl",
                                "figures.jsonl"}

    def plain(calls):  # tensors as floats, for comparison
        return [(n, tuple({k: float(v) for k, v in a.items()}
                          if isinstance(a, dict) and n == "log_metrics" else a
                          for a in args), kw) for n, args, kw in calls]

    assert plain(got_exp.calls) == plain(ref_exp.calls)
    assert ("log_metrics", ({"val_loss": 1.2},), {"step": None, "epoch": 0}) in (
        got_exp.calls)
    assert got.remote is None  # closed: the remote ended once


def test_tracker_selection(tmp_path, monkeypatch):
    for value in ("", "none", "offline", "wandb"):
        monkeypatch.setenv("PECLR_TRACKER", value)
        assert port_logging.make_remote_tracker("exp") is None
    monkeypatch.setenv("PECLR_TRACKER", "comet")
    monkeypatch.setitem(sys.modules, "comet_ml", None)  # not installed
    assert port_logging.make_remote_tracker("exp") is None
    monkeypatch.setitem(sys.modules, "comet_ml", _fake_comet())
    logger = port_logging.ExperimentLogger(str(tmp_path), "exp")
    assert isinstance(logger.remote, port_logging.CometRemote)
    assert all(v is not None for v in logger.remote._exp.kwargs.values())
    logger.close()


def test_broken_remote_never_stops_the_run(tmp_path):
    class Exploding:
        def __getattr__(self, name):
            def boom(*a, **k):
                raise ConnectionError("link down")
            return boom

    logger = port_logging.ExperimentLogger(str(tmp_path), "exp",
                                           remote=Exploding())
    logger.log_parameters({"a": 1})
    logger.log_metrics({"loss": 1.0}, epoch=0)
    logger.log_figure("/tmp/x.png")
    logger.close()
    with open(os.path.join(logger.dir, "experiment.json")) as f:
        assert json.load(f)["params"] == {"a": 1}


def test_throughput_matches_on_the_same_clock(monkeypatch):
    ticks = [0.0, 0.5, 1.1, 1.6, 2.4, 2.9, 3.0]
    for mod in (profiler, jax_profiler):
        clock = iter(ticks)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        meter = mod.Throughput(warmup_steps=2)
        for _ in ticks:
            meter.tick(64)
        if mod is profiler:
            got = meter.report()
        else:
            ref = meter.report()
    assert got == ref and set(got) == {"step_time_s", "images_per_sec"}
    assert profiler.Throughput().report() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiler.trace(str(tmp_path / "prof")):
        torch.ones(8, 8).sum()
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(tmp_path / "prof" / traces[0]) as f:
        assert "traceEvents" in json.load(f)
    with profiler.trace(None):  # nothing when no directory is given
        pass


def test_json_io_matches(tmp_path):
    obj = {"a": [1, 2.5, None], "b": {"c": "d"}}
    io.save_json(obj, str(tmp_path / "got.json"))
    jax_io.save_json(obj, str(tmp_path / "ref.json"))
    assert (tmp_path / "got.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert io.read_json(str(tmp_path / "ref.json")) == jax_io.read_json(
        str(tmp_path / "got.json")) == obj
