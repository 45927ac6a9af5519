"""harness/spans.py on hand-made event lists: a kernel goes to the
innermost program span open when its launch ran (matched by correlation
id, on any thread), an idle interval to the spans open over it, and a
capture without program spans gives nothing.  pinned_mb.pred reads the
program's counter a traced unit; phases.py reads each tiny cell's spans;
trace.profile keeps its keys."""

import json
import os
import shutil
from types import SimpleNamespace

import pytest
import torch

from benchmark import phases
from benchmark.harness import common, spans, trace
from benchmark.harness.counts import PEAK_HBM

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
DATA = os.path.join(common.BENCH_DIR, "tests", "data")


class Event:
    """What harness/spans.py reads of a kineto event."""

    def __init__(self, name, start_us, end_us, device=CPU, corr=0,
                 annotation=False, thread=1):
        self._name, self._start, self._end = name, start_us, end_us
        self._device, self._corr = device, corr
        self._annotation, self._thread = annotation, thread

    def name(self):
        return self._name

    def start_ns(self):
        return int(self._start * 1e3)

    def duration_ns(self):
        return int((self._end - self._start) * 1e3)

    def device_type(self):
        return self._device

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._annotation

    def start_thread_id(self):
        return self._thread


def span(name, start, end, thread=1):
    return Event(name, start, end, annotation=True, thread=thread)


def kernel(name, start, end, corr):
    return Event(name, start, end, device=CUDA, corr=corr)


def launch(start, corr, thread=1, name="cudaLaunchKernel"):
    return Event(name, start, start + 2, corr=corr, thread=thread)


def fake_profile(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


def pretrain_step_events():
    """One step, 0-100 µs on the host: zero_grad, a microbatch whose
    augment holds a warp.shift, its backward (whose kernels autograd
    launches from thread 2), and the update.  Device events run late."""
    return [
        span("pretrain.step", 0, 100),
        span("pretrain.zero_grad", 1, 5),
        span("pretrain.microbatch", 6, 80),
        span("pretrain.augment", 7, 30),
        span("warp.shift", 10, 20),
        span("pretrain.backward", 40, 79),
        span("pretrain.update", 85, 99),
        # torch's own ops and annotations, some sharing the launches' ids
        Event("aten::mm", 41, 60, corr=3),
        Event("MmBackward0", 42, 58, corr=4, thread=2),
        span("Optimizer.step#LARS.step", 86, 98),
        Event("pretrain.augment", 8, 9, device=CUDA, annotation=True),
        launch(2, 1),                      # zero_grad's fill
        launch(8, 2),                      # augment, outside the shift
        launch(12, 3, name="cuLaunchKernel"),   # the shift kernel
        launch(45, 4, thread=2),           # backward, from autograd
        launch(50, 5, thread=2),
        launch(90, 6, name="cudaMemcpyAsync"),  # the update
        launch(105, 7),                    # after every span
        kernel("fill", 10, 12, 1),
        kernel("colour", 20, 30, 2),
        kernel("shift_lerp_kernel", 30, 50, 3),
        kernel("dgrad", 60, 70, 4),
        kernel("wgrad", 90, 100, 5),
        kernel("Memcpy HtoD", 110, 114, 6),
        kernel("late", 120, 121, 7),
    ]


def test_a_kernel_goes_to_the_innermost_span_open_at_its_launch():
    p = spans.read(fake_profile(pretrain_step_events()))
    dev = p["device_us"]
    assert dev["warp.shift"] == pytest.approx(20.0)
    assert dev["pretrain.augment"] == pytest.approx(10.0 + 20.0)
    # launched from thread 2 while thread 1 was inside backward
    assert dev["pretrain.backward"] == pytest.approx(10.0 + 10.0)
    assert dev["pretrain.zero_grad"] == pytest.approx(2.0)
    assert dev["pretrain.update"] == pytest.approx(4.0)
    assert dev["pretrain.microbatch"] == pytest.approx(50.0)
    assert dev["pretrain.step"] == pytest.approx(56.0)
    assert p["device_us_total"] == pytest.approx(57.0)
    assert p["device_us_credited"] == pytest.approx(56.0)
    parents = {s["name"]: s["parent"] for s in p["spans"]}
    assert parents == {
        "pretrain.step": None, "pretrain.zero_grad": "pretrain.step",
        "pretrain.microbatch": "pretrain.step",
        "pretrain.augment": "pretrain.microbatch",
        "warp.shift": "pretrain.augment",
        "pretrain.backward": "pretrain.microbatch",
        "pretrain.update": "pretrain.step"}


def test_an_idle_interval_goes_to_the_spans_open_over_it():
    p = spans.read(fake_profile(pretrain_step_events()))
    idle = p["idle_us"]
    # the card is busy over [10, 12], [20, 50], [60, 70], [90, 100],
    # [110, 114], [120, 121]; the capture spans 0-121
    assert idle["pretrain.zero_grad"] == pytest.approx(4.0)     # 1-5
    assert idle["warp.shift"] == pytest.approx(8.0)             # 12-20
    assert idle["pretrain.augment"] == pytest.approx(3.0 + 8.0)  # and 7-10
    assert idle["pretrain.backward"] == pytest.approx(10.0 + 9.0)  # 50-60, 70-79
    assert idle["pretrain.update"] == pytest.approx(5.0)        # 85-90
    # 0-10, 12-20, 50-60, 70-90; none after the step ends at 100
    assert idle["pretrain.step"] == pytest.approx(10.0 + 8.0 + 10.0 + 20.0)
    assert p["idle_us_total"] == pytest.approx(121.0 - 57.0)


def test_overlapping_spans_of_two_threads_credit_the_later_started():
    events = [span("pred.pass1", 0, 50), span("pred.h2d", 40, 60, thread=3),
              launch(45, 1), launch(55, 2), kernel("a", 70, 80, 1),
              kernel("b", 80, 85, 2)]
    p = spans.read(fake_profile(events))
    assert p["device_us"] == {"pred.pass1": 0.0, "pred.h2d": 15.0}
    assert p["idle_us"]["pred.pass1"] == pytest.approx(40.0)
    assert p["idle_us"]["pred.h2d"] == pytest.approx(20.0)


def test_no_program_spans_give_nothing():
    events = [e for e in pretrain_step_events()
              if not (e.is_user_annotation()
                      and e.name().startswith(spans.PREFIXES))]
    p = spans.read(fake_profile(events))
    assert p["spans"] == [] and p["device_us"] == {} and p["idle_us"] == {}
    assert p["device_us_credited"] == 0.0
    assert p["device_us_total"] == pytest.approx(57.0)


def _ctx(kind, units=2, trace_=True):
    return {"kind": kind, "window": {"units": 9, "images": 9, "seconds": 1.0},
            "setup_s": 1.0, "counts": {},
            "trace": {"summary": {"busy_ms": 1.0, "buckets_ms": {}},
                      "device_spans": [], "units": units} if trace_ else None}


def test_pinned_mb_reads_the_programs_counter_a_traced_unit(monkeypatch):
    from peclr_tpu_torch.utils import profiler

    monkeypatch.setattr(profiler, "_counters", {"pinned_bytes": 36_135_360})
    reader = common.metric_readers()["pinned_mb.pred"]
    assert reader.read(_ctx("pred")) == pytest.approx(18.06768)


@pytest.mark.parametrize("counters", [None, {}],
                         ids=["a_program_without_counters", "nothing_pinned"])
@pytest.mark.parametrize("kind", ["pretrain", "finetune", "pred"])
def test_pinned_mb_reads_nothing_without_the_counter(counters, kind,
                                                     monkeypatch):
    if counters is None:
        monkeypatch.setattr(spans, "program_counters", lambda: {})
    else:
        from peclr_tpu_torch.utils import profiler

        monkeypatch.setattr(profiler, "_counters", counters)
    reader = common.metric_readers()["pinned_mb.pred"]
    assert reader.read(_ctx(kind)) is None
    assert reader.read(_ctx(kind, trace_=False)) is None


def test_phases_figures_read_their_spans_a_unit():
    p = spans.read(fake_profile(pretrain_step_events()))
    p["counters"] = {"pinned_bytes": 36_135_360}
    got = phases.figures("pretrain", p, 2,
                         {"warp_bytes_per_unit": 0.5 * PEAK_HBM * 1e-6})
    assert got["augment_ms"] == pytest.approx(30.0 / 1e3 / 2)
    assert got["optimizer_ms"] == pytest.approx(6.0 / 1e3 / 2)
    assert got["backward_idle_ms"] == pytest.approx(19.0 / 1e3 / 2)
    assert got["pinned_mb"] == pytest.approx(18.06768)
    # 0.5 µs of least time a unit over 10 µs of shift kernels a unit
    assert got["warp_span_roofline"] == pytest.approx(5.0)
    # the predictor's figure reads a span this capture lacks
    assert phases.figures("pred", p, 2, {}) == {"pinned_mb": 18.06768}
    empty = spans.read(fake_profile([]))
    empty["counters"] = {}
    assert phases.figures("pretrain", empty, 2, {}) == {}


#: each tiny stand-in: (config, traffic, entry, the spans it records)
TINY = {
    "pretrain": ("peclr-tiny", "recipe-tiny", "pretrain_step",
                 ("pretrain.step", "pretrain.zero_grad", "pretrain.microbatch",
                  "pretrain.augment", "pretrain.forward", "pretrain.loss",
                  "pretrain.backward", "pretrain.update")),
    "finetune": ("rn25d-tiny", "finetune-tiny", "finetune_step",
                 ("finetune.step", "finetune.augment", "finetune.zero_grad",
                  "finetune.forward", "finetune.loss", "finetune.backward",
                  "finetune.update")),
    "pred": ("rn25d-tiny", "leaderboard-tiny", "two_pass_pred",
             ("pred.h2d", "pred.pass1", "pred.refine", "pred.pass2",
              "pred.fetch")),
}


@pytest.mark.parametrize("kind", sorted(TINY))
def test_phases_reads_the_spans_of_a_tiny_cell(kind, tmp_path, capsys):
    config, traffic, entry, want = TINY[kind]
    root = tmp_path / "bench"
    shutil.copytree(DATA, root)
    (root / "workloads").mkdir(exist_ok=True)
    (root / "workloads" / "tiny.json").write_text(json.dumps({
        "config": config, "traffic": traffic, "entry": entry, "chips": 1,
        "why": "tiny stand-in", "limits": {}}))
    line = phases.main(["--workload", "tiny", "--seed", "3000000019",
                        "--seconds", "0.1"], root=str(root),
                       device="cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        json.loads(json.dumps(line))
    assert set(want) <= set(line["device_ms"]) == set(line["idle_ms"])
    # every cell warps, in two shift passes a warp
    assert "warp.shift" in line["device_ms"]
    # the CPU capture has no device events: nothing busy, nothing credited
    assert line["device_ms_total"] == 0.0 and line["credited_pct"] is None


def test_profile_keeps_its_keys():
    from peclr_tpu_torch.utils.profiler import span

    def run():
        with span("pred.pass1"):
            torch.ones(4).sum()

    got = trace.profile(run, torch.device("cpu"))
    assert list(got) == ["summary", "device_spans"]
    assert got["device_spans"] == []
    assert set(got["summary"]) == {"steps", "wall_ms", "host_ops",
                                   "device_time"}
