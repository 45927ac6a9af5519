"""The port's bench (peclr_tpu_torch/bench.py, `python -m
peclr_tpu_torch.bench`) against the reference's bench.py, on the CPU at a
tiny size (RN18, microbatch 2 x accum 1, 2 windows of 2 steps).

What a CPU run can show: the one stdout line carries exactly the keys of
the reference's line, its metric and estimator strings, and vs_baseline
null; the knobs are the reference's names and defaults; the windows are
chained (the state ends at step WARMUP + W·N, no warm-up a window); the
batch is the reference's synthetic_pretrain_batch byte for byte; the
initial weights carry the reference's recipe state's layout; a bad route
or a missing card ends the run.  The step itself is held to the
reference's by tests/test_torch_train_step.py.  No time here is the
card's."""

import ast
import io
import json
import math
import os
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from peclr_tpu.train.recipe import build_pretrain_state as jax_build_state
from peclr_tpu.train.recipe import synthetic_pretrain_batch as jax_batch
from peclr_tpu_torch import bench
from peclr_tpu_torch.data.synthetic import seeded_peclr_variables
from peclr_tpu_torch.models.port import peclr_variables_to_state_dict
from peclr_tpu_torch.ops.augment import ROUTES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESNET, BATCH, ACCUM, ITERS, WINDOWS = "18", 2, 1, 2, 2
ENV = {"BENCH_RESNET": RESNET, "BENCH_BATCH": str(BATCH),
       "BENCH_ACCUM": str(ACCUM), "BENCH_ITERS": str(ITERS),
       "BENCH_WINDOWS": str(WINDOWS)}
#: the reference's knobs that set XLA options; the port reads none of them
XLA_KNOBS = {"BENCH_UNROLL", "BENCH_COMPILER_OPTIONS", "BENCH_STATS_ACCUM",
             "JAX_COMPILATION_CACHE_DIR"}


def _reference_tree():
    with open(os.path.join(REPO, "bench.py")) as fh:
        return ast.parse(fh.read())


def _reference_line_keys():
    """The keys of the dict that the reference's bench.py hands to
    json.dumps."""
    for node in ast.walk(_reference_tree()):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            return [ast.literal_eval(k) for k in node.args[0].keys]
    raise AssertionError("no json.dumps of a dict in bench.py")


def _reference_knobs():
    """{name: default} of every os.environ.get(NAME[, DEFAULT]) in the
    reference's bench.py (None where it gives no default)."""
    out = {}
    for node in ast.walk(_reference_tree()):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and ast.unparse(node.func.value) == "os.environ"):
            name, *default = (ast.literal_eval(a) for a in node.args)
            out[name] = default[0] if default else None
    return out


@pytest.fixture(scope="module")
def bench_run():
    """bench.main(["--device", "cpu"]) at ENV: its record, stdout, stderr,
    and the batch, initial weights and final state that its run saw."""
    seen = {}
    real_run = bench.run

    def spy(step, state, batch, *args, **kwargs):
        seen["batch"] = batch
        seen["initial"] = {k: v.clone()
                           for k, v in state.model.state_dict().items()}
        state, report = real_run(step, state, batch, *args, **kwargs)
        seen["state"] = state
        return state, report

    out, err = io.StringIO(), io.StringIO()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            for name, value in ENV.items():
                mp.setenv(name, value)
            mp.setattr(bench, "run", spy)
            with redirect_stdout(out), redirect_stderr(err):
                record = bench.main(["--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    return record, out.getvalue(), err.getvalue(), seen


def test_stdout_is_one_line_with_the_references_keys(bench_run):
    record, out, _, _ = bench_run
    lines = out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == record
    assert list(line) == _reference_line_keys()
    assert set(line) == {"metric", "value", "unit", "vs_baseline",
                         "estimator"}


def test_metric_estimator_and_baseline(bench_run):
    record = bench_run[0]
    assert record["metric"] == (
        f"aug+train images/sec/chip (RN{RESNET} PeCLR, microbatch {BATCH} "
        f"x accum {ACCUM}, bf16)")
    assert record["estimator"] == f"min_of_{WINDOWS}_windows_x_{ITERS}_iters"
    assert record["unit"] == "images/sec/chip"
    assert record["vs_baseline"] is None
    assert math.isfinite(record["value"]) and record["value"] > 0


def test_value_is_the_best_window(bench_run):
    record, _, err, _ = bench_run
    report = json.loads(err.splitlines()[-1])
    assert err.splitlines()[0] == "cpu"  # the card's name and power limit
    assert len(report["window_seconds"]) == WINDOWS
    best = BATCH * ACCUM * ITERS / min(report["window_seconds"])
    assert record["value"] == round(best, 1)
    assert math.isfinite(report["first_warmup_loss"])
    assert report["host_waits"] == 0
    assert report["peak_memory_bytes"] is None  # no card
    assert (report["resnet"], report["route"]) == (RESNET, "grouped")


def test_windows_are_chained_after_one_warm_up(bench_run):
    """WARMUP steps once, then W windows of N steps on one state."""
    state = bench_run[3]["state"]
    assert bench.WARMUP == 3
    assert state.step == bench.WARMUP + WINDOWS * ITERS


def test_batch_is_the_references_byte_for_byte(bench_run):
    batch = bench_run[3]["batch"]
    want = jax_batch(BATCH * ACCUM)
    assert set(batch) == set(want)
    for key, value in batch.items():
        ref = np.array(want[key])
        assert value.dtype == torch.from_numpy(ref).dtype
        assert value.numpy().tobytes() == ref.tobytes(), key


def test_initial_weights_carry_the_references_recipe_state(bench_run):
    """The reference's build_pretrain_state variables, carried across by
    models/port.py, name every tensor of the bench's model at its shape;
    the values (torch's BatchNorm step counters aside) are the seeded
    weights of train/recipe.py:build_pretrain_state, bit for bit (torch's
    generator cannot replay flax's init, a deliberate difference)."""
    got = bench_run[3]["initial"]
    _, ref_state, _ = jax_build_state(resnet=RESNET, batch=BATCH,
                                      accum=ACCUM)
    carried = peclr_variables_to_state_dict(
        {"params": ref_state.params, "batch_stats": ref_state.batch_stats},
        RESNET)
    assert set(carried) == set(got)
    for key, value in carried.items():
        assert tuple(value.shape) == tuple(got[key].shape), key
    got = {k: v for k, v in got.items()
           if not k.endswith("num_batches_tracked")}
    seeded = peclr_variables_to_state_dict(seeded_peclr_variables(RESNET, 0),
                                           RESNET)
    for key, value in got.items():
        assert torch.equal(value, seeded[key].to(value.dtype)), key


def test_knobs_are_the_references():
    """Every knob of the reference's bench.py with its default, but the
    XLA ones, which the port reads not at all."""
    ref = _reference_knobs()
    assert set(ref) - XLA_KNOBS == set(bench.KNOBS)
    for name, default in bench.KNOBS.items():
        assert ref[name] == default, name
    assert bench.knobs({}) == {"batch": 128, "accum": 16, "iters": 6,
                               "windows": 3, "resnet": "50"}
    with open(os.path.join(REPO, "peclr_tpu_torch", "bench.py")) as fh:
        source = fh.read()
    for name in XLA_KNOBS:
        assert f'"{name}"' not in source, name


def test_unknown_route_exits_with_the_routes(capsys):
    with pytest.raises(SystemExit) as exc:
        bench.parse_args(["--route", "shift"])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    for route in ROUTES:
        assert route in err


def test_no_card_raises_before_any_work(monkeypatch):
    """main([]) asks for the card: without one it raises and builds
    nothing on the CPU."""
    assert not torch.cuda.is_available()

    def build(*args, **kwargs):
        raise AssertionError("the bench built its step without a card")

    monkeypatch.setattr(bench, "build", build)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


@pytest.mark.parametrize("case, route, change", [
    ("nan_loss", "grouped", {"first_warmup_loss": float("nan")}),
    ("host_wait", "grouped", {"host_waits": [["train/step.py:1"]]}),
    ("too_few", "grouped", {"launches_per_step": {
        "shift_lerp_grouped": 31.0, "shift_lerp_flat": 0.0,
        "shift_lerp_matmul": 0.0}}),
    ("other_kernel", "matmul", {"launches_per_step": {
        "shift_lerp_grouped": 2.0, "shift_lerp_flat": 0.0,
        "shift_lerp_matmul": 32.0}}),
    ("gather_launched", "gather", {"launches_per_step": {
        "shift_lerp_grouped": 32.0, "shift_lerp_flat": 0.0,
        "shift_lerp_matmul": 0.0}}),
])
def test_check_ends_a_bad_run(case, route, change):
    """On the card the run ends nonzero on a non-finite first loss, a wait
    on the card, or launches off 2 x accum of the route's kernel."""
    report = {"first_warmup_loss": 5.5, "host_waits": [],
              "launches_per_step": {
                  "shift_lerp_grouped": 32.0 if route == "grouped" else 0.0,
                  "shift_lerp_flat": 0.0,
                  "shift_lerp_matmul": 32.0 if route == "matmul" else 0.0}}
    card = torch.device("cuda", 0)
    bench.check(report, route, 16, card)  # the good run passes
    with pytest.raises(SystemExit) as exc:
        bench.check({**report, **change}, route, 16, card)
    assert exc.value.code not in (0, None), case
