"""The port's multi-card and stream-rate scripts (peclr_tpu_torch/scripts:
bench_multichip, multihost_harness, bench_streams) on the CPU at the
reference's small sizes.

What a CPU run can show: the scaling table's losses do not depend on the
mesh (gloo ranks at worlds 1, 2 and 4, the reference's bound); weak
scaling's global-batch accounting and record keys at world 1; the harness
end to end, two processes meeting through env:// against one process; the
harness's global batch bit-equal to the reference's and each process's
rows those of the whole batch; the stream passes' plain versions against
the reference's own jitted `f_*` (read from scripts/bench_streams.py);
and each script refusing to run without a card unless asked for the CPU.
No time here is a device's."""

import ast
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peclr_tpu_torch.ops import streams
from peclr_tpu_torch.parallel.mesh import Mesh, local_rows
from peclr_tpu_torch.parallel.multihost import (
    global_batch_from_host_local,
    local_batch_size,
)
from peclr_tpu_torch.scripts import (
    bench_multichip,
    bench_streams,
    multihost_harness,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the tiny weak-scaling run: RN18, 64² canvases to 32² views, 2 rows a
#: microbatch, accum 2, one timed step
WEAK_ARGV = ["--device", "cpu", "--resnet", "18", "--canvas", "64",
             "--view", "32", "--batch", "2", "--accum", "2", "--iters", "1"]


def _reference_module(name):
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reference_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reference_stream_fns():
    """The reference's jitted f_copy, f_add, f_bn_res_relu and f_stats, as
    its main() defines them (scripts/bench_streams.py:102-130), compiled
    from its source."""
    path = os.path.join(REPO, "scripts", "bench_streams.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    fns = [n for n in ast.walk(main)
           if isinstance(n, ast.FunctionDef) and n.name.startswith("f_")]
    namespace = {"jax": jax, "jnp": jnp}
    exec(compile(ast.Module(body=fns, type_ignores=[]), path, "exec"),
         namespace)
    return {n.name: namespace[n.name] for n in fns}


# --------------------------------------------------------------------------
# bench_multichip


def test_scaling_table_is_equal_across_worlds(tmp_path):
    """The reference's table (RN18, global microbatch 8, accum 2, 64² to
    32², f32) at worlds 1, 2 and 4 over gloo: two chained steps' losses
    within 5e-5 relative of world 1's (tests/test_bench_artifacts.py:
    94-97), every rank's equal (checked by the script)."""
    art = bench_multichip.main(["--scaling_table", "--device", "cpu",
                                "--mesh_sizes", "1,2,4",
                                "--out", str(tmp_path / "table.json")])
    assert art["config"] == {
        "global_microbatch": 8, "accum": 2, "resnet": "18", "canvas": 64,
        "view": 32, "platform": "cpu", "mesh_sizes": [1, 2, 4],
        "route": "grouped", "precision": "f32", "tf32": False}
    rows = art["rows"]
    assert [r["mesh"] for r in rows] == [1, 2, 4]
    assert all(r["backend"] == "gloo" for r in rows)
    for key in ("loss_step1", "loss_step2"):
        base = rows[0][key]
        assert np.isfinite(base)
        for r in rows[1:]:
            assert abs(r[key] - base) <= 5e-5 * abs(base), (key, rows)
    assert art["max_rel_to_mesh1"] <= 5e-5
    assert art["backend"] == "cpu" and art["device"] == "cpu"


def test_weak_scaling_accounting_and_keys(tmp_path):
    """World 1 on the CPU, each route in turn in one rank: the global
    batch is batch x accum x world, img/s is it over ms a step, the record
    carries the mesh's and the no-mesh step's numbers, and the first steps
    agree (the same state, batch and draws; the BatchNorm across ranks
    sums in another order)."""
    rec = bench_multichip.main(WEAK_ARGV + [
        "--route", "grouped,matmul", "--out", str(tmp_path / "w.json")])
    assert rec["world"] == 1 and rec["collective_backend"] == "gloo"
    assert rec["global_batch_per_step"] == 2 * 2 * 1
    assert rec["config"] == {"batch": 2, "accum": 2, "resnet": "18",
                             "canvas": 64, "view": 32,
                             "route": "grouped,matmul", "iters": 1,
                             "precision": "bf16", "with_stats": False}
    assert set(rec["routes"]) == {"grouped", "matmul"}
    for route, got in rec["routes"].items():
        assert set(got) == {
            "ms_per_step", "img_per_s", "img_per_s_per_card", "loss_step1",
            "ranks_loss_step1", "launches_per_step_per_rank",
            "last_paths_per_rank", "host_waits_in_window", "no_mesh",
            "mesh_over_no_mesh", "loss_step1_mesh_minus_no_mesh"}
        np.testing.assert_allclose(got["img_per_s"],
                                   4 / (got["ms_per_step"] / 1e3), rtol=1e-12)
        assert got["img_per_s_per_card"] == got["img_per_s"]
        np.testing.assert_allclose(
            got["mesh_over_no_mesh"],
            got["ms_per_step"] / got["no_mesh"]["ms_per_step"], rtol=1e-12)
        assert abs(got["loss_step1_mesh_minus_no_mesh"]) <= 1e-5
        # the CPU takes the kernels' plain versions: nothing launched
        assert set(got["launches_per_step_per_rank"][0].values()) == {0.0}
        assert got["host_waits_in_window"] == 0
    losses = {g["loss_step1"] for g in rec["routes"].values()}
    assert max(losses) - min(losses) <= 1e-5  # the routes' warps agree
    assert rec["backend"] == "cpu" and rec["device"] == "cpu"
    with open(tmp_path / "w.json") as fh:
        assert json.load(fh) == json.loads(json.dumps(rec))


def test_weak_scaling_refuses_ranks_sharing_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="one rank a card"):
        bench_multichip.main(["--world", "2", "--out", os.devnull])


# --------------------------------------------------------------------------
# multihost_harness


def test_harness_end_to_end(tmp_path):
    """Two processes, each on its own rows, meeting through env:// over
    gloo, against one process on the whole batch: the reference's bound
    (max_rel_err < 2e-5), the workers equal."""
    out = tmp_path / "crossproc.json"
    rec = multihost_harness.main(["--device", "cpu", "--out", str(out),
                                  "--tmpdir", str(tmp_path),
                                  "--timeout", "300"])
    assert rec["ok"] is True and rec["max_rel_err"] < 2e-5
    assert rec["worker_exit_codes"] == [0, 0]
    assert rec["collective_backend"] == "gloo"
    ws = rec["workers"]
    assert [w["process_id"] for w in ws] == [0, 1]
    assert all(w["process_count"] == 2 and w["local_devices"] == 1
               and w["global_devices"] == 2 for w in ws)
    assert ws[0]["losses"] == ws[1]["losses"]
    assert len(rec["single_process_losses"]) == multihost_harness.STEPS
    assert out.exists()


def test_single_process_reference_defaults_to_the_card(monkeypatch):
    """Without a device it asks for the card (resolve_device), and there is
    none here."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost_harness.single_process_reference()


def test_harness_batch_is_the_reference_s():
    ref = _reference_module("multihost_harness")
    for name in ("GLOBAL_BATCH", "ACCUM", "CANVAS", "VIEW", "STEPS"):
        assert getattr(multihost_harness, name) == getattr(ref, name), name
    ours, theirs = multihost_harness._batch_numpy(), ref._batch_numpy()
    assert ours.keys() == theirs.keys()
    for key in theirs:
        assert ours[key].dtype == theirs[key].dtype
        np.testing.assert_array_equal(ours[key], theirs[key])
    assert ref.pytest_approx_list([1.0, 2.0]) == (
        multihost_harness.pytest_approx_list([1.0, 2.0 + 1e-7]))


def test_each_process_loads_the_whole_batch_s_rows():
    """global_batch_from_host_local on each of two processes' rows
    (shard_batch's layout) puts exactly those rows of the global batch on
    the device; the two halves are the whole batch, each row once."""
    batch = multihost_harness._batch_numpy()
    n = multihost_harness.GLOBAL_BATCH * multihost_harness.ACCUM
    seen = []
    for rank in range(2):
        mesh = Mesh(None, rank, 2, torch.device("cpu"), "gloo")
        rows = local_rows(mesh, n, multihost_harness.ACCUM)
        assert len(rows) == local_batch_size(n, mesh) == n // 2
        tensors, copied = global_batch_from_host_local(
            mesh, {k: v[rows] for k, v in batch.items()})
        assert copied is None
        for key, value in tensors.items():
            np.testing.assert_array_equal(value.numpy(), batch[key][rows])
        seen.extend(rows.tolist())
    assert sorted(seen) == list(range(n))


# --------------------------------------------------------------------------
# bench_streams


@pytest.fixture(scope="module")
def stream_inputs():
    shape = (4, 8, 8, 32)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    r = rng.standard_normal(shape).astype(np.float32)
    g = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, shape[-1]).astype(np.float32)
    return x, r, g, b


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_stream_plain_versions_match_the_reference(stream_inputs, dtype):
    """copy and add bit-exact; bn_res_relu within 1e-6 relative in f32 and
    one bf16 ulp (XLA may contract x·g + b); the stats' mean and variance
    (the reference's f_stats reduces them and folds them back as zeros)
    within 1e-6 relative of its formulas, and its output x itself."""
    fns = _reference_stream_fns()
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    x, r, g, b = stream_inputs
    jx, jr = jnp.asarray(x, jdt), jnp.asarray(r, jdt)
    tx = torch.from_numpy(x).to(tdt)
    tr = torch.from_numpy(r).to(tdt)
    tg, tb = torch.from_numpy(g), torch.from_numpy(b)

    def as_np(t):
        return t.float().numpy()

    np.testing.assert_array_equal(
        as_np(streams.copy_plain(tx)),
        np.asarray(fns["f_copy"](jx), np.float32))
    np.testing.assert_array_equal(
        as_np(streams.add_plain(tx, tr)),
        np.asarray(fns["f_add"](jx, jr), np.float32))
    got = as_np(streams.bn_res_relu_plain(tx, tr, tg, tb))
    want = np.asarray(fns["f_bn_res_relu"](jx, jr, jnp.asarray(g),
                                           jnp.asarray(b)), np.float32)
    if dtype == "bf16":
        ulp = np.abs(want) * 2.0 ** -7 + 1e-30
        assert np.all(np.abs(got - want) <= ulp)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(fns["f_stats"](jx), np.float32), as_np(tx))
    sums = streams.stats_plain(tx).numpy()
    count = x.size // x.shape[-1]
    mean = sums[0] / count
    var = sums[1] / count - mean ** 2
    xs = jx.astype(jnp.float32)
    ref_mean = np.asarray(jnp.mean(xs, axis=(0, 1, 2)))
    ref_var = np.asarray(jnp.mean(jnp.square(xs), axis=(0, 1, 2))
                         - jnp.square(ref_mean))
    scale = np.abs(as_np(tx)).reshape(-1, x.shape[-1]).mean(0)
    assert np.all(np.abs(mean - ref_mean) <= 1e-6 * scale)
    np.testing.assert_allclose(var, ref_var, rtol=1e-6, atol=1e-6)


def test_stream_wrappers_take_the_plain_version_on_the_cpu(stream_inputs):
    x, r, g, b = (torch.from_numpy(v) for v in stream_inputs)
    out = torch.empty_like(x)
    assert streams.stream_copy(x, out=out) is out
    assert torch.equal(out, x + 1)
    assert torch.equal(streams.stream_add(x, r), x + r)
    assert torch.equal(streams.stream_bn_res_relu(x, r, g, b),
                       torch.relu(x * g + b + r))
    want = torch.stack([x.double().sum((0, 1, 2)),
                        (x.double() ** 2).sum((0, 1, 2))])
    torch.testing.assert_close(streams.stream_stats(x).double(), want,
                               rtol=1e-5, atol=1e-5)
    assert streams.stream_copy.launches == 0  # the plain version ran
    with pytest.raises(ValueError, match="no stream kernel"):
        streams.stream_copy(x.to("meta"))


def test_stream_paths():
    """The 16-byte path needs every base 16-byte aligned and, for the
    per-channel passes, C a multiple of the elements in 16 bytes."""
    x = torch.zeros(64, dtype=torch.bfloat16)
    assert streams.stream_path(x) == "vec16"
    assert streams.stream_path(x[1:]) == "scalar"
    assert streams.stream_path(x, channels=16) == "vec16"
    assert streams.stream_path(x, channels=12) == "scalar"
    assert streams.stream_path(x.float(), channels=12) == "vec16"


def test_bench_streams_runs_and_counts_its_bytes(tmp_path):
    art = bench_streams.main(["--device", "cpu", "--shape", "2,4,4,16",
                              "--iters", "2",
                              "--out", str(tmp_path / "s.json")])
    n = 2 * 4 * 4 * 16
    assert art["shape"] == [2, 4, 4, 16]
    for dtype, size in (("bf16", 2), ("f32", 4)):
        for pattern, nbytes in (("copy_1r1w", 2 * n * size),
                                ("add_2r1w", 3 * n * size),
                                ("bn_res_relu_2r1w", 3 * n * size + 128),
                                ("stats", n * size + 128)):
            case = art["cases"][f"{dtype}:{pattern}"]
            assert case["bytes"] == nbytes
            assert set(case) >= {"ms", "GBps", "share_of_peak", "eager",
                                 "path", "eager_over_kernel"}
    assert set(art["batchnorm_train"]) == {"dtype", "fwd", "fwd_bwd"}
    assert art["host_waits_in_windows"] == 0
    assert art["backend"] == "cpu"
    for dtype in ("bf16", "f32"):
        case = art["cases"][f"{dtype}:bn_res_relu_2r1w"]
        assert case["checked_with"] == bench_streams.CHECK_GB
        assert art["cases"][f"{dtype}:stats"]["tolerance"] == 1e-6


def test_bn_res_relu_check_draws_a_scale_and_shift_per_channel():
    """bench_streams holds bn_res_relu to its plain version with g and b
    that differ by channel and are neither 1 nor 0, so that a kernel that
    skips the multiply-add, or reads another channel's g and b, differs."""
    g, b = bench_streams.check_scale_shift(256, "cpu")
    assert g.dtype == b.dtype == torch.float32 and g.shape == b.shape == (256,)
    assert 0.5 <= g.min() and g.max() <= 1.5 and -1 <= b.min() and b.max() <= 1
    assert len(set(g.tolist())) == 256 and len(set(b.tolist())) == 256


# --------------------------------------------------------------------------
# without a card


@pytest.mark.parametrize("argv", [
    ("bench_multichip", []), ("bench_multichip", ["--scaling_table"]),
    ("multihost_harness", []), ("bench_streams", [])],
    ids=["weak", "table", "harness", "streams"])
def test_each_script_needs_a_card_unless_asked_for_the_cpu(monkeypatch,
                                                           tmp_path, argv):
    module, args = argv
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = {"bench_multichip": bench_multichip.main,
            "multihost_harness": multihost_harness.main,
            "bench_streams": bench_streams.main}[module]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args + ["--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()
