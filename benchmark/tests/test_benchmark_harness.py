"""The harness: its files are found by name, a cell added as data files
runs without an edit, the counts match hand counts, and no run loads JAX
or the JAX package."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch
import torch.nn.functional as F

from benchmark import run
from benchmark.harness import common, counts
from benchmark.reference import models

ROOT = common.REPO_ROOT
BENCH = common.BENCH_DIR
DATA = os.path.join(BENCH, "tests", "data")


def _benchmark_json():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_file_of_benchmark_json_is_found_by_name():
    bench = _benchmark_json()
    for cfg in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, cfg["file"]))
        assert common.data_file("configs", cfg["name"])["name"] == cfg["name"]
    readers = common.metric_readers()
    for cell in bench["workloads"]:
        spec = common.resolve_workload(cell["name"])
        assert (spec["config"], spec["traffic"], spec["chips"]) == (
            cell["config"], cell["traffic"], cell["chips"])
        entry = common.entry_module(spec["entry"])
        assert hasattr(entry, "Runner") and entry.KIND
        assert spec["limits"]
    for group, kind in (("end_to_end", "end_to_end"),
                        ("per_layer", "per_layer")):
        for metric in bench[group]:
            module = readers[metric["name"]]
            assert module.KIND == kind and module.UNIT == metric["unit"]


def test_a_reader_with_nothing_to_read_returns_nothing():
    ctx = {"kind": "pred", "window": {"units": 3, "images": 6, "seconds": 1.0,
                                      "latencies_s": [0.1, 0.2, 0.3]},
           "setup_s": 1.0, "counts": {}, "trace": None}
    for name, module in common.metric_readers().items():
        value = module.read(ctx)
        if name in ("setup_s", "pred_img_s", "pred_p95_ms"):
            assert value is not None and value > 0
        else:
            assert value is None, name


def _tiny_cell(tmp_path, name, config, traffic, entry, limits):
    root = tmp_path / "bench"
    shutil.copytree(DATA, root)
    (root / "workloads").mkdir(exist_ok=True)
    (root / "workloads" / f"{name}.json").write_text(json.dumps({
        "config": config, "traffic": traffic, "entry": entry, "chips": 1,
        "why": "a cell added as data files", "limits": limits}))
    return str(root)


def test_a_cell_added_in_a_temporary_directory_runs(tmp_path, capsys):
    root = _tiny_cell(tmp_path, "added", "rn25d-tiny", "leaderboard-tiny",
                      "two_pass_pred", {"pass1_gap": 1e-4, "pass2_gap": 1e-4})
    result = run.main(["--workload", "added", "--seed", "3000000019",
                       "--seconds", "0.5", "--trace", "0"], root=root,
                      device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(result))
    assert result["correct"] and result["attempted"] >= 1
    assert set(result["metrics"]) == {"setup_s", "pred_img_s", "pred_p95_ms"}
    assert list(result)[-1] == "checks"


def _conv_flops_by_hooks(fn):
    """FLOPs of the convolutions and dense layers fn() calls, from the
    shapes of the tensors they get."""
    total = [0]
    conv, linear = F.conv2d, F.linear

    def counted_conv(x, w, *a, **kw):
        out = conv(x, w, *a, **kw)
        total[0] += 2 * out.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        return out

    def counted_linear(x, w, *a, **kw):
        out = linear(x, w, *a, **kw)
        total[0] += 2 * out.numel() * w.shape[1]
        return out

    F.conv2d, F.linear = counted_conv, counted_linear
    try:
        fn()
    finally:
        F.conv2d, F.linear = conv, linear
    return total[0]


@pytest.mark.parametrize("size,h", [("18", 32), ("50", 64), ("50", 37)])
def test_flop_counts_match_the_model_run(size, h):
    from benchmark.harness import inputs

    q = models.Precision("f32")
    p = inputs.make_weights(models.peclr_layout(size), 1, "cpu")
    x = torch.zeros(1, h, h, 3)
    got = _conv_flops_by_hooks(lambda: models.peclr_forward(
        torch.cat([x, x]), p, size, q))
    assert got == 2 * counts.peclr_forward_flops(size, h)
    p = inputs.make_weights(models.rn25d_layout(size), 1, "cpu")
    K = torch.eye(3).expand(2, 3, 3)
    got = _conv_flops_by_hooks(lambda: models.rn25d_forward(
        torch.cat([x, x]), K, p, size, q, train=False))
    assert got == 2 * counts.rn25d_forward_flops(size, h)


def test_flop_and_byte_counts_by_hand():
    # one 3x3 conv, 4x4 image, 3 -> 8 channels: 16 outputs x 8 x 27 MACs
    assert counts.conv_flops(4, 4, 3, 8, 3, 1)[0] == 2 * 16 * 8 * 27
    # ResNet-50 at 224^2: 4.09 GMACs in the trunk (He et al. 2016: 3.8e9
    # counting the stages' multiply-adds alone)
    trunk, embed = counts.resnet_trunk_flops("50", 224, 224)
    assert embed == 2048 and abs(trunk / 2 - 4.089e9) < 0.01e9
    # two images 8x8 -> 4x4, 3 channels, u8 source, bf16 rows: U = V = 128
    b = counts.warp_pass_bytes(2, (8, 8), (4, 4), 3, 1, 2, 2.05, 2.05)
    assert b["pass1"] == 3 * 16 * 8 * 1 + 16 * 8 + 3 * 16 * 128 * 2
    assert b["pass2"] == 3 * 8 * 8 * 2 + 8 * 8 + 3 * 8 * 128 * 2


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "peclr_tpu_torch_lookalike", sys)
    assert "peclr_tpu_torch_lookalike" not in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "peclr_tpu.x", sys)
    assert "peclr_tpu.x" in common.forbidden_modules()


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.argv = ['run.py']\n"
        "import runpy, os\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from benchmark import run, calibrate\n"
        "from benchmark.harness import common\n"
        "for n in ('pretrain_step', 'finetune_step', 'two_pass_pred'):\n"
        "    common.entry_module(n)\n"
        "common.metric_readers()\n"
        "import benchmark.reference.train, benchmark.reference.pred\n"
        "import peclr_tpu_torch.train.step, peclr_tpu_torch.train.finetune\n"
        "import peclr_tpu_torch.eval.pred_fh, peclr_tpu_torch.models\n"
        "import peclr_tpu_torch.train.optimizer, peclr_tpu_torch.ops.augment\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]
                          .replace("'", '"')))
    assert "peclr_tpu_torch" in tops
    assert not tops & common.FORBIDDEN_MODULES


def test_the_reference_imports_nothing_of_the_program():
    import ast

    for fname in os.listdir(os.path.join(BENCH, "reference")):
        if not fname.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(BENCH, "reference", fname)).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert name.split(".")[0] in ("torch", "numpy", "math",
                                              "typing", "__future__",
                                              "benchmark"), (fname, name)
                assert not name.startswith("benchmark.") or \
                    name.startswith("benchmark.reference"), (fname, name)


def test_without_a_card_a_run_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, os.path.join("benchmark", "run.py"), "--workload",
         _benchmark_json()["workloads"][0]["name"], "--seed", "5",
         "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_a_run_fails(tmp_path):
    bench = _benchmark_json()
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for path in bench["paths"]:
        shutil.copytree(os.path.join(ROOT, path), tmp_path / path,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable] + bench["command"][1:] + [
            "--workload", bench["workloads"][0]["name"], "--seed", "5",
            "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
