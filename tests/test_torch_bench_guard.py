"""The port's perf guard (peclr_tpu_torch/scripts/bench_guard.py) on the CPU
at a tiny shape: the four phases measured and held to the script's
references (keys, not rates: the CPU's rates are not the card's), the
bands computed from runs as PERF.md states, and the hot-path hash: stable,
and moved by a change to a kernel's CUDA source."""

import json
import os
import shutil

import pytest

from peclr_tpu_torch.scripts import bench_guard

PHASES = ("pretrain_rn50", "pretrain_rn152", "finetune", "pred")


def test_measure_phases_tiny_on_the_cpu():
    measured = bench_guard.measure_phases(1, 1, device="cpu", batch=2,
                                          accum=2, resnet="18")
    assert tuple(measured) == PHASES
    for name, got in measured.items():
        assert got["seconds"] > 0 and got["resnet"] == "18"
        assert got["images_per_step"] == (4 if name.startswith("pretrain")
                                          else 2)
        assert got["img_per_s"] == pytest.approx(
            got["images_per_step"] / got["seconds"])
    # the CPU's profile has no device events: busy is not measured here
    assert measured["finetune"]["busy_ms"] is None
    phases = bench_guard.verdict(measured)
    assert tuple(phases) == PHASES
    for name, p in phases.items():
        keys = {"img_per_sec", "reference_img_per_sec", "band", "ratio",
                "pass", "ms_per_step", "images_per_step", "resnet"}
        if name in bench_guard.PROFILED:
            keys |= {"wall_ms", "trace_busy_ms", "implied_gap_ms"}
        assert set(p) == keys, name
        ref = bench_guard.REFERENCE[name]
        assert p["ratio"] == pytest.approx(p["img_per_sec"] / ref["img_s"])
        assert p["pass"] == (p["ratio"] >= ref["band"])


@pytest.mark.parametrize("runs, band", [
    ([100.0, 99.0, 101.0], 0.98),       # capped at MAX_BAND
    ([100.0, 90.0, 101.0, 95.0], 0.92),  # 90 / 97.5 = 0.923 rounded down
    ([50.0, 45.5, 50.0], 0.91),
])
def test_band_is_the_lowest_run_over_the_median(runs, band):
    assert bench_guard.band_of(runs) == band


def test_band_needs_three_runs():
    with pytest.raises(ValueError):
        bench_guard.band_of([1.0, 1.0])


def test_calibrate_reads_the_runs(tmp_path):
    paths = []
    for i, scale in enumerate((1.0, 0.95, 1.02)):
        path = tmp_path / f"run{i}.json"
        path.write_text(json.dumps({"phases": {
            name: {"img_per_sec": 100.0 * scale * (j + 1)}
            for j, name in enumerate(PHASES)}}))
        paths.append(str(path))
    ref = bench_guard.calibrate(paths)
    assert ref["pretrain_rn50"] == {"img_s": 100.0, "band": 0.95,
                                    "runs": [100.0, 95.0, 102.0]}
    assert ref["pred"]["img_s"] == 400.0  # the median


def _copy_hot_path(dst):
    for rel in bench_guard.HOT_PATHS:
        src = os.path.join(bench_guard.REPO, rel)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(dst, rel),
                            ignore=shutil.ignore_patterns("__pycache__"))
        else:
            os.makedirs(os.path.dirname(os.path.join(dst, rel)),
                        exist_ok=True)
            shutil.copy(src, os.path.join(dst, rel))


def test_hot_path_hash_is_stable_and_sees_a_kernel_change(tmp_path):
    tree = bench_guard.hot_path_hash()
    assert tree == bench_guard.hot_path_hash()
    _copy_hot_path(str(tmp_path))
    assert bench_guard.hot_path_hash(str(tmp_path)) == tree
    # a file the hash does not read leaves it alone
    (tmp_path / "peclr_tpu_torch" / "csrc" / "notes.txt").write_text("x")
    assert bench_guard.hot_path_hash(str(tmp_path)) == tree
    kernel = tmp_path / "peclr_tpu_torch" / "csrc" / "shift_lerp.cu"
    kernel.write_text(kernel.read_text() + "\n// changed\n")
    assert bench_guard.hot_path_hash(str(tmp_path)) != tree


def test_check_reports_staleness(tmp_path):
    art = tmp_path / "guard.json"
    art.write_text(json.dumps({"hot_path_hash": bench_guard.hot_path_hash()}))
    assert bench_guard.main(["--check", "--out", str(art)])["fresh"]
    art.write_text(json.dumps({"hot_path_hash": "0" * 64}))
    report = bench_guard.main(["--check", "--out", str(art)])
    assert not report["fresh"] and report["tree_hash"] != "0" * 64
