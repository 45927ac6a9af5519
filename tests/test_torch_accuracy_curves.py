"""The reference's claims on the recipe-shape learning curves
(tests/test_accuracy_curves.py), case for case, over the port's card
artifacts.

`python -m peclr_tpu_torch.scripts.accuracy_proxy --probe-every 80
--curve-out ...` records, for PeCLR and SimCLR pretrained at the published
recipe's shape (microbatch 128 x accum 16, LARS at 1e-5, 128-px views, 640
steps, 4,096 synthetic frames), a frozen-encoder linear-probe EPE curve from
the shared random-init baseline, absolute and wrist-relative.  The port ran
the reference's six configurations (RN50 and RN152, seeds 5-7) on the H100
(tests/fixtures/torch_accuracy/accuracy_curves_*.json).  Every bound below is
the reference's, written once, beside the line of
tests/test_accuracy_curves.py that sets it.  These tests read the artifacts
only: no run, no JAX.
"""

import glob
import json
import os

import pytest

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "torch_accuracy")
#: (artifact name, resnet size, seed): the reference's six curves
#: (tests/test_accuracy_curves.py:40-47)
CURVES = [
    ("rn50", "50", 5),
    ("rn50_seed6", "50", 6),
    ("rn50_seed7", "50", 7),
    ("rn152", "152", 5),
    ("rn152_seed6", "152", 6),
    ("rn152_seed7", "152", 7),
]
RN50_CURVES = [name for name, size, _ in CURVES if size == "50"]
RN152_CURVES = [name for name, size, _ in CURVES if size == "152"]
#: the recipe's configuration, as the reference's artifacts record it
#: (bench_artifacts/accuracy_curves_*.json)
RECIPE = {"steps": 640, "batch": 128, "accum": 16, "optimizer": "LARS",
          "lr": 1e-5, "view": 128, "num_images": 4096, "probe_train": 3072,
          "probe_every": 80}
KINDS = ("peclr", "simclr")

#: at least this many probe points a curve (:108)
MIN_PROBES = 5
#: the warmup transient owns the first probe intervals: the global peak at
#: index <= 2 (:126)
PEAK_INDEX = 2
#: from probe index 2 on, no rise of more than 3% a point (:127-128)
RISE_PER_POINT = 1.03
#: the final probe below 0.85 of the step-0 baseline (:130)
FINAL_OVER_BASELINE = 0.85
#: the final probe below this share of the post-baseline peak (:133)
FINAL_OVER_PEAK = {"50": 0.75, "152": 0.85}
#: the two kinds' baselines equal (the same initial encoder) (:144)
BASELINE_TOL = 1e-6
#: the contrastive loss falls by more than 0.5 (:152)
LOSS_DROP = 0.5
#: RN50, three seeds: the absolute ratio's mean in this open band (:180)
RN50_ABS_BAND = (0.92, 1.06)
#: RN50: the wrist-relative ratio's mean below this (:182), and at least
#: this many seeds below 1 (:183)
RN50_REL_MEAN_BELOW, RN50_REL_SEEDS_BELOW_1 = 0.98, 2
#: RN152, three seeds: the absolute and wrist-relative ratios' means in
#: these open bands (:219-220), with at least 2 wrist-relative ratios (:214)
RN152_ABS_BAND, RN152_REL_BAND = (1.00, 1.15), (1.00, 1.18)
RN152_MIN_REL = 2

#: the claims the card's curves miss, with the card's numbers and the TPU's
#: (PERF.md §6-7, ROADMAP queue 3); strict, so a claim that holds fails
#: here.  For the RN50 ordering no fault of the port was found (initial
#: weights, precision and a longer parity run ruled out, PERF.md §7)
MISSED_RN50_ORDERING = (
    "the card's RN50 PeCLR/SimCLR ratios, seeds 5/6/7: absolute 1.345 / "
    "1.063 / 0.863 (mean 1.090, outside (0.92, 1.06)), wrist-relative "
    "1.434 / 1.067 / 0.930 (mean 1.144, not < 0.98; one seed below 1, not "
    "2); the TPU's 1.031 / 0.997 / 0.938 (0.989) and 0.918 / 0.990 / 0.884 "
    "(0.931)")
MISSED = {
    ("test_probe_epe_improves_monotonically",
     ("simclr", "rn152_seed7", "152", 7)):
        "the card's RN152 seed-7 SimCLR curve rises 3.4% from probe 6 to 7 "
        "(6.700 -> 6.926 px), past the 3% a point the TPU's runs kept "
        "(worst 2.47%); every other bound holds",
}


def _params(test, cases):
    """pytest params of `test`'s cases, those in MISSED strict xfails."""
    return [pytest.param(*case, marks=[
        pytest.mark.xfail(strict=True, reason=MISSED[(test, case)])]
        if (test, case) in MISSED else []) for case in cases]


def _load(name):
    path = os.path.join(FIXTURES, f"accuracy_curves_{name}.json")
    if not os.path.exists(path):
        pytest.fail(f"{path} missing: run python -m peclr_tpu_torch.scripts."
                    "accuracy_proxy --probe-every 80 --curve-out ... on the "
                    "card (README)")
    with open(path) as fh:
        d = json.load(fh)
    # written after every probe, complete only at the end of the run
    assert d["complete"] is True, f"{name}: partial artifact committed"
    return d


def _final_ratios(names):
    """Per artifact, the final probe's PeCLR/SimCLR ratios (absolute,
    wrist-relative)."""
    abs_ratios, rel_ratios = [], []
    for name in names:
        curves = _load(name)["curves"]
        p, s = curves["peclr"]["probe"][-1], curves["simclr"]["probe"][-1]
        abs_ratios.append(p["probe_epe_px"] / s["probe_epe_px"])
        if "probe_epe_rel_px" in p:
            rel_ratios.append(p["probe_epe_rel_px"] / s["probe_epe_rel_px"])
    return abs_ratios, rel_ratios


def test_every_curve_artifact_is_whitelisted_and_complete():
    """Every accuracy_curves_*.json of the port is complete (both kinds,
    each probe curve from step 0 to the configured last step) and in
    CURVES, so that the claims below run on it (:66-97)."""
    paths = sorted(glob.glob(os.path.join(FIXTURES, "accuracy_curves_*.json")))
    assert paths, "no curve artifacts committed"
    whitelisted = {f"accuracy_curves_{name}.json" for name, _, _ in CURVES}
    for path in paths:
        base = os.path.basename(path)
        with open(path) as fh:
            d = json.load(fh)
        assert d.get("complete") is True, f"{base}: partial artifact"
        assert set(d["curves"]) >= set(KINDS), base
        for kind in KINDS:
            probe = d["curves"][kind]["probe"]
            assert probe[0]["step"] == 0, (base, kind)
            assert probe[-1]["step"] == d["config"]["steps"], (base, kind)
        assert base in whitelisted, f"{base} is not in CURVES"


@pytest.mark.parametrize("name,size,seed", CURVES)
def test_recipe_shape_config(name, size, seed):
    """The reference's configuration of the curve exactly (:101-108), run on
    the card, which the artifact names."""
    d = _load(name)
    cfg = d["config"]
    assert {k: cfg[k] for k in RECIPE} == RECIPE, cfg
    assert (cfg["resnet"], cfg["seed"]) == (size, seed), cfg
    assert d["backend"] == "cuda" and "," in d["device"], d["device"]
    for kind in KINDS:
        assert len(d["curves"][kind]["probe"]) >= MIN_PROBES


@pytest.mark.parametrize("kind,name,size,seed", _params(
    "test_probe_epe_improves_monotonically",
    [(kind,) + case for kind in KINDS for case in CURVES]))
def test_probe_epe_improves_monotonically(kind, name, size, seed):
    """The LARS warmup's transient within the first two probe intervals,
    then a descent up to 3% probe noise a point, well below the baseline
    and the post-baseline peak (:111-134)."""
    epes = [p["probe_epe_px"] for p in _load(name)["curves"][kind]["probe"]]
    peak_i = max(range(len(epes)), key=lambda i: epes[i])
    assert peak_i <= PEAK_INDEX, (name, kind, epes)
    for prev, cur in zip(epes[2:], epes[3:]):
        assert cur < prev * RISE_PER_POINT, (name, kind, epes)
    assert epes[-1] < FINAL_OVER_BASELINE * epes[0], (name, kind, epes)
    assert epes[-1] < FINAL_OVER_PEAK[size] * max(epes[1:]), (name, kind, epes)


@pytest.mark.parametrize("name,size,seed", CURVES)
def test_shared_random_init_baseline(name, size, seed):
    """The same seed gives both kinds the same initial encoder, so the same
    step-0 probe (:137-144)."""
    curves = _load(name)["curves"]
    p0, s0 = curves["peclr"]["probe"][0], curves["simclr"]["probe"][0]
    assert p0["step"] == s0["step"] == 0
    assert abs(p0["probe_epe_px"] - s0["probe_epe_px"]) < BASELINE_TOL


@pytest.mark.parametrize("name,size,seed", CURVES)
@pytest.mark.parametrize("kind", KINDS)
def test_contrastive_loss_decreases(name, size, seed, kind):
    loss = _load(name)["curves"][kind]["loss"]
    assert loss[-1] < loss[0] - LOSS_DROP, (name, kind, loss[0], loss[-1])


@pytest.mark.xfail(strict=True, reason=MISSED_RN50_ORDERING)
def test_recipe_shape_ordering_multiseed():
    """RN50 over three seeds (:155-183): on absolute keypoints the two
    objectives tie (the mean ratio in RN50_ABS_BAND); on wrist-relative
    pose PeCLR is better (the mean below RN50_REL_MEAN_BELOW, at least
    RN50_REL_SEEDS_BELOW_1 seeds below 1).  The TPU's ratios: absolute
    1.031 / 0.997 / 0.938, wrist-relative 0.918 / 0.990 / 0.884."""
    abs_ratios, rel_ratios = _final_ratios(RN50_CURVES)
    mean_abs = sum(abs_ratios) / len(abs_ratios)
    mean_rel = sum(rel_ratios) / len(rel_ratios)
    assert RN50_ABS_BAND[0] < mean_abs < RN50_ABS_BAND[1], abs_ratios
    assert mean_rel < RN50_REL_MEAN_BELOW, rel_ratios
    assert sum(r < 1.0 for r in rel_ratios) >= RN50_REL_SEEDS_BELOW_1, (
        rel_ratios)


def test_recipe_shape_ordering_multiseed_rn152():
    """RN152 over three seeds (:186-220): SimCLR's probe ahead on both
    targets, the mean ratios in RN152_ABS_BAND and RN152_REL_BAND.  The
    TPU's ratios: absolute 1.070 / 1.108 / 1.076, wrist-relative (seeds
    6-7) 1.113 / 1.077."""
    abs_ratios, rel_ratios = _final_ratios(RN152_CURVES)
    assert len(abs_ratios) == 3 and len(rel_ratios) >= RN152_MIN_REL
    mean_abs = sum(abs_ratios) / len(abs_ratios)
    mean_rel = sum(rel_ratios) / len(rel_ratios)
    assert RN152_ABS_BAND[0] < mean_abs < RN152_ABS_BAND[1], abs_ratios
    assert RN152_REL_BAND[0] < mean_rel < RN152_REL_BAND[1], rel_ratios
