"""The comparison that decides `correct`: the plain reference agrees with
the program at a tiny size on the CPU, piece by piece and through whole
runs; the control (the reference in the next precision below the
configuration's) and each fault planted in the timed path come out not
correct under the cells' own limits.  The `cuda` tests read the control at
each cell's own size on the card."""

import json
import os

import pytest
import torch

from benchmark import calibrate, run
from benchmark.harness import checks, common, faults, inputs
from benchmark.reference import augment, models, warp

DATA = os.path.join(common.BENCH_DIR, "tests", "data")
#: the tiny stand-in of each cell: (workload, config, traffic, entry)
TINY = {
    "pretrain-rn50-mb512": ("peclr-tiny", "recipe-tiny", "pretrain_step"),
    "finetune-rn50-crop128": ("rn25d-tiny", "finetune-tiny", "finetune_step"),
    "pred-rn50-leaderboard": ("rn25d-tiny", "leaderboard-tiny",
                              "two_pass_pred"),
}
KIND = {"pretrain_step": "pretrain", "finetune_step": "finetune",
        "two_pass_pred": "pred"}


def _cells():
    with open(os.path.join(common.REPO_ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


def _tiny_root(tmp_path, cell):
    """A data root holding the tiny stand-in of `cell` under the cell's name
    and with the cell's own limits."""
    import shutil

    config, traffic, entry = TINY[cell]
    root = tmp_path / "bench"
    shutil.copytree(DATA, root)
    limits = common.data_file("workloads", cell)["limits"]
    (root / "workloads").mkdir(exist_ok=True)
    (root / "workloads" / f"{cell}.json").write_text(json.dumps({
        "config": config, "traffic": traffic, "entry": entry, "chips": 1,
        "why": "tiny stand-in", "limits": limits}))
    return str(root)


def test_the_draws_are_the_programs():
    from peclr_tpu_torch.config.defaults import (
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.ops.augment import draw

    cfg = common.data_file("configs", "peclr-rn50")
    ours = augment.draw(torch.Generator().manual_seed(7), 6,
                        cfg["augmentation"]["flags"],
                        cfg["augmentation"]["params"])
    theirs = draw(torch.Generator().manual_seed(7), 6, peclr_pretrain_flags(),
                  AugmentationParams())
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k


@pytest.mark.parametrize("interp,route_scale", [("area", 2.05),
                                                ("linear", 3.0)])
def test_the_warp_agrees_with_the_programs(interp, route_scale):
    from peclr_tpu_torch.ops.warp_mxu import affine_warp_mxu

    gen = torch.Generator().manual_seed(3)
    img = inputs.frames(3, 40, gen, "cpu")
    ang = torch.tensor([10.0, -30.0, 0.0])
    rot = augment.rotation_about_center(ang, torch.full((3,), 20.0),
                                        torch.full((3,), 18.0))
    scale = torch.tensor([[0.5, 0.5, 1.0]]).T.expand(3, 3, 1)
    m = rot * scale
    ours = warp.two_pass_warp(img, m, (20, 20), route_scale, route_scale,
                              interp)
    theirs = affine_warp_mxu(img, m, (20, 20), interp=interp,
                             max_scale_x=route_scale, max_scale_y=route_scale)
    assert torch.allclose(ours, theirs, atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("kind", ["peclr", "rn25d"])
def test_the_models_agree_with_the_programs(kind):
    from peclr_tpu_torch.models import PeCLRModel, RN25DPose

    size = "18"
    layout = (models.peclr_layout if kind == "peclr" else
              models.rn25d_layout)(size)
    p = inputs.make_weights(layout, 9, "cpu")
    net = PeCLRModel(size) if kind == "peclr" else RN25DPose(size)
    net.load_state_dict(p, strict=True)
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    q = models.Precision("f32")
    with torch.no_grad():
        if kind == "peclr":
            net.train()
            ours = models.peclr_forward(x, p, size, q)
            theirs = net(x)["projection"]
        else:
            net.eval()
            K = torch.tensor(inputs.K_FREIHAND).expand(4, 3, 3)
            ours = models.rn25d_forward(x, K, p, size, q, train=False)["kp3d"]
            theirs = net(x, K=K)["kp3d"]
    assert torch.allclose(ours, theirs, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_a_tiny_run_is_correct_under_the_cells_limits(cell, tmp_path,
                                                      capsys):
    result = run.main(["--workload", cell, "--seed", "2999999993",
                       "--seconds", "0.3", "--trace", "0"],
                      root=_tiny_root(tmp_path, cell), device="cpu")
    assert result["correct"], result["checks"]
    assert result["failed"] == 0


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_control_is_not_correct(cell, tmp_path):
    root = _tiny_root(tmp_path, cell)
    spec = common.resolve_workload(cell, root)
    entry = common.entry_module(spec["entry"])
    lower = calibrate.LOWER[spec["config_data"]["precision"]["program"]]
    row = calibrate.one(entry, spec, 3000000007, torch.device("cpu"), 0.3,
                        control=lower)
    ok, compared = checks.judge(row["readings"], spec["limits"])
    assert not ok, compared


@pytest.mark.parametrize("entry", ["pretrain_step", "finetune_step"])
def test_the_compared_steps_do_not_depend_on_the_window(entry, tmp_path):
    """The steps compared after the window start from the seeded state
    whatever the window did: rewound, the same objects give what a run
    without a window gives, bit for bit (the CPU is deterministic)."""
    cell = next(c for c, v in TINY.items() if v[2] == entry)
    spec = common.resolve_workload(cell, _tiny_root(tmp_path, cell))
    module = common.entry_module(entry)
    results = []
    for seconds in (None, 0.3):
        runner = module.Runner(spec, 3000000019, torch.device("cpu"))
        runner.setup()
        if seconds:
            assert runner.window(seconds)["units"] >= 1
        runner.finish()
        results.append(runner.program_result())
    quiet, after = results
    assert quiet["losses"] == after["losses"]
    for key in ("first_grad", "params", "running"):
        for name, value in quiet[key].items():
            assert torch.equal(value, after[key][name]), (key, name)
    assert torch.equal(quiet["views"], after["views"])


def _planted_launches(counts):
    """route_launches that report one launch of the grouped kernel more at
    each look than the program made."""
    looks = [0]

    def route_launches():
        looks[0] += 1
        out = counts()
        out["shift_lerp_grouped"] += looks[0]
        return out

    return route_launches


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("planted", ["launches", "waits"])
def test_a_wrong_dispatch_is_not_correct(cell, planted, tmp_path,
                                         monkeypatch):
    """A run whose warp kernel launched otherwise than due, or that waited
    on the card inside a step or batch, is not correct."""
    if planted == "launches":
        monkeypatch.setattr(common, "route_launches",
                            _planted_launches(common.route_launches))
    else:
        monkeypatch.setattr(common, "host_waits",
                            lambda run: [run(), ["planted.py:1"]][1:])
    result = run.main(["--workload", cell, "--seed", "3000000013",
                       "--seconds", "0.3", "--trace", "0"],
                      root=_tiny_root(tmp_path, cell), device="cpu")
    name = "launch_gap" if planted == "launches" else "host_waits"
    assert result["checks"][name]["value"] > 0, result["checks"]
    assert not result["correct"]


FAULT_CASES = [(cell, fault) for cell in sorted(TINY)
               for fault in faults.FAULTS[KIND[TINY[cell][2]]]]


@pytest.mark.parametrize("cell,fault", FAULT_CASES)
def test_a_fault_in_the_timed_path_is_not_correct(cell, fault, tmp_path):
    root = _tiny_root(tmp_path, cell)
    with faults.plant(KIND[TINY[cell][2]], fault):
        result = run.main(["--workload", cell, "--seed", "3000000011",
                           "--seconds", "0.3", "--trace", "0"], root=root,
                          device="cpu")
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["finetune-rn50-crop128",
                                  "pred-rn50-leaderboard",
                                  "pretrain-rn50-mb512"])
def test_the_control_fails_at_the_cells_own_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    if cell not in _cells():
        pytest.skip(f"{cell} is not a cell of BENCHMARK.json")
    spec = common.resolve_workload(cell)
    entry = common.entry_module(spec["entry"])
    lower = calibrate.LOWER[spec["config_data"]["precision"]["program"]]
    for seed in (3000000101, 3000000103, 3000000107):
        row = calibrate.one(entry, spec, seed, torch.device("cuda"), 3.0,
                            control=lower)
        ok, compared = checks.judge(row["readings"], spec["limits"])
        assert not ok, compared
