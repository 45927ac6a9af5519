"""The port's accuracy proxy (peclr_tpu_torch/scripts/accuracy_proxy.py)
against the reference's scripts/accuracy_proxy.py on the CPU, and the
reference's claims on the port's committed card artifacts.

Parity: the synthetic frames and the probe's ridge solve are bit-equal, the
embedding agrees with the reference model's in f32 (rtol 5e-3, as
tests/test_torch_pretrain_models.py: f32 convolutions summed in another
order), and both pretrain loops take the same pool indices a step.

Artifacts (tests/fixtures/torch_accuracy/, written on the H100 by
`python -m peclr_tpu_torch.scripts.accuracy_proxy`): a card record of each
of the reference's configurations, and the claims of
tests/test_accuracy_proxy.py, fixed before any card run; each record names
its card.  The recipe curves' claims are tests/test_torch_accuracy_curves.py.
"""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peclr_tpu.models import PeCLRModel as JaxPeCLR
from peclr_tpu.ops import image as jax_image
from peclr_tpu_torch.data.synthetic import seeded_peclr_variables
from peclr_tpu_torch.models import PeCLRModel
from peclr_tpu_torch.models.port import peclr_variables_to_state_dict
from peclr_tpu_torch.scripts import accuracy_proxy as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_accuracy")
PROXY = os.path.join(FIXTURES, "accuracy_proxy.jsonl")
REFERENCE_PROXY = os.path.join(REPO, "tests", "fixtures",
                               "accuracy_proxy.jsonl")
#: the reference's records leave out the flags that were at their defaults
PROXY_DEFAULTS = {"accum": 1, "optimizer": "adam", "lr": 5e-5,
                  "probe_every": 0}
#: the 64-px records with at least 300 steps: (resnet, seed, steps), at
#: batch 64, 2,048 images, probe on 1,536, Adam, lr 5e-5
RECORDS_64PX = [("18", 5, 400), ("18", 5, 800), ("18", 6, 400),
                ("50", 5, 600), ("50", 5, 360), ("50", 6, 360),
                ("50", 7, 360), ("152", 5, 360), ("152", 6, 360),
                ("152", 7, 360)]


def _reference():
    spec = importlib.util.spec_from_file_location(
        "reference_accuracy_proxy",
        os.path.join(REPO, "scripts", "accuracy_proxy.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref = _reference()


def test_hand_template_and_frames_are_bit_equal():
    np.testing.assert_array_equal(port.hand_template(), ref.hand_template())
    for canvas in (128, 64):
        got = port.render_batch(np.random.default_rng(5), 6, canvas)
        want = ref.render_batch(np.random.default_rng(5), 6, canvas)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_linear_probe_is_bit_equal_on_the_same_embeddings():
    """Both probes given the same embeddings (a fixed projection of the
    frames): {"abs", "rel"} equal to the bit."""
    imgs, joints = ref.render_batch(np.random.default_rng(7), 300, 64)
    proj = np.random.default_rng(8).normal(size=(32 * 32 * 3, 48)).astype(
        np.float32)

    def features(chunk):
        return (np.asarray(chunk, np.float32).reshape(len(chunk), -1) / 255.0
                ) @ proj

    got = port.linear_probe(lambda c: torch.from_numpy(features(c)), imgs,
                            joints, 32, 200, 5)
    want = ref.linear_probe(lambda c: features(np.asarray(c)), imgs, joints,
                            32, 200, 5)
    assert got == want


def test_embedding_matches_the_reference_model():
    """make_embed against the reference's make_embed (its PeCLRModel in
    f32, normalize_imagenet of the uint8 frames, train=False): RN18, 64 px,
    4 frames, the same seeded weights."""
    variables = seeded_peclr_variables("18", seed=3)
    imgs, _ = ref.render_batch(np.random.default_rng(9), 4, 64)
    model = JaxPeCLR(resnet_size="18", dtype=jnp.float32)
    want = np.asarray(model.apply(
        variables, jax_image.normalize_imagenet(
            jnp.asarray(imgs).astype(jnp.float32) / 255.0),
        train=False)["embedding"])
    torch_model = PeCLRModel("18")
    torch_model.load_state_dict(peclr_variables_to_state_dict(variables, "18"),
                                strict=True)
    got = port.make_embed(torch_model)(imgs)  # f32 on the CPU
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-3,
                               atol=5e-3 * np.abs(want).max())


def test_pretrain_takes_the_reference_index_stream(monkeypatch):
    """Each step's microbatches are the pool rows default_rng(1000 * seed
    + i) draws, on both sides (accum 2: a step's rows split in order)."""
    import peclr_tpu.train.step as jax_step
    import peclr_tpu_torch.train.step as torch_step

    imgs, joints = ref.render_batch(np.random.default_rng(4), 16, 32)
    seen = {"ref": [], "port": []}

    def jax_factory(*args, **kwargs):
        def step(state, batch, key):
            seen["ref"].append(np.asarray(batch["image"]))
            return state, {"loss": jnp.zeros(())}
        return step

    def torch_factory(*args, **kwargs):
        def step(state, batch, generator):
            seen["port"].append(batch["image"].numpy().copy())
            return state, {"loss": torch.zeros(())}
        return step

    monkeypatch.setattr(jax_step, "make_peclr_train_step", jax_factory)
    monkeypatch.setattr(torch_step, "make_peclr_train_step", torch_factory)
    common = dict(steps=3, batch=4, seed=5, view=32, resnet="18", accum=2)
    ref.pretrain("peclr", imgs, joints, **common)
    port.pretrain("peclr", imgs, joints, device="cpu", **common)
    assert len(seen["ref"]) == len(seen["port"]) == 3
    for i, (got, want) in enumerate(zip(seen["port"], seen["ref"])):
        rows = np.random.default_rng(5000 + i).integers(0, 16, 8)
        np.testing.assert_array_equal(want, imgs[rows])
        np.testing.assert_array_equal(got, want)


def test_record_splits_each_run_into_setup_first_step_and_steps(tmp_path):
    """A record times each kind's setup, first step and the steps after it
    apart (the kind that runs first pays the process's one-time costs
    there), its steps_per_s over the steps after the first; the probes are
    left out of each."""
    out = tmp_path / "proxy.jsonl"
    record = port.main(["--resnet", "18", "--steps", "3", "--batch", "4",
                        "--num-images", "24", "--probe-train", "16",
                        "--view", "32", "--probe-every", "2",
                        "--device", "cpu", "--out", str(out)])
    for kind in ("peclr", "simclr"):
        r = record[kind]
        assert min(r["setup_seconds"], r["first_step_seconds"],
                   r["steps_seconds"], r["probe_seconds"]) > 0, r
        assert (r["setup_seconds"] + r["first_step_seconds"]
                + r["steps_seconds"]) <= r["pretrain_seconds"] + 1e-6, r
        assert r["steps_per_s"] == pytest.approx(2 / r["steps_seconds"])
    assert json.loads(out.read_text())["config"]["steps"] == 3


# ---------------------------------------------------------------------------
# The committed card artifacts


def _records():
    with open(PROXY) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _record(resnet, seed, steps):
    found = [r for r in _records()
             if r["config"]["view"] == 64 and r["config"]["resnet"] == resnet
             and r["config"]["seed"] == seed and r["config"]["steps"] == steps]
    assert len(found) == 1, (resnet, seed, steps, len(found))
    return found[0]


def test_proxy_records_are_the_card_runs_of_the_configs():
    """One card record for each record of the reference's
    tests/fixtures/accuracy_proxy.jsonl, with its configuration (the curve's
    path apart), and the 64-px records of RECORDS_64PX among them."""
    with open(REFERENCE_PROXY) as fh:
        configs = [json.loads(line)["config"] for line in fh if line.strip()]
    records = _records()
    for ref_cfg in configs:
        want = {k: v for k, v in {**PROXY_DEFAULTS, **ref_cfg}.items()
                if k != "curve_out"}
        found = [r for r in records
                 if {k: r["config"].get(k) for k in want} == want]
        assert len(found) == 1, (want, len(found))
        r = found[0]
        assert r["backend"] == "cuda" and "," in r["device"], r["device"]
        for kind in ("peclr", "simclr"):
            assert r[kind]["probe_epe_px"] > 0
            assert np.isfinite(r[kind]["final_loss"])
    assert len(records) == len(configs)
    for resnet, seed, steps in RECORDS_64PX:
        cfg = _record(resnet, seed, steps)["config"]
        assert (cfg["batch"], cfg["num_images"], cfg["probe_train"],
                cfg["accum"], cfg["optimizer"], cfg["lr"]) == (
            64, 2048, 1536, 1, "adam", 5e-5), cfg


def test_primary_record_peclr_beats_simclr():
    """The primary 64-px record (RN18, seed 5, 800 steps): PeCLR's probe
    beats SimCLR's by at least 3% (the TPU's ratio was 0.901)."""
    r = _record("18", 5, 800)
    assert r["epe_ratio_peclr_over_simclr"] < 0.97, r


#: records whose card run missed the claim, with their ratio and the TPU's
#: (ROADMAP queue 3); strict, so a record that meets it fails here
MISSED = {
    ("18", 6, 400): "the card's ratio is 1.0635 (PeCLR 4.092 px, SimCLR "
                    "3.848); the TPU's was 0.994",
    ("50", 7, 360): "the card's ratio is 1.0333 (PeCLR 14.766 px, SimCLR "
                    "14.290); the TPU's was 0.898",
}


@pytest.mark.parametrize("resnet,seed,steps", [
    pytest.param(*config, id=f"rn{config[0]}_seed{config[1]}_{config[2]}",
                 marks=([pytest.mark.xfail(strict=True, reason=MISSED[config])]
                        if config in MISSED else []))
    for config in RECORDS_64PX])
def test_peclr_beats_simclr_in_every_64px_record(resnet, seed, steps):
    """Every 64-px record of 300 steps or more: ratio below 1 (the TPU's
    worst was 0.994)."""
    r = _record(resnet, seed, steps)
    assert r["epe_ratio_peclr_over_simclr"] < 1.0, r
