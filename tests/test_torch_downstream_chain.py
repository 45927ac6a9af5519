"""The port's downstream chain (peclr_tpu_torch/scripts/downstream_chain.py)
against the reference's scripts/downstream_chain.py on the CPU, a run of
the port's chain at a tiny size, and the reference's claims on the port's
committed card artifact.

Parity:
  * both scripts draw the same pool rows a step, pretraining and
    fine-tuning;
  * the frozen fine-tune, 2 steps of RN25DPose at RN18, 64² crops, batch
    4, from the same initial weights (those of tests/test_torch_finetune.py,
    whose fc places the keypoints inside the crop: from flax's initial fc
    they bunch near the origin, and the z-root MLP's division by a bone
    length amplifies the two sides' f32 differences past its tolerance)
    and the same PeCLR encoder, the port fed the
    reference's draws (op by op, as tests/test_torch_finetune.py does, and
    at its base lr 1e-6 for the same reason): the backbone's parameters
    unchanged to the bit and its BatchNorm statistics moved, on both sides;
    fc and the z-root MLP within that file's tolerances (2e-5, statistics
    1e-4 of their scale); evaluate() of the two results, fed the same
    draws, within 1e-3 relative (or 1e-6 m, for the recreated-3D check's
    rounding-level error) on the EPEs (two f32 models of the same weights)
    and 0.02 on the AUCs (tests/test_eval.py's bound on an AUC);
  * the .pth round trip bit-exact, and a dropped entry found.

Artifact (tests/fixtures/torch_accuracy/downstream_chain.json, written on
the H100): the claims of tests/test_downstream_chain.py, fixed before the
card run.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import peclr_tpu.train.finetune as jax_finetune
import peclr_tpu.train.optimizer as jax_optimizer
import peclr_tpu.train.step as jax_step
import peclr_tpu_torch.eval.evaluate as torch_evaluate
import peclr_tpu_torch.train.finetune as torch_finetune
import peclr_tpu_torch.train.optimizer as torch_optimizer
import peclr_tpu_torch.train.step as torch_step
from peclr_tpu.config.defaults import AugmentationFlags as JaxFlags
from peclr_tpu.config.defaults import AugmentationParams as JaxParams
from peclr_tpu.eval.evaluate import supervised_sample_batch as jax_sample
import peclr_tpu.models as jax_models
from peclr_tpu.models import RN25DPose as JaxRN25D
from peclr_tpu.ops.augment import augment_batch
from peclr_tpu_torch.data.synthetic import (
    generate_freihand_like,
    seeded_peclr_variables,
    seeded_rn25d_variables,
)
from peclr_tpu_torch.models.port import (
    peclr_variables_to_state_dict,
    rn25d_variables_to_state_dict,
)
from peclr_tpu_torch.scripts import downstream_chain as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "tests", "fixtures", "torch_accuracy",
                        "downstream_chain.json")
SIZE, CROP, B, SEED, STEPS = "18", 64, 4, 5, 2
TIERS = ["none", "peclr_quarter", "peclr_full", "peclr_full_pth_roundtrip",
         "simclr_full"]


def _reference():
    spec = importlib.util.spec_from_file_location(
        "reference_downstream_chain",
        os.path.join(REPO, "scripts", "downstream_chain.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ref = _reference()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("chain_fh"))
    generate_freihand_like(root, num_unique=4, seed=11)
    train, _ = port.collect_pool(root, "train", 0.75, SEED, B)
    val, _ = port.collect_pool(root, "val", 0.75, SEED, B)
    return train, val


class _Stop(Exception):
    pass


def test_index_streams_equal_the_reference(monkeypatch, pools):
    """Pretraining takes default_rng(77 * seed + i) rows a step and
    fine-tuning default_rng(99 * seed + i), on both sides."""
    train, _ = pools
    seen = {}

    def recorder(side, array_of, loss, stop_at=None):
        def factory(*args, **kwargs):
            def step(state, batch, key_or_gen):
                seen.setdefault(side, []).append(array_of(batch["image"]))
                if stop_at is not None and len(seen[side]) == stop_at:
                    raise _Stop
                return state, {"loss": loss}
            return step
        return factory

    monkeypatch.setattr(jax_step, "make_peclr_train_step",
                        recorder("ref_pre", np.asarray, jnp.zeros(())))
    monkeypatch.setattr(torch_step, "make_peclr_train_step",
                        recorder("port_pre", lambda t: t.numpy().copy(),
                                 torch.zeros(())))
    kinds_at = [("none", "peclr", 0), ("q", "peclr", 1), ("full", "peclr", 3)]
    args = (train, 3, B, SEED, 32, SIZE, kinds_at)
    got = port.pretrain_encoders(*args, device="cpu")
    want = ref.pretrain_encoders(*args)
    assert set(got) == set(want) == {"q", "full"}

    monkeypatch.setattr(jax_finetune, "make_finetune_step",
                        recorder("ref_ft", np.asarray, jnp.zeros(()), 3))
    monkeypatch.setattr(torch_finetune, "make_finetune_step",
                        recorder("port_ft", lambda t: t.numpy().copy(),
                                 torch.zeros(()), 3))
    for fn, kw in ((ref.finetune_and_eval, {}),
                   (port.finetune_and_eval, {"device": "cpu"})):
        with pytest.raises(_Stop):
            fn(None, train, train, 3, B, SEED, CROP, SIZE, **kw)

    n = len(train["image"])
    for side, base in (("pre", 77), ("ft", 99)):
        assert len(seen[f"ref_{side}"]) == len(seen[f"port_{side}"]) == 3
        for i in range(3):
            rows = np.random.default_rng(base * SEED + i).integers(0, n, B)
            np.testing.assert_array_equal(seen[f"ref_{side}"][i],
                                          train["image"][rows])
            np.testing.assert_array_equal(seen[f"port_{side}"][i],
                                          seen[f"ref_{side}"][i])


def _op_by_op_sample(key, batch, flags, params, use_palm=False):
    """The reference's supervised sample, run op by op from inside its
    jitted step (tests/test_torch_finetune.py)."""
    def host(k, b):
        out = jax_sample(jnp.asarray(k),
                         {n: jnp.asarray(v) for n, v in b.items()},
                         flags, params, use_palm)
        return {n: np.asarray(v) for n, v in out.items()}

    shapes = jax.eval_shape(
        lambda k, b: jax_sample(k, b, flags, params, use_palm), key, batch)
    return jax.pure_callback(host, shapes, key, batch)


def _ref_draws(key, batch):
    jflags = JaxFlags(crop=True, resize=True)
    jparams = JaxParams(resize_shape=(CROP, CROP))
    drawn = augment_batch(key, jnp.asarray(np.asarray(batch["image"])),
                          jnp.asarray(np.asarray(batch["joints25d"])),
                          jflags, jparams).params
    return {k: torch.from_numpy(np.array(v)) for k, v in drawn.items()}


@pytest.fixture(scope="module")
def frozen_runs(pools):
    """The frozen fine-tune on both sides (module docstring)."""
    train, val = pools
    patch = pytest.MonkeyPatch()
    init = seeded_rn25d_variables(SIZE, seed=1)

    class SeededRN25D(JaxRN25D):
        def init(self, *args, **kwargs):
            return jax.tree_util.tree_map(jnp.asarray, init)
    encoder_vars = seeded_peclr_variables(SIZE, seed=3)
    encoder_sd = peclr_variables_to_state_dict(encoder_vars, SIZE)

    def load_reference_init(model, seed):
        model.load_state_dict(rn25d_variables_to_state_dict(init, SIZE),
                              strict=True)
        return model

    real_build = jax_optimizer.build_optimizer
    real_torch_build = torch_optimizer.build_optimizer
    real_step = torch_finetune.make_finetune_step
    real_evaluate = torch_evaluate.evaluate

    def port_step(*args, **kwargs):
        step, count = real_step(*args, **kwargs), [0]

        def with_reference_draws(state, batch, generator):
            key = jax.random.fold_in(jax.random.PRNGKey(SEED + 1), count[0])
            count[0] += 1
            return step(state, batch, None, draws=_ref_draws(key, batch))
        return with_reference_draws

    def port_evaluate(predict, pipeline, flags, aug, num_batches, device):
        draws = [_ref_draws(jax.random.fold_in(jax.random.PRNGKey(0), i), b)
                 for i, b in enumerate(pipeline.batches(num_batches))]
        return real_evaluate(predict, pipeline, flags, aug,
                             num_batches=num_batches, device=device,
                             draws=draws)

    patch.setattr(jax_optimizer, "build_optimizer",
                  lambda *a, **kw: real_build(*a, **{**kw, "base_lr": 1e-6}))
    patch.setattr(torch_optimizer, "build_optimizer",
                  lambda *a, **kw: real_torch_build(
                      *a, **{**kw, "base_lr": 1e-6}))
    patch.setattr(jax_finetune, "supervised_sample_batch", _op_by_op_sample)
    patch.setattr(jax_models, "RN25DPose", SeededRN25D)
    patch.setattr(port, "init_as_reference", load_reference_init)
    patch.setattr(torch_finetune, "make_finetune_step", port_step)
    patch.setattr(torch_evaluate, "evaluate", port_evaluate)
    try:
        want, final_vars, _ = ref.finetune_and_eval(
            encoder_vars, train, val, STEPS, B, SEED, CROP, SIZE,
            freeze_encoder=True)
        log = {}
        got, model = port.finetune_and_eval(
            encoder_sd, train, val, STEPS, B, SEED, CROP, SIZE,
            freeze_encoder=True, device="cpu", log=log)
    finally:
        patch.undo()
    start = load_reference_init(_rn25d(), SEED)
    torch_finetune.load_pretrained_encoder(start, encoder_sd)
    return dict(
        start={k: v.detach().numpy().copy()
               for k, v in start.state_dict().items()},
        port={k: v.detach().numpy().copy()
              for k, v in model.state_dict().items()},
        ref=rn25d_variables_to_state_dict(
            jax.tree_util.tree_map(np.asarray, final_vars), SIZE),
        results=(got, want), log=log)


def _rn25d():
    from peclr_tpu_torch.models import RN25DPose

    return RN25DPose(SIZE)


def test_frozen_backbone_is_unchanged_and_its_statistics_move(frozen_runs):
    """On both sides the backbone's parameters (fc aside) end equal to the
    bit to the loaded encoder, and its BatchNorm statistics move."""
    start = frozen_runs["start"]
    assert frozen_runs["log"]["finetune_finetune"]["frozen_backbone_bitexact"]
    params = {name for name, _ in _rn25d().named_parameters()}
    for side in ("port", "ref"):
        end, moved = frozen_runs[side], 0
        for name, value in start.items():
            if not port._frozen(name):
                continue
            if name in params:
                np.testing.assert_array_equal(np.asarray(end[name]), value,
                                              err_msg=f"{side} {name}")
            elif "running" in name:
                moved += not np.array_equal(np.asarray(end[name]), value)
        assert moved > 0, side


def test_head_matches_the_reference(frozen_runs):
    """fc and the z-root MLP: parameters within 2e-5, BatchNorm statistics
    within 1e-4 of their scale (tests/test_torch_finetune.py); both moved."""
    got, want, start = (frozen_runs[k] for k in ("port", "ref", "start"))
    for name, value in want.items():
        if "num_batches_tracked" in name or not (
                name.startswith("backend_model.fc.")
                or name.startswith("zroot_ref.")):
            continue
        value = np.asarray(value)
        tol = (1e-4 * np.abs(value).max() + 1e-7 if "running" in name
               else 2e-5)
        np.testing.assert_allclose(got[name], value, rtol=0, atol=tol,
                                   err_msg=name)
    for name in ("backend_model.fc.weight", "backend_model.fc.bias"):
        assert not np.array_equal(got[name], start[name]), name


def test_evaluate_matches_the_reference(frozen_runs):
    got, want = frozen_runs["results"]
    assert set(got) == set(want)
    for key, value in want.items():
        value = float(value)
        if "AUC" in key or "auc" in key:
            assert abs(got[key] - value) <= 0.02, (key, got[key], value)
        else:
            assert got[key] == pytest.approx(value, rel=1e-3, abs=1e-6), key


def test_pth_roundtrip_is_bit_exact(tmp_path, monkeypatch):
    sd = peclr_variables_to_state_dict(seeded_peclr_variables("50", 4), "50")
    merged, meta = port.pth_roundtrip(sd, "50", str(tmp_path / "enc.pth"))
    assert meta["encoder_bitexact"] is True
    assert meta["roundtripped_leaves"] == sum(k.startswith("encoder.")
                                              for k in sd) > 100
    assert meta["pth_bytes"] > 1e6
    assert set(merged) == set(sd)
    for name, value in sd.items():
        assert torch.equal(merged[name], value), name

    import peclr_tpu_torch.models.port as torch_port

    real = torch_port.torchvision_to_peclr_encoder

    def dropping(state_dict, size, prefix=""):
        out = real(state_dict, size, prefix)
        out.pop(sorted(out)[0])
        return out

    monkeypatch.setattr(torch_port, "torchvision_to_peclr_encoder", dropping)
    _, meta = port.pth_roundtrip(sd, "50", str(tmp_path / "enc2.pth"))
    assert meta["encoder_bitexact"] is False


def test_chain_main_on_the_cpu(tmp_path):
    """The chain end to end at RN18, 64² crops, 24 unique frames, 4
    pretrain and 4 fine-tune steps of 8: the five tiers, the round trip's
    row equal to peclr_full's, the leaderboard's JSON written."""
    out = tmp_path / "chain.json"
    artifact = port.main([
        "--device", "cpu", "--resnet", "18", "--crop", "64",
        "--num-unique", "24", "--pretrain-steps", "4", "--finetune-steps",
        "4", "--batch", "8", "--freeze-encoder", "--root",
        str(tmp_path / "fh"), "--out", str(out)])
    with open(out) as fh:
        assert json.load(fh) == artifact
    by = {r["encoder"]: r for r in artifact["rows"]}
    assert [r["encoder"] for r in artifact["rows"]] == TIERS
    assert by["peclr_full_pth_roundtrip"] == {
        **by["peclr_full"], "encoder": "peclr_full_pth_roundtrip"}
    assert artifact["port_roundtrip"]["encoder_bitexact"] is True
    assert artifact["pred_fh_json"] == "pred_chain.json"
    assert artifact["pred_fh_entries"] == 32
    assert artifact["backend"] == "cpu"
    for name, phase in artifact["phases"].items():
        if name.startswith("finetune_"):
            assert phase["frozen_backbone_bitexact"], name
        if "last_loss" in phase:
            assert np.isfinite(phase["last_loss"]), name


# ---------------------------------------------------------------------------
# The committed card artifact


@pytest.fixture(scope="module")
def chain():
    with open(ARTIFACT) as fh:
        return json.load(fh)


def test_artifact_is_the_card_run_of_the_config(chain):
    cfg = chain["config"]
    assert (cfg["resnet"], cfg["crop"], cfg["batch"], cfg["num_unique"],
            cfg["pretrain_steps"], cfg["finetune_steps"],
            cfg["freeze_encoder"], cfg["seed"], cfg["train_ratio"]) == (
        "50", 128, 64, 192, 600, 400, True, 5, 0.9), cfg
    assert chain["backend"] == "cuda" and "," in chain["device"]
    assert [r["encoder"] for r in chain["rows"]] == TIERS


def test_aligned_accuracy_improves_with_pretraining(chain):
    """Aligned AUC: none below both PeCLR tiers, and the aligned EPE the
    other way round (the TPU's margins were 0.011 AUC); the quarter
    budget at most the full one's plus the tie tolerance 1e-3."""
    by = {r["encoder"]: r for r in chain["rows"]}
    auc = {k: by[k]["auc_procrustes"] for k in by}
    epe = {k: by[k]["Mean_EPE_3D_procrustes"] for k in by}
    assert auc["none"] < auc["peclr_quarter"], auc
    assert auc["none"] < auc["peclr_full"], auc
    assert epe["none"] > epe["peclr_quarter"], epe
    assert epe["none"] > epe["peclr_full"], epe
    assert auc["peclr_quarter"] <= auc["peclr_full"] + 1e-3, auc


def test_peclr_at_least_ties_simclr(chain):
    by = {r["encoder"]: r for r in chain["rows"]}
    assert (by["peclr_full"]["auc_procrustes"]
            >= by["simclr_full"]["auc_procrustes"] - 1e-3), by


def test_pth_roundtrip_row_equals_the_direct_row(chain):
    rt = chain["port_roundtrip"]
    assert rt["encoder_bitexact"] is True
    assert rt["pth_bytes"] > 1e6 and rt["roundtripped_leaves"] > 100
    by = {r["encoder"]: r for r in chain["rows"]}
    direct, via_pth = by["peclr_full"], by["peclr_full_pth_roundtrip"]
    for k in ("auc_procrustes", "Mean_EPE_3D", "Mean_EPE_3D_procrustes"):
        assert via_pth[k] == pytest.approx(direct[k], rel=1e-9), k


def test_leaderboard_json_written(chain):
    assert chain["pred_fh_json"] == "pred_chain.json"
    assert chain["pred_fh_entries"] == 32
    assert chain["phases"]["leaderboard"]["kernel1_launches"] > 0
