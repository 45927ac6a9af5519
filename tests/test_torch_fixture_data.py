"""The committed FreiHAND-layout fixture that chip_smoke.py trains on
(tests/fixtures/torch_freihand_like/freihand_dataset: 8 frames x 4 versions,
seed 7), and the port's dataset generators against the reference's."""

import json
import os

import numpy as np
import pytest

from peclr_tpu.data import synthetic as jax_synthetic
from peclr_tpu_torch.data import synthetic
from peclr_tpu_torch.data.pipeline import decode_image

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "torch_freihand_like", "freihand_dataset")


def _json_files(root, prefix):
    out = {}
    for name in sorted(os.listdir(root)):
        if name.startswith(prefix) and name.endswith(".json"):
            with open(os.path.join(root, name)) as f:
                out[name] = json.load(f)
    return out


def _frames(root, sub):
    rgb = os.path.join(root, sub, "rgb")
    return sorted(os.listdir(rgb)), rgb


def test_fixture_is_what_the_generator_writes(tmp_path):
    """Its JSON files equal what generate_freihand_like(num_unique=8,
    seed=7) writes; its 32 frames decode to 224 x 224 x 3."""
    made = synthetic.generate_freihand_like(str(tmp_path), num_unique=8, seed=7)
    assert _json_files(FIXTURE, "training_") == _json_files(made, "training_")
    assert len(_json_files(FIXTURE, "training_")) == 3
    names, rgb = _frames(FIXTURE, "training")
    assert names == _frames(made, "training")[0]
    assert len(names) == 32
    for name in names:
        img = decode_image(os.path.join(rgb, name))
        assert img.shape == (224, 224, 3) and img.dtype == np.uint8


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_generator_matches_the_reference(tmp_path, kind):
    """The same JSON files, and the same frames bit for bit under the same
    encoder (both write with cv2, or both with PIL)."""
    got, ref = str(tmp_path / "got"), str(tmp_path / "ref")
    if kind == "train":
        synthetic.generate_freihand_like(got, num_unique=5, seed=11)
        jax_synthetic.generate_freihand_like(ref, num_unique=5, seed=11)
        prefix, sub = "training_", "training"
    else:
        synthetic.generate_freihand_eval_like(got, num_images=3, seed=8)
        jax_synthetic.generate_freihand_eval_like(ref, num_images=3, seed=8)
        prefix, sub = "evaluation_", "evaluation"
    assert _json_files(got, prefix) == _json_files(ref, prefix)
    names, rgb = _frames(got, sub)
    ref_names, ref_rgb = _frames(ref, sub)
    assert names == ref_names
    for name in names:
        np.testing.assert_array_equal(decode_image(os.path.join(rgb, name)),
                                      decode_image(os.path.join(ref_rgb, name)))


def test_random_hand_and_render_match():
    got_rng, ref_rng = np.random.default_rng(2), np.random.default_rng(2)
    for _ in range(3):
        hand = synthetic._random_hand_3d(got_rng)
        np.testing.assert_array_equal(hand, jax_synthetic._random_hand_3d(ref_rng))
        K = np.asarray(synthetic._FH_K, np.float32)
        np.testing.assert_array_equal(synthetic._render(hand, K, got_rng, 96),
                                      jax_synthetic._render(hand, K, ref_rng, 96))
