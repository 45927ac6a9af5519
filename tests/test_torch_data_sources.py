"""The port's data sources, samplers and geometry (peclr_tpu_torch/data/
{freihand,youtube,sampler}.py, geometry/{camera,joints,mano}.py) against
the reference's on the same inputs, on the CPU.

Sources are compared exactly: indices, every record's arrays and the probed
image size, with sklearn installed and with it made unimportable in both
packages (the RandomState fallback of seeded_split).  The camera functions
run in f32 in both, torch against jnp: 1e-6 of each tensor's scale.
"""

import json
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peclr_tpu.data import freihand as jax_freihand
from peclr_tpu.data import sampler as jax_sampler
from peclr_tpu.data import youtube as jax_youtube
from peclr_tpu.data.synthetic import (
    generate_freihand_eval_like,
    generate_freihand_like,
)
from peclr_tpu.geometry import camera as jax_camera
from peclr_tpu.geometry import joints as jax_joints
from peclr_tpu.geometry import mano as jax_mano
from peclr_tpu_torch.data import freihand, sampler, youtube
from peclr_tpu_torch.geometry import camera, joints, mano


@pytest.fixture(scope="module")
def fh_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fh_sources"))
    generate_freihand_like(root, num_unique=12, seed=7)
    generate_freihand_eval_like(root, num_images=4, seed=8)
    return root


def _assert_sources_equal(ref, got):
    assert len(got) == len(ref)
    np.testing.assert_array_equal(got.indices, ref.indices)
    for i in range(len(ref)):
        assert got.image_path(i) == ref.image_path(i)
        r, g = ref.record(i), got.record(i)
        assert set(g) == set(r)
        for key in r:
            np.testing.assert_array_equal(np.asarray(g[key]),
                                          np.asarray(r[key]), err_msg=key)


@pytest.mark.parametrize("sklearn", ["installed", "unimportable"])
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_freihand_source_matches(fh_root, split, sklearn, monkeypatch):
    if sklearn == "unimportable":
        monkeypatch.setitem(sys.modules, "sklearn", None)
        monkeypatch.setitem(sys.modules, "sklearn.model_selection", None)
    ref = jax_freihand.FreihandSource(fh_root, split, seed=5, train_ratio=0.75)
    got = freihand.FreihandSource(fh_root, split, seed=5, train_ratio=0.75)
    _assert_sources_equal(ref, got)
    assert got.image_size == ref.image_size == (224, 224)
    if split != "test":
        assert len(got) == 4 * (9 if split == "train" else 3)


@pytest.mark.parametrize("n,ratio,seed", [(12, 0.75, 5), (32560, 0.9999999999, 5),
                                          (101, 0.3, 11)])
def test_seeded_split_both_branches(n, ratio, seed, monkeypatch):
    for blocked in (False, True):
        if blocked:
            monkeypatch.setitem(sys.modules, "sklearn", None)
            monkeypatch.setitem(sys.modules, "sklearn.model_selection", None)
        for a, b in zip(freihand.seeded_split(n, ratio, seed),
                        jax_freihand.seeded_split(n, ratio, seed)):
            np.testing.assert_array_equal(a, b)


def test_pseudo_bound_box_matches():
    np.testing.assert_array_equal(freihand.pseudo_bound_box(),
                                  jax_freihand.pseudo_bound_box())
    np.testing.assert_array_equal(freihand.pseudo_bound_box(0.5, 128.0),
                                  jax_freihand.pseudo_bound_box(0.5, 128.0))


def _write_ytb(root, frames, left_all=False, seed=0):
    """The YT3DH layout of tests/test_misc_components.py: raw COCO-style
    json and frame jpgs (frame 2 missing, so the scan drops it)."""
    import cv2

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "youtube", "vid0", "video", "frames"),
                exist_ok=True)
    images, annotations = [], []
    for i in range(frames):
        name = f"youtube/vid0/video/frames/{i:04d}.png"
        if i != 2:
            img = rng.integers(0, 255, (240, 320, 3), dtype=np.uint8)
            cv2.imwrite(os.path.join(root, name.replace(".png", ".jpg")), img)
        images.append({"id": 100 + i, "name": name, "width": 320, "height": 240})
        verts = np.stack([rng.uniform(70, 250, 778), rng.uniform(60, 180, 778),
                          rng.uniform(5, 9, 778)], axis=1)
        annotations.append({"id": i, "image_id": 100 + i,
                            "is_left": 1 if left_all or i == 1 else 0,
                            "vertices": verts.tolist()})
    with open(os.path.join(root, "youtube_train.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    return root


@pytest.mark.parametrize("layout", ["ytb_root", "lefty_root"])
def test_youtube_source_matches(tmp_path, layout):
    """Each package on its own copy: the records and the three cache files
    they write are equal; a second construction reads the caches."""
    base = _write_ytb(str(tmp_path / "base"), frames=4 if layout == "ytb_root" else 2,
                      left_all=layout == "lefty_root")
    ref_root, got_root = str(tmp_path / "ref"), str(tmp_path / "got")
    shutil.copytree(base, ref_root)
    shutil.copytree(base, got_root)
    ref = jax_youtube.YoutubeSource(ref_root, "train")
    got = youtube.YoutubeSource(got_root, "train")
    assert len(got) == len(ref) == (3 if layout == "ytb_root" else 2)
    for i in range(len(ref)):
        assert (os.path.relpath(got.image_path(i), got_root)
                == os.path.relpath(ref.image_path(i), ref_root))
        r, g = ref.record(i), got.record(i)
        assert set(g) == set(r)
        for key in r:
            np.testing.assert_array_equal(np.asarray(g[key]),
                                          np.asarray(r[key]), err_msg=key)
    for name in ("joints.json", "images.json", "invalid_index.csv"):
        with open(os.path.join(ref_root, f"youtube_train_{name}"), "rb") as a, \
                open(os.path.join(got_root, f"youtube_train_{name}"), "rb") as b:
            assert a.read() == b.read(), name
    again = youtube.YoutubeSource(got_root, "train")
    np.testing.assert_array_equal(again.indices, got.indices)


def test_samplers_match():
    a, b = sampler.BalancedSampler([5, 17, 3], seed=9), jax_sampler.BalancedSampler(
        [5, 17, 3], seed=9)
    for n in (1, 7, 100):  # stateful: the stream continues across draws
        assert a.draw(n) == b.draw(n)
    for shuffle in (True, False):
        e, f = sampler.EpochSampler(40, 3, shuffle), jax_sampler.EpochSampler(
            40, 3, shuffle)
        for epoch in (0, 1, 7):
            np.testing.assert_array_equal(e.epoch(epoch), f.epoch(epoch))
    with pytest.raises(ValueError):
        sampler.BalancedSampler([3, 0])


def test_joint_orders_match():
    names = ("ait", "freihand", "interhand", "mano")
    assert joints.JOINT_ORDERS == jax_joints.JOINT_ORDERS
    for src in names:
        for dst in names:
            np.testing.assert_array_equal(joints.permutation(src, dst),
                                          jax_joints.permutation(src, dst))
    assert (joints.WRIST, joints.INDEX_MCP, joints.MIDDLE_MCP) == (
        jax_joints.WRIST, jax_joints.INDEX_MCP, jax_joints.MIDDLE_MCP)


def test_mano_regression_matches(rng):
    """The port's own copy of the regressor, equal to the reference's;
    joints within 1e-6 of their scale (einsum order)."""
    np.testing.assert_array_equal(mano.mano_regressor(),
                                  jax_mano.mano_regressor())
    verts = rng.uniform(-0.1, 0.1, (3, 778, 3)).astype(np.float32)
    got, ref = mano.joints_from_mano_mesh(verts), jax_mano.joints_from_mano_mesh(
        verts)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def _hands(rng, n):
    from peclr_tpu_torch.data.synthetic import _random_hand_3d

    j3d = np.stack([_random_hand_3d(rng) for _ in range(n)])
    K = np.broadcast_to(np.asarray([[388.9, 0.0, 112.0], [0.0, 388.7, 112.0],
                                    [0.0, 0.0, 1.0]], np.float32), (n, 3, 3))
    return j3d, np.ascontiguousarray(K)


def test_camera_functions_match(rng):
    j3d, K = _hands(rng, 6)
    tj3d, tK = torch.from_numpy(j3d), torch.from_numpy(K)

    def close(got, ref):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-6 * max(np.abs(ref).max(), 1.0))

    j25, scale = camera.convert_to_2_5d(tK, tj3d)
    r25, rscale = jax_camera.convert_to_2_5d(jnp.asarray(K), jnp.asarray(j3d))
    close(j25, r25)
    close(scale, rscale)
    z, K_inv = camera.root_depth(j25, tK)
    rz, rK_inv = jax_camera.root_depth(r25, jnp.asarray(K))
    close(z, rz)
    close(K_inv, rK_inv)
    back = camera.convert_2_5d_to_3d(j25, scale, tK)
    close(back, jax_camera.convert_2_5d_to_3d(r25, rscale, jnp.asarray(K)))
    close(back, j3d)  # the round trip holds
    given = torch.full((6,), 7.5)
    close(camera.convert_2_5d_to_3d(j25, scale, tK, z_root=given),
          jax_camera.convert_2_5d_to_3d(r25, rscale, jnp.asarray(K),
                                        z_root=jnp.full((6,), 7.5)))
    close(camera.move_wrist_to_palm(tj3d),
          jax_camera.move_wrist_to_palm(jnp.asarray(j3d)))
    close(camera.move_palm_to_wrist(tj3d),
          jax_camera.move_palm_to_wrist(jnp.asarray(j3d)))


def test_project_to_25d_np_matches(rng):
    from peclr_tpu.data.pipeline import project_to_25d_np as ref_project
    from peclr_tpu_torch.data.pipeline import project_to_25d_np

    j3d, K = _hands(rng, 3)
    for i in range(3):
        got, ref = project_to_25d_np(K[i], j3d[i]), ref_project(K[i], j3d[i])
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1] == ref[1]
        torch_25, _ = camera.convert_to_2_5d(torch.from_numpy(K[i]),
                                             torch.from_numpy(j3d[i]))
        np.testing.assert_allclose(got[0], torch_25.numpy(), rtol=0,
                                   atol=1e-6 * np.abs(got[0]).max())
