"""The port's model, weight carry-across and small helpers against the
reference, on the CPU in f32.

Weights are made from a seed in the reference's flax layout
(peclr_tpu_torch/data/synthetic.py), applied by the reference's flax
RN25DPose, and carried into the port by rn25d_variables_to_state_dict."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peclr_tpu.geometry import affine as jax_affine
from peclr_tpu.geometry import camera as jax_camera
from peclr_tpu.geometry import joints as jax_joints
from peclr_tpu.models import RN25DPose as JaxRN25DPose
from peclr_tpu.models import port as jax_port
from peclr_tpu.models.heads import ZrootRefineMLP as JaxZroot
from peclr_tpu.ops import image as jax_image
from peclr_tpu.ops import pooling as jax_pooling
from peclr_tpu_torch.data.synthetic import (
    seeded_intrinsics,
    seeded_rn25d_variables,
)
from peclr_tpu_torch.geometry import affine, camera, joints
from peclr_tpu_torch.models import K_DEFAULT, RN25DPose
from peclr_tpu_torch.models.heads import ZrootRefineMLP
from peclr_tpu_torch.models.port import rn25d_variables_to_state_dict
from peclr_tpu_torch.ops.image import normalize_imagenet
from peclr_tpu_torch.ops.pooling import max_pool_3x3s2p1


def _port_model(variables, size):
    model = RN25DPose(size)
    model.load_state_dict(rn25d_variables_to_state_dict(variables, size),
                          strict=True)
    return model.eval()


@pytest.mark.parametrize("size", ["18", "50"])
def test_rn25d_matches_reference(rng, size):
    """kp25d within rtol 1e-4 / atol 1e-4 and kp3d within rtol 1e-3 (f32
    convolutions summed in another order)."""
    variables = seeded_rn25d_variables(size, seed=int(size))
    images = rng.normal(0, 1, (3, 64, 64, 3)).astype(np.float32)
    K = seeded_intrinsics(3, seed=1)
    ref = jax.jit(lambda v, x, k: JaxRN25DPose(size=size).apply(
        v, x, K=k, train=False))(variables, jnp.asarray(images),
                                 jnp.asarray(K))
    model = _port_model(variables, size)
    with torch.no_grad():
        got = model(torch.from_numpy(images), K=torch.from_numpy(K))
    np.testing.assert_allclose(got["kp25d"].numpy(), np.asarray(ref["kp25d"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["kp3d"].numpy(), np.asarray(ref["kp3d"]),
                               rtol=1e-3, atol=1e-5)
    assert (got["kp25d"][:, 0, 2] == 0).all()  # the wrist's depth

    # the reference's own exporter gives the same state dict, which loads
    # strictly and gives the same outputs
    exported = jax_port.variables_to_rn25d_checkpoint(variables, size)
    state = model.state_dict()
    assert set(exported) == set(state)
    for key, value in exported.items():
        np.testing.assert_array_equal(np.asarray(value), state[key].numpy(),
                                      err_msg=key)
    again = RN25DPose(size)
    again.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in exported.items()}, strict=True)
    with torch.no_grad():
        out = again.eval()(torch.from_numpy(images), K=torch.from_numpy(K))
    torch.testing.assert_close(out["kp3d"], got["kp3d"], rtol=0, atol=0)


def test_carry_across_rejects_missing_variables():
    variables = seeded_rn25d_variables("18", seed=0)
    del variables["batch_stats"]["backbone"]["bn1"]["var"]
    with pytest.raises(KeyError, match="bn1/var"):
        rn25d_variables_to_state_dict(variables, "18")


def test_default_K_matches_reference():
    from peclr_tpu.models.rn25d import K_DEFAULT as jax_K

    np.testing.assert_array_equal(np.asarray(K_DEFAULT, np.float32),
                                  np.asarray(jax_K))


def test_zroot_head_matches_reference(rng):
    """The closed-form root depth with its eps maxima, sqrt and [4, 50] clip,
    then the MLP (leaky ReLU 0.01, eval-mode BN), on ordinary and on
    degenerate poses (coincident joints, a root clipped at 4)."""
    b = 6
    kp = rng.normal(0, 0.3, (b, 21, 3)).astype(np.float32)
    kp[..., 2] = 1.0
    zrel = rng.normal(0, 0.2, (b, 21, 1)).astype(np.float32)
    kp[1, 8, :2] = kp[1, 3, :2]  # a = 0: the eps floor
    zrel[2] = 0.0
    kp[2, 8, :2] = kp[2, 3, :2] + 5.0  # a long bone: the root clips at 4
    head = JaxZroot()
    variables = head.init(jax.random.PRNGKey(0), jnp.asarray(kp),
                          jnp.asarray(zrel))
    # eval-mode statistics that are not the identity
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(
            np.float32), variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    ref = np.asarray(head.apply(variables, jnp.asarray(kp), jnp.asarray(zrel)))

    mapping = [("zroot_ref." + t, c, path, kind)
               for t, c, path, kind in jax_port.zroot_mlp_mapping()]
    sd = jax_port.export_state_dict(variables, mapping)
    port = ZrootRefineMLP()
    port.load_state_dict({k: torch.from_numpy(np.asarray(v))
                          for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(kp), torch.from_numpy(zrel)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_affine_helpers_match_reference(rng):
    boxes = np.concatenate([rng.uniform(0, 100, (5, 2)),
                            rng.uniform(120, 224, (5, 2))], 1).astype(np.float32)
    np.testing.assert_allclose(
        affine.modify_bbox(boxes, 0.33).numpy(),
        np.asarray(jax_affine.modify_bbox(boxes, 0.33)), rtol=1e-6)
    mats = affine.affine_from_bbox(boxes, 224, 0.7).numpy()
    np.testing.assert_allclose(
        mats, np.asarray(jax_affine.affine_from_bbox(boxes, 224, 0.7)),
        rtol=1e-6, atol=1e-5)
    pts = rng.uniform(0, 224, (5, 21, 2)).astype(np.float32)
    np.testing.assert_allclose(
        affine.apply_affine(affine.invert_affine(torch.from_numpy(mats)),
                            torch.from_numpy(pts)).numpy(),
        np.asarray(jax_affine.apply_affine(jax_affine.invert_affine(mats),
                                           pts)), rtol=1e-5, atol=1e-3)
    tx, ty, s = rng.normal(size=(3, 5)).astype(np.float32)
    np.testing.assert_allclose(
        affine.compose(affine.translation(tx, ty), affine.scaling(s, s)).numpy(),
        np.asarray(jax_affine.compose(jax_affine.translation(tx, ty),
                                      jax_affine.scaling(s, s))), rtol=1e-6)


def test_camera_and_joint_orders_match_reference(rng):
    kp3d = rng.normal(size=(4, 21, 3)).astype(np.float32)
    t = torch.from_numpy(kp3d)
    got = camera.move_palm_to_wrist(t).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_camera.move_palm_to_wrist(jnp.asarray(kp3d))),
        rtol=1e-6)
    assert torch.equal(t, torch.from_numpy(kp3d))  # out of place
    for order in joints.JOINT_ORDERS:
        assert joints.JOINT_ORDERS[order] == jax_joints.JOINT_ORDERS[order]
    for src in joints.JOINT_ORDERS:
        for dst in joints.JOINT_ORDERS:
            np.testing.assert_array_equal(joints.permutation(src, dst),
                                          jax_joints.permutation(src, dst))
    assert (joints.WRIST, joints.INDEX_MCP) == (jax_joints.WRIST,
                                                jax_joints.INDEX_MCP)


def test_image_ops_match_reference(rng):
    x = rng.uniform(0, 1, (2, 9, 11, 3)).astype(np.float32)
    np.testing.assert_allclose(
        normalize_imagenet(torch.from_numpy(x)).numpy(),
        np.asarray(jax_image.normalize_imagenet(jnp.asarray(x))), rtol=1e-6)
    fm = rng.normal(size=(2, 15, 12, 4)).astype(np.float32)  # NHWC
    got = max_pool_3x3s2p1(torch.from_numpy(fm).permute(0, 3, 1, 2))
    ref = np.asarray(jax_pooling.max_pool_3x3s2p1(jnp.asarray(fm)))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


def test_checkpoint_reader_matches_reference(tmp_path):
    from peclr_tpu.train.checkpoint import load_torch_checkpoint as jax_load
    from peclr_tpu_torch.train.checkpoint import load_torch_checkpoint

    sd = _port_model(seeded_rn25d_variables("18", seed=3), "18").state_dict()
    paths = {"pth": str(tmp_path / "rn18.pth"),
             "ckpt": str(tmp_path / "rn18.ckpt"),
             "npz": str(tmp_path / "rn18.npz")}
    torch.save(sd, paths["pth"])
    torch.save({"state_dict": sd, "epoch": 3}, paths["ckpt"])
    np.savez(paths["npz"], **{k: v.numpy() for k, v in sd.items()})
    for path in paths.values():
        got = load_torch_checkpoint(path)
        ref = jax_load(path)
        assert set(got) == set(ref) == set(sd)
        for key in sd:
            assert got[key].device.type == "cpu"
            np.testing.assert_array_equal(got[key].numpy(), ref[key])
        RN25DPose("18").load_state_dict(got, strict=True)


def test_decode_image_matches_reference(tmp_path):
    from peclr_tpu.data.pipeline import decode_image as jax_decode
    from peclr_tpu.data.synthetic import generate_freihand_eval_like
    from peclr_tpu_torch.data.pipeline import decode_image

    generate_freihand_eval_like(str(tmp_path), num_images=2, seed=4)
    rgb = os.path.join(str(tmp_path), "evaluation", "rgb")
    for name in sorted(os.listdir(rgb)):
        got = decode_image(os.path.join(rgb, name))
        assert got.dtype == np.uint8 and got.shape == (224, 224, 3)
        np.testing.assert_array_equal(got, jax_decode(os.path.join(rgb, name)))
