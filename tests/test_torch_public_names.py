"""The port's last public names against the reference's (geometry/joints.py's
reorders and MIDDLE_PIP, rotation_matrix_2d, error_in_conversion,
pseudo_joint_bound, read_yaml, and constants.py's BASE_DIR and FreiHAND
sizes), and a diff of every public name of the two packages: each
top-level function, class and constant of a module of peclr_tpu, and of
the reference's scripts that the port carries (SCRIPTS), and of the
reference's entry points (__graft_entry__.py, ENTRY), has a counterpart in
the port's module of the same path (peclr_tpu_torch/entry.py for the
entry points), or stands on the written list of deliberate differences
below."""

import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import peclr_tpu.constants as jax_constants
import peclr_tpu_torch.constants as torch_constants
from peclr_tpu.geometry import affine as jax_affine
from peclr_tpu.geometry import camera as jax_camera
from peclr_tpu.geometry import joints as jax_joints
from peclr_tpu.geometry import mano as jax_mano
from peclr_tpu.utils import io as jax_io
from peclr_tpu_torch.geometry import affine, camera, joints, mano
from peclr_tpu_torch.utils import io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the reference's scripts with a counterpart in peclr_tpu_torch/scripts/
SCRIPTS = ("accuracy_proxy.py", "downstream_chain.py", "trace_buckets.py",
           "profile_step.py", "bench_serving.py", "bench_decode.py",
           "bench_host_pipeline.py", "bench_pred_pipeline.py",
           "bench_multichip.py", "multihost_harness.py", "bench_streams.py",
           "bench_guard.py")
#: the reference's entry points and the port's module that mirrors
#: them (entry, and dryrun_multichip re-exported from parallel/dryrun.py)
ENTRY = ("__graft_entry__.py", "peclr_tpu_torch/entry.py")

#: reference names the port does not have, each with what covers it: JAX-
#: or TPU-only names, and names whose job the port does another way.  "*"
#: stands for a whole module.
DELIBERATE = {
    "peclr_tpu/ops/augment.py": {
        "augment_batch": "ops/augment.py:draw then apply (torch cannot "
                         "replay jax.random)",
        "WARP_BACKEND": "the `route` argument of ops/augment.py:apply",
        "affine_warp": "the routes of ops/augment.py:apply "
                       "(ops/warp.py:affine_warp is the gather route)",
    },
    "peclr_tpu/models/port.py": {
        name: "flax converters; the port maps torch state dicts "
              "(models/port.py:variables_to_state_dict and the renames)"
        for name in ("encoder_to_torchvision", "export_state_dict",
                     "import_state_dict", "peclr_checkpoint_to_variables",
                     "rn25d_checkpoint_to_variables",
                     "torchvision_to_encoder",
                     "variables_to_peclr_checkpoint",
                     "variables_to_rn25d_checkpoint")
    },
    "peclr_tpu/train/optimizer.py": {
        "LarsState": "optax state; train/optimizer.py:PretrainOptimizer",
        "lars_wrapper": "optax transform; PretrainOptimizer(lars=True)",
    },
    "peclr_tpu/models/heads.py": {
        "jax_stop_gradient": "torch's detach() where the reference stops "
                             "gradients",
    },
    "peclr_tpu/models/resnet.py": {
        "StemConv": "the TPU's space-to-depth stem; a plain 7x7 Conv2d",
        "ModuleDef": "a flax type alias",
        "maybe_remat": "flax rematerialisation (TPU memory)",
        "remat_mode": "flax rematerialisation (TPU memory)",
        "BN_MOMENTUM": "flax's momentum convention (0.9); torch's 0.1 in "
                       "models/batchnorm.py",
    },
    "peclr_tpu/train/step.py": {
        "jit_with_options": "XLA compilation; torch runs eagerly",
        "DEFAULT_TPU_COMPILER_OPTIONS": "TPU compiler options",
        "resolve_compiler_options": "TPU compiler options",
    },
    "peclr_tpu/parallel/mesh.py": {
        "batch_sharding": "GSPMD sharding; parallel/mesh.py:shard_batch "
                          "and local_rows",
    },
    "peclr_tpu/cli/evaluate.py": {
        "load_model_variables": "cli/evaluate.py:load_model",
    },
    "peclr_tpu/ops/pallas/__init__.py": {"*": "the package of the TPU "
                                              "kernels"},
    "peclr_tpu/ops/pallas/barrel_shift.py": {
        "*": "the Pallas kernels; their counterparts are "
             "ops/shift_lerp.py, ops/shift_lerp_matmul.py and csrc/",
    },
    "scripts/bench_pred_pipeline.py": {
        "DEVICE_BUSY_MS_PER_BATCH128": "the TPU trace's busy time; the "
                                       "port measures its own each run "
                                       "(trace_buckets of one profiled "
                                       "batch)",
    },
}


def _public_names(path):
    """Top-level functions and classes, and names assigned at top level
    that start with a capital (constants, type aliases), not private."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for target in targets:
                out.update(n.id for n in ast.walk(target)
                           if isinstance(n, ast.Name) and n.id[:1].isupper())
    return {n for n in out if not n.startswith("_")}


def _exported(path):
    """The names a module lists in its `__all__` (a re-export counts as
    the module's own)."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "__all__"
                        for t in node.targets)):
            return set(ast.literal_eval(node.value))
    return set()


def _module_pairs():
    pairs = []
    for root, _, files in os.walk(os.path.join(REPO, "peclr_tpu")):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)
                pairs.append((rel, "peclr_tpu_torch" + rel[len("peclr_tpu"):]))
    for name in SCRIPTS:
        pairs.append((f"scripts/{name}", f"peclr_tpu_torch/scripts/{name}"))
    pairs.append(ENTRY)
    return sorted(pairs)


def test_every_public_name_has_a_counterpart():
    missing = []
    for ref_path, port_path in _module_pairs():
        listed = DELIBERATE.get(ref_path, {})
        if "*" in listed:
            assert not os.path.exists(os.path.join(REPO, port_path)), port_path
            continue
        want = _public_names(os.path.join(REPO, ref_path))
        port = os.path.join(REPO, port_path)
        have = (_public_names(port) | _exported(port)
                if os.path.exists(port) else set())
        missing += [f"{ref_path}:{n}" for n in sorted(want - have - set(listed))]
    assert not missing, missing


def test_the_list_names_only_what_is_missing():
    """A name on the list that the port has, or the reference no longer
    has, is stale."""
    port_of = dict(_module_pairs())
    for ref_path, listed in DELIBERATE.items():
        if "*" in listed:
            continue
        want = _public_names(os.path.join(REPO, ref_path))
        have = _public_names(os.path.join(REPO, port_of[ref_path]))
        for name in listed:
            assert name in want and name not in have, (ref_path, name)


# ---------------------------------------------------------------------------
# The names themselves


@pytest.mark.parametrize("fn", ["freihand_to_ait", "ait_to_freihand",
                                "mano_to_ait", "interhand_to_ait"])
def test_joint_reorders_match(rng, fn):
    x = rng.normal(size=(2, 5, 21, 3)).astype(np.float32)
    want = np.asarray(getattr(jax_joints, fn)(jnp.asarray(x)))
    got = getattr(joints, fn)(torch.from_numpy(x))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(getattr(joints, fn)(x), want)


def test_reorder_and_middle_pip_match(rng):
    x = rng.normal(size=(21, 2)).astype(np.float32)
    for src in ("ait", "freihand", "mano", "interhand"):
        for dst in ("ait", "freihand"):
            np.testing.assert_array_equal(
                joints.reorder(x, src, dst),
                np.asarray(jax_joints.reorder(jnp.asarray(x), src, dst)))
    assert joints.MIDDLE_PIP == jax_joints.MIDDLE_PIP == 8


def test_rotation_matrix_2d_matches(rng):
    angles = rng.uniform(-180, 180, (3, 4)).astype(np.float32)
    for scale in (1.0, 0.7):
        want = np.asarray(jax_affine.rotation_matrix_2d(jnp.asarray(angles),
                                                        scale))
        got = affine.rotation_matrix_2d(torch.from_numpy(angles), scale)
        assert got.shape == want.shape == (3, 4, 2, 2)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(affine.rotation_matrix_2d(30.0).numpy(),
                               np.asarray(jax_affine.rotation_matrix_2d(30.0)),
                               rtol=1e-6, atol=1e-7)


def test_error_in_conversion_matches(rng):
    a = rng.normal(size=(4, 21, 3)).astype(np.float32)
    b = a + rng.normal(0, 1e-3, a.shape).astype(np.float32)
    want = float(jax_camera.error_in_conversion(a, b))
    assert float(camera.error_in_conversion(a, b)) == want
    assert float(camera.error_in_conversion(torch.from_numpy(a),
                                            torch.from_numpy(b))) == want


def test_pseudo_joint_bound_matches(rng):
    vertices = rng.normal(size=(778, 3)).astype(np.float32)
    got = mano.pseudo_joint_bound(vertices)
    want = jax_mano.pseudo_joint_bound(vertices)
    assert got.dtype == want.dtype == np.float32 and got.shape == (21, 3)
    np.testing.assert_array_equal(got, want)


def test_read_yaml_matches(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text("a: 1\nb: [2.5, x]\nc: {d: true}\n")
    assert io.read_yaml(str(path)) == jax_io.read_yaml(str(path)) == {
        "a": 1, "b": [2.5, "x"], "c": {"d": True}}


def test_freihand_constants_match():
    for name in ("FREIHAND_TRAIN_SIZE", "FREIHAND_EVAL_SIZE",
                 "FREIHAND_VERSIONS"):
        assert getattr(torch_constants, name) == getattr(jax_constants, name)


@pytest.mark.parametrize("base_path", [None, "/data/peclr"])
def test_base_dir_reads_base_path(base_path):
    """BASE_DIR is BASE_PATH where it is set, else the repository's root,
    in both packages (read when the module is imported: a subprocess)."""
    env = {k: v for k, v in os.environ.items() if k != "BASE_PATH"}
    if base_path is not None:
        env["BASE_PATH"] = base_path
    code = ("import peclr_tpu.constants as a, peclr_tpu_torch.constants as b;"
            "print(a.BASE_DIR); print(b.BASE_DIR)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert out == [base_path or REPO] * 2
