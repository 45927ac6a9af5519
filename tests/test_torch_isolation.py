"""The port stands alone: no module of peclr_tpu_torch, and not
chip_smoke.py, imports JAX, flax or the reference package; chip_smoke.py
refuses to run without a card or without the package beside it."""

import ast
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "peclr_tpu")

_BLOCK_AND_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys

FORBIDDEN = %r

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("the port imported " + name)
        return None

sys.meta_path.insert(0, Block())
import peclr_tpu_torch
names = ["peclr_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(peclr_tpu_torch.__path__,
                                          "peclr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(len(names))
"""


def test_port_imports_nothing_of_the_reference():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCK_AND_IMPORT % (FORBIDDEN,)], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 84  # every module was imported


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_names_the_reference():
    """Imports inside functions too (chip_smoke imports lazily)."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "peclr_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        for module in _imported_modules(path):
            assert module.split(".")[0] not in FORBIDDEN, (path, module)


def test_no_source_loads_the_reference_build():
    """The port loads nothing built from the reference package: no source
    of peclr_tpu_torch (Python, C++ or CUDA) and not chip_smoke.py names
    the reference's native directory or its decode library."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(os.path.join(REPO, "peclr_tpu_torch")):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        paths += [os.path.join(root, f) for f in files
                  if f.endswith((".py", ".cc", ".cu", ".cuh", ".h"))]
    assert any(p.endswith("jpeg_decode.cc") for p in paths)
    for path in paths:
        with open(path) as f:
            text = f.read()
        for name in ("native/", "libpeclr_loader"):
            assert name not in text, (path, name)


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_without_a_card():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_refuses_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path))
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "peclr_tpu_torch" in proc.stderr
