"""Environment-derived paths (the same env-var contract as
peclr_tpu/constants.py: DATA_PATH, SAVED_MODELS_BASE_PATH, ...)."""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DATA_PATH = os.environ.get("DATA_PATH", os.path.join(REPO_ROOT, "data", "raw"))
FREIHAND_DATA = os.path.join(DATA_PATH, "freihand_dataset")
SAVED_MODELS_BASE_PATH = os.environ.get(
    "SAVED_MODELS_BASE_PATH", os.path.join(REPO_ROOT, "data", "models")
)
