"""Environment-derived paths and constants (the same env-var contract as
peclr_tpu/constants.py: BASE_PATH, DATA_PATH, SAVED_MODELS_BASE_PATH,
SAVED_META_INFO_PATH, COMET_*).

Modules that use a path read it from this module when they are called
(`constants.FREIHAND_DATA`), so a caller may point it elsewhere first.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BASE_DIR = os.environ.get("BASE_PATH", REPO_ROOT)
DATA_PATH = os.environ.get("DATA_PATH", os.path.join(REPO_ROOT, "data", "raw"))
FREIHAND_DATA = os.path.join(DATA_PATH, "freihand_dataset")
YOUTUBE_DATA = os.path.join(DATA_PATH, "youtube_3d_hands", "data")
SAVED_MODELS_BASE_PATH = os.environ.get(
    "SAVED_MODELS_BASE_PATH", os.path.join(REPO_ROOT, "data", "models")
)
SAVED_META_INFO_PATH = os.environ.get(
    "SAVED_META_INFO_PATH", os.path.join(REPO_ROOT, "data", "meta")
)

STD_LOGGING_FORMAT = "%(name)s -%(levelname)s - %(message)s"

#: remote experiment-tracking credentials, read only when PECLR_TRACKER=comet
#: opts in (utils/logging.py); the JSONL record is written regardless
COMET_KWARGS = {
    "api_key": os.environ.get("COMET_API_KEY"),
    "project_name": os.environ.get("COMET_PROJECT"),
    "workspace": os.environ.get("COMET_WORKSPACE"),
}

#: FreiHAND's sizes: 32,560 unique training images in 4 colourings
#: (gs/hom/sample/auto), 3,960 evaluation images
FREIHAND_TRAIN_SIZE = 32560
FREIHAND_EVAL_SIZE = 3960
FREIHAND_VERSIONS = ("gs", "hom", "sample", "auto")
