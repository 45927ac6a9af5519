"""Small JSON helpers (port of peclr_tpu/utils/io.py)."""

from __future__ import annotations

import json
from typing import Any


def read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def save_json(obj: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)
