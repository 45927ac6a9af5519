"""Small JSON and YAML helpers (port of peclr_tpu/utils/io.py)."""

from __future__ import annotations

import json
from typing import Any


def read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def save_json(obj: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def read_yaml(path: str) -> Any:
    """A YAML file's content; yaml is imported only here."""
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)
