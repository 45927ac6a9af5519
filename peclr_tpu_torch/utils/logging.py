"""Console logging and experiment tracking (port of
peclr_tpu/utils/logging.py).

ExperimentLogger is offline first: params, tags and per-step/epoch metrics
go to JSONL and JSON files under <meta_dir>/<experiment_key>/, with the
step/epoch cadence switch of `-log_interval`.  PECLR_TRACKER=comet mirrors
them to Comet (comet_ml and the COMET_* variables); a remote failure never
stops training.
"""

from __future__ import annotations

import json
import logging
import os
import time
import uuid
from typing import Any, Dict, Optional

from peclr_tpu_torch import constants


def get_console_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(constants.STD_LOGGING_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger


class CometRemote:
    """The ExperimentLogger surface onto a `comet_ml.Experiment`."""

    def __init__(self, experiment_name: str, comet_module=None):
        if comet_module is None:
            import comet_ml as comet_module
        kwargs = {k: v for k, v in constants.COMET_KWARGS.items()
                  if v is not None}
        self._exp = comet_module.Experiment(**kwargs)
        self._exp.set_name(experiment_name)

    def log_parameters(self, params: Dict[str, Any]):
        self._exp.log_parameters(params)

    def add_tags(self, tags):
        self._exp.add_tags(list(tags))

    def log_metrics(self, metrics, step=None, epoch=None, context="train"):
        # Comet namespaces validation metrics by prefix
        if context != "train":
            metrics = {f"{context}_{k}": v for k, v in metrics.items()}
        self._exp.log_metrics(metrics, step=step, epoch=epoch)

    def log_figure(self, path: str, name: Optional[str] = None):
        self._exp.log_image(path, name=name)

    def end(self):
        self._exp.end()


def make_remote_tracker(experiment_name: str):
    """The remote backend that PECLR_TRACKER selects: CometRemote for
    "comet", None when unset, "none" or "offline".  An unknown name, a
    missing package or a failed construction warns and gives None."""
    backend = os.environ.get("PECLR_TRACKER", "").strip().lower()
    if backend in ("", "none", "offline"):
        return None
    log = get_console_logger("peclr_tpu_torch.tracking")
    if backend != "comet":
        log.warning(f"unknown PECLR_TRACKER={backend!r}; tracking offline only")
        return None
    try:
        return CometRemote(experiment_name)
    except Exception as e:
        log.warning(f"comet tracker unavailable ({e}); tracking offline only")
        return None


class ExperimentLogger:
    """File-backed experiment tracker: experiment.json (name, key, tags,
    params), metrics.jsonl and figures.jsonl, optionally mirrored to a
    remote backend (`remote=` or PECLR_TRACKER)."""

    def __init__(
        self,
        meta_dir: str,
        experiment_name: str,
        experiment_key: Optional[str] = None,
        log_interval: str = "epoch",
        remote=None,
    ):
        self.experiment_name = experiment_name
        self.experiment_key = experiment_key or uuid.uuid4().hex
        self.log_interval = log_interval
        self.dir = os.path.join(meta_dir, self.experiment_key)
        os.makedirs(self.dir, exist_ok=True)
        self._metrics_path = os.path.join(self.dir, "metrics.jsonl")
        self._metrics_f = open(self._metrics_path, "a")
        self._meta: Dict[str, Any] = {
            "experiment_name": experiment_name,
            "experiment_key": self.experiment_key,
            "created": time.time(),
            "tags": [],
            "params": {},
        }
        self._flush_meta()
        self.remote = (
            remote if remote is not None else make_remote_tracker(experiment_name)
        )

    def _remote(self, method: str, *args, **kwargs):
        if self.remote is None:
            return
        try:
            getattr(self.remote, method)(*args, **kwargs)
        except Exception as e:  # remote tracking must never stop training
            get_console_logger("peclr_tpu_torch.tracking").warning(
                f"remote {method} failed: {e}"
            )

    def _flush_meta(self):
        with open(os.path.join(self.dir, "experiment.json"), "w") as f:
            json.dump(self._meta, f, indent=2, default=str)

    def log_parameters(self, params: Dict[str, Any]):
        flat = _flatten(params)
        self._meta["params"].update(flat)
        self._flush_meta()
        self._remote("log_parameters", flat)

    def add_tags(self, tags):
        self._meta["tags"].extend(tags)
        self._flush_meta()
        self._remote("add_tags", tags)

    def log_metrics(self, metrics: Dict[str, float], step: Optional[int] = None,
                    epoch: Optional[int] = None, context: str = "train"):
        rec = {
            "t": time.time(),
            "context": context,
            "step": step,
            "epoch": epoch,
            **{k: _to_float(v) for k, v in metrics.items()},
        }
        if self._metrics_f.closed:  # written again after close()
            self._metrics_f = open(self._metrics_path, "a")
        self._metrics_f.write(json.dumps(rec) + "\n")
        self._metrics_f.flush()
        self._remote("log_metrics", metrics, step=step, epoch=epoch,
                     context=context)

    def log_figure(self, path: str, name: Optional[str] = None):
        """Record a saved figure."""
        with open(os.path.join(self.dir, "figures.jsonl"), "a") as f:
            f.write(json.dumps({"t": time.time(), "path": path, "name": name})
                    + "\n")
        self._remote("log_figure", path, name=name)

    def close(self):
        """Idempotent; a later write reopens the metrics file."""
        if not self._metrics_f.closed:
            self._metrics_f.close()
        self._remote("end")
        self.remote = None


class NullLogger:
    """ExperimentLogger's surface, recording nothing: the tracker of a
    data-parallel rank other than 0 (rank 0 alone writes)."""

    dir = None

    def __init__(self, experiment_name: str, experiment_key: str,
                 log_interval: str = "epoch"):
        self.experiment_name = experiment_name
        self.experiment_key = experiment_key
        self.log_interval = log_interval

    def log_parameters(self, params: Dict[str, Any]):
        pass

    def add_tags(self, tags):
        pass

    def log_metrics(self, metrics: Dict[str, float], step: Optional[int] = None,
                    epoch: Optional[int] = None, context: str = "train"):
        pass

    def log_figure(self, path: str, name: Optional[str] = None):
        pass

    def close(self):
        pass


def _to_float(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


def _flatten(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


#: augmentation flag -> short experiment-name code
NAME_CODES = {
    "color_drop": "CD",
    "color_jitter": "CJ",
    "crop": "C",
    "cut_out": "CO",
    "flip": "F",
    "gaussian_blur": "GB",
    "random_crop": "RC",
    "resize": "Re",
    "rotate": "Ro",
    "sobel_filter": "SF",
    "gaussian_noise": "GN",
}


def prepare_name(prefix: str, batch_size: int, active_flags) -> str:
    codes = "_".join(sorted(NAME_CODES[f] for f in active_flags if f in NAME_CODES))
    return f"{prefix}{batch_size}{codes}"
