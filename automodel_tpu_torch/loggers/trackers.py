"""Experiment-tracker bridges, wandb / mlflow / comet, offline-safe (port
of `automodel_tpu/loggers/trackers.py`). Where the client library is
missing or cannot start (no network), a tracker writes a local JSONL
mirror, `<run_dir>/<kind>_metrics.jsonl`, through the same interface, so
the recipe never branches on a tracker's availability. The port runs one
process, which writes as rank 0.

YAML:

    wandb:  {project: my-proj, name: run-1, mode: offline}
    mlflow: {tracking_uri: file:./mlruns, experiment: my-exp}
    comet:  {project: my-proj, workspace: me}
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any

logger = logging.getLogger(__name__)


class _NullTracker:
    """The local JSONL mirror with the tracker interface."""

    def __init__(self, run_dir: str, kind: str):
        os.makedirs(run_dir, exist_ok=True)
        self._f = open(os.path.join(run_dir, f"{kind}_metrics.jsonl"), "a")

    def log(self, metrics: dict, step: int | None = None) -> None:
        if self._f is None:
            return
        rec = {"step": step, "ts": time.time(), **metrics}
        self._f.write(json.dumps(rec, default=float) + "\n")
        self._f.flush()

    def log_config(self, config: dict) -> None:
        self.log({"_config": config})

    def finish(self, status: str = "FINISHED") -> None:
        if self._f is not None:
            self.log({"_status": status})
            self._f.close()
            self._f = None


class WandbTracker:
    def __init__(self, cfg: dict, run_dir: str):
        self._run = None
        self._fallback = None
        try:
            import wandb

            self._run = wandb.init(
                project=cfg.get("project", "automodel_tpu"),
                name=cfg.get("name"),
                mode=cfg.get("mode", "offline"),
                dir=run_dir,
                config=cfg.get("config"),
            )
        except Exception as e:  # library missing or no network
            logger.warning("wandb unavailable (%s): local JSONL mirror", e)
            self._fallback = _NullTracker(run_dir, "wandb")

    def log(self, metrics: dict, step: int | None = None) -> None:
        if self._run is not None:
            self._run.log(metrics, step=step)
        elif self._fallback is not None:
            self._fallback.log(metrics, step)

    def log_config(self, config: dict) -> None:
        if self._run is not None:
            self._run.config.update(config, allow_val_change=True)
        elif self._fallback is not None:
            self._fallback.log_config(config)

    def finish(self, status: str = "FINISHED") -> None:
        if self._run is not None:
            self._run.finish(exit_code=0 if status == "FINISHED" else 1)
            self._run = None
        elif self._fallback is not None:
            self._fallback.finish(status)


class MLflowTracker:
    """Marks the run KILLED on a SIGTERM exit."""

    def __init__(self, cfg: dict, run_dir: str):
        self._mlflow = None
        self._fallback = None
        try:
            import mlflow

            if cfg.get("tracking_uri"):
                mlflow.set_tracking_uri(cfg["tracking_uri"])
            mlflow.set_experiment(cfg.get("experiment", "automodel_tpu"))
            mlflow.start_run(run_name=cfg.get("name"))
            self._mlflow = mlflow
        except Exception as e:
            logger.warning("mlflow unavailable (%s): local JSONL mirror", e)
            self._fallback = _NullTracker(run_dir, "mlflow")

    def log(self, metrics: dict, step: int | None = None) -> None:
        if self._mlflow is not None:
            clean = {k: float(v) for k, v in metrics.items() if _is_number(v)}
            self._mlflow.log_metrics(clean, step=step)
        elif self._fallback is not None:
            self._fallback.log(metrics, step)

    def log_config(self, config: dict) -> None:
        if self._mlflow is not None:
            self._mlflow.log_params(_flatten(config))
        elif self._fallback is not None:
            self._fallback.log_config(config)

    def finish(self, status: str = "FINISHED") -> None:
        if self._mlflow is not None:
            self._mlflow.end_run(status=status)
            self._mlflow = None
        elif self._fallback is not None:
            self._fallback.finish(status)


def _is_number(v: Any) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


def _flatten(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = str(v)
    return out


class CometTracker:
    """The Comet experiment bridge, with the same JSONL fallback."""

    def __init__(self, cfg: dict, run_dir: str):
        self._exp = None
        self._fallback = None
        try:
            import comet_ml

            self._exp = comet_ml.Experiment(
                project_name=cfg.get("project", "automodel_tpu"),
                workspace=cfg.get("workspace"),
                disabled=bool(cfg.get("disabled", False)),
            )
            if cfg.get("name"):
                self._exp.set_name(cfg["name"])
        except Exception as e:  # library missing or no network
            logger.warning("comet unavailable (%s): local JSONL mirror", e)
            self._fallback = _NullTracker(run_dir, "comet")

    def log(self, metrics: dict, step: int | None = None) -> None:
        if self._exp is not None:
            self._exp.log_metrics(metrics, step=step)
        elif self._fallback is not None:
            self._fallback.log(metrics, step)

    def log_config(self, config: dict) -> None:
        if self._exp is not None:
            self._exp.log_parameters(config)
        elif self._fallback is not None:
            self._fallback.log_config(config)

    def finish(self, status: str = "FINISHED") -> None:
        if self._exp is not None:
            if status != "FINISHED":
                self._exp.log_other("status", status)
            self._exp.end()
            self._exp = None
        elif self._fallback is not None:
            self._fallback.finish(status)


_TRACKERS = {"wandb": WandbTracker, "mlflow": MLflowTracker, "comet": CometTracker}


def build_trackers(cfg, run_dir: str) -> list:
    """Every tracker the YAML has a section for."""
    trackers = []
    for key, cls in _TRACKERS.items():
        node = cfg.get(key)
        if node is not None:
            trackers.append(
                cls(node.to_dict() if hasattr(node, "to_dict") else dict(node), run_dir))
    return trackers
