"""JSONL per-step metric logging and stdlib logging setup (port of
`automodel_tpu/loggers/metric_logger.py`; the port runs one process, so
there is no rank filter). The records keep the JAX keys, which is what the
loss-curve comparison (`scripts/compare_golden.py`) reads."""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import IO, Any


class MetricLogger:
    """Append one JSON object per step to a .jsonl file."""

    def __init__(self, path: str | None, also_stdout: bool = True):
        self.path = path
        self.also_stdout = also_stdout
        self._f: IO | None = None
        self._counters: dict[str, float] = {}
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")

    def set_counter(self, name: str, value: float) -> None:
        """Pin a counter to an externally-owned monotonic total; current
        values ride every subsequent `log` record. The resilience layer
        mirrors its retry/rollback/wasted-step totals here, so goodput is
        reconstructable from the JSONL."""
        self._counters[name] = value

    def log(self, record: dict) -> None:
        rec = {k: _to_scalar(v) for k, v in record.items()}
        for k, v in self._counters.items():
            rec.setdefault(k, v)
        rec.setdefault("ts", time.time())
        if self._f is not None:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self.also_stdout:
            body = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items()
                if k not in ("ts", "step")
            )
            logging.getLogger("metrics").info("step %s | %s", rec.get("step", "?"), body)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def _to_scalar(v: Any):
    if hasattr(v, "item"):
        return v.item()
    return v


def setup_logging(level: int = logging.INFO) -> None:
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s [%(name)s] %(message)s")
    )
    root = logging.getLogger()
    root.handlers = [handler]
    root.setLevel(level)
