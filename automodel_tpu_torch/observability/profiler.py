"""Profiling: step-windowed `torch.profiler` capture and the serve step's
analytic cost (port of `automodel_tpu/observability/profiler.py`).

- `Profiler` (train path, the recipe's `profiling:` section): a trace of
  steps [start_step, start_step + num_steps), exported as a Chrome trace
  (`trace_step<start>.json`) under `trace_dir`.
- `ServeProfiler` (serve path, `serving.observability`): one capture per
  run, triggered either by a fixed step range (`profile_window: [start, n]`)
  or by the first step whose measured time crosses `itl_spike_ms`, so the
  trace you get is the trace of the anomaly, not of a lucky warm step.
- `step_efficiency`: the JAX package asks XLA's `cost_analysis()` for the
  compiled step's FLOPs and bytes. An eager step has no compiled program
  to ask, so the engine counts them itself (`ServingEngine.step_cost`,
  from its weights and the plan's rows and positions). Joined with a
  measured step time they give achieved FLOP/s and bytes/s, and MFU /
  bandwidth utilization on a card whose name says which peaks apply
  (`card_peaks`).

The hand-written kernels launch through ctypes, so the profiler's op view
does not name them; its device timeline does.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import torch

logger = logging.getLogger(__name__)

#: dense peaks by a substring of the CUDA device name (NVIDIA data sheet,
#: SXM part): FLOP/s by compute dtype, HBM bytes/s
CARD_PEAKS = {
    "H100 80GB HBM3": {"flops": {torch.bfloat16: 989e12, torch.float16: 989e12,
                                 torch.float32: 67e12},
                       "bytes_per_s": 3.35e12},
}


def card_peaks(name: str, dtype: torch.dtype) -> Optional[dict]:
    """{"peak_flops", "peak_bytes_per_s"} of the card `name` for `dtype`, or
    None for a card (or a CPU) whose name does not say which peaks apply."""
    for key, peaks in CARD_PEAKS.items():
        if key in name and dtype in peaks["flops"]:
            return {"peak_flops": peaks["flops"][dtype],
                    "peak_bytes_per_s": peaks["bytes_per_s"]}
    return None


def _activities(device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class _Capture:
    """One torch.profiler window, exported as a Chrome trace on stop."""

    def __init__(self, device, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.prof = torch.profiler.profile(activities=_activities(device))
        self.prof.__enter__()

    def stop(self) -> str:
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(self.path)
        return self.path


@dataclasses.dataclass
class ProfilingConfig:
    trace_dir: Optional[str] = None
    start_step: int = 5     # skip warmup steps
    num_steps: int = 3

    def build(self, device="cpu") -> "Profiler":
        return Profiler(self, device)


class Profiler:
    """Step-windowed trace capture; call `step(n)` once per train step,
    after the step ran."""

    def __init__(self, config: ProfilingConfig, device="cpu"):
        self.config = config
        self.device = device
        self._capture: Optional[_Capture] = None
        self.done = False
        self.trace_path: Optional[str] = None

    def step(self, step_num: int) -> None:
        c = self.config
        if c.trace_dir is None or self.done:
            return
        if self._capture is None and step_num >= c.start_step:
            self._capture = _Capture(
                self.device, os.path.join(c.trace_dir, f"trace_step{step_num}.json"))
            logger.info("profiler trace started (step %d) → %s", step_num, c.trace_dir)
        elif self._capture is not None and step_num >= c.start_step + c.num_steps:
            self.close()

    def close(self) -> None:
        if self._capture is not None:
            self.trace_path = self._capture.stop()
            self._capture = None
            self.done = True
            logger.info("profiler trace written to %s", self.trace_path)


annotate = torch.profiler.record_function  # a named range for model code


class ServeProfiler:
    """Serving-path windowed capture. One capture per run: either the
    fixed `window = (start_step, num_steps)` or the first step whose
    measured time exceeds `itl_spike_ms` (then `spike_steps` more)."""

    def __init__(self, trace_dir: str, *, window=None,
                 itl_spike_ms: float | None = None, spike_steps: int = 3,
                 device="cpu"):
        self.trace_dir = trace_dir
        self.window = tuple(window) if window else None
        self.itl_spike_ms = itl_spike_ms
        self.spike_steps = spike_steps
        self.device = device
        self._capture: Optional[_Capture] = None
        self._stop_at: int | None = None
        self.done = False
        self.triggered_by: str | None = None
        self.trace_path: Optional[str] = None

    def observe(self, step_idx: int, step_ms: float | None = None) -> None:
        """Call once per serve step with the step's measured wall ms."""
        if self.done or self.trace_dir is None:
            return
        if self._capture is None:
            if self.window and self.window[0] <= step_idx:
                self._start(step_idx, step_idx + self.window[1], "window")
            elif (self.itl_spike_ms is not None and step_ms is not None
                  and step_ms > self.itl_spike_ms):
                self._start(step_idx, step_idx + self.spike_steps, "spike")
        elif self._stop_at is not None and step_idx >= self._stop_at:
            self._stop()

    def _start(self, step_idx: int, stop_at: int, why: str) -> None:
        self._capture = _Capture(self.device, os.path.join(
            self.trace_dir, f"serve_{why}_step{step_idx}.json"))
        self._stop_at = stop_at
        self.triggered_by = why
        logger.info("serve profiler started (%s, step %d) → %s",
                    why, step_idx, self.trace_dir)

    def _stop(self) -> None:
        self.trace_path = self._capture.stop()
        self._capture = None
        self.done = True
        logger.info("serve profiler trace written to %s", self.trace_path)

    def close(self) -> None:
        if self._capture is not None:
            self._stop()


def step_efficiency(cost: dict | None, step_s: float, *,
                    peak_flops: float | None = None,
                    peak_bytes_per_s: float | None = None) -> dict:
    """Join static cost with one measured step time. Achieved rates are
    always reported; MFU / bandwidth-utilization only when the hardware
    peaks are known (None on a CPU run)."""
    out = {"step_ms": step_s * 1e3}
    if not cost or step_s <= 0:
        return out
    gflops_s = cost["flops"] / step_s / 1e9
    gbytes_s = cost["bytes_accessed"] / step_s / 1e9
    out.update({
        "flops_per_step": cost["flops"],
        "bytes_per_step": cost["bytes_accessed"],
        "achieved_gflops_per_s": gflops_s,
        "achieved_gbytes_per_s": gbytes_s,
    })
    if peak_flops:
        out["mfu"] = cost["flops"] / step_s / peak_flops
    if peak_bytes_per_s:
        out["bw_util"] = cost["bytes_accessed"] / step_s / peak_bytes_per_s
    return out
