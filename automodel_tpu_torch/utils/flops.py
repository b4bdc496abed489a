"""MFU / FLOPs accounting (port of `automodel_tpu/utils/flops.py`): the
per-architecture FLOPs formula lives on the model config
(`flops_per_token`: the dense decoder's, or the MoE decoder's with the
routed experts counted at top-k of E and the router); this module has the
card's peak and the MFU/TPS computation the recipe logs."""

from __future__ import annotations

import dataclasses

import torch

#: dense bf16 peak TFLOP/s per card, by a substring of its CUDA device name
#: (NVIDIA data sheets, SXM parts)
PEAK_TFLOPS = {
    "h100": 989.0,
    "h200": 989.0,
    "a100": 312.0,
}


def device_peak_tflops(device=None) -> float:
    """The dense bf16 peak of a CUDA device. Raises for any other device and
    for a card not in the table: an MFU against a guessed peak is no MFU."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError(f"no peak FLOP/s is known for a {device.type} device")
    name = torch.cuda.get_device_name(device).lower()
    for key, peak in PEAK_TFLOPS.items():
        if key in name:
            return peak
    raise ValueError(f"no peak FLOP/s is known for the card {name!r}")


@dataclasses.dataclass
class MFUCalculator:
    """tokens/sec and MFU from a model config's flops_per_token. Without a
    peak (a CPU run) `mfu_pct` is None."""

    flops_per_token: float
    num_devices: int = 1
    peak_tflops_per_device: float | None = None

    def metrics(self, num_tokens: int, seconds: float) -> dict:
        tps = num_tokens / seconds
        achieved = tps * self.flops_per_token
        mfu = None
        if self.peak_tflops_per_device is not None:
            peak = self.peak_tflops_per_device * 1e12 * self.num_devices
            mfu = 100.0 * achieved / peak
        return {
            "tps": tps,
            "tps_per_device": tps / self.num_devices,
            "tflops_per_device": achieved / self.num_devices / 1e12,
            "mfu_pct": mfu,
        }
