"""Process-group bootstrap (port of
`automodel_tpu/distributed/init_utils.py`).

The JAX package joins the pod's coordination service; the port starts a
`torch.distributed` process group from the environment `torchrun` sets
(`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`): NCCL
when the run is on the card, gloo on the CPU. Each rank binds its card
(`torch.cuda.set_device(LOCAL_RANK)`) before the group starts. A process
that no launcher started (no `WORLD_SIZE` in the environment) starts no
group: it is the plain one-device path.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def launched_distributed() -> bool:
    """True when a launcher (torchrun, or a test's spawned ranks) set the
    process group's environment."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def initialize_distributed(device: torch.device | str | None = None,
                           timeout_s: float = 600.0) -> bool:
    """Start the process group from the launcher's environment, once.

    `device` picks the backend (a CUDA device: NCCL, bound to
    `LOCAL_RANK`; else gloo). Returns True when a group is up, False for a
    process no launcher started."""
    if dist.is_initialized():
        return True
    if not launched_distributed():
        return False
    dev = torch.device("cuda" if device is None else device)
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    backend = "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    logger.info("process group up: rank %d/%d, %s", rank, world, backend)
    return True


def local_device(device: torch.device) -> torch.device:
    """This rank's card (`cuda:LOCAL_RANK`) for a CUDA run, else `device`."""
    if device.type == "cuda" and device.index is None and dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def get_world_size_safe() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank_safe() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return get_rank_safe() == 0


def destroy_distributed() -> None:
    """Tear the group down (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
