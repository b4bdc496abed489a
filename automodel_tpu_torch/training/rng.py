"""Counter-based RNG (port of `automodel_tpu/training/rng.py`): a stream of
`torch.Generator`s, each seeded from (seed, counter). The numbers differ
from `jax.random`'s; tests hand both packages the same numpy data
instead. The counter rides the recipe's checkpoint (`state_dict`), so a
resumed run draws the keys the unbroken run would have drawn. Its keys are
the JAX state's; `ranked` is always true, since the port runs one process."""

from __future__ import annotations

import numpy as np
import torch


class StatefulRNG:
    def __init__(self, seed: int = 0, device="cpu"):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.counter = 0

    def next_key(self) -> torch.Generator:
        self.counter += 1
        ss = np.random.SeedSequence([self.seed & 0xFFFFFFFF, self.counter])
        seed = int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))
        return torch.Generator(device=self.device).manual_seed(seed)

    def state_dict(self) -> dict:
        return {"seed": self.seed, "ranked": True, "counter": self.counter}

    def load_state_dict(self, state: dict) -> None:
        if int(state["seed"]) != self.seed:
            raise ValueError(
                f"resume with a different seed ({self.seed}, checkpoint {state['seed']})")
        self.counter = int(state["counter"])
