"""Mutation check of the rollback's counters and the serve loop's flight
recorder, on the CPU.

Each mutant breaks one site of `automodel_tpu_torch/` in a copy of the repo
made under OUT_DIR, and runs the tests that should catch it:

- a rollback that restores the tensors but leaves the counters (the
  train state's step and the optimizer's count, a host int or, under
  `skip_nonfinite_updates`, a scalar tensor on the device) where they were
  (`utils/host_buffers.fill`): the cosine schedule of
  `tiny_llama_resilient_smoke.yaml` then gives the steps after the
  rollback other learning rates and Adam bias corrections than JAX's
  rewound run, and the in-place restore test sees the counts;
- a skipped update that still advances the optimizer's count
  (`optim/optimizer._update_where`): the steps after the skip run the
  schedule and the bias corrections one count ahead of the JAX step's;
- a serve loop that re-raises a crash without dumping the flight recorder
  (`serving/engine.serve_batch`).

    python tests/resilience_mutants.py [OUT_DIR]

Prints one line per mutant, its pytest summary and the tests that failed,
and exits 1 if a mutant fails no test (or the unmutated copy fails one).
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import moe_family_mutants  # noqa: E402

RECIPE = ("tests/test_torch_resilience.py::test_resilient_yaml_matches_jax_through_the_faults "
          "tests/test_torch_resilience.py::test_rollback_restores_in_place_and_rewinds_the_"
          "counters")
CRASH = "tests/test_torch_observability.py::test_serve_step_crash_dumps_the_flight_recorder"
SKIP = "tests/test_torch_resilience.py::test_skipped_updates_select_as_the_jax_step"

MUTANTS = {
    "none": (f"{RECIPE} {CRASH} {SKIP}", []),
    "rollback_keeps_counters": (
        RECIPE,
        [("utils/host_buffers.py", "    return copy.deepcopy(saved)\n", "    return live\n"),
         ("utils/host_buffers.py", "        return live.copy_(saved)\n",
          "        return live.copy_(saved) if live.dim() else live\n")]),
    "skip_advances_count": (
        SKIP,
        [("optim/optimizer.py", "        count.add_(ok.to(count.dtype))\n",
          "        count.add_(1)\n")]),
    "no_flight_dump_on_crash": (
        CRASH,
        [("serving/engine.py",
          '        except BaseException:\n            self.obs.flight_dump("crash")\n',
          "        except BaseException:\n")]),
}


if __name__ == "__main__":
    moe_family_mutants.MUTANTS = MUTANTS
    sys.exit(moe_family_mutants.main(sys.argv[1:]))
