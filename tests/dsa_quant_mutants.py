"""Mutation check of the DSA top-k and the quantizer's fp32 clip, on the CPU.

Each mutant breaks one site of `automodel_tpu_torch/` in a copy of the repo
made under OUT_DIR, and runs the tests that should catch it:

- the top-k breaking ties by the HIGHEST index (`ops/dsa.stable_topk` on the
  reversed scores): the GLM-like tie case of tests/test_torch_dsa.py, whose
  relu zeros cross the top-k boundary with fewer keys selected than are
  admissible;
- the quantizer without its fp32 clip before the division
  (`ops/quant._quantize`): the inf inputs of
  tests/test_torch_quant_linear.py make the scale inf and the quantized
  value NaN.

    python tests/dsa_quant_mutants.py [OUT_DIR]

Prints one line per mutant, its pytest summary and the tests that failed,
and exits 1 if a mutant fails no test (or the unmutated copy fails one).
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import moe_family_mutants  # noqa: E402

MUTANTS = {
    "none": ("tests/test_torch_dsa.py::test_topk_select_ties_match_jax_and_fail_a_highest_"
             "index_tiebreak tests/test_torch_quant_linear.py::test_quantize_is_bit_equal_"
             "and_clamps_in_fp32", []),
    "topk_ties_to_highest_index": (
        "tests/test_torch_dsa.py::test_topk_select_ties_match_jax_and_fail_a_highest_"
        "index_tiebreak tests/test_torch_dsa.py::test_sparse_block_matches_jax",
        [("ops/dsa.py",
          "    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)\n",
          "    vals, idx = torch.sort(x.flip(-1), dim=-1, descending=True, stable=True)\n"
          "    idx = x.shape[-1] - 1 - idx\n")]),
    "no_fp32_clip": (
        "tests/test_torch_quant_linear.py::test_quantize_is_bit_equal_and_clamps_in_fp32",
        [("ops/quant.py", "        xf.clamp_(_F32.min, _F32.max)\n", "")]),
}


if __name__ == "__main__":
    moe_family_mutants.MUTANTS = MUTANTS
    sys.exit(moe_family_mutants.main(sys.argv[1:]))
