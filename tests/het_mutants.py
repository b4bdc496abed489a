"""Mutation check of the heterogeneous MoE engine's and Gemma-4's port, on the
CPU.

Each mutant breaks one site of `automodel_tpu_torch/` in a copy of the repo
made under OUT_DIR, and runs the tests that should catch it:

- MiMo's sinks dropped from the sliding layers' attention (the forward and
  gradients, tests/test_torch_het_moe.py; het_generate's forward oracle);
- rope applied on Step-3.5's NoPE layer;
- Gemma-4's KV-shared layers computing their own K/V from their zero
  placeholders (tests/test_torch_gemma4.py);
- the sparse block selection breaking ties by the highest block index
  (the bitwise keep-mask test);
- Step-3.5's head gate taken off.

    python tests/het_mutants.py [OUT_DIR]

Prints one line per mutant, its pytest summary and the tests that failed,
and exits 1 if a mutant fails no test (or the unmutated copy fails one).
The mutants run in parallel (~2 min).
"""

from __future__ import annotations

import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import moe_family_mutants

HET = "tests/test_torch_het_moe.py"
FORWARD = f"{HET}::test_forward_and_gradients_match_jax"
# mutant -> (the tests that should catch it, [(file under the package, the
# source text, its replacement)]); each text occurs once in its file
MUTANTS = {
    "none": (f"{FORWARD} {HET}::test_select_sparse_blocks_bitwise_with_ties "
             "tests/test_torch_gemma4.py::test_forward_and_gradients_match_jax", []),
    "drop_sinks": (f"{FORWARD} tests/test_torch_het_generate.py", [
        ("models/moe_lm/het_moe.py",
         '            sinks=lp["sinks"] if g.sinks else None, impl=cfg.attn_impl,',
         "            sinks=None, impl=cfg.attn_impl,")]),
    "rope_on_nope_layers": (FORWARD, [
        ("models/moe_lm/het_moe.py", "    if not (roped and rot):", "    if not rot:")]),
    "gemma4_shared_layers_own_kv": (
        "tests/test_torch_gemma4.py::test_forward_and_gradients_match_jax", [
            ("models/moe_lm/gemma4.py",
             "        kv_in = last_kv[lt] if i >= first_shared else None",
             "        kv_in = None")]),
    "ties_by_highest_index": (f"{HET}::test_select_sparse_blocks_bitwise_with_ties", [
        ("models/moe_lm/het_moe.py",
         "    _, top_idx = stable_topk(sel, k_eff)",
         "    top_idx = sel.shape[-1] - 1 - stable_topk(sel.flip(-1), k_eff)[1]")]),
    "no_head_gate": (FORWARD, [
        ("models/moe_lm/het_moe.py",
         "    if cfg.head_gate:\n        gate = torch.sigmoid(x @ lp[\"g_proj\"][\"kernel\"])\n"
         "        attn = attn * gate",
         "    if False:\n        gate = torch.sigmoid(x @ lp[\"g_proj\"][\"kernel\"])\n"
         "        attn = attn * gate")]),
}


def main(argv: list[str]) -> int:
    out_dir = Path(argv[0]) if argv else Path(tempfile.mkdtemp(prefix="het_mutants_"))
    out_dir.mkdir(parents=True, exist_ok=True)
    # the copy-and-run machinery of tests/moe_family_mutants.py, on this table
    moe_family_mutants.MUTANTS = MUTANTS
    ok = True
    with ThreadPoolExecutor(3) as pool:
        for line, caught in pool.map(lambda n: moe_family_mutants.run(n, out_dir), MUTANTS):
            print(line, flush=True)
            ok = ok and caught
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
