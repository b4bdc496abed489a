"""Mutation check of K1-K3's soft cap, in the CPU emulation.

Each mutant drops the cap, or the cap's gradient factor 1 - tanh^2, at one
site of `automodel_tpu_torch/csrc/flash_attention.cu`; the capped cases of
tests/test_torch_flash_emulated.py (both routes) run against each, in a copy
of the repo made under OUT_DIR. A mutant no case fails is a site the tests do
not hold. `--unit-logits` runs the same with the cases' q left at unit
variance (no `capped_q`), where the cap hardly bends the logits.

    python tests/cuda_emulation/soft_cap_mutants.py [OUT_DIR] [--unit-logits]

Prints one line per mutant: the capped cases that failed (dtype0 is
bfloat16, the tensor-core route; dtype1 float32, the CUDA-core route).
Needs g++; the mutants build and run in parallel (~2 min).
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CU = "automodel_tpu_torch/csrc/flash_attention.cu"
TEST = "tests/test_torch_flash_emulated.py"
# mutant -> (the source text, its replacement); each text occurs once
MUTANTS = {
    "none": None,
    "K1_mma_no_cap": (
        "          s[j][e] = p.soft_cap * tanhf(s[j][e] * p.scale / p.soft_cap);",
        "          s[j][e] = s[j][e] * p.scale;"),
    "K1_fma_no_cap": (
        "        if (p.soft_cap > 0.f) x = p.soft_cap * tanhf(x / p.soft_cap);",
        "        "),
    "K2_mma_no_cap_grad": (
        "          cap_grad = 1.f - th * th;\n          pr = fast_exp2",
        "          cap_grad = 1.f;\n          pr = fast_exp2"),
    # the split K3 (head dim 256): the (1 - tanh^2) scale P^T hands over
    "K3_mma_split_no_cap_grad": (
        "              cap_grad = 1.f - th * th;",
        "              cap_grad = 1.f;"),
    "K3_mma_no_cap_grad": (
        "            cap_grad = 1.f - th * th;\n          }\n          const float pr",
        "            cap_grad = 1.f;\n          }\n          const float pr"),
    "K2_K3_fma_no_cap_grad": ("  if (p.soft_cap > 0.f) g *= 1.f - t * t;", ""),
}


def run(name: str, out_dir: Path, unit_logits: bool) -> str:
    d = out_dir / name
    shutil.rmtree(d, ignore_errors=True)
    for sub in ("automodel_tpu", "automodel_tpu_torch", "tests"):
        shutil.copytree(ROOT / sub, d / sub,
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(ROOT / "pytest.ini", d / "pytest.ini")
    if MUTANTS[name] is not None:
        old, new = MUTANTS[name]
        src = (d / CU).read_text()
        assert src.count(old) == 1, f"{name}: the site occurs {src.count(old)} times"
        (d / CU).write_text(src.replace(old, new))
    if unit_logits:
        test = (d / TEST).read_text()
        old = "return q if cap is None else (q.float() * (cap / 4)).to(q.dtype)"
        assert old in test
        (d / TEST).write_text(test.replace(old, "return q"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", HOME=str(d))
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                        "-k", "softcap", TEST], cwd=d, capture_output=True, text=True,
                       env=env)
    failed = sorted(set(re.findall(r"FAILED \S+\[(\S+)\]", r.stdout)))
    summary = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else r.stderr[-300:]
    return f"{name}: {summary} | failed: {failed}"


def main(argv: list[str]) -> int:
    unit = "--unit-logits" in argv
    args = [a for a in argv if a != "--unit-logits"]
    out_dir = Path(args[0]) if args else Path(tempfile.mkdtemp(prefix="soft_cap_mutants_"))
    out_dir.mkdir(parents=True, exist_ok=True)
    print(f"logits: {'unit variance' if unit else 'bent by the cap (capped_q)'}", flush=True)
    with ThreadPoolExecutor(len(MUTANTS)) as pool:
        for line in pool.map(lambda n: run(n, out_dir, unit), MUTANTS):
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
