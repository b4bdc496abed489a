"""Mutation check of K4's and K5's sliding window and sinks, in the CPU
emulation.

Each mutant drops the window or the sink at one site of
`automodel_tpu_torch/csrc/ragged_paged_attention.cu` or `paged_split.cuh`;
the window and sink cases of tests/test_torch_rpa_emulated.py (both routes
of both kernels) run against each, in a copy of the repo made under
OUT_DIR. A mutant no case fails is a site the tests do not hold. (The
split kernel's early exit below the window is left out: without it such a
split runs no step and writes partials the combine never reads, so the
output is the same; the NaN-page case shows no page below the window is
read.)

    python tests/cuda_emulation/window_sink_mutants.py [OUT_DIR]

Prints one line per mutant: its pytest summary and the cases that failed.
Needs g++; the mutants build and run in parallel (~1 min).
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
CSRC = "automodel_tpu_torch/csrc/"
TEST = "tests/test_torch_rpa_emulated.py"
# mutant -> (file under csrc, the source text, its replacement) for each of
# its sites; each text occurs once in its file
MUTANTS = {
    "none": None,
    # every route: the window's first kv is 0
    "no_window": [("paged_split.cuh",
                   "  return window > 0 ? max(pos - window + 1, 0) : 0;",
                   "  return 0;")],
    # the split kernel reads from the split's start, not the window's
    "split_from_j0": [("paged_split.cuh",
                       "  const int jlo = max(j0, lo);", "  const int jlo = j0;")],
    # the combine reads every split from 0, written or not
    "combine_from_split_0": [(
        "paged_split.cuh",
        "  const int first = pos < 0 ? 0 : window_start(pos, sh.window) / sh.split_kv;",
        "  const int first = 0;")],
    # the CUDA-core kernel keeps the first page's rows below the window
    "fma_no_row_mask": [
        ("ragged_paged_attention.cu",
         "        p_s[pr] = (base + r <= pos && base + r >= lo) ? s : -INFINITY;",
         "        p_s[pr] = (base + r <= pos) ? s : -INFINITY;"),
        ("ragged_paged_attention.cu",
         "        const float e = (base + r <= pos && base + r >= lo)",
         "        const float e = (base + r <= pos)")],
    "combine_no_sink": [("paged_split.cuh",
                         "  if (sinks != nullptr) {\n    mx = fmaxf(mx, sinks[h]);",
                         "  if (false) {\n    mx = fmaxf(mx, sinks[h]);")],
    "fma_no_sink": [("ragged_paged_attention.cu",
                     "    if (sinks != nullptr) {\n      const float s = sinks[h * G + g];",
                     "    if (false) {\n      const float s = sinks[h * G + g];")],
}


def run(name: str, out_dir: Path) -> str:
    d = out_dir / name
    shutil.rmtree(d, ignore_errors=True)
    for sub in ("automodel_tpu", "automodel_tpu_torch", "tests"):
        shutil.copytree(ROOT / sub, d / sub,
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(ROOT / "pytest.ini", d / "pytest.ini")
    for file, old, new in MUTANTS[name] or ():
        path = d / CSRC / file
        src = path.read_text()
        assert src.count(old) == 1, f"{name}: the site occurs {src.count(old)} times"
        path.write_text(src.replace(old, new))
    env = dict(os.environ, JAX_PLATFORMS="cpu", HOME=str(d))
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                        "-k", "window or sinks or exited", TEST], cwd=d,
                       capture_output=True, text=True, env=env)
    failed = sorted(set(re.findall(r"FAILED \S+::(\S+)", r.stdout)))
    summary = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else r.stderr[-300:]
    return f"{name}: {summary} | failed: {failed}"


def main(argv: list[str]) -> int:
    out_dir = Path(argv[0]) if argv else Path(tempfile.mkdtemp(prefix="window_sink_mutants_"))
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(MUTANTS)) as pool:
        for line in pool.map(lambda n: run(n, out_dir), MUTANTS):
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
