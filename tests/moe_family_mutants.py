"""Mutation check of the GQA MoE families' port and of K1-K3's head-dim
padding, on the CPU.

Each mutant breaks one site of `automodel_tpu_torch/` in a copy of the repo
made under OUT_DIR, and runs the tests that should catch it:

- the softmax scale of a padded head taken from the padded head dim (the
  emulated K1-K3 at head dims 8 and 32, tests/test_torch_flash_emulated_base.py);
- gpt-oss's `gate_up_proj` read as gate then up halves, not interleaved
  (the checkpoint round trip, tests/test_torch_moe_families.py);
- gpt-oss's activation without its clamp (the forward and the MoE block
  past the clamp);
- Hunyuan's q/k norms before the rotary, not after (its config and
  forward);
- the engine's rotary over the whole head, the partial rotary ignored
  (tests/test_torch_moe_families_serving.py, GLM-4.5 served).

    python tests/moe_family_mutants.py [OUT_DIR]

Prints one line per mutant, its pytest summary and the tests that failed,
and exits 1 if a mutant fails no test. Needs g++ for the first mutant;
the mutants run in parallel (~3 min).
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

ROOT = Path(__file__).resolve().parents[1]
PKG = "automodel_tpu_torch/"
# mutant -> (the tests that should catch it, [(file under the package, the
# source text, its replacement)]); each text occurs once in its file
MUTANTS = {
    "none": ("tests/test_torch_moe_families.py", []),
    "scale_from_padded_dim": (
        "tests/test_torch_flash_emulated_base.py::test_emulated_kernels_take_padded_head_dims",
        [("ops/flash_attention.py",
          "        fa_cuda.pad_head_dim(v, Dvp), scale=scale, soft_cap=soft_cap, masks=masks)",
          "        fa_cuda.pad_head_dim(v, Dvp), scale=Dp ** -0.5, soft_cap=soft_cap,"
          " masks=masks)")]),
    "gate_up_not_interleaved": (
        "tests/test_torch_moe_families.py::test_checkpoints_round_trip_bitwise",
        [("checkpoint/hf_adapter.py",
          "                        lambda n, cols=cols: plain(n)[..., cols], dtype, device))",
          "                        lambda n, cols=cols: plain(n).unflatten(-1, (2, -1))"
          "[..., cols.start, :], dtype, device))")]),
    "no_clamp": (
        "tests/test_torch_moe_families.py",
        [("moe/experts.py",
          "        g = torch.clamp(g, max=limit)\n        u = torch.clamp(u, -limit, limit)\n",
          "")]),
    "hunyuan_qk_norm_before_rope": (
        "tests/test_torch_moe_families.py",
        [("models/moe_lm/families.py",
          '    kw["qk_norm_after_rope"] = True\n',
          '    kw["qk_norm_after_rope"] = False\n')]),
    "engine_rotates_whole_head": (
        "tests/test_torch_moe_families_serving.py",
        [("serving/engine.py",
          "        inv_freq = rope_frequencies(\n            cfg.rope_dim,",
          "        inv_freq = rope_frequencies(\n            cfg.resolved_head_dim,")]),
}


def run(name: str, out_dir: Path) -> tuple[str, bool]:
    d = out_dir / name
    shutil.rmtree(d, ignore_errors=True)
    for sub in ("automodel_tpu", "automodel_tpu_torch", "tests", "examples"):
        shutil.copytree(ROOT / sub, d / sub,
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(ROOT / "pytest.ini", d / "pytest.ini")
    shutil.copy(ROOT / "chip_smoke.py", d / "chip_smoke.py")  # published configs
    tests, sites = MUTANTS[name]
    for file, old, new in sites:
        path = d / PKG / file
        src = path.read_text()
        assert src.count(old) == 1, f"{name}: the site occurs {src.count(old)} times"
        path.write_text(src.replace(old, new))
    env = dict(os.environ, JAX_PLATFORMS="cpu", HOME=str(d))
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                        "-p", "no:randomly", *tests.split()], cwd=d,
                       capture_output=True, text=True, env=env)
    failed = sorted(set(re.findall(r"FAILED \S+::(\S+)", r.stdout)))
    summary = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else r.stderr[-300:]
    caught = bool(failed) if name != "none" else r.returncode == 0
    return f"{name}: {summary} | failed: {failed}", caught


def main(argv: list[str]) -> int:
    out_dir = Path(argv[0]) if argv else Path(tempfile.mkdtemp(prefix="moe_family_mutants_"))
    out_dir.mkdir(parents=True, exist_ok=True)
    ok = True
    with ThreadPoolExecutor(3) as pool:
        for line, caught in pool.map(lambda n: run(n, out_dir), MUTANTS):
            print(line, flush=True)
            ok = ok and caught
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
