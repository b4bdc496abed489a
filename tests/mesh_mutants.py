"""Mutation check of the port's training mesh, on the CPU.

Each mutant breaks one site of `automodel_tpu_torch/` in a copy of the repo
made under OUT_DIR and runs `tests/test_torch_mesh.py` (4 gloo ranks held
to the JAX package), which must fail:

- the FSDP gather's backward keeps this rank's block of its own gradient
  instead of reduce-scattering the sum (`parallel/collectives.py`);
- the train step divides by this rank's label-token count, not the global
  one (`training/train_step.py`);
- the `o_proj` partial sums are not all-reduced over `tp`
  (`models/llm/decoder.py`);
- the clip reads the local norm: each leaf's squared norm is not summed
  over the axes that split it (`training/train_step.py`);
- one expert's tokens go to its neighbour in the EP dispatch
  (`moe/experts.py`).

    python tests/mesh_mutants.py [OUT_DIR]

Prints one line per mutant, its pytest summary and the tests that failed,
and exits 1 if a mutant fails no test (or the unmutated copy fails one).
The mutants run in parallel, three at a time (~4 min).
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
TESTS = "tests/test_torch_mesh.py"
# mutant -> [(file under the package, the source text, its replacement)];
# each text occurs once in its file
MUTANTS = {
    "none": [],
    "no_grad_reduce_scatter": [
        ("parallel/collectives.py",
         "        return reduce_scatter_dim(g.to(ctx.in_dtype), ctx.dim, ctx.group), None, None, None",
         "        g = g.to(ctx.in_dtype)\n"
         "        n, r = group_size(ctx.group), dist.get_rank(ctx.group)\n"
         "        return g.chunk(n, ctx.dim)[r].contiguous(), None, None, None")],
    "local_token_count": [
        ("training/train_step.py",
         "            n_tokens = sync[0].sum_over_batch(n_tokens)\n", "")],
    "no_tp_reduce_after_o_proj": [
        ("models/llm/decoder.py",
         "    attn_out = reduce_from(\n", "    attn_out = (lambda x, group: x)(\n")],
    "clip_local_norm": [
        ("training/train_step.py",
         "                sq = sq.clone()\n                dist.all_reduce(sq, group=group)\n",
         "                sq = sq.clone()\n")],
    "misroute_one_expert": [
        ("moe/experts.py",
         "        torch.arange(E_loc, device=dev).repeat(P), recv_e.long(), output_size=n_recv)",
         "        torch.arange(E_loc, device=dev).clamp(min=1).repeat(P), recv_e.long(),\n"
         "        output_size=n_recv)")],
}


def run(name: str, out_dir: Path) -> tuple[str, bool]:
    d = out_dir / name
    shutil.rmtree(d, ignore_errors=True)
    for sub in ("automodel_tpu", "automodel_tpu_torch", "tests", "examples"):
        shutil.copytree(ROOT / sub, d / sub,
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(ROOT / "pytest.ini", d / "pytest.ini")
    for file, old, new in MUTANTS[name]:
        path = d / PKG / file
        src = path.read_text()
        assert src.count(old) == 1, f"{name}: the site occurs {src.count(old)} times"
        path.write_text(src.replace(old, new))
    env = dict(os.environ, JAX_PLATFORMS="cpu", HOME=str(d))
    r = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                        "-p", "no:randomly", TESTS], cwd=d,
                       capture_output=True, text=True, env=env)
    failed = sorted(set(re.findall(r"FAILED \S+::(\S+)", r.stdout)))
    summary = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else r.stderr[-300:]
    caught = bool(failed) if name != "none" else r.returncode == 0
    return f"{name}: {summary} | failed: {failed}", caught


def main(argv: list[str]) -> int:
    out_dir = Path(argv[0]) if argv else Path(tempfile.mkdtemp(prefix="mesh_mutants_"))
    out_dir.mkdir(parents=True, exist_ok=True)
    ok = True
    with ThreadPoolExecutor(3) as pool:
        for line, caught in pool.map(lambda n: run(n, out_dir), MUTANTS):
            print(line, flush=True)
            ok = ok and caught
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
