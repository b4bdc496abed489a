"""Ranks for the port's mesh tests: `python tests/torch_mesh_worker.py
SPEC.json` starts `spec["world"]` gloo processes on the CPU (one process
group for the whole spec) and runs each of `spec["runs"]` through the
port's train recipe class, as `torchrun` would run it: RANK, WORLD_SIZE,
LOCAL_RANK and MASTER_ADDR/PORT in the environment, `device="cpu"`.
Every rank is its own interpreter with its own PYTHONHASHSEED (rank + 1):
code whose collectives follow the iteration order of a set of strings
then disagrees across ranks on every run, not on some.

`spec["grad_sync_check"]` (mesh sizes) runs the train step's reductions
on a small tree of integer-valued blocks instead (`_grad_sync_check`).

Each run is `{"name", "argv"}` (the CLI's arguments: a YAML and dotted
overrides), and may name an `"init"`: an `.npz` of the whole initial
trainable tree (keys joined by "|": LoRA's own keys hold "/"), which each
rank copies into its blocks after `setup()` (the JAX recipe's initial
weights, as the one-process parity tests hand them over with
`params_from_jax`). Every rank writes `<out>/<name>/rank_<r>.json` with
its mesh, its parameter bytes against the whole's, and the shapes of the
tensors the FSDP gathers made (`parallel/collectives.all_gather_dim`).
Rank 0's `training.jsonl` lands in the run's `run_dir`. Torch runs one
thread per rank. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _rank_main(rank: int, spec: dict) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(spec["world"]), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(spec["port"]))
    sys.path.insert(0, str(ROOT))
    import faulthandler

    import torch

    if os.environ.get("MESH_WORKER_DUMP"):
        faulthandler.dump_traceback_later(float(os.environ["MESH_WORKER_DUMP"]), exit=True)
    torch.set_num_threads(1)
    if spec.get("runs"):
        _recipe_runs(rank, spec)
    if spec.get("grad_sync_check"):
        _grad_sync_check(rank, spec)
    if spec.get("check_dtensor_refusal"):
        _dtensor_refusal(rank, spec)
    torch.distributed.destroy_process_group()


def _recipe_runs(rank: int, spec: dict) -> None:
    from automodel_tpu_torch.config import parse_args_and_load_config
    from automodel_tpu_torch.parallel import collectives
    from automodel_tpu_torch.recipes.llm.train_ft import (
        TrainFinetuneRecipeForNextTokenPrediction,
    )
    from automodel_tpu_torch.utils.tree import tree_leaves

    gathered: list = []
    plain_gather = collectives.all_gather_dim

    def counting_gather(x, dim, group):
        out = plain_gather(x, dim, group)
        gathered.append(list(out.shape))
        return out

    collectives.all_gather_dim = counting_gather
    for run in spec["runs"]:
        gathered.clear()
        recipe = TrainFinetuneRecipeForNextTokenPrediction(
            parse_args_and_load_config(run["argv"]), device="cpu")
        recipe.setup()
        if "init" in run:
            _load_init(recipe.train_state.params, run["init"])
        recipe.run_train_validation_loop()
        leaves = tree_leaves(recipe.train_state.params)
        local = sum(p.to_local().numel() * p.element_size() for p in leaves)
        whole = sum(p.numel() * p.element_size() for p in leaves)
        # leaves no axis splits (the norm scales): every rank holds them whole
        replicated = sum(p.numel() * p.element_size() for p in leaves
                         if all(pl.is_replicate() for pl in p.placements))
        out = Path(spec["out"]) / run["name"]
        out.mkdir(parents=True, exist_ok=True)
        (out / f"rank_{rank}.json").write_text(json.dumps({
            "mesh": recipe.mesh_ctx.describe(), "param_bytes": local,
            "param_bytes_whole": whole, "param_bytes_replicated": replicated,
            "gathered_shapes": gathered,
            "steps": recipe.step_scheduler.step,
        }))
        del recipe


#: (mesh axes per dim, shape) of the leaves `_grad_sync_check` lays out: an
#: expert stack split on three axes, a projection and the embedding on two,
#: a router on one, a norm scale on none
GRAD_SYNC_LEAVES = {
    "experts": (("ep", "dp_shard", "tp"), (4, 4, 6)),
    "q_proj": (("dp_shard", "tp"), (4, 6)),
    "embed": (("tp", "dp_shard"), (6, 4)),
    "gate": (("dp_shard", None), (4, 4)),
    "norm": ((None,), (4,)),
}


def _grad_sync_check(rank: int, spec: dict) -> None:
    """The train step's mesh reductions on `spec["grad_sync_check"]` (the
    mesh sizes) over `GRAD_SYNC_LEAVES`: every rank's gradient shard is its
    block of one integer-valued tensor per leaf, so after `reduce_grads`
    each block is that block times the product of the batch axes the leaf
    is not split on, and the norm follows exactly. Records the group keys
    in their creation order, this rank's hash seed and the results."""
    import math

    import torch

    from automodel_tpu_torch.distributed import MeshConfig
    from automodel_tpu_torch.distributed.init_utils import initialize_distributed
    from automodel_tpu_torch.parallel.sharding import distribute_leaf, layout_from_spec
    from automodel_tpu_torch.training.train_step import MeshGradSync

    initialize_distributed("cpu")
    ctx = MeshConfig(**spec["grad_sync_check"]).build("cpu")
    gen = torch.Generator().manual_seed(0)
    full, params, factors = {}, {}, {}
    for name, (pspec, shape) in GRAD_SYNC_LEAVES.items():
        full[name] = torch.randint(-3, 4, shape, generator=gen).float()
        params[name] = distribute_leaf(full[name], layout_from_spec(pspec, shape, ctx), ctx)
        split = {a for part in pspec if part for a in (part,)}
        factors[name] = math.prod(ctx.sizes[a] for a in ("dp_replicate", "dp_shard", "ep")
                                  if a not in split)
    sync = MeshGradSync(ctx, params)
    local = [params[n].to_local().clone() for n in GRAD_SYNC_LEAVES]
    want = [params[n].to_local() * factors[n] for n in GRAD_SYNC_LEAVES]
    sync.reduce_grads(local)
    norm = float(sync.global_norm(local))
    expected = math.sqrt(sum(factors[n] ** 2 * float((full[n] ** 2).sum())
                             for n in GRAD_SYNC_LEAVES))
    out = Path(spec["out"]) / "grad_sync"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"rank_{rank}.json").write_text(json.dumps({
        "mesh": ctx.describe(), "group_keys": [list(k) for k in ctx._groups],
        "hash_seed": os.environ.get("PYTHONHASHSEED"),
        "blocks_equal": [bool(torch.equal(g, w)) for g, w in zip(local, want)],
        "norm": norm, "expected_norm": expected,
    }))


def _load_init(params, path: str) -> None:
    """Each leaf's block of the whole tensor saved at its path, in place."""
    import numpy as np
    import torch

    from automodel_tpu_torch.parallel.sharding import dtensor_box, is_dtensor, slice_box

    whole = np.load(path)

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
                continue
            full = torch.from_numpy(whole["|".join(prefix + (k,))]).to(v.dtype)
            with torch.no_grad():
                if is_dtensor(v):
                    offs, lens, _ = dtensor_box(v)
                    v.to_local().copy_(slice_box(full, offs, lens))
                else:
                    v.copy_(full)

    walk(params, ())


def _dtensor_refusal(rank: int, spec: dict) -> None:
    """A DTensor handed to the flash wrapper raises, naming itself."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from automodel_tpu_torch.ops.flash_attention import flash_attention

    mesh = init_device_mesh("cpu", (spec["world"],))
    q = distribute_tensor(torch.zeros(1, 4, spec["world"], 8), mesh, [Shard(2)])
    try:
        flash_attention(q, q, q)
        raised, message = None, ""
    except Exception as e:  # noqa: BLE001 - the kind is the result
        raised, message = type(e).__name__, str(e)
    out = Path(spec["out"]) / "dtensor_refusal"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"rank_{rank}.json").write_text(json.dumps({"raised": raised, "message": message}))


def main(argv: list) -> int:
    import subprocess

    if argv[1:2] == ["--rank"]:
        _rank_main(int(argv[2]), json.loads(Path(argv[0]).read_text()))
        return 0
    spec = json.loads(Path(argv[0]).read_text())
    ranks = [subprocess.Popen([sys.executable, __file__, argv[0], "--rank", str(r)],
                              env=dict(os.environ, PYTHONHASHSEED=str(r + 1)))
             for r in range(spec["world"])]
    try:
        # a rank that fails leaves the others waiting in a collective
        while any(p.poll() is None for p in ranks) and not any(p.poll() for p in ranks):
            time.sleep(0.2)
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
    return 0 if all(p.wait() == 0 for p in ranks) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
