"""The port's training mesh (`distributed/`, `parallel/`, the mesh paths of
the decoders, the MoE block, the train step, the optimizer and the
checkpointer) on gloo ranks on the CPU, held to the JAX package.

- Mesh and sharding units, as `tests/unit/test_mesh.py` holds JAX's: the
  inferred `dp_shard`, the size mismatch, the aliases, a mesh axis claimed
  once per array, the divisibility fallback, the placements and blocks,
  `cp` / `pp` refused naming item 12b; the groups listed in one order,
  none made on first use.
- One process group of 4 ranks (`tests/torch_mesh_worker.py`, each rank
  with its own hash seed) runs the train recipe class on these meshes,
  each from the same HF checkpoint the JAX package writes from its own
  init (LoRA's base: the port's init, written once for both packages):
  - `tiny_llama_mock_smoke.yaml` at `dp_shard 4`, `dp_replicate 2 x
    dp_shard 2` and `dp_shard 2 x tp 2`: the loss and grad-norm curves
    within 1e-4 relative of the JAX recipe's run of the same YAML on its
    8-device mesh over steps 1-5 (docs/PARITY.md), and step 1 within 1e-5
    of the port's one-process run (fp32; only the order of the sums
    differs);
  - per-rank parameter bytes under `dp_shard 4` a quarter of the whole,
    and every tensor the FSDP gathers made one layer's (2-D), never a
    stack's;
  - `qwen3_moe_ep_smoke.yaml` as written (bf16, `ep: 2`, so `dp_shard 2 x
    ep 2` on 4 ranks), only `max_steps` cut: against JAX's run of the YAML
    as written (`dp_shard 4 x ep 2` on 8 devices) and against the port's
    one-process run in fp32 (`--model.dtype=float32 --distributed.ep=1`)
    step for step within 1e-4 relative in fp32, and in bf16 the port's gap
    to JAX bf16 at most twice JAX bf16's own gap to JAX fp32 plus 1e-4
    (docs/PARITY.md runs bf16 parity this way, queue 3 deviation 1);
  - a tiny DeepSeek-V3 with the MTP head at `dp_shard 2 x ep 2` and at
    `dp_shard 2 x tp 2` (MLA heads split), the MiniMax-M2 and gpt-oss smoke
    YAMLs and `llama_lora.yaml` (fp32) at `dp_shard 2 x tp 2`: loss and
    grad norm within 1e-5 of the port's one-process runs, which start from
    the same weights, and the LoRA run's consolidated export (gathered
    to rank 0) equal to the one-process export; the DeepSeek-V3 + MTP run
    at `ep 2` and the LoRA run also within 1e-4 of the JAX recipe's run of
    the same YAML and overrides on its 8-device mesh, every port run of
    the two starting from the JAX recipe's initial trainable tree (the
    LoRA base from one HF checkpoint that both packages read);
  - resharding: the `dp_shard 4` run saves at step 3; resumed at
    `dp_shard 2 x tp 2` (the same group) and at one process (here), steps
    4-6 equal the uninterrupted run's within 1e-5 relative (the sums'
    order differs across meshes);
  - a DTensor handed to the flash wrapper raises TypeError on every rank.
- One process group of 8 ranks at `dp_shard 2 x ep 2 x tp 2`, each rank
  under its own hash seed: the same groups in the same order on every
  rank, and the train step's gradient sums and norm over an expert stack
  split on three axes, leaves split on two and one, and a replicated one
  exact on integer-valued blocks (a group order that followed a set's
  iteration would pair ranks wrongly: a hang).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from automodel_tpu.checkpoint.hf_adapter import get_adapter as j_get_adapter
from automodel_tpu.checkpoint.hf_adapter import save_hf_checkpoint as j_save
from automodel_tpu.config import parse_args_and_load_config as j_parse
from automodel_tpu.models.registry import get_model_spec as j_get_model_spec
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JRecipe,
)
from automodel_tpu_torch.checkpoint import get_adapter, save_hf_checkpoint
from automodel_tpu_torch.config import parse_args_and_load_config
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.distributed import MeshAxisName, MeshConfig, MeshContext
from automodel_tpu_torch.models.registry import get_model_spec
from automodel_tpu_torch.parallel import AxisRules, logical_to_shardings
from automodel_tpu_torch.parallel.sharding import layout_from_spec
from automodel_tpu_torch.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction,
)
from automodel_tpu_torch.training.train_step import init_train_state

ROOT = Path(__file__).resolve().parents[1]
EX = ROOT / "examples" / "llm_finetune"
LLAMA = str(EX / "tiny_llama_mock_smoke.yaml")
QWEN3_EP = str(EX / "qwen3_moe_ep_smoke.yaml")
DSV3 = str(EX / "deepseek_v3_smoke.yaml")
LORA = str(EX / "llama_lora.yaml")
# tp over the families whose layers need more than the f / g pair: MLA
# (latents whole on every rank) with the MTP head, MiniMax-M2's RMSNorm
# over the flattened q / k, gpt-oss's expert biases and sinks
TP_FAMILIES = {"dsv3_mtp_tp": [DSV3, "--model.hf_config.num_nextn_predict_layers=1"],
               "minimax_m2_tp": [str(EX / "minimax_m2_smoke.yaml")],
               "gpt_oss_tp": [str(EX / "gpt_oss_smoke.yaml")]}
STEPS = 5
LLAMA_MESHES = {"dp_shard4": [], "hsdp": ["--distributed.dp_replicate=2"],
                "dp2_tp2": ["--distributed.tp=2"]}
QWEN3_STEPS = 3


# -- mesh and sharding units -----------------------------------------------------
def test_mesh_config_infers_dp_and_refuses_mismatch():
    assert MeshConfig(tp=2).resolve(8).dp_shard == 4
    assert MeshConfig(dp_replicate=2, ep=2).resolve(8).dp_shard == 2
    with pytest.raises(ValueError, match="not divisible"):
        MeshConfig(tp=3).resolve(8)
    with pytest.raises(ValueError, match="multiply to 4, but there are 8"):
        MeshConfig(dp_shard=2, tp=2).resolve(8)
    from automodel_tpu_torch.distributed import refuse_unported_axes

    for axis in ("cp", "pp"):
        with pytest.raises(NotImplementedError, match=f"distributed.{axis}=2.*12b"):
            refuse_unported_axes({axis: 2})


def test_mesh_aliases_sizes_and_coordinates():
    ctx = MeshContext(MeshConfig(dp_replicate=2, dp_shard=2, ep=2, tp=2))
    assert ctx.resolve_axes("batch") == ("dp_replicate", "dp_shard", "ep")
    assert ctx.axis_size("dp") == 4 and ctx.batch_size_divisor == 8
    assert ctx.spec("batch", None, "tp") == (("dp_replicate", "dp_shard", "ep"), None, "tp")
    assert ctx.num_devices == 16 and ctx.mesh_axes == ("dp_replicate", "dp_shard", "ep", "tp")
    # rank r sits at the row-major unravel of r over (pp, dp_rep, dp_shard, ep, cp, tp)
    assert ctx.coords(13) == {"pp": 0, "dp_replicate": 1, "dp_shard": 1, "ep": 0,
                              "cp": 0, "tp": 1}
    with pytest.raises(ValueError, match="Unknown mesh axis"):
        ctx.resolve_axes("bogus")
    assert MeshContext(MeshConfig(dp_shard=1)).mesh_axes == (MeshAxisName.DP_SHARD,)


def test_groups_are_listed_in_one_order_and_never_made_on_first_use():
    # every rank creates the groups in this order in `build`; `group()` only
    # looks them up, so no code path can reorder the creation
    ctx = MeshContext(MeshConfig(dp_replicate=2, dp_shard=2, ep=2, tp=2))
    keys = ctx.group_keys()
    assert len(keys) == 15 and len(set(keys)) == 15
    assert keys[:4] == [("dp_replicate",), ("dp_shard",), ("ep",), ("tp",)]
    assert keys[4] == ("dp_replicate", "dp_shard") and keys[-1] == tuple(ctx.mesh_axes)
    assert MeshContext(MeshConfig(dp_shard=1)).group_keys() == []
    with pytest.raises(RuntimeError, match="layout-only"):
        ctx.group(("tp", "dp_shard"))
    assert ctx.group("cp") is None  # sizes multiplying to 1: no group


def test_rules_claim_each_mesh_axis_once_and_fall_back_when_indivisible():
    ctx = MeshContext(MeshConfig(dp_shard=2, tp=2))
    rules = AxisRules().with_overrides(("embed", "tp"))
    # `embed` takes tp first; `mlp` finds it claimed and replicates
    assert rules.spec(("embed", "mlp"), ctx) == ("tp", None)
    lay = logical_to_shardings({"w": ("embed", "mlp"), "n": ("norm",)}, ctx,
                               shapes={"w": (8, 6), "n": (8,)})
    assert lay["w"].dims == (("dp_shard",), ("tp",)) and lay["n"].dims == ((),)
    # 5 rows do not divide over dp_shard=2: replicated on that dim
    odd = logical_to_shardings(("embed", "mlp"), ctx, shapes=(5, 6))
    assert odd.dims == ((), ("tp",))


def test_layout_placements_blocks_and_primaries():
    from torch.distributed.tensor import Replicate, Shard

    ctx = MeshContext(MeshConfig(dp_replicate=2, dp_shard=2, tp=2))
    lay = layout_from_spec(("dp_shard", "tp"), (8, 6), ctx)
    assert lay.placements(ctx) == [Replicate(), Shard(0), Shard(1)]
    # rank 7 = (dp_replicate 1, dp_shard 1, tp 1): rows 4-7, columns 3-5
    assert lay.box((8, 6), ctx.sizes, ctx.coords(7)) == ((4, 3), (4, 3))
    assert [r for r in range(8) if lay.is_primary(ctx.coords(r))] == [0, 1, 2, 3]
    # two axes on one dim split it in mesh order
    both = layout_from_spec((("dp_replicate", "dp_shard"), None), (8, 3), ctx)
    assert [both.box((8, 3), ctx.sizes, ctx.coords(r))[0] for r in (0, 2, 4, 6)] == [
        (0, 0), (2, 0), (4, 0), (6, 0)]


# -- the gloo ranks --------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _records(run_dir) -> list:
    with open(Path(run_dir) / "training.jsonl") as f:
        return [json.loads(line) for line in f]


def _curve(run_dir, key="loss") -> np.ndarray:
    return np.array([r[key] for r in _records(run_dir)])


def _jax_checkpoint(yaml_path: str, out: Path, seed: int) -> None:
    """JAX's init of the YAML's model, written as an HF checkpoint."""
    with open(yaml_path) as f:
        hf = yaml.safe_load(f)["model"]["hf_config"]
    spec = j_get_model_spec(hf)
    jcfg = spec.config_from_hf(hf, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, spec.module.init(jcfg, jax.random.key(seed)))
    j_save(j_get_adapter(spec.adapter_name, jcfg, **spec.adapter_kwargs).to_hf(params),
           str(out), hf_config=hf)


def _port_checkpoint(yaml_path: str, out: Path, seed: int) -> None:
    """The port's init of the YAML's model, written as an HF checkpoint (a
    base both packages read)."""
    with open(yaml_path) as f:
        hf = yaml.safe_load(f)["model"]["hf_config"]
    spec = get_model_spec(hf)
    tcfg = spec.config_from_hf(hf, dtype=torch.float32)
    params = spec.module.init(tcfg, torch.Generator().manual_seed(seed))
    save_hf_checkpoint(get_adapter(spec.adapter_name, tcfg, **spec.adapter_kwargs)
                       .to_hf(params), str(out), hf_config=hf)


def _jax_run(argv: list) -> None:
    _jax_setup(argv).run_train_validation_loop()


def _jax_setup(argv: list, init_npz: Path | None = None):
    """The JAX recipe, set up; with `init_npz`, its initial trainable tree
    saved there for the port's runs to start from (keys joined by "|":
    LoRA's own keys hold "/")."""
    recipe = JRecipe(j_parse(argv))
    recipe.setup()
    if init_npz is not None:
        flat = {}

        def walk(node, prefix):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, prefix + (k,))
                else:
                    flat["|".join(prefix + (k,))] = np.asarray(v)

        walk(recipe.train_state.params, ())
        np.savez(init_npz, **flat)
    return recipe


def _port_run(argv: list, init_npz: Path | None = None):
    recipe = TrainFinetuneRecipeForNextTokenPrediction(
        parse_args_and_load_config(argv), device="cpu")
    recipe.setup()
    if init_npz is not None:  # the JAX recipe's initial trainable tree
        whole = np.load(init_npz)
        tree: dict = {}
        for key in whole.files:
            *path, leaf = key.split("|")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = whole[key]
        recipe.train_state = init_train_state(params_from_jax(tree, device="cpu"),
                                              recipe.tx)
    recipe.run_train_validation_loop()
    return recipe


def _start_ranks(spec: dict, path: Path) -> subprocess.Popen:
    path.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("WORLD_SIZE", None)
    # a session of its own: the ranks are killed with it (`os.killpg`)
    return subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_mesh_worker.py"),
                             str(path)], cwd=ROOT, env=env, start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run, once: the JAX recipe's, the 4- and 8-rank groups', one
    process's."""
    tmp = tmp_path_factory.mktemp("mesh")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    _jax_checkpoint(LLAMA, tmp / "llama_hf", seed=1)
    _jax_checkpoint(QWEN3_EP, tmp / "qwen3_hf", seed=2)
    _port_checkpoint(LORA, tmp / "lora_hf", seed=3)
    llama = [LLAMA, f"--model.pretrained_path={tmp / 'llama_hf'}",
             f"--step_scheduler.max_steps={STEPS}", "--checkpoint.enabled=false"]
    qwen3 = [QWEN3_EP, f"--model.pretrained_path={tmp / 'qwen3_hf'}",
             f"--step_scheduler.max_steps={QWEN3_STEPS}", "--checkpoint.enabled=false"]
    dsv3 = [DSV3, "--step_scheduler.max_steps=3", "--model.hf_config.num_nextn_predict_layers=1"]
    lora = [LORA, "--step_scheduler.max_steps=3", "--model.dtype=float32",
            f"--model.pretrained_path={tmp / 'lora_hf'}"]
    save = [LLAMA, f"--model.pretrained_path={tmp / 'llama_hf'}",
            "--step_scheduler.max_steps=6", "--step_scheduler.ckpt_every_steps=3",
            f"--checkpoint.checkpoint_dir={tmp / 'ckpt_dp4'}"]
    resume = [LLAMA, f"--model.pretrained_path={tmp / 'llama_hf'}",
              "--step_scheduler.max_steps=6", f"--checkpoint.restore_from={tmp / 'ckpt_dp4'}",
              "--checkpoint.restore_step=3"]

    def rd(name):
        return f"--run_dir={tmp / name}"

    # three multi-rank axes: the gradient sums and the norm reduce over
    # groups of two and three axes, which every rank must create alike
    workers = [_start_ranks({"world": 8, "port": _free_port(), "out": str(tmp / "ranks"),
                             "grad_sync_check": {"dp_shard": 2, "ep": 2, "tp": 2}},
                            tmp / "spec8.json")]
    try:
        # the JAX recipe's initial DeepSeek-V3 + MTP and LoRA trees, for
        # every port run of those YAMLs (the port's own init draws other
        # numbers)
        inits = {"dsv3": tmp / "jax_dsv3_init.npz", "lora": tmp / "jax_lora_init.npz"}
        j_dsv3 = _jax_setup(dsv3 + [rd("jax_dsv3_mtp")], inits["dsv3"])
        j_lora = _jax_setup(lora + ["--checkpoint.enabled=false", rd("jax_lora")],
                            inits["lora"])
        group = [
            *[{"name": f"llama_{m}", "argv": llama + over + [rd(f"llama_{m}")]}
              for m, over in LLAMA_MESHES.items()],
            {"name": "save_dp4", "argv": save + [rd("save_dp4")]},
            {"name": "resume_dp2_tp2", "argv": resume + [
                "--distributed.tp=2", f"--checkpoint.checkpoint_dir={tmp / 'ckpt_tp'}",
                rd("resume_dp2_tp2")]},
            {"name": "qwen3_ep", "argv": qwen3 + [rd("qwen3_ep")]},
            {"name": "qwen3_ep_fp32",
             "argv": qwen3 + ["--model.dtype=float32", rd("qwen3_ep_fp32")]},
            {"name": "dsv3_mtp_ep", "argv": dsv3 + ["--distributed.ep=2", rd("dsv3_mtp_ep")],
             "init": str(inits["dsv3"])},
            *[{"name": name, "argv": argv + ["--step_scheduler.max_steps=3",
                                             "--distributed.tp=2", "--distributed.ep=1",
                                             rd(name)]}
              for name, argv in TP_FAMILIES.items()],
            {"name": "lora_dp2_tp2", "argv": lora + [
                "--distributed.tp=2", f"--checkpoint.checkpoint_dir={tmp / 'lora_dp2_tp2_ckpt'}",
                rd("lora_dp2_tp2")], "init": str(inits["lora"])},
        ]
        workers.append(_start_ranks({"world": 4, "port": _free_port(),
                                     "out": str(tmp / "ranks"), "runs": group,
                                     "check_dtensor_refusal": True}, tmp / "spec4.json"))
        # the JAX runs and the one-process runs while the ranks work
        _jax_run(llama + [rd("jax_llama")])
        _jax_run(qwen3 + [rd("jax_qwen3")])
        _jax_run(qwen3 + ["--model.dtype=float32", rd("jax_qwen3_fp32")])
        j_dsv3.run_train_validation_loop()
        j_lora.run_train_validation_loop()
        _port_run(llama + [rd("one_llama")])
        _port_run(qwen3 + ["--model.dtype=float32", "--distributed.ep=1", rd("one_qwen3_fp32")])
        _port_run(dsv3 + [rd("one_dsv3_mtp")], inits["dsv3"])
        for name, argv in TP_FAMILIES.items():
            _port_run(argv + ["--step_scheduler.max_steps=3", "--distributed.ep=1",
                              rd(f"one_{name}")])
        _port_run(lora + [f"--checkpoint.checkpoint_dir={tmp / 'one_lora_ckpt'}",
                          rd("one_lora")], inits["lora"])
        outs = [w.communicate(timeout=600)[0] for w in workers]
    finally:
        for w in workers:
            if w.poll() is None:
                os.killpg(w.pid, 9)
    for w, out in zip(workers, outs):
        assert w.returncode == 0, out[-6000:]
    # a one-process resume of the 4-rank checkpoint
    _port_run(resume + [f"--checkpoint.checkpoint_dir={tmp / 'ckpt_one'}", rd("resume_one")])
    torch.set_num_threads(n)
    return tmp


def _rel(got, want) -> np.ndarray:
    return np.abs(np.asarray(got) - np.asarray(want)) / np.abs(np.asarray(want))


@pytest.mark.parametrize("mesh", sorted(LLAMA_MESHES))
def test_llama_mesh_matches_jax_and_one_process(runs, mesh):
    got = runs / f"llama_{mesh}"
    ranks = [json.loads((runs / "ranks" / f"llama_{mesh}" / f"rank_{r}.json").read_text())
             for r in range(4)]
    want_mesh = {"dp_shard4": (1, 4, 1), "hsdp": (2, 2, 1), "dp2_tp2": (1, 2, 2)}[mesh]
    assert (ranks[0]["mesh"]["dp_replicate"], ranks[0]["mesh"]["dp_shard"],
            ranks[0]["mesh"]["tp"]) == want_mesh
    for key in ("loss", "grad_norm"):
        port, jax_curve = _curve(got, key), _curve(runs / "jax_llama", key)
        assert len(port) == len(jax_curve) == STEPS
        assert _rel(port, jax_curve).max() <= 1e-4, (key, port, jax_curve)
        assert _rel(port[0], _curve(runs / "one_llama", key)[0]) <= 1e-5, key
    assert _records(got)[0]["num_label_tokens"] == _records(runs / "jax_llama")[0][
        "num_label_tokens"]


def test_fsdp_shards_params_and_gathers_one_layer_at_a_time(runs):
    ranks = [json.loads((runs / "ranks" / "llama_dp_shard4" / f"rank_{r}.json").read_text())
             for r in range(4)]
    whole = ranks[0]["param_bytes_whole"]
    for r in ranks:
        # a quarter of every split leaf (each dim the rules put on dp_shard
        # divides by 4 here: no padding), plus the norm scales, whole
        rep = r["param_bytes_replicated"]
        assert 0 < rep < whole / 100
        assert r["param_bytes"] == (whole - rep) / 4 + rep
        assert r["gathered_shapes"], "no FSDP gather ran"
        # the stacks are (L, in, out): a gathered tensor is one layer's
        # (or the embedding / head), never a whole stack
        assert max(len(s) for s in r["gathered_shapes"]) == 2
    # dp_shard 2 x tp 2: a rank holds a quarter of each 2-D kernel
    tp_ranks = json.loads((runs / "ranks" / "llama_dp2_tp2" / "rank_0.json").read_text())
    assert tp_ranks["param_bytes"] < whole / 2


def test_qwen3_moe_ep_yaml_as_written(runs):
    # fp32: the port's dp_shard 2 x ep 2 against JAX's dp_shard 4 x ep 2 and
    # the port's one process
    fp32 = _curve(runs / "qwen3_ep_fp32")
    assert len(fp32) == QWEN3_STEPS
    assert _rel(fp32, _curve(runs / "jax_qwen3_fp32")).max() <= 1e-4
    assert _rel(fp32, _curve(runs / "one_qwen3_fp32")).max() <= 1e-5
    # bf16 as written: the port's gap to JAX bf16 against JAX's bf16 rounding
    port, jax_bf16 = _curve(runs / "qwen3_ep"), _curve(runs / "jax_qwen3")
    own_gap = np.abs(jax_bf16 - _curve(runs / "jax_qwen3_fp32"))
    assert len(port) == QWEN3_STEPS
    assert np.all(np.abs(port - jax_bf16) <= 2 * own_gap + 1e-4 * np.abs(jax_bf16)), (
        port, jax_bf16, own_gap)
    rank = json.loads((runs / "ranks" / "qwen3_ep" / "rank_0.json").read_text())
    assert rank["mesh"]["ep"] == 2 and rank["mesh"]["dp_shard"] == 2
    # the gate's statistics are the global batch's on every mesh
    for want in ("jax_qwen3_fp32", "one_qwen3_fp32"):
        assert [r["moe_load_imbalance"] for r in _records(runs / "qwen3_ep_fp32")] == \
            pytest.approx([r["moe_load_imbalance"] for r in _records(runs / want)], rel=1e-5)


@pytest.mark.parametrize("name,one", [("dsv3_mtp_ep", "one_dsv3_mtp"),
                                      ("lora_dp2_tp2", "one_lora")]
                         + [(n, f"one_{n}") for n in TP_FAMILIES])
def test_mtp_ep_and_lora_tp_match_one_process(runs, name, one):
    for key in ("loss", "grad_norm"):
        got, want = _curve(runs / name, key), _curve(runs / one, key)
        assert len(got) == len(want) == 3
        assert _rel(got, want).max() <= 1e-5, (key, got, want)
    if name.startswith("lora"):
        # the consolidated export, gathered to rank 0: the merged weights
        from automodel_tpu_torch.checkpoint import HFCheckpointReader

        with HFCheckpointReader(str(runs / f"{name}_ckpt" / "hf")) as a, \
                HFCheckpointReader(str(runs / f"{one}_ckpt" / "hf")) as b:
            assert sorted(a.keys()) == sorted(b.keys())
            for k in a.keys():
                torch.testing.assert_close(a(k), b(k), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,jax_name", [("dsv3_mtp_ep", "jax_dsv3_mtp"),
                                           ("lora_dp2_tp2", "jax_lora")])
def test_mtp_ep_and_lora_tp_match_jax(runs, name, jax_name):
    # the same YAML and overrides, from the JAX recipe's initial trainable
    # tree (and, for LoRA, the same HF base), against JAX's 8-device mesh
    for key in ("loss", "grad_norm"):
        got, want = _curve(runs / name, key), _curve(runs / jax_name, key)
        assert len(got) == len(want) == 3
        assert _rel(got, want).max() <= 1e-4, (key, got, want)


def test_groups_are_made_in_one_order_whatever_the_hash_seed(runs):
    # 8 ranks at dp_shard 2 x ep 2 x tp 2, each under its own PYTHONHASHSEED:
    # the same groups in the same order on every rank, and the train step's
    # gradient sums and norm exact over groups of one, two and three axes
    # (a creation order that followed a set's iteration pairs ranks wrongly
    # and hangs here)
    ranks = [json.loads((runs / "ranks" / "grad_sync" / f"rank_{r}.json").read_text())
             for r in range(8)]
    assert len({r["hash_seed"] for r in ranks}) == 8
    want = MeshContext(MeshConfig(dp_shard=2, ep=2, tp=2)).group_keys()
    assert len(want) == 7
    for r in ranks:
        assert (r["mesh"]["dp_shard"], r["mesh"]["ep"], r["mesh"]["tp"]) == (2, 2, 2)
        assert [tuple(k) for k in r["group_keys"]] == want
        assert r["blocks_equal"] == [True] * 5
        assert r["norm"] == pytest.approx(r["expected_norm"], rel=1e-6)


@pytest.mark.parametrize("resumed", ["resume_dp2_tp2", "resume_one"])
def test_checkpoint_reshards_across_meshes(runs, resumed):
    uninterrupted = _records(runs / "save_dp4")
    assert [r["step"] for r in uninterrupted] == [1, 2, 3, 4, 5, 6]
    got = _records(runs / resumed)
    assert [r["step"] for r in got] == [4, 5, 6]
    for key in ("loss", "grad_norm"):
        assert _rel([r[key] for r in got],
                    [r[key] for r in uninterrupted[3:]]).max() <= 1e-5, key
    steps = sorted(p.name for p in (runs / "ckpt_dp4").iterdir())
    assert steps == ["step_3", "step_6"]
    assert sorted(p.name for p in (runs / "ckpt_dp4" / "step_3").glob("rank_*.pt")) == [
        f"rank_{r:05d}.pt" for r in range(4)]


def test_kernel_wrappers_refuse_dtensors(runs):
    for r in range(4):
        rank = json.loads((runs / "ranks" / "dtensor_refusal" / f"rank_{r}.json").read_text())
        assert rank["raised"] == "TypeError" and "DTensor" in rank["message"]
