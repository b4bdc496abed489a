"""Port parity of the seq-cls and retrieval recipes and the data and
optimizer pieces ported with them, on the CPU, the JAX package beside
`automodel_tpu_torch` on the same YAMLs, weights and numpy inputs.

- `examples/llm_seq_cls/llama_seq_cls_smoke.yaml`,
  `examples/retrieval/{bi_encoder,cross_encoder}_smoke.yaml` and
  `examples/llm_pretrain/nanogpt_bins.yaml` (on shards written to a temp
  dir by the port's `write_bin_shard`, byte-equal to JAX's) through the
  recipe the port's CLI resolves, from the JAX recipe's initial weights,
  3 steps: losses within 1e-4 relative (docs/PARITY.md), and the seq-cls
  and cross-encoder `num_correct` equal; the CLI's `main` runs each YAML;
- the three mock datasets sample for sample, `info_nce_loss` (both
  directions and one) and the pools within 1e-6 relative;
- `pack_documents` with first fit, knapsack and an align, row for row;
- `param_groups` (regex and substring patterns, `lr_mult`, weight decay,
  a schedule) against optax's grouped update over 3 steps within 1e-6;
- the seq-cls and bi-encoder YAMLs with LoRA over a shared HF base,
  against JAX's curves (PEFT on these recipes as in JAX);
- the refused recipes still raise, naming themselves.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from automodel_tpu.checkpoint.hf_adapter import get_adapter as j_get_adapter
from automodel_tpu.checkpoint.hf_adapter import save_hf_checkpoint as j_save
from automodel_tpu.cli.app import resolve_recipe_class as j_resolve
from automodel_tpu.config import ConfigNode as JConfigNode
from automodel_tpu.datasets import mock as j_mock
from automodel_tpu.datasets import nanogpt as j_nanogpt
from automodel_tpu.datasets.packing import PackedSequenceConfig as JPackedSequenceConfig
from automodel_tpu.datasets.packing import pack_documents as j_pack_documents
from automodel_tpu.loss import infonce as j_infonce
from automodel_tpu.models.llm import decoder as j_decoder
from automodel_tpu.models.registry import get_model_spec as j_get_model_spec
from automodel_tpu.optim import LRSchedulerConfig as JLRSchedulerConfig
from automodel_tpu.optim import OptimizerConfig as JOptimizerConfig
from automodel_tpu_torch.cli.app import main as cli_main
from automodel_tpu_torch.cli.app import resolve_recipe_class
from automodel_tpu_torch.config import ConfigNode, parse_args_and_load_config
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.datasets import mock, nanogpt
from automodel_tpu_torch.datasets.packing import PackedSequenceConfig, pack_documents
from automodel_tpu_torch.loss import infonce
from automodel_tpu_torch.optim import LRSchedulerConfig, OptimizerConfig
from automodel_tpu_torch.training import init_train_state

STEPS = 3
YAMLS = {
    "seq_cls": "examples/llm_seq_cls/llama_seq_cls_smoke.yaml",
    "bi_encoder": "examples/retrieval/bi_encoder_smoke.yaml",
    "cross_encoder": "examples/retrieval/cross_encoder_smoke.yaml",
    "nanogpt": "examples/llm_pretrain/nanogpt_bins.yaml",
}


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _shards(tmp_path, write):
    rng = np.random.default_rng(0)
    for i in range(2):
        write(rng.integers(1, 512, 6000).astype(np.uint16), str(tmp_path / f"shard_{i}.bin"))
    return str(tmp_path / "shard_*.bin")


def test_nanogpt_shards_and_windows_equal_to_jax(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jglob = _shards(tmp_path / "j", j_nanogpt.write_bin_shard)
    tglob = _shards(tmp_path / "t", nanogpt.write_bin_shard)
    for i in range(2):
        assert ((tmp_path / "j" / f"shard_{i}.bin").read_bytes()
                == (tmp_path / "t" / f"shard_{i}.bin").read_bytes())
    for kw in ({"shuffle_seed": 5}, {"shuffle_seed": None, "bos_token_id": 7}):
        want = j_nanogpt.NanogptBinDatasetConfig(path=jglob, seq_len=64, **kw).build()
        got = nanogpt.NanogptBinDatasetConfig(path=tglob, seq_len=64, **kw).build()
        assert len(got) == len(want) > 10
        for i in (0, 3, len(got) - 1):
            for k in ("input_ids", "labels"):
                np.testing.assert_array_equal(got[i][k], want[i][k])


@pytest.mark.parametrize("recipe", sorted(YAMLS))
def test_recipe_loss_curve_matches_live_jax_run(recipe, tmp_path):
    """docs/PARITY.md: the recipe the port's CLI resolves, from the JAX
    recipe's initial weights, on the same YAML and batches, 3 steps."""
    argv = [YAMLS[recipe], "--checkpoint.enabled=false",
            f"--step_scheduler.max_steps={STEPS}"]
    if recipe == "nanogpt":
        argv.append(f"--dataset.path={_shards(tmp_path, nanogpt.write_bin_shard)}")
    runs = {name: parse_args_and_load_config(argv + [f"--run_dir={tmp_path / name}"])
            for name in ("jax", "port")}
    jnode = JConfigNode(runs["jax"].to_dict())
    j_recipe = j_resolve(jnode)(jnode)
    j_recipe.setup()
    init = jax.tree.map(np.asarray, j_recipe.train_state.params)
    j_recipe.run_train_validation_loop()
    cls = resolve_recipe_class(runs["port"])
    assert cls.__name__ == type(j_recipe).__name__
    t_recipe = cls(runs["port"], device="cpu")
    t_recipe.setup()
    assert t_recipe.model_cfg.causal == j_recipe.model_cfg.causal
    t_recipe.train_state = init_train_state(params_from_jax(init, device="cpu"), t_recipe.tx)
    t_recipe.run_train_validation_loop()
    want = _records(tmp_path / "jax" / "training.jsonl")
    got = _records(tmp_path / "port" / "training.jsonl")
    assert len(want) == len(got) == STEPS
    w, g = (np.array([r["loss"] for r in rs]) for rs in (want, got))
    rel = np.abs(g - w) / np.abs(w)
    assert rel.max() <= 1e-4, rel
    for key in ("num_label_tokens", "num_correct"):
        assert [r.get(key) for r in got] == [r.get(key) for r in want], key


@pytest.mark.parametrize("recipe", ["seq_cls", "bi_encoder"])
def test_peft_recipe_loss_curve_matches_live_jax_run(recipe, tmp_path):
    """PEFT on these recipes as in JAX: LoRA on q/k/v/o over a base both
    packages read from the JAX package's HF checkpoint, the seq-cls head
    trained beside the adapters; the port starts from JAX's adapters (and
    head), 3 steps within 1e-4 relative."""
    import yaml

    hf = yaml.safe_load(open(YAMLS[recipe]))["model"]["hf_config"]
    jcfg = j_get_model_spec(hf).config_from_hf(hf, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, j_decoder.init(jcfg, jax.random.key(4)))
    j_save(j_get_adapter("dense_decoder", jcfg).to_hf(params), str(tmp_path / "base"),
           hf_config=hf)
    argv = [YAMLS[recipe], "--checkpoint.enabled=false", f"--step_scheduler.max_steps={STEPS}",
            f"--model.pretrained_path={tmp_path / 'base'}", "--peft.r=4", "--peft.alpha=8.0"]
    runs = {name: parse_args_and_load_config(argv + [f"--run_dir={tmp_path / name}"])
            for name in ("jax", "port")}
    jnode = JConfigNode(runs["jax"].to_dict())
    j_recipe = j_resolve(jnode)(jnode)
    j_recipe.setup()
    init = jax.tree.map(np.asarray, j_recipe.train_state.params)
    j_recipe.run_train_validation_loop()
    t_recipe = resolve_recipe_class(runs["port"])(runs["port"], device="cpu")
    t_recipe.setup()
    assert t_recipe.peft_cfg is not None and t_recipe.base_params is not None
    assert sorted(init) == sorted(t_recipe.train_state.params)
    t_recipe.train_state = init_train_state(params_from_jax(init, device="cpu"), t_recipe.tx)
    t_recipe.run_train_validation_loop()
    w, g = (np.array([r["loss"] for r in _records(tmp_path / n / "training.jsonl")])
            for n in ("jax", "port"))
    assert len(w) == len(g) == STEPS
    rel = np.abs(g - w) / np.abs(w)
    assert rel.max() <= 1e-4, rel


@pytest.mark.parametrize("recipe", ["seq_cls", "bi_encoder", "cross_encoder"])
def test_cli_runs_the_recipe_yaml(recipe, tmp_path):
    r = cli_main([YAMLS[recipe], f"--run_dir={tmp_path}", "--step_scheduler.max_steps=2"],
                 device="cpu")
    losses = [rec["loss"] for rec in _records(tmp_path / "training.jsonl")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert r.model_cfg.causal == (recipe != "bi_encoder")


@pytest.mark.parametrize("name", ["retrieval_distill_bi_encoder",
                                  "retrieval_mine_hard_negatives"])
def test_unported_retrieval_recipes_raise(name):
    with pytest.raises(NotImplementedError, match=name):
        resolve_recipe_class(ConfigNode({"recipe": name}))


@pytest.mark.parametrize("cls", ["MockSeqClsDatasetConfig", "MockRetrievalDatasetConfig",
                                 "MockRerankDatasetConfig"])
def test_mock_datasets_equal_to_jax(cls):
    want = getattr(j_mock, cls)(num_samples=6, seed=3).build()
    got = getattr(mock, cls)(num_samples=6, seed=3).build()
    assert len(got) == len(want)
    for i in range(len(got)):
        w, g = want[i], got[i]
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype


@pytest.mark.parametrize("symmetric", [True, False])
def test_info_nce_and_pools_equal_to_jax(symmetric):
    rng = np.random.default_rng(4)
    h = rng.normal(size=(6, 9, 16)).astype(np.float32)
    mask = (rng.random((6, 9)) < 0.7).astype(np.int32)
    mask[:, 0] = 1
    for fn in ("mean_pool", "normalized_mean_pool"):
        np.testing.assert_allclose(
            getattr(infonce, fn)(torch.from_numpy(h), torch.from_numpy(mask)).numpy(),
            np.asarray(getattr(j_infonce, fn)(jnp.asarray(h), jnp.asarray(mask))),
            rtol=1e-6, atol=1e-6)
    q, d = rng.normal(size=(2, 8, 16)).astype(np.float32)
    got, n = infonce.info_nce_loss(torch.from_numpy(q), torch.from_numpy(d),
                                   temperature=0.07, symmetric=symmetric)
    want, wn = j_infonce.info_nce_loss(jnp.asarray(q), jnp.asarray(d),
                                       temperature=0.07, symmetric=symmetric)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(n) == float(wn) == 8


def _docs(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 40))
        ids = rng.integers(1, 100, k).astype(np.int32)
        labels = ids.copy()
        labels[0] = -100
        out.append({"input_ids": ids, "labels": labels})
    return out


@pytest.mark.parametrize("kw", [dict(strategy="first_fit"), dict(strategy="knapsack"),
                                dict(strategy="first_fit", align=16),
                                dict(strategy="knapsack", drop_last_incomplete=True)])
def test_pack_documents_equal_to_jax(kw):
    docs = _docs(30, 5)
    want = list(j_pack_documents(docs, JPackedSequenceConfig(seq_len=64, **kw)))
    got = list(pack_documents(docs, PackedSequenceConfig(seq_len=64, **kw)))
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        for k in ("input_ids", "labels", "segment_ids", "positions"):
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
def test_param_groups_equal_to_optax(name):
    groups = ({"pattern": "embed", "lr_mult": 0.1, "weight_decay": 0.0},
              {"pattern": r"layers/.*norm", "lr_mult": 2.0},
              {"pattern": "q_proj", "weight_decay": 0.5})
    rng = np.random.default_rng(6)
    tree = {"embed": {"embedding": rng.normal(size=(10, 4))},
            "layers": {"input_norm": {"scale": rng.normal(size=(2, 4))},
                       "q_proj": {"kernel": rng.normal(size=(2, 4, 4))},
                       "o_proj": {"kernel": rng.normal(size=(2, 4, 4))}},
            "final_norm": {"scale": rng.normal(size=(4,))}}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
             for _ in range(3)]
    sched = dict(warmup_steps=1, decay_steps=5, style="cosine")
    jcfg = JOptimizerConfig(name=name, lr=1e-2, weight_decay=0.1, param_groups=groups)
    tx = jcfg.build(JLRSchedulerConfig(**sched).build(1e-2))
    jp = jax.tree.map(jnp.asarray, tree)
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
    tcfg = OptimizerConfig(name=name, lr=1e-2, weight_decay=0.1, param_groups=groups)
    opt = tcfg.build(LRSchedulerConfig(**sched).build(1e-2))
    tp = params_from_jax(tree, device="cpu")
    ostate = opt.init(tp)
    for g in grads:
        opt.update(params_from_jax(g, device="cpu"), ostate, tp)
    for path, want in jax.tree_util.tree_flatten_with_path(jp)[0]:
        got = tp
        for k in path:
            got = got[k.key]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7,
                                   err_msg=str(path))
    # the groups bite: without them the port's update leaves optax's grouped one
    plain = OptimizerConfig(name=name, lr=1e-2, weight_decay=0.1).build(
        LRSchedulerConfig(**sched).build(1e-2))
    tp0 = params_from_jax(tree, device="cpu")
    state0 = plain.init(tp0)
    for g in grads:
        plain.update(params_from_jax(g, device="cpu"), state0, tp0)
    assert not np.allclose(tp0["embed"]["embedding"].numpy(),
                           np.asarray(jp["embed"]["embedding"]), rtol=1e-4)
