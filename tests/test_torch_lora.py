"""The port's PEFT path (`automodel_tpu_torch/peft/lora.py` and the PEFT,
validation and export branches of `recipes/llm/train_ft.py`) against the
JAX package's, on the CPU in fp32.

- `merge_lora` for LoRA, DoRA, QLoRA and QLoRA + DoRA on a tiny decoder's
  tree, adapters on q/k/v/o and the head: the merged leaves within 1e-6 of
  JAX's, the adapters' gradients through the merge within 1e-5, and the
  port's decoder, which merges layer by layer inside its loop, giving the
  logits of the JAX decoder on the whole merged tree within 1e-5 of the
  largest logit (the scaled columns make logits of ~10). The data
  can fail a merge: every `b` is nonzero, every DoRA `m` lies away from
  the column norm, every kernel's columns are scaled apart (so each output
  channel has its own int8 scale), and one column holds exact halves of
  its scale (round half to even, both packages).
- `init_lora`: the JAX function's keys, shapes and zeros, DoRA's column
  norms, `match_pattern`, and its "matched no parameters" error.
- `examples/llm_finetune/llama_lora.yaml` cut to a tiny run: 5 steps of
  8 x 32 tokens, fp32, the base read from an HF checkpoint at
  `model.pretrained_path` (so both packages start from the same base) and
  the JAX recipe's initial adapters handed to the port. The YAML warms
  the learning rate up from 0 over 10 steps, under which the adapters
  barely move in 5 steps and a merge that dropped them would pass; the
  runs here train at a constant 5e-3. The LoRA curve (with validation
  every 2 steps and the sampling eval) and DoRA over the QLoRA base with
  weight decay 0.1 (one JAX run for the three options, whose merges the
  tests above hold one by one): losses within 1e-4 relative of JAX
  (docs/PARITY.md, steps 1-5);
  `validation.jsonl`'s `val_loss` within 1e-4, `gen_token_accuracy` and
  `gen_prefix_len` equal.
- The PEFT-only checkpoint: it holds the adapters and their optimizer
  state alone; a run stopped at step 3 and resumed, and a run from
  `checkpoint.restore_from`, rebuild the base from the HF checkpoint and
  give the unbroken run's losses and validation records bit for bit (on
  one torch thread, as `test_torch_checkpoint_resume.py` runs).
- The merged consolidated export, read back by the JAX package's reader,
  equals the port's merge bit for bit and the JAX merge within 1e-6.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from automodel_tpu.checkpoint.hf_adapter import HFCheckpointReader as JReader
from automodel_tpu.checkpoint.hf_adapter import get_adapter as j_get_adapter
from automodel_tpu.config import ConfigNode as JConfigNode
from automodel_tpu.models.llm import decoder as j_decoder
from automodel_tpu.models.llm.families import llama_config as j_llama_config
from automodel_tpu.models.registry import get_model_spec as j_get_model_spec
from automodel_tpu.peft import lora as j_lora
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JRecipe,
)
from automodel_tpu_torch.checkpoint import DenseDecoderAdapter, save_hf_checkpoint
from automodel_tpu_torch.config import load_yaml
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.models.common.layers import count_params
from automodel_tpu_torch.models.llm import decoder
from automodel_tpu_torch.models.llm.families import llama_config
from automodel_tpu_torch.peft import lora
from automodel_tpu_torch.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction,
)
from automodel_tpu_torch.training import init_train_state

LORA_YAML = "examples/llm_finetune/llama_lora.yaml"
TINY_HF = dict(architectures=["LlamaForCausalLM"], vocab_size=64, hidden_size=32,
               intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2)
# peft variants of the merge tests
MERGE_VARIANTS = {
    "lora": {},
    "dora": {"dora": True},
    "qlora": {"quantize_base": "int8"},
    "qlora_dora": {"quantize_base": "int8", "dora": True},
}
TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "lm_head")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, prefix + (key,)).items()}
    return {prefix: tree}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Bit-reproducible CPU runs for the resume checks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the merge -------------------------------------------------------------------
def _merge_inputs(variant):
    """A tiny decoder's numpy tree with columns scaled apart and one column
    of exact halves; adapters with nonzero b and DoRA m off the norm."""
    tcfg = llama_config(TINY_HF, dtype=torch.float32, remat_policy="none")
    params = decoder.init(tcfg, torch.Generator().manual_seed(0))
    base = jax.tree.map(lambda t: t.numpy().copy(), params)
    rng = np.random.default_rng(1)
    for path, leaf in _flat(base).items():
        if path[-1] == "kernel":
            leaf *= np.geomspace(0.25, 4.0, leaf.shape[-1]).astype(np.float32)
    # column 0 of layer 0's q_proj: absmax 63.5, so the int8 scale is 0.5
    # exactly and these values are x.5 multiples of it: 2.5 -> 2, 3.5 -> 4,
    # -0.5 -> -0, 1.5 -> 2 under round half to even
    q = base["layers"]["q_proj"]["kernel"]
    q[0, :, 0] = 0.0
    q[0, :5, 0] = [63.5, 1.25, 1.75, -0.25, 0.75]
    cfg = lora.LoRAConfig(r=4, alpha=8.0, target_modules=TARGETS, **MERGE_VARIANTS[variant])
    adapters = {}
    for ps, leaf in lora._leaves_with_path(base):
        if lora._matches(cfg, ps, leaf):
            *lead, fi, fo = leaf.shape
            ab = {"a": rng.normal(0, fi ** -0.5, (*lead, fi, 4)).astype(np.float32),
                  "b": rng.normal(0, 0.3, (*lead, 4, fo)).astype(np.float32)}
            if cfg.dora:
                norm = np.linalg.norm(leaf, axis=-2)
                ab["m"] = (norm * rng.uniform(0.5, 1.5, norm.shape)).astype(np.float32)
            adapters[ps] = ab
    return tcfg, cfg, base, adapters


def _j_cfg(cfg):
    return j_lora.LoRAConfig(r=cfg.r, alpha=cfg.alpha, target_modules=cfg.target_modules,
                             dora=cfg.dora, quantize_base=cfg.quantize_base)


@pytest.mark.parametrize("variant", sorted(MERGE_VARIANTS))
def test_merge_lora_matches_jax(variant):
    tcfg, cfg, base, adapters = _merge_inputs(variant)
    jcfg_l = _j_cfg(cfg)
    # eager, as the JAX recipe quantizes (under jit XLA divides by 127 as a
    # product with its reciprocal, one ulp off now and then)
    j_base = j_lora.quantize_base(jax.tree.map(jnp.asarray, base), jcfg_l)
    t_base = lora.quantize_base(params_from_jax(base, device="cpu"), cfg)
    if cfg.quantize_base:
        q8 = t_base["layers"]["q_proj"]["kernel"]
        assert q8["q8"].dtype == torch.int8 and q8["sc"].shape == (2, 1, 32)
        assert float(q8["sc"][0, 0, 0]) == 0.5
        assert q8["q8"][0, :5, 0].tolist() == [127, 2, 4, 0, 2]
        jq = _flat(_np_tree(j_base))
        carried = _flat(params_from_jax(_np_tree(j_base), device="cpu"))
        for path, leaf in _flat(t_base).items():  # int8 values and scales equal
            np.testing.assert_array_equal(leaf.numpy(), jq[path])
            assert carried[path].dtype == leaf.dtype and torch.equal(carried[path], leaf)
    j_ad = jax.tree.map(jnp.asarray, adapters)
    t_ad = {k: {n: torch.from_numpy(v.copy()).requires_grad_() for n, v in ab.items()}
            for k, ab in adapters.items()}
    j_merge = jax.jit(lambda b, ad: j_lora.merge_lora(b, ad, jcfg_l))
    want = _flat(_np_tree(j_merge(j_base, j_ad)))
    got = _flat(lora.merge_lora(t_base, t_ad, cfg))
    assert got.keys() == want.keys()
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf.detach().numpy(), want[path], rtol=1e-6, atol=1e-6,
                                   err_msg=str(path))
    # the adapters' gradients through the merge, against jax.grad
    rng = np.random.default_rng(2)
    probe = {p: rng.normal(size=v.shape).astype(np.float32) for p, v in want.items()}

    def j_loss(ad):
        merged = _flat(j_lora.merge_lora(j_base, ad, jcfg_l))
        return sum(jnp.sum(merged[p] * probe[p]) for p in merged)

    j_grads = jax.jit(jax.grad(j_loss))(j_ad)
    sum(torch.sum(v * torch.from_numpy(probe[p])) for p, v in got.items()).backward()
    for ps, ab in t_ad.items():
        for name, t in ab.items():
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(j_grads[ps][name]),
                                       rtol=1e-5, atol=1e-5, err_msg=f"{ps}/{name}")
    # the decoder merging layer by layer = the JAX decoder on the merged tree
    jcfg = j_llama_config(TINY_HF, dtype=jnp.float32, remat_policy="none")
    ids = np.random.default_rng(3).integers(0, 64, (2, 9)).astype(np.int32)
    j_logits = jax.jit(lambda b, ad: j_decoder.forward(j_merge(b, ad), jcfg, jnp.asarray(ids)))(
        j_base, j_ad)
    t_logits = decoder.forward(t_base, tcfg, torch.from_numpy(ids), lora=t_ad, lora_cfg=cfg)
    j_logits = np.asarray(j_logits)
    err = np.abs(t_logits.detach().numpy() - j_logits).max()
    assert err <= 1e-5 * np.abs(j_logits).max(), (err, np.abs(j_logits).max())


def test_init_lora_keys_shapes_and_errors():
    tcfg, cfg, base, _ = _merge_inputs("dora")
    t_base = params_from_jax(base, device="cpu")
    got = lora.init_lora(t_base, cfg, torch.Generator().manual_seed(0))
    want = jax.jit(lambda b, k: j_lora.init_lora(b, _j_cfg(cfg), k))(
        jax.tree.map(jnp.asarray, base), jax.random.key(0))
    assert list(got) == list(want)  # the same paths, in the same order
    assert "lm_head/kernel" in got and "layers/q_proj/kernel" in got
    for ps, ab in got.items():
        assert ab.keys() == want[ps].keys() == {"a", "b", "m"}
        for name, t in ab.items():
            assert tuple(t.shape) == want[ps][name].shape and t.dtype == torch.float32
        assert not ab["b"].any()
        np.testing.assert_allclose(ab["m"].numpy(), np.asarray(want[ps]["m"]), rtol=1e-6)
        fan_in = ab["a"].shape[-2]
        assert 0.5 < float(ab["a"].std()) * fan_in ** 0.5 < 1.5
    only_q = lora.LoRAConfig(match_pattern=r"layers/q_proj")
    assert list(lora.init_lora(t_base, only_q, torch.Generator())) == ["layers/q_proj/kernel"]
    with pytest.raises(ValueError, match="matched no parameters"):
        lora.init_lora(t_base, lora.LoRAConfig(target_modules=("nope",)), torch.Generator())
    with pytest.raises(ValueError, match="quantize_base"):
        lora.LoRAConfig(quantize_base="nf4")


# -- the recipe ------------------------------------------------------------------
VARIANTS = {
    "lora": {},
    "qlora_dora_wd": {"peft.quantize_base": "int8", "peft.dora": True,
                      "optimizer.weight_decay": 0.1},
}
STEPS, SEQ, MICRO = 5, 32, 8
VALIDATION = {
    "validation_dataset": {"_target_": "automodel_tpu.datasets.mock.MockDatasetConfig",
                           "num_samples": 16, "seq_len": SEQ, "vocab_size": 64, "seed": 7},
    "step_scheduler.val_every_steps": 2,
    "validation_generation": {"prompt_len": 8, "max_new_tokens": 8, "max_batches": 1},
}


@pytest.fixture(scope="module")
def hf_base(tmp_path_factory):
    """A tiny Llama's HF checkpoint (port-drawn weights) that every run
    reads at `model.pretrained_path`."""
    out = tmp_path_factory.mktemp("lora_base") / "hf"
    tcfg = llama_config(TINY_HF, dtype=torch.float32)
    params = decoder.init(tcfg, torch.Generator().manual_seed(4))
    save_hf_checkpoint(DenseDecoderAdapter(tcfg).to_hf(params), str(out),
                       hf_config=dict(TINY_HF, model_type="llama"))
    return str(out)


def _node(tmp, run, hf_base, variant, **overrides):
    """llama_lora.yaml cut to the tiny run (see the module docstring)."""
    node = load_yaml(LORA_YAML)
    for key, value in {
            "run_dir": str(tmp / run), "checkpoint.checkpoint_dir": str(tmp / f"ck_{run}"),
            "model.pretrained_path": hf_base, "model.dtype": "float32",
            "dataset.seq_len": SEQ, "dataset.num_samples": 64, "dataset.vocab_size": 64,
            "dataloader.microbatch_size": MICRO, "step_scheduler.max_steps": STEPS,
            "step_scheduler.ckpt_every_steps": 3, "optimizer.lr": 5e-3,
            "lr_scheduler.style": "constant", "lr_scheduler.warmup_steps": 0,
            **VARIANTS[variant], **(VALIDATION if variant == "lora" else {}),
            **overrides}.items():
        node.set(key, value)
    return node


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _port_run(node, init=None):
    recipe = TrainFinetuneRecipeForNextTokenPrediction(node, device="cpu")
    recipe.setup()
    if init is not None:  # the JAX recipe's initial adapters
        recipe.train_state = init_train_state(params_from_jax(init, device="cpu"), recipe.tx)
    recipe.run_train_validation_loop()
    return recipe


@pytest.fixture(scope="module")
def run_cache(tmp_path_factory, hf_base):
    """variant -> a live JAX run of it (checkpointer off) and the port's run
    from the same base and initial adapters, with the export on; each made
    once."""
    cache = {}

    def get(variant):
        if variant not in cache:
            tmp = tmp_path_factory.mktemp(f"lora_{variant}")
            j_node = JConfigNode(_node(tmp, "jax", hf_base, variant).to_dict())
            j_node.set("checkpoint.enabled", False)
            j_recipe = JRecipe(j_node)
            j_recipe.setup()
            init = _np_tree(j_recipe.train_state.params)
            j_base = _np_tree(j_recipe.base_params)
            j_recipe.run_train_validation_loop()
            port = _port_run(_node(tmp, "port", hf_base, variant,
                                   **{"checkpoint.save_consolidated": "final"}), init)
            cache[variant] = (variant, tmp, init, j_base,
                              _np_tree(j_recipe.train_state.params), port)
        return cache[variant]

    return get


@pytest.fixture(params=sorted(VARIANTS))
def runs(request, run_cache):
    return run_cache(request.param)


def test_yaml_curve_matches_jax(runs):
    variant, tmp, init, j_base, j_final, port = runs
    want = np.array([r["loss"] for r in _records(tmp / "jax" / "training.jsonl")])
    got = np.array([r["loss"] for r in _records(tmp / "port" / "training.jsonl")])
    assert len(want) == len(got) == STEPS
    assert abs(want[-1] - want[0]) > 1e-3  # the adapters moved the loss
    rel = np.abs(got - want) / np.abs(want)
    assert rel.max() <= 1e-4, rel
    assert list(port.train_state.params) == list(init)  # the trainable tree
    assert not any(t.requires_grad for t in _flat(port.base_params).values())
    if variant == "qlora_dora_wd":
        assert port.base_params["layers"]["q_proj"]["kernel"]["q8"].dtype == torch.int8
        assert port.base_params["lm_head"]["kernel"]["q8"].dtype == torch.int8
    # the base the port read equals the JAX recipe's, int8 leaves too
    jb = _flat(j_base)
    for path, leaf in _flat(port.base_params).items():
        np.testing.assert_array_equal(leaf.numpy(), jb[path])
    for ps, ab in port.train_state.params.items():
        for name, t in ab.items():
            np.testing.assert_allclose(t.detach().numpy(), j_final[ps][name],
                                       rtol=1e-3, atol=1e-5, err_msg=f"{ps}/{name}")
    if variant == "lora":
        j_val = _records(tmp / "jax" / "validation.jsonl")
        t_val = _records(tmp / "port" / "validation.jsonl")
        assert [r["step"] for r in t_val] == [r["step"] for r in j_val] == [2, 4]
        for a, b in zip(t_val, j_val):
            assert abs(a["val_loss"] - b["val_loss"]) <= 1e-4 * abs(b["val_loss"])
            for key in ("gen_token_accuracy", "gen_prefix_len", "gen_samples"):
                assert a[key] == b[key], key
        assert t_val[0]["gen_samples"] == MICRO


def test_peft_checkpoint_resume_and_restore_bitwise(run_cache, tmp_path, hf_base):
    _, tmp, init, _, _, full = run_cache("lora")
    steps = full.checkpointer.all_steps()
    assert steps == [3, 5]
    state = torch.load(os.path.join(full.checkpointer.root, "step_5", "state.pt"),
                       weights_only=True)
    assert list(state["params"]) == list(init)  # the adapters alone
    assert state["opt_state"]["mu"].keys() == state["params"].keys()
    assert full.checkpointer.last_save["bytes"] < 3 * 4 * count_params(
        full.train_state.params) + 65536
    _port_run(_node(tmp_path, "half", hf_base, "lora", **{"step_scheduler.max_steps": 3}),
              init)
    resumed = _port_run(_node(tmp_path, "half", hf_base, "lora"))
    restored = _port_run(_node(tmp_path, "from", hf_base, "lora", **{
        "checkpoint.restore_from": str(tmp_path / "ck_half"),
        "checkpoint.restore_step": 3}))
    unbroken = _records(tmp / "port" / "training.jsonl")
    for run, first in (("half", 1), ("from", 4)):
        recs = _records(tmp_path / run / "training.jsonl")
        assert [r["step"] for r in recs] == list(range(first, STEPS + 1))
        assert [r["loss"] for r in recs] == [r["loss"] for r in unbroken[first - 1:]]
        assert [r["grad_norm"] for r in recs] == [r["grad_norm"] for r in unbroken[first - 1:]]
    drop_ts = lambda recs: [{k: v for k, v in r.items() if k != "ts"} for r in recs]
    assert drop_ts(_records(tmp_path / "half" / "validation.jsonl")) == drop_ts(
        _records(tmp / "port" / "validation.jsonl"))
    for other in (resumed, restored):
        for ps, ab in other.train_state.params.items():
            for name, t in ab.items():
                assert torch.equal(t, full.train_state.params[ps][name])


def test_merged_export_reads_back_in_jax(runs):
    variant, tmp, _, j_base, _, port = runs
    reader = JReader(str(tmp / "ck_port" / "hf"))
    hf = reader.hf_config()
    spec = j_get_model_spec(hf)
    jcfg = spec.config_from_hf(hf)
    got = _flat(_np_tree(j_get_adapter(spec.adapter_name, jcfg,
                                       **spec.adapter_kwargs).from_hf(reader)))
    merged = _flat(lora.merged_state_dict(port.base_params, port.train_state.params,
                                          port.peft_cfg))
    assert got.keys() == merged.keys()
    j_merged = _flat(_np_tree(j_lora.merge_lora(
        jax.tree.map(jnp.asarray, j_base),
        jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), port.train_state.params),
        _j_cfg(port.peft_cfg))))
    for path, leaf in merged.items():
        np.testing.assert_array_equal(got[path], leaf.numpy())
        np.testing.assert_allclose(got[path], j_merged[path], rtol=1e-6, atol=1e-6)
    q = ("layers", "q_proj", "kernel")  # the export holds the merge, not the base
    base_q = port.base_params["layers"]["q_proj"]["kernel"]
    base_q = lora.dequantize(base_q, torch.float32).numpy()
    assert np.abs(got[q] - base_q).max() > 1e-4


def test_cli_runs_the_yaml_on_the_cpu(tmp_path):
    """`llm_finetune`'s CLI entry on llama_lora.yaml as written (bf16, seq
    256, r 16 on q/k/v/o), only the output directories moved and 2 of its
    30 steps run."""
    from automodel_tpu_torch.cli.app import main as cli_main

    recipe = cli_main([LORA_YAML, f"--run_dir={tmp_path}",
                       f"--checkpoint.checkpoint_dir={tmp_path / 'ck'}",
                       "--step_scheduler.max_steps=2"], device="cpu")
    assert recipe.peft_cfg == lora.LoRAConfig(r=16, alpha=32.0)
    assert recipe.model_cfg.dtype == torch.bfloat16 and recipe.device.type == "cpu"
    recs = _records(tmp_path / "training.jsonl")
    assert [r["step"] for r in recs] == [1, 2] and all(np.isfinite(r["loss"]) for r in recs)
    assert recipe.checkpointer.all_steps() == [2]
    assert (tmp_path / "ck" / "hf" / "config.json").is_file()
