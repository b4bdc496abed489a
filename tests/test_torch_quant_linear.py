"""Port parity of the quantized linears and QAT (`ops/quant.py`'s
`quantized_matmul`, `matmul`, `fake_quantize`, `QATConfig`; the decoders'
`linear_precision`, the engine's `serve_precision`, `generate()`, the
recipe's `model.linear_precision` and `qat`), on the CPU: the JAX package
and `automodel_tpu_torch` fed the same numpy inputs and weights. The port
forms the scale `amax / qmax + 1e-12` as XLA does in every jitted JAX
program (one rounding of amax times the fp32 reciprocal plus 1e-12), so
its quantized operands are compared bit for bit with jitted JAX; an eager
JAX call divides, one ulp away in about half of the fp8 rows.

- `_quantize`: the quantized operands and scales bit-equal to JAX's, on
  inputs that reach the ±448 / ±127 edge, an inf (clipped to the fp32
  range before the division) and an fp32-max one; the CPU product within 1e-5 of the output's largest magnitude
  (fp8's products are exact in fp32, int8's sums are fp32 on both sides);
  the bf16 gradients within 1e-2 of their largest magnitude (dx rounds
  through bf16, dw has an fp32 result).
- `fake_quantize`'s grid and straight-through gradient, and the delayed,
  kernel-only QAT transform, equal to JAX's.
- The tiny Llama and MLA decoders with `linear_precision`: logits within
  1e-5 of their largest magnitude (fp32), gradients within 1e-2, as the
  product's own (the linears' backward multiplies in bf16 by design and
  rounds dx to bf16: an fp32 cotangent that differs in its last bits
  between the packages can round to the neighbouring bf16 value, one part
  in 256, and two layers compound it).
- The engine with `serve_precision` fp8 and int8 in lockstep with the JAX
  engine over ragged streams (logits within 1e-4, greedy tokens equal),
  and greedy `generate()` token-equal.
- `tiny_llama_mock_smoke.yaml` with `model.linear_precision: fp8` and
  with `qat` (int8 from step 2), 5 steps in fp32: each step's loss from the
  JAX run's weights at that step within 1e-4; the free-running curves
  within the protocol's 1e-4 (fp8: steps 1-2, then 2e-3, the test says
  why); before `start_step` the QAT run equals a plain run bit for bit.
  QAT with `peft` raises.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mla_moe import MLA_KW, run_lockstep
from test_torch_quant_serving import INT8_CASES, LLAMA

from automodel_tpu.config.loader import ConfigNode as JConfigNode
from automodel_tpu.inference.generate import GenerateConfig as JGenerateConfig
from automodel_tpu.inference.generate import generate as j_generate
from automodel_tpu.models.llm import decoder as j_decoder
from automodel_tpu.ops import quant as j_quant
from automodel_tpu.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction as JRecipe,
)
from automodel_tpu.serving import ServingConfig as JServingConfig
from automodel_tpu.serving import ServingEngine as JServingEngine
from automodel_tpu_torch.config import load_yaml
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.inference.generate import GenerateConfig, generate
from automodel_tpu_torch.models.llm import decoder
from automodel_tpu_torch.ops import quant
from automodel_tpu_torch.recipes.llm.train_ft import (
    TrainFinetuneRecipeForNextTokenPrediction,
)
from automodel_tpu_torch.serving import ServingConfig, ServingEngine
from automodel_tpu_torch.training import init_train_state

PRECISIONS = ("fp8", "int8")
TINY_YAML = "examples/llm_finetune/tiny_llama_mock_smoke.yaml"
F32_MAX = float(np.finfo(np.float32).max)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one CPU thread: the models are tiny, and under the tier-1
    run's workers several threads per process oversubscribe the cores
    (the recipe cases ran 10-20x slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn else a).numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 and a.dtype != np.int8 else a


def _close(got, want, rel, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= rel * scale, (what, err, scale)


def operands(seed=0, M=24, K=64, N=48):
    """x and w with rows / columns that reach the grid's edge: one value
    far above the rest in a row, values straddling 448, an inf (clipped to
    the fp32 range first) and an fp32-max entry, and a column 1000x
    another."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    x[0, :4] = [447.9, 448.0, 448.1, -448.1]
    x[1, 3] = np.inf
    x[2, 5] = -F32_MAX
    x[3] *= 1e-3
    w = rng.normal(size=(K, N)).astype(np.float32)
    w[:, 0] *= 1000.0
    w[:, 1] *= 1e-3
    w[7, 2] = -np.inf
    return x, w


@pytest.mark.parametrize("precision", PRECISIONS)
def test_quantize_is_bit_equal_and_clamps_in_fp32(precision):
    x, w = operands()
    qd_j, qmax = j_quant._qparams(precision)
    qd_t, _ = quant._qparams(precision)
    for a, axis in ((x, -1), (w, 0), (x, None)):
        qj, sj = jax.jit(lambda v, axis=axis: j_quant._quantize(v, qd_j, qmax, axis=axis))(
            jnp.asarray(a))
        qt, st = quant._quantize(torch.from_numpy(a), qd_t, qmax, dim=axis)
        np.testing.assert_array_equal(_bits(qt), _bits(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        assert np.isfinite(st.numpy()).all() and np.isfinite(qt.float().numpy()).all()
        # the clamp binds: some entries sit on the grid's edge
        assert float(qt.float().abs().max()) == qmax


@pytest.mark.parametrize("precision", PRECISIONS)
def test_quantized_matmul_forward_and_backward_match_jax(precision):
    x, w = operands(1)
    x[1, 3] = x[2, 5] = 0.0  # finite outputs for the comparison
    w[7, 2] = 0.0
    x3 = x.reshape(2, 12, -1)
    want = j_quant.quantized_matmul(jnp.asarray(x3), jnp.asarray(w), precision)
    got = quant.quantized_matmul(torch.from_numpy(x3), torch.from_numpy(w), precision)
    _close(got, want, 1e-5, "out")
    # the dispatcher, and a kernel quantized once
    _close(quant.matmul(torch.from_numpy(x3), torch.from_numpy(w), precision), want, 1e-5)
    qk = quant.quantize_kernel(torch.from_numpy(w), precision)
    np.testing.assert_array_equal(
        quant.quantized_matmul(torch.from_numpy(x3), qk, precision).numpy(), got.numpy())
    np.testing.assert_array_equal(quant.matmul(torch.from_numpy(x3), torch.from_numpy(w), None)
                                  .numpy(), x3 @ w)
    # backward: bf16 on the original operands
    cot = np.random.default_rng(2).normal(size=want.shape).astype(np.float32)
    jdx, jdw = jax.grad(lambda a, b: jnp.sum(
        j_quant.quantized_matmul(a, b, precision) * cot), argnums=(0, 1))(
        jnp.asarray(x3), jnp.asarray(w))
    tx = torch.from_numpy(x3).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    (quant.quantized_matmul(tx, tw, precision) * torch.from_numpy(cot)).sum().backward()
    _close(tx.grad, jdx, 1e-2, "dx")
    _close(tw.grad, jdw, 1e-2, "dw")
    assert tx.grad.dtype == tw.grad.dtype == torch.float32


@pytest.mark.parametrize("precision", PRECISIONS)
def test_near_max_inputs_saturate_not_nan(precision):
    """tests/unit/test_quant_qat.py's saturation cases, on both packages."""
    x = np.array([[447.9, 448.0, 448.1, -448.1, 1e30, -1e30]], np.float32)
    eye = np.eye(6, dtype=np.float32)
    want = np.asarray(jax.jit(lambda a, b: j_quant.quantized_matmul(a, b, precision))(
        jnp.asarray(x), jnp.asarray(eye)))
    got = quant.quantized_matmul(torch.from_numpy(x), torch.from_numpy(eye), precision)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_array_equal(got.numpy(), want)


def test_fake_quantize_and_the_qat_transform_match_jax():
    rng = np.random.default_rng(1)
    tree = {"layers": {"q_proj": {"kernel": rng.normal(size=(2, 8, 16))},
                       "input_norm": {"scale": rng.normal(size=(2, 8))}},
            "embed": {"embedding": rng.normal(size=(16, 8))},
            "lm_head": {"kernel": rng.normal(size=(8, 16))}}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    for precision in PRECISIONS:
        x = tree["layers"]["q_proj"]["kernel"]
        got = quant.fake_quantize(torch.from_numpy(x), precision)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax.jit(
            lambda v, p=precision: j_quant.fake_quantize(v, p))(jnp.asarray(x))))
        # STE: the gradient of sum(fake_quantize(x)) is exactly ones
        tx = torch.from_numpy(x).requires_grad_(True)
        quant.fake_quantize(tx, precision).sum().backward()
        np.testing.assert_array_equal(tx.grad.numpy(), np.ones_like(x))
    jt = j_quant.QATConfig(enabled=True, precision="int8", start_step=3).make_param_transform()
    tt = quant.QATConfig(enabled=True, precision="int8", start_step=3).make_param_transform()
    assert quant.QATConfig().make_param_transform() is None
    tp = jax.tree.map(torch.from_numpy, tree)
    jt = jax.jit(jt)
    for step in (0, 2, 3, 7):
        want = jt(jax.tree.map(jnp.asarray, tree), jnp.asarray(step))
        got = tt(tp, step)
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree.leaves(got)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=str(path))
        moved = not np.array_equal(got["layers"]["q_proj"]["kernel"].numpy(),
                                   tree["layers"]["q_proj"]["kernel"])
        assert moved == (step >= 3)
        # kernels only: embeddings and norm scales never move
        np.testing.assert_array_equal(got["embed"]["embedding"].numpy(),
                                      tree["embed"]["embedding"])


# ---------------------------------------------------------------------------
# the decoders, the engine and generate()
# ---------------------------------------------------------------------------
def _dense_cfgs(precision, **kw):
    fields = dict(LLAMA, linear_precision=precision, **kw)
    return (j_decoder.TransformerConfig(**fields, dtype=jnp.float32, remat_policy="none",
                                        attn_impl="xla"),
            decoder.TransformerConfig(**fields, dtype=torch.float32))


def _mla_cfgs(precision):
    fields = dict(MLA_KW, mla_q_lora_rank=12, linear_precision=precision)
    return (j_decoder.TransformerConfig(**fields, dtype=jnp.float32, remat_policy="none",
                                        attn_impl="xla"),
            decoder.TransformerConfig(**fields, dtype=torch.float32))


def _np_params(tcfg, seed=0):
    params = decoder.init(tcfg, torch.Generator().manual_seed(seed))
    return jax.tree.map(lambda t: t.numpy(), params)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("arch", ("llama", "mla"))
def test_decoder_with_linear_precision_matches_jax(arch, precision):
    jcfg, tcfg = (_dense_cfgs if arch == "llama" else _mla_cfgs)(precision)
    params = _np_params(tcfg, 1)
    rng = np.random.default_rng(3)
    ids = rng.integers(1, tcfg.vocab_size, (2, 12)).astype(np.int32)
    cot = rng.normal(size=(2, 12, tcfg.vocab_size)).astype(np.float32)

    def jf(p):
        out = j_decoder.forward(p, jcfg, jnp.asarray(ids))
        return jnp.sum(out * cot), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    tp = params_from_jax(params, device="cpu")
    for p in jax.tree.leaves(tp):
        p.requires_grad_(True)
    out = decoder.forward(tp, tcfg, torch.from_numpy(ids).long())
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out, jout, 1e-5, "logits")
    # the quantized forward differs from the plain one by far more
    plain = decoder.forward(tp, dataclasses.replace(tcfg, linear_precision=None),
                            torch.from_numpy(ids).long())
    assert float((plain - out).abs().max()) > 100 * 1e-5 * float(out.detach().abs().max())
    for (path, g), t in zip(jax.tree_util.tree_leaves_with_path(jg), jax.tree.leaves(tp)):
        _close(t.grad, g, 1e-2, str(path))


SERVE_CASES = {"llama": INT8_CASES["llama"], "mla": INT8_CASES["mla"]}


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_engine_serve_precision_lockstep_matches_jax(case, precision, monkeypatch):
    """Both engines with `serve_precision`, fed the same ragged stream:
    equal plans, logits within 1e-4, greedy tokens equal; the port's
    kernels quantized once at build."""
    cfgs, sc, prompts, arrivals, max_new = SERVE_CASES[case]
    j_cfg, t_cfg = cfgs()
    params = _np_params(t_cfg, 2)
    je = JServingEngine(jax.tree.map(jnp.asarray, params), j_cfg,
                        JServingConfig(**sc, serve_precision=precision))
    te = ServingEngine(params_from_jax(params, device="cpu"), t_cfg,
                       ServingConfig(**sc, serve_precision=precision), device="cpu")
    assert te.cfg.linear_precision == precision
    lp = te._layers[0][2]
    assert isinstance(lp["q_proj" if case == "llama" else "kv_down_proj"]["kernel"],
                      quant.QuantizedKernel)
    assert isinstance(lp["o_proj"]["kernel"], quant.QuantizedKernel) == (case == "mla")
    outs = run_lockstep(je, te, prompts, arrivals, max_new, monkeypatch)
    plain = ServingEngine(params_from_jax(params, device="cpu"), t_cfg,
                          ServingConfig(**sc), device="cpu")
    assert plain.cfg.linear_precision is None and outs


@pytest.mark.parametrize("precision", PRECISIONS)
def test_generate_with_linear_precision_token_equal_to_jax(precision):
    for jcfg, tcfg in (_dense_cfgs(precision), _mla_cfgs(precision)):
        params = _np_params(tcfg, 4)
        ids = np.random.default_rng(5).integers(1, tcfg.vocab_size, (2, 7)).astype(np.int32)
        want = np.asarray(j_generate(jax.tree.map(jnp.asarray, params), jcfg,
                                     jnp.asarray(ids), jax.random.key(0),
                                     JGenerateConfig(max_new_tokens=6)))
        got = generate(params_from_jax(params, device="cpu"), tcfg, torch.from_numpy(ids),
                       None, GenerateConfig(max_new_tokens=6)).numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the recipe
# ---------------------------------------------------------------------------
def _node(tmp_path, name, steps=5, **sets):
    node = load_yaml(TINY_YAML)
    node.set("checkpoint.enabled", False)
    node.set("run_dir", str(tmp_path / name))
    node.set("step_scheduler.max_steps", steps)
    for k, v in sets.items():
        node.set(k.replace("__", "."), v)
    return node


def _losses(path):
    with open(path) as f:
        return np.array([json.loads(line)["loss"] for line in f])


def _run_pair(tmp_path, **sets):
    """The JAX recipe, then the port's from the JAX recipe's initial weights
    twice: free running, and teacher-forced (each step starting from the
    JAX run's weights at that step). Returns the three loss curves."""
    j_recipe = JRecipe(JConfigNode(_node(tmp_path, "jax", **sets).to_dict()))
    j_recipe.setup()
    init = jax.tree.map(np.asarray, j_recipe.train_state.params)
    seen = []
    j_step = j_recipe._invoke_train_step

    def capture(batch):
        seen.append(jax.tree.map(np.asarray, j_recipe.train_state.params))
        return j_step(batch)

    j_recipe._invoke_train_step = capture
    j_recipe.run_train_validation_loop()
    curves = {"jax": _losses(tmp_path / "jax" / "training.jsonl")}
    for name in ("free", "forced"):
        t_recipe = TrainFinetuneRecipeForNextTokenPrediction(
            _node(tmp_path, name, **sets), device="cpu")
        t_recipe.setup()
        t_recipe.train_state = init_train_state(params_from_jax(init, device="cpu"),
                                                t_recipe.tx)
        if name == "forced":
            t_step = t_recipe.run_step

            def forced(microbatches, t_recipe=t_recipe, t_step=t_step):
                want = jax.tree.leaves(seen[t_recipe.train_state.step])
                with torch.no_grad():
                    for p, w in zip(jax.tree.leaves(t_recipe.train_state.params), want):
                        p.copy_(torch.from_numpy(w))
                return t_step(microbatches)

            t_recipe.run_step = forced
        t_recipe.run_train_validation_loop()
        curves[name] = _losses(tmp_path / name / "training.jsonl")
    return curves, init, t_recipe


@pytest.mark.parametrize("case", ("linear_precision_fp8", "qat_int8"))
def test_recipe_loss_curve_matches_live_jax_run(case, tmp_path):
    """Every step's loss from the JAX run's weights at that step within the
    protocol's 1e-4; the free-running curve too where the quantization grid
    lets it. An activation or weight that differs in its last bits between
    the packages (another summation order) can round to the neighbouring
    grid point, one part in 16 for fp8 (1 in 127 for int8): from the same
    weights the fp8 losses differ by up to ~4e-5, and once the runs' updates
    differ by bf16 roundings (step 3 on) the free-running fp8 curve drifts
    to a few 1e-4, held to 2e-3."""
    sets = ({"model__linear_precision": "fp8"} if case == "linear_precision_fp8" else
            {"qat__enabled": True, "qat__precision": "int8", "qat__start_step": 2})
    curves, init, t_recipe = _run_pair(tmp_path, **sets)
    want = curves["jax"]
    assert len(want) == len(curves["free"]) == len(curves["forced"]) == 5
    rel = np.abs(curves["forced"] - want) / np.abs(want)
    assert rel.max() <= 1e-4, rel
    rel = np.abs(curves["free"] - want) / np.abs(want)
    assert rel[:2].max() <= 1e-4 and rel.max() <= 2e-3, rel
    if case == "qat_int8":
        assert rel.max() <= 1e-4, rel
        assert t_recipe.model_cfg.linear_precision is None
        # before start_step a QAT run is a plain run, bit for bit
        plain = TrainFinetuneRecipeForNextTokenPrediction(
            _node(tmp_path, "plain", steps=3), device="cpu")
        plain.setup()
        plain.train_state = init_train_state(params_from_jax(init, device="cpu"), plain.tx)
        plain.run_train_validation_loop()
        base = _losses(tmp_path / "plain" / "training.jsonl")
        np.testing.assert_array_equal(curves["free"][:2], base[:2])
        assert curves["free"][2] != base[2]
    else:
        assert t_recipe.model_cfg.linear_precision == "fp8"


def test_qat_with_peft_raises(tmp_path):
    node = _node(tmp_path, "peft", qat__enabled=True)
    node.set("peft", {"r": 4, "alpha": 8.0, "target_modules": ["q_proj"]})
    with pytest.raises(ValueError, match="does not compose with peft"):
        TrainFinetuneRecipeForNextTokenPrediction(node, device="cpu").setup()
