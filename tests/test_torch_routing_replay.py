"""Port parity of MoE routing replay (`models/moe_lm/decoder.forward`'s
`return_routing` and `routing_override`; JAX `tests/unit/test_moe.py::
test_router_replay_pins_selection`), on the CPU: the DeepSeek-V3 smoke
model, the same numpy weights and tokens in both packages.

- The captured routing (num_moe_layers, B*S, K) equals JAX's.
- Replayed on the same weights, the logits equal the unreplayed ones and
  the routing comes back unchanged.
- With the router's weights reversed and scaled, the natural routing
  changes and the replayed one does not; the replayed forward's logits and
  every gradient leaf (the router's included, which the replay still
  trains) match JAX's replayed forward within 1e-5 / 1e-4 of their largest
  magnitude.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from automodel_tpu.models.moe_lm import decoder as j_moe
from automodel_tpu.models.registry import get_model_spec as j_get_model_spec
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.models.moe_lm import decoder as moe_decoder
from automodel_tpu_torch.models.registry import get_model_spec


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one CPU thread: the models are tiny, and under the tier-1
    run's workers several threads per process oversubscribe the cores
    (the recipe cases ran 10-20x slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= rel * scale, (what, err, scale)


def _setup():
    with open("examples/llm_finetune/deepseek_v3_smoke.yaml") as f:
        hf = yaml.safe_load(f)["model"]["hf_config"]
    tcfg = get_model_spec(hf).config_from_hf(hf, dtype=torch.float32, remat_policy="none")
    jcfg = j_get_model_spec(hf).config_from_hf(hf, dtype=jnp.float32, remat_policy="none",
                                               attn_impl="xla")
    params = jax.tree.map(lambda t: t.numpy(),
                          moe_decoder.init(tcfg, torch.Generator().manual_seed(9)))
    gate = params["moe_layers"]["moe"]["gate"]
    gate["e_score_bias"] = np.random.default_rng(1).normal(
        0, 0.05, gate["e_score_bias"].shape).astype(np.float32)
    ids = np.random.default_rng(2).integers(1, hf["vocab_size"], (2, 8)).astype(np.int32)
    return tcfg, jcfg, params, ids


def test_routing_capture_and_replay_match_jax():
    tcfg, jcfg, params, ids = _setup()
    tids = torch.from_numpy(ids).long()
    tp = params_from_jax(params, device="cpu")
    jp = jax.tree.map(jnp.asarray, params)

    _, _, jst = jax.jit(lambda p: j_moe.forward(p, jcfg, jnp.asarray(ids), return_stats=True,
                                                return_routing=True))(jp)
    out0, _, st = moe_decoder.forward(tp, tcfg, tids, return_stats=True, return_routing=True)
    routing = st["routing"]
    assert routing.shape == (tcfg.num_moe_layers, ids.size, tcfg.moe.experts_per_token)
    np.testing.assert_array_equal(routing.numpy(), np.asarray(jst["routing"]))
    # without return_routing the stats carry none
    assert "routing" not in moe_decoder.forward(tp, tcfg, tids, return_stats=True)[2]

    # replay on the same weights: the same logits and routing
    out1, _, st1 = moe_decoder.forward(tp, tcfg, tids, return_stats=True,
                                       return_routing=True, routing_override=routing)
    torch.testing.assert_close(out1, out0, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(st1["routing"].numpy(), routing.numpy())

    # the router's weights reversed and scaled: natural routing moves, the
    # replayed one does not
    p2 = copy.deepcopy(params)
    w = p2["moe_layers"]["moe"]["gate"]["weight"]
    p2["moe_layers"]["moe"]["gate"]["weight"] = np.ascontiguousarray(w[..., ::-1] * 3.0)
    tp2 = params_from_jax(p2, device="cpu")
    _, _, nat = moe_decoder.forward(tp2, tcfg, tids, return_stats=True, return_routing=True)
    assert not np.array_equal(nat["routing"].numpy(), routing.numpy())
    for p in jax.tree.leaves(tp2):
        p.requires_grad_(True)
    cot = np.random.default_rng(3).normal(size=out0.shape).astype(np.float32)
    out2, aux2, rep = moe_decoder.forward(tp2, tcfg, tids, return_stats=True,
                                          return_routing=True, routing_override=routing)
    np.testing.assert_array_equal(rep["routing"].numpy(), routing.numpy())
    (torch.sum(out2 * torch.from_numpy(cot)) + aux2).backward()

    jrouting = jnp.asarray(routing.numpy())

    def jf(p):
        out, aux = j_moe.forward(p, jcfg, jnp.asarray(ids), routing_override=jrouting)
        return jnp.sum(out * cot) + aux, out

    (_, jout), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jax.tree.map(jnp.asarray, p2))
    _close(out2, jout, 1e-5, "logits")
    for (path, g), t in zip(jax.tree_util.tree_leaves_with_path(jg), jax.tree.leaves(tp2)):
        _close(t.grad if t.grad is not None else torch.zeros(np.shape(g)), g, 1e-4, str(path))
    # the replay still trains the router
    assert float(tp2["moe_layers"]["moe"]["gate"]["weight"].grad.abs().max()) > 0
