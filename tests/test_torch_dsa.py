"""Port parity of DSA, the lightning-indexer top-k sparse MLA of
DeepSeek-V3.2/V4 and GLM-5 (`ops/dsa.py`, `models/llm/mla.py`'s sparse
blocks, the MoE decoder's DSA dispatch with IndexShare), on the CPU: the JAX
package and `automodel_tpu_torch` fed the same numpy weights and inputs.

- The four `ops/dsa.py` functions: scores within 1e-5 of their largest
  magnitude, the selection mask equal, the KL within 1e-6 relative.
- Ties: the GLM indexer's relu makes exact-zero scores in bulk. The case
  here puts those ties across the top-k boundary with fewer selected keys
  than admissible ones; a top-k that broke ties by the highest index would
  select another set, and the test checks that it would.
- The oracle and the chunked block in both indexer styles, with packed
  segments, pad queries and IndexShare's shared call: outputs within 1e-5
  of their largest magnitude, the aux within 1e-5 relative, the selection
  (the valid part of the chunked indices, as sets) equal to JAX's, every
  gradient leaf within 1e-4 of its largest magnitude; the indexer's
  gradient comes only through the KL.
- The chunked path's memory: the largest live bytes of a forward and
  backward grow with the query block, not with S².
- The MoE decoder on the three DSA families' smoke models (forward, aux,
  gradients), GLM's IndexShare on both paths.

The smoke YAMLs' curves and the HF checkpoints are in
tests/test_torch_dsa_recipes.py.
"""

import copy
import dataclasses as dc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from torch.utils._python_dispatch import TorchDispatchMode

from automodel_tpu.models.llm import mla as j_mla
from automodel_tpu.models.llm.decoder import TransformerConfig as JConfig
from automodel_tpu.models.moe_lm import decoder as j_moe
from automodel_tpu.models.registry import get_model_spec as j_get_model_spec
from automodel_tpu.ops import dsa as j_dsa
from automodel_tpu.ops.rope import rope_frequencies as j_rope_frequencies
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.models.llm import mla
from automodel_tpu_torch.models.llm.decoder import TransformerConfig, init_attention_layers
from automodel_tpu_torch.models.moe_lm import decoder as moe_decoder
from automodel_tpu_torch.models.registry import get_model_spec
from automodel_tpu_torch.ops import dsa
from automodel_tpu_torch.ops.rope import rope_frequencies

MLA_KW = dict(
    vocab_size=128, hidden_size=32, intermediate_size=48, num_layers=2,
    num_heads=4, num_kv_heads=4, attention_type="mla", mla_q_lora_rank=8,
    mla_kv_lora_rank=16, mla_qk_nope_head_dim=8, mla_qk_rope_head_dim=8,
    mla_v_head_dim=8, remat_policy="none", dsa_indexer_loss_coeff=0.1,
)
STYLES = {
    "deepseek": dict(dsa_index_n_heads=4, dsa_index_head_dim=16),
    "glm": dict(dsa_indexer_style="glm", dsa_index_n_heads=2, dsa_index_head_dim=16),
}
SMOKE = {"deepseek_v32": "DeepseekV32ForCausalLM",
         "deepseek_v4_dsa": "DeepseekV4ForCausalLM",
         "glm_moe_dsa": "GlmMoeDsaForCausalLM"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Torch on one CPU thread: the models are tiny, and under the tier-1
    run's workers several threads per process oversubscribe the cores
    (the recipe cases ran 10-20x slower than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return _np(tree)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _close(got, want, rel, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= rel * scale, (what, err, scale)


def configs(style: str, topk: int, **kw):
    fields = dict(MLA_KW, **STYLES[style], dsa_index_topk=topk, **kw)
    return (TransformerConfig(**fields, dtype=torch.float32),
            JConfig(**fields, dtype=jnp.float32))


def layer_params(tcfg, seed: int):
    """One layer's params as numpy (the port's init), every norm scale and
    the GLM key norm's bias drawn at random."""
    stack = init_attention_layers(tcfg, torch.Generator().manual_seed(seed), 1)
    lp = jax.tree.map(lambda a: a[0], _tree_np(stack))
    rng = np.random.default_rng(seed)
    for path, leaf in _flat(lp).items():
        node = lp
        for p in path[:-1]:
            node = node[p]
        if path[-1] in ("scale", "bias"):
            node[path[-1]] = rng.normal(1.0 if path[-1] == "scale" else 0.0, 0.3,
                                        leaf.shape).astype(np.float32)
    return lp


def inputs(B: int, S: int, H: int, seed: int, packed: bool = True):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, S, H)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    seg = np.zeros((B, S), np.int32)
    if packed:  # row 1: two documents, the second restarting its positions
        cut = S // 3
        seg[1, cut:] = 1
        pos[1, cut:] = np.arange(S - cut)
    mask = np.ones((B, S), bool)
    mask[-1, -3:] = False
    return h, pos, seg, mask


# ---------------------------------------------------------------------------
# ops/dsa.py
# ---------------------------------------------------------------------------
def _indexer_inputs(glm: bool, seed=0):
    rng = np.random.default_rng(seed)
    B, S, H, Hi, Di, rq = 2, 12, 32, 4, 16, 8
    x = rng.normal(size=(B, S, H)).astype(np.float32)
    q_lat = rng.normal(size=(B, S, rq)).astype(np.float32)
    ip = {"wq": {"kernel": rng.normal(size=(rq if glm else H, Hi * Di))},
          "wk": {"kernel": rng.normal(size=(H, Di))},
          "wgate": {"kernel": rng.normal(size=(H, Hi))}}
    if glm:
        ip["k_norm"] = {"scale": rng.normal(1.0, 0.3, Di), "bias": rng.normal(0, 0.3, Di)}
    ip = jax.tree.map(lambda a: np.asarray(a, np.float32), ip)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    return x, q_lat, ip, pos, Hi, Di


@pytest.mark.parametrize("glm", (False, True), ids=("deepseek", "glm"))
def test_indexer_scores_match_jax(glm):
    x, q_lat, ip, pos, Hi, Di = _indexer_inputs(glm)
    T = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    tip = jax.tree.map(T, ip)
    if glm:
        want = j_dsa.indexer_scores_glm(x, q_lat, ip, Hi, Di, pos, j_rope_frequencies(8))
        got = dsa.indexer_scores_glm(T(x), T(q_lat), tip, Hi, Di, T(pos), rope_frequencies(8))
    else:
        want = j_dsa.indexer_scores(x, ip, Hi, Di, pos, j_rope_frequencies(Di))
        got = dsa.indexer_scores(T(x), tip, Hi, Di, T(pos), rope_frequencies(Di))
        # no rope
        _close(dsa.indexer_scores(T(x), tip, Hi, Di, T(pos), None),
               j_dsa.indexer_scores(x, ip, Hi, Di, pos, None), 1e-5)
    _close(got, want, 1e-5)


def tied_scores(B=2, S=24, seed=0):
    """GLM-like indexer scores: relu zeros in bulk (a third of all pairs
    exactly 0), so that for most queries the k-th admissible score is a
    zero tied with zeros on both sides of the boundary."""
    rng = np.random.default_rng(seed)
    s = np.maximum(rng.normal(size=(B, S, S)), 0.0).astype(np.float32)
    s[rng.random(size=s.shape) < 0.35] = 0.0
    return s


def test_topk_select_ties_match_jax_and_fail_a_highest_index_tiebreak():
    S, k = 24, 6
    scores = tied_scores(S=S)
    base = np.tril(np.ones((S, S), bool))[None]
    want = np.asarray(j_dsa.topk_select_mask(scores, base, k))
    got = dsa.topk_select_mask(torch.from_numpy(scores), torch.from_numpy(base), k).numpy()
    np.testing.assert_array_equal(got, want)
    adm = np.broadcast_to(base, scores.shape).sum(-1)
    np.testing.assert_array_equal(got.sum(-1), np.minimum(k, adm))
    assert (adm > k).sum() >= 20  # a top-k smaller than the admissible keys
    # the data can fail the code: ties cross the boundary, so taking the
    # highest index among equal scores selects another set
    masked = np.where(base, scores, -np.inf)
    flipped = torch.from_numpy(np.ascontiguousarray(masked[..., ::-1]))
    _, idx = dsa.stable_topk(flipped, k)
    mutant = np.zeros_like(want)
    np.put_along_axis(mutant, S - 1 - idx.numpy(), True, axis=-1)
    mutant &= np.broadcast_to(base, mutant.shape)
    assert (mutant != want).any(-1).sum() >= 10


def test_indexer_kl_loss_matches_jax():
    rng = np.random.default_rng(3)
    B, S = 2, 10
    scores = rng.normal(size=(B, S, S)).astype(np.float32)
    probs = rng.random(size=(B, S, S)).astype(np.float32)
    base = np.tril(np.ones((S, S), bool))[None]
    sel = np.asarray(j_dsa.topk_select_mask(scores, base, 4))
    mask = np.ones((B, S), bool)
    mask[1, -4:] = False
    T = torch.from_numpy
    for tm in (None, mask):
        want = j_dsa.indexer_kl_loss(scores, probs, sel, None if tm is None else tm)
        ts = T(scores).requires_grad_(True)
        got = dsa.indexer_kl_loss(ts, T(probs), T(sel), None if tm is None else T(tm))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        g = jax.grad(lambda s: j_dsa.indexer_kl_loss(s, probs, sel, tm))(scores)
        got.backward()
        _close(ts.grad, g, 1e-5)


# ---------------------------------------------------------------------------
# the sparse MLA blocks
# ---------------------------------------------------------------------------
def _run_both(style, impl, topk, S=40, block=8, flag=None, prev=None, seed=0,
              cot_seed=5, jax_grads=True):
    tcfg, jcfg = configs(style, topk, dsa_impl=impl, dsa_query_block=block)
    lp = layer_params(tcfg, seed)
    h, pos, seg, mask = inputs(2, S, tcfg.hidden_size, seed + 1)
    cot = np.random.default_rng(cot_seed).normal(size=h.shape).astype(np.float32)
    inv = j_rope_frequencies(jcfg.rope_dim, jcfg.rope_theta)
    ident = lambda a, axes: a  # noqa: E731
    jflag = None if flag is None else jnp.asarray(int(flag), jnp.int32)
    jprev = None if prev is None else jnp.asarray(prev[0])

    def jf(lp):
        out, aux, sel = j_mla.mla_sparse_attention_block(
            jnp.asarray(h), lp, jcfg, jnp.asarray(pos), jnp.asarray(seg), inv, ident,
            token_mask=jnp.asarray(mask), prev_sel=jprev, indexer_flag=jflag)
        return jnp.sum(out * cot) + aux, (out, aux, sel)

    (_, (jout, jaux, jsel)), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(lp)
    tlp = params_from_jax(lp, device="cpu")
    for p in jax.tree.leaves(tlp):
        p.requires_grad_(True)
    tprev = None if prev is None else torch.from_numpy(np.asarray(prev[1]))
    out, aux, sel = mla.mla_sparse_attention_block(
        torch.from_numpy(h), tlp, tcfg, torch.from_numpy(pos), torch.from_numpy(seg),
        rope_frequencies(tcfg.rope_dim, tcfg.rope_theta),
        token_mask=torch.from_numpy(mask), prev_sel=tprev, indexer_flag=flag)
    (torch.sum(out * torch.from_numpy(cot)) + aux).backward()
    tg = jax.tree.map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p), tlp)
    return dict(jout=jout, jaux=jaux, jsel=jsel, jg=jg, out=out, aux=aux, sel=sel, tg=tg,
                pos=pos, seg=seg)


def _valid_sets(idx, pos, seg):
    """The admissible part of (B, S, K) chunked indices, as sets per query."""
    B, S, _ = idx.shape
    adm = (seg[:, :, None] == seg[:, None, :]) & (pos[:, :, None] >= pos[:, None, :])
    return [[{int(j) for j in idx[b, t] if adm[b, t, j]} for t in range(S)]
            for b in range(B)]


def _sel_sets(sel):
    return [[set(np.nonzero(row)[0].tolist()) for row in b] for b in sel]


@pytest.mark.parametrize("impl", ("oracle", "chunked"))
@pytest.mark.parametrize("style", ("deepseek", "glm"))
def test_sparse_block_matches_jax(style, impl):
    """Forward, aux, selection and every gradient leaf against JAX; topk 6
    is below the admissible count of most queries (S 40, packed rows)."""
    r = _run_both(style, impl, topk=6)
    _close(r["out"], r["jout"], 1e-5, "out")
    np.testing.assert_allclose(float(r["aux"]), float(r["jaux"]), rtol=1e-5)
    assert float(r["jaux"]) > 1e-3
    if impl == "oracle":
        np.testing.assert_array_equal(r["sel"].numpy(), np.asarray(r["jsel"]))
    else:
        assert r["sel"].shape == tuple(np.shape(r["jsel"]))
        assert _valid_sets(r["sel"].numpy(), r["pos"], r["seg"]) == _valid_sets(
            np.asarray(r["jsel"]), r["pos"], r["seg"])
    for path, g in _flat(r["jg"]).items():
        _close(_flat(r["tg"])[path], g, 1e-4, path)


@pytest.mark.parametrize("impl", ("oracle", "chunked"))
def test_index_share_shared_call_matches_jax(impl):
    """A "shared" IndexShare call (flag 0) reuses the running selection,
    adds no KL and passes the indexer no gradient."""
    full = _run_both("glm", impl, topk=6, S=32)
    prev = (np.asarray(full["jsel"]), full["sel"].numpy())
    r = _run_both("glm", impl, topk=6, S=32, flag=False, prev=prev, seed=4)
    _close(r["out"], r["jout"], 1e-5, "out")
    assert float(r["aux"]) == float(r["jaux"]) == 0.0
    np.testing.assert_array_equal(_np(r["sel"]), prev[1])
    for path, g in _flat(r["jg"]).items():
        _close(_flat(r["tg"])[path], g, 1e-4, path)
    for g in jax.tree.leaves(r["tg"]["indexer"]):
        assert float(g.abs().max()) == 0.0


@pytest.mark.parametrize("style", ("deepseek", "glm"))
def test_chunked_selects_what_the_oracle_selects_under_ties(style):
    """Zero indexer query weights on half the heads and a relu-heavy key
    norm leave exact-zero ties across the boundary: the chunked path's
    valid indices are the oracle's selection, query for query, and its
    output and aux match."""
    S, topk = 48, 8
    tcfg_o, _ = configs(style, topk, dsa_impl="oracle")
    tcfg_c = dc.replace(tcfg_o, dsa_impl="chunked", dsa_query_block=16)
    lp = params_from_jax(layer_params(tcfg_o, 7), device="cpu")
    ip = lp["indexer"]
    # every indexer dot <= 0 for a quarter of the keys: their scores tie at 0
    ip["wk"]["kernel"][:, :] = ip["wk"]["kernel"].abs()
    h, pos, seg, mask = inputs(2, S, tcfg_o.hidden_size, 8)
    h[:, ::4] = -np.abs(h[:, ::4])
    ip["wq"]["kernel"][:, :] = ip["wq"]["kernel"].abs()
    args = (torch.from_numpy(h), lp)
    inv = rope_frequencies(tcfg_o.rope_dim, tcfg_o.rope_theta)
    kw = dict(token_mask=torch.from_numpy(mask))
    T = torch.from_numpy
    with torch.no_grad():
        o_out, o_aux, o_sel = mla.mla_sparse_attention_block(
            *args, tcfg_o, T(pos), T(seg), inv, **kw)
        c_out, c_aux, c_idx = mla.mla_sparse_attention_block(
            *args, tcfg_c, T(pos), T(seg), inv, **kw)
    assert _valid_sets(c_idx.numpy(), pos, seg) == _sel_sets(o_sel.numpy())
    _close(c_out, o_out, 1e-5)
    np.testing.assert_allclose(float(c_aux), float(o_aux), rtol=1e-5)


@pytest.mark.parametrize("impl", ("oracle", "chunked"))
def test_indexer_gets_gradient_only_via_kl(impl):
    tcfg, _ = configs("deepseek", 4, dsa_impl=impl, dsa_query_block=4)
    lp = params_from_jax(layer_params(tcfg, 0), device="cpu")
    h, pos, _, _ = inputs(1, 12, tcfg.hidden_size, 1, packed=False)
    inv = rope_frequencies(tcfg.rope_dim, tcfg.rope_theta)
    for use_aux in (True, False):
        for p in jax.tree.leaves(lp):
            p.grad = None
            p.requires_grad_(True)
        out, aux, _ = mla.mla_sparse_attention_block(
            torch.from_numpy(h), lp, tcfg, torch.from_numpy(pos), None, inv)
        (aux if use_aux else torch.sum(out ** 2)).backward()
        gn = sum(float(p.grad.abs().sum()) for p in jax.tree.leaves(lp["indexer"])
                 if p.grad is not None)
        assert (gn > 0.0) if use_aux else (gn == 0.0)


class _PeakBytes(TorchDispatchMode):
    """The largest total of live tensor storage bytes created under it
    (weak references drop a storage's bytes when it is freed)."""

    def __init__(self):
        super().__init__()
        self.live, self.peak, self._seen = 0, 0, set()

    def _drop(self, key, n):
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in jax.tree.leaves(out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                key = st.data_ptr()
                if key and key not in self._seen:
                    n = st.nbytes()
                    self._seen.add(key)
                    self.live += n
                    weakref.finalize(st, self._drop, key, n)
        self.peak = max(self.peak, self.live)
        return out


def test_chunked_sparse_memory_scales_blockwise():
    """Forward and backward at S 1024: the oracle's live bytes carry (S, S)
    scores and masks, the chunked path's one (block, S) block at a time
    (each block checkpointed); doubling the block roughly doubles them."""
    S = 1024
    tcfg, _ = configs("deepseek", 64)
    lp = params_from_jax(layer_params(tcfg, 0), device="cpu")
    h, pos, _, _ = inputs(1, S, tcfg.hidden_size, 1, packed=False)
    inv = rope_frequencies(tcfg.rope_dim, tcfg.rope_theta)

    def peak(cfg):
        for p in jax.tree.leaves(lp):
            p.grad = None
            p.requires_grad_(True)
        hh = torch.from_numpy(h).requires_grad_(True)
        with _PeakBytes() as m:
            out, aux, _ = mla.mla_sparse_attention_block(
                hh, lp, cfg, torch.from_numpy(pos), None, inv)
            (out.square().sum() + aux).backward()
        return m.peak

    oracle = peak(dc.replace(tcfg, dsa_impl="oracle"))
    c64 = peak(dc.replace(tcfg, dsa_impl="chunked", dsa_query_block=64))
    c128 = peak(dc.replace(tcfg, dsa_impl="chunked", dsa_query_block=128))
    assert c64 < oracle / 4, (oracle, c64)
    assert c64 < c128 < 3 * c64, (c64, c128)


# ---------------------------------------------------------------------------
# the MoE decoder on the DSA families
# ---------------------------------------------------------------------------
def smoke_hf(name: str) -> dict:
    with open(f"examples/llm_finetune/{name}_smoke.yaml") as f:
        return yaml.safe_load(f)["model"]["hf_config"]


def _moe_params(tcfg, seed):
    params = _tree_np(moe_decoder.init(tcfg, torch.Generator().manual_seed(seed)))
    rng = np.random.default_rng(seed)
    params = copy.deepcopy(params)
    for path, leaf in _flat(params).items():
        node = params
        for p in path[:-1]:
            node = node[p]
        if path[-1] in ("scale", "bias", "e_score_bias"):
            node[path[-1]] = rng.normal(1.0 if path[-1] == "scale" else 0.0, 0.3,
                                        leaf.shape).astype(np.float32)
    return params


def test_family_configs_match_jax():
    from test_torch_moe_families import _fields_equal

    for name, arch in SMOKE.items():
        hf = smoke_hf(name)
        assert hf["architectures"] == [arch]
        spec, j_spec = get_model_spec(hf), j_get_model_spec(hf)
        _fields_equal(spec.config_from_hf(hf, dtype=torch.float32),
                      j_spec.config_from_hf(hf, dtype=jnp.float32))
        assert (spec.name, spec.adapter_name, spec.adapter_kwargs) == (
            j_spec.name, j_spec.adapter_name, j_spec.adapter_kwargs)


@pytest.mark.parametrize("name,impl", (("deepseek_v32", "auto"), ("deepseek_v4_dsa", "auto"),
                                       ("glm_moe_dsa", "oracle"), ("glm_moe_dsa", "chunked")))
def test_moe_decoder_forward_and_gradients_match_jax(name, impl):
    """The smoke model (all layers DSA; GLM's second layer "shared"):
    logits within 1e-5, the aux (balance + indexer KL) within 1e-5
    relative, every gradient leaf within 1e-4 of its largest magnitude."""
    hf = dict(smoke_hf(name), num_hidden_layers=2)
    over = dict(dsa_impl=impl, dsa_query_block=8, remat_policy="full")
    tcfg = get_model_spec(hf).config_from_hf(hf, dtype=torch.float32, **over)
    jcfg = j_get_model_spec(hf).config_from_hf(hf, dtype=jnp.float32, attn_impl="xla",
                                               **over)
    params = _moe_params(tcfg, 3)
    S = 24
    rng = np.random.default_rng(4)
    ids = rng.integers(1, hf["vocab_size"], (2, S)).astype(np.int32)
    mask = np.ones((2, S), bool)
    mask[1, -3:] = False
    cot = rng.normal(size=(2, S, hf["vocab_size"])).astype(np.float32)

    def jf(p):
        out, aux = j_moe.forward(p, jcfg, jnp.asarray(ids), token_mask=jnp.asarray(mask))
        return jnp.sum(out * cot) + aux, (out, aux)

    (_, (jout, jaux)), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(params)
    tp = params_from_jax(params, device="cpu")
    for p in jax.tree.leaves(tp):
        p.requires_grad_(True)
    out, aux = moe_decoder.forward(tp, tcfg, torch.from_numpy(ids).long(),
                                   token_mask=torch.from_numpy(mask))
    (torch.sum(out * torch.from_numpy(cot)) + aux).backward()
    _close(out, jout, 1e-5, "logits")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    tg = _flat(jax.tree.map(lambda p: p.grad, tp))
    for path, g in _flat(jg).items():
        _close(tg[path] if tg[path] is not None else torch.zeros(np.shape(g)), g, 1e-4, path)
