"""The selective remat policies ("dots", "dots_with_no_batch_dims",
"checkpoint_dots") beside "none" and "full", on the CPU.

- A tiny Llama's logits and every gradient leaf under each policy equal
  the JAX decoder's under the same policy: logits within 1e-5, gradients
  within 1e-4 of each leaf's largest magnitude (fp32, the tolerance of
  test_torch_sliding_families.py), with the plain attention and with the
  flash path (on CPU tensors K1-K3's plain versions, behind the same
  autograd function the card runs).
- What a policy keeps from the forward for the backward, counted as the
  bytes of the forward's tensor storages still alive when the forward
  returns (checkpoint's own saved-tensor hooks hide its cache from an
  outer `saved_tensors_hooks`, so the count follows the storages): none >
  dots > dots_with_no_batch_dims > full, checkpoint_dots == dots. On the
  CPU the plain attention's scores are a batched product, which "dots"
  keeps and "dots_with_no_batch_dims" does not.
- Under every policy but "none" the flash forward runs twice per layer
  (the recompute), and the backward reads the recompute's buffers: the
  first pass's outputs, overwritten with NaN once the backward starts,
  leave the gradients unchanged.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from automodel_tpu.models.llm import decoder as j_decoder
from automodel_tpu.models.llm import families as j_families
from automodel_tpu_torch.convert import params_from_jax
from automodel_tpu_torch.models.common.layers import REMAT_POLICIES
from automodel_tpu_torch.models.llm import decoder, families
from automodel_tpu_torch.ops import flash_attention as fa

POLICIES = ("none", "dots", "dots_with_no_batch_dims", "checkpoint_dots", "full")
HF = dict(architectures=["LlamaForCausalLM"], vocab_size=64, hidden_size=32,
          intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
          num_key_value_heads=2, attention_bias=True)
B, S = 2, 24


def _inputs():
    tcfg = families.llama_config(HF, dtype=torch.float32)
    params = decoder.init(tcfg, torch.Generator().manual_seed(0))
    jp = jax.tree.map(lambda t: t.numpy(), params)
    rng = np.random.default_rng(1)
    for node in jp["layers"].values():
        if "bias" in node:
            node["bias"] = rng.normal(0, 0.3, node["bias"].shape).astype(np.float32)
    ids = rng.integers(1, HF["vocab_size"], (B, S)).astype(np.int32)
    cot = rng.normal(size=(B, S, HF["vocab_size"])).astype(np.float32)
    return jp, ids, cot


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


class _Storages(TorchDispatchMode):
    """Weak references to the storage of every op output."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in jax.tree.leaves(out, is_leaf=lambda x: isinstance(x, torch.Tensor)):
            if isinstance(t, torch.Tensor):
                s = t.untyped_storage()
                self.refs.append((StorageWeakRef(s), s.data_ptr(), s.nbytes()))
        return out

    def live_bytes(self) -> int:
        """Bytes of the live storages, each once (a freed storage's address
        may come back for a later one)."""
        live = {ptr: n for ref, ptr, n in self.refs if not ref.expired()}
        return sum(live.values())


def _port(policy, impl, jp, ids, cot, count=None):
    tcfg = families.llama_config(HF, dtype=torch.float32, remat_policy=policy,
                                 attn_impl=impl)
    tp = params_from_jax(jp, device="cpu")
    leaves = {k: v.requires_grad_() for k, v in _flat(tp).items()}
    ctx = _Storages() if count is not None else contextlib.nullcontext()
    with ctx:
        loss = (decoder.forward(tp, tcfg, torch.from_numpy(ids)) * torch.from_numpy(cot)).sum()
    if count is not None:
        count.append(ctx.live_bytes())
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def test_policies_are_the_jax_names():
    assert set(REMAT_POLICIES) == set(POLICIES)


@pytest.mark.parametrize("policy", POLICIES)
def test_gradients_equal_jax_under_the_same_policy(policy):
    jp, ids, cot = _inputs()
    jcfg = j_families.llama_config(HF, dtype=jnp.float32, remat_policy=policy,
                                   attn_impl="xla")

    def j_loss(params):
        return jnp.sum(j_decoder.forward(params, jcfg, jnp.asarray(ids)) * cot)

    jl, jg = jax.value_and_grad(j_loss)(jax.tree.map(jnp.asarray, jp))
    jflat = _flat(jax.tree.map(np.asarray, jg))
    for impl in ("xla", "flash"):
        loss, grads = _port(policy, impl, jp, ids, cot)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        for key, g in grads.items():
            want = jflat[key]
            err = np.abs(g.numpy() - want).max() / max(np.abs(want).max(), 1e-30)
            assert err <= 1e-4, (policy, impl, key, err)


def test_saved_bytes_order():
    jp, ids, cot = _inputs()
    saved = {}
    for policy in POLICIES:
        count = []
        _port(policy, "xla", jp, ids, cot, count)
        saved[policy] = count[0]
    assert (saved["none"] > saved["dots"] > saved["dots_with_no_batch_dims"]
            > saved["full"]), saved
    assert saved["checkpoint_dots"] == saved["dots"], saved


@pytest.mark.parametrize("policy", POLICIES)
def test_backward_reads_the_recompute(policy, monkeypatch):
    jp, ids, cot = _inputs()
    _, want = _port("none", "flash", jp, ids, cot)
    calls = {"fwd": [], "bwd": 0}
    fwd, bwd = fa.flash_attention_ref, fa.flash_attention_bwd_ref

    def counted_fwd(*a, **kw):
        out, lse = fwd(*a, **kw)
        calls["fwd"].append((calls["bwd"] > 0, out, lse))
        return out, lse

    def poisoned_bwd(*a, **kw):
        if calls["bwd"] == 0 and policy != "none":
            for recompute, out, lse in calls["fwd"]:
                if not recompute:  # the first pass's buffers
                    out.fill_(float("nan"))
                    lse.fill_(float("nan"))
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention_ref", counted_fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd_ref", poisoned_bwd)
    _, got = _port(policy, "flash", jp, ids, cot)
    L = HF["num_hidden_layers"]
    assert len(calls["fwd"]) == (L if policy == "none" else 2 * L)
    assert sum(r for r, _, _ in calls["fwd"]) == (0 if policy == "none" else L - 1)
    assert calls["bwd"] == L
    for key, g in got.items():
        assert torch.isfinite(g).all(), key
        torch.testing.assert_close(g, want[key], rtol=0, atol=0)
