"""K1-K3's wrappers on the CPU: the route each input dtype takes, and the
refusals made before any device is touched. No JAX; the kernels themselves
run in tests/test_torch_cuda.py on the card."""

import pytest
import torch

from automodel_tpu_torch.ops.cuda import flash_attention as fa_cuda


def test_route_follows_dtype():
    assert fa_cuda.route(torch.bfloat16) == "mma"
    assert fa_cuda.route(torch.float32) == "fma"
    with pytest.raises(KeyError):
        fa_cuda.route(torch.float16)
    # each of K1, K2 and K3 is a different kernel on each route
    mma, fma = fa_cuda.KERNELS["mma"], fa_cuda.KERNELS["fma"]
    assert mma[0] != fma[0] and mma[1] != fma[1] and mma[2] != fma[2]


def _qkv(dtype, D=64, Dv=None):
    q = torch.zeros((1, 8, 4, D), dtype=dtype)
    k = torch.zeros((1, 8, 2, D), dtype=dtype)
    v = torch.zeros((1, 8, 2, Dv or D), dtype=dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case, match", [
    ("window", "sliding windows"),
    ("position_causal", "position-causal"),
    ("dv_ne_d", "head dims"),
    ("head_dim_48", "head dim 48"),
])
def test_unsupported_cases_are_refused(dtype, case, match):
    q, k, v = _qkv(dtype, D=48 if case == "head_dim_48" else 64,
                   Dv=32 if case == "dv_ne_d" else None)
    kw = {"window": dict(sliding_window=16),
          "position_causal": dict(position_causal=True)}.get(case, {})
    with pytest.raises(NotImplementedError, match=match):
        fa_cuda.check_supported(q, k, v, **kw)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_are_refused_not_computed(dtype):
    """The wrappers launch or raise: a CPU tensor gets no plain-version
    answer from them (the CPU path is `ops.flash_attention`'s)."""
    q, k, v = _qkv(dtype)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa_cuda.flash_fwd_cuda(q, k, v, scale=0.125)
    lse = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa_cuda.flash_dkv_cuda(q, k, v, q, lse, lse, scale=0.125)


def test_k7_route_follows_dtype():
    from automodel_tpu_torch.ops.cuda import paged_mla_attention as mla

    assert mla.route(torch.bfloat16) == "mma"
    assert mla.route(torch.float32) == "fma"
    assert not set(mla.KERNELS["mma"]) & set(mla.KERNELS["fma"])


def test_k5_route_follows_dtype():
    from automodel_tpu_torch.ops.cuda import ragged_paged_attention as rpa

    assert rpa.route(torch.bfloat16) == "mma"
    assert rpa.route(torch.float32) == "fma"
    assert not set(rpa.KERNELS["mma"]) & set(rpa.KERNELS["fma"])
    # no profiler substring of K4's kernel (`gqa_kernel<`) matches K5's
    # split-route kernels
    assert not any("gqa_kernel<" in k + "<" for k in rpa.KERNELS["mma"])
