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
    ("dv_ne_d", "head dims"),
    ("head_dim_48", "head dim 48"),
    ("head_dim_96", "head dim 96"),
    # MLA's pair is taken, but no other pair with Dv != D
    ("dv_192_192", "head dim 192"),
    ("dv_96_64", "head dims q/k 96, v 64"),
    # with a window or causal masking by position, an uninstantiated pair
    # is refused all the same, before the device is looked at
    ("window_head_dim_96", "head dim 96"),
    ("position_causal_dv_96_64", "head dims q/k 96, v 64"),
])
def test_unsupported_cases_are_refused(dtype, case, match):
    D, Dv = {"head_dim_48": (48, None), "dv_ne_d": (64, 32),
             "head_dim_96": (96, None), "window_head_dim_96": (96, None),
             "dv_192_192": (192, 192), "dv_96_64": (96, 64),
             "position_causal_dv_96_64": (96, 64)}[case]
    q, k, v = _qkv(dtype, D=D, Dv=Dv)
    with pytest.raises(NotImplementedError, match=match):
        fa_cuda.check_supported(q, k, v)
    kw = {"window_head_dim_96": dict(sliding_window=16),
          "position_causal_dv_96_64": dict(
              kv_positions=torch.arange(8, dtype=torch.int32)[None])}.get(case, {})
    with pytest.raises(NotImplementedError, match=match):
        fa_cuda.flash_fwd_cuda(q, k, v, scale=0.125, **kw)


MASKS = {
    "window": dict(sliding_window=16),
    "two_sided_window": dict(sliding_window=4, causal=False),
    "position_causal": dict(kv_positions=torch.arange(8, dtype=torch.int32)[None] + 3,
                            kv_segment_ids=torch.zeros((1, 8), dtype=torch.int32)),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dims", [(64, 64), (192, 128), (256, 256)])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_masks_are_taken(dtype, dims, mask):
    """Windows (one- and two-sided) and causal masking by position pass
    the kernels' checks at every instantiated pair, Gemma's 256 included:
    a CPU tensor then meets the device check, not a refusal."""
    q, k, v = _qkv(dtype, D=dims[0], Dv=dims[1])
    fa_cuda.check_supported(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa_cuda.flash_fwd_cuda(q, k, v, scale=0.125, **MASKS[mask])


def test_granule_ranges_are_min_and_max_per_32_rows():
    """The position ranges the kernels skip tiles by: per 32-row granule,
    the min and max of the positions, a ragged last granule included."""
    pos = torch.tensor([[5, 3, 9] + list(range(40, 80)) + [1, 2]], dtype=torch.int32)
    rng = fa_cuda.granule_ranges(pos)
    assert rng.dtype == torch.int32 and rng.shape == (1, 2, 2)
    assert rng[0, 0].tolist() == [3, 68]
    assert rng[0, 1].tolist() == [1, 79]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dims", fa_cuda.HEAD_DIMS)
def test_instantiated_head_dims_are_taken(dtype, dims):
    q, k, v = _qkv(dtype, D=dims[0], Dv=dims[1])
    fa_cuda.check_supported(q, k, v)  # no refusal, on either route


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
    """K6's and K7's route follows the query dtype, and their split and
    CUDA-core keys each pick out one device kernel (the combine is one
    kernel, shared)."""
    from automodel_tpu_torch.ops.cuda import paged_mla_attention as mla

    assert mla.route(torch.bfloat16) == "mma"
    assert mla.route(torch.float32) == "fma"
    for kernel in ("K6", "K7"):
        assert not set(mla.KERNELS[kernel]["mma"]) & set(mla.KERNELS[kernel]["fma"])
    keys = {mla.KERNELS[k][r][0] for k in ("K6", "K7") for r in ("mma", "fma")}
    assert len(keys) == 4 and not any(a != b and a in b for a in keys for b in keys)


def _check_rpa_kernels(kernel):
    """K4's or K5's route follows the query dtype, and every profiler key
    of theirs picks out one device kernel: K4 and K5 share the split and
    combine templates (they differ in the page type), so no key may be a
    substring of another."""
    from automodel_tpu_torch.ops.cuda import ragged_paged_attention as rpa

    assert rpa.route(torch.bfloat16) == "mma"
    assert rpa.route(torch.float32) == "fma"
    assert not set(rpa.KERNELS[kernel]["mma"]) & set(rpa.KERNELS[kernel]["fma"])
    keys = [n for routes in rpa.KERNELS.values() for r in routes.values()
            for n in r]
    assert not any(a != b and a in b for a in keys for b in keys)


def test_k5_route_follows_dtype():
    _check_rpa_kernels("K5")


def test_k4_route_follows_dtype():
    _check_rpa_kernels("K4")


@pytest.mark.parametrize("dims, padded", [
    ((8, 8), (16, 16)), ((32, 32), (64, 64)), ((96, 96), (128, 128)),
    ((64, 96), (128, 128)), ((192, 128), (192, 128)), ((200, 100), (256, 256)),
])
def test_head_dims_pad_to_the_smallest_pair_that_holds_them(dims, padded):
    assert fa_cuda.padded_head_dims(*dims) == padded
    if dims in fa_cuda.HEAD_DIMS:
        q, k, v = _qkv(torch.float32, D=dims[0], Dv=dims[1])
        assert fa_cuda.pad_head_dim(q, padded[0]) is q


@pytest.mark.parametrize("dims", [(264, 264), (64, 300), (320, 128)])
def test_head_dims_above_256_are_refused(dims):
    with pytest.raises(NotImplementedError, match="exceed every instantiated"):
        fa_cuda.padded_head_dims(*dims)


@pytest.mark.parametrize("dims", [(8, 8), (32, 32), (96, 96), (64, 96)])
def test_padded_plain_versions_equal_unpadded(dims):
    """What the CUDA route does for a head of these dims, on the plain
    versions: q and k zero-padded to the pair's q/k dim and v (and dO) to
    its v dim, at the caller's scale (from the true D), give the unpadded
    out, lse, dq, dk and dv in their first columns and zeros past them
    (windowed, soft-capped, GQA)."""
    from automodel_tpu_torch.ops import flash_attention as fa

    D, Dv = dims
    Dp, Dvp = fa_cuda.padded_head_dims(D, Dv)
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 40, 4, D, generator=gen)
    k = torch.randn(1, 40, 2, D, generator=gen)
    v = torch.randn(1, 40, 2, Dv, generator=gen)
    dout = torch.randn(1, 40, 4, Dv, generator=gen)
    _, mask = fa.mask_case(1, 40, 40, device="cpu", sliding_window=9)
    kw = dict(scale=D ** -0.5, soft_cap=5.0)
    out, lse = fa.flash_attention_ref(q, k, v, mask, **kw)
    delta = (dout * out).sum(-1).transpose(1, 2).contiguous()
    grads = fa.flash_attention_bwd_ref(q, k, v, dout, lse, delta, mask, **kw)
    qp, kp = fa_cuda.pad_head_dim(q, Dp), fa_cuda.pad_head_dim(k, Dp)
    vp, dop = fa_cuda.pad_head_dim(v, Dvp), fa_cuda.pad_head_dim(dout, Dvp)
    out_p, lse_p = fa.flash_attention_ref(qp, kp, vp, mask, **kw)
    grads_p = fa.flash_attention_bwd_ref(qp, kp, vp, dop, lse_p, delta, mask, **kw)
    torch.testing.assert_close(lse_p, lse, atol=1e-6, rtol=1e-6)
    for got, want, width in ((out_p, out, Dv), (grads_p[0], grads[0], D),
                             (grads_p[1], grads[1], D), (grads_p[2], grads[2], Dv)):
        torch.testing.assert_close(got[..., :width], want, atol=1e-6, rtol=1e-6)
        assert not got[..., width:].any()
