"""K1-K3's CUDA source (`automodel_tpu_torch/csrc/flash_attention.cu`)
compiled for the CPU with g++ against `tests/cuda_emulation/
cuda_emulation.h`, which emulates threads, barriers, warp shuffles and
votes, `ldmatrix`, `mma.sync` and `cp.async`, and held to the plain
versions on the same inputs: the tensor-core bf16 K1-K3 and the CUDA-core
fp32 K1-K3, at every instantiated pair of head dims, MLA's q/k 192 with
v 128 included. This checks the kernels' indexing, fragment layouts, masks
and edges where no card is present; their speed, and the hardware's own
reading of the PTX, are checked on the card (tests/test_torch_cuda.py,
chip_smoke.py). Skips without g++."""

import ctypes
import shutil

import pytest
import torch
from cuda_emulation import rewrite

from automodel_tpu_torch.ops import flash_attention as fa
from automodel_tpu_torch.ops.cuda import _build

# as on the card (tests/test_torch_cuda.py): fp32 differs by summation order,
# bf16 by where probabilities round; a share of the largest magnitude
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
CASES = {
    # B, S, T, Hq, Hkv, D (q/k), Dv, causal, packed segments, soft cap
    "causal_gqa_ragged": (2, 200, 200, 4, 2, 64, 64, True, False, None),
    "causal_d128_segments": (1, 192, 192, 8, 2, 128, 128, True, True, None),
    "bidirectional_softcap": (1, 96, 96, 2, 1, 64, 64, False, False, 20.0),
    "causal_s_gt_t_d128": (1, 130, 70, 4, 4, 128, 128, True, False, None),
    "causal_s_lt_t_d16": (2, 70, 150, 4, 2, 16, 16, True, False, None),
    "causal_softcap_d128": (1, 150, 150, 4, 2, 128, 128, True, False, 30.0),
    # MLA's heads (Moonlight, DeepSeek-V3): q/k 192, v 128; G 1 and 2
    "mla_causal_g1": (1, 150, 150, 2, 2, 192, 128, True, False, None),
    "mla_causal_segments_g2": (1, 140, 140, 4, 2, 192, 128, True, True, None),
    "mla_softcap_s_gt_t_g2": (1, 100, 70, 2, 1, 192, 128, True, False, 25.0),
    "mla_bidirectional_g1": (2, 70, 70, 1, 1, 192, 128, False, False, None),
}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    so = rewrite.build(gxx, _build.CSRC / "flash_attention.cu",
                       tmp_path_factory.mktemp("fa_emulated"))
    lib = ctypes.CDLL(str(so))
    tail = [ctypes.c_int] * 7 + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    lib.fa_forward.argtypes = [ctypes.c_void_p] * 7 + tail
    lib.fa_backward_dq.argtypes = [ctypes.c_void_p] * 9 + tail
    lib.fa_backward_dkv.argtypes = [ctypes.c_void_p] * 10 + tail
    return lib


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1.0)).item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernels_match_plain_versions(lib, case, dtype):
    B, S, T, Hq, Hkv, D, Dv, causal, packed, cap = CASES[case]
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dtype)

    q, k, v = randn(B, S, Hq, D), randn(B, T, Hkv, D), randn(B, T, Hkv, Dv)
    dout = randn(B, S, Hq, Dv)
    seg = None
    if packed:
        cuts = torch.tensor([0, S // 3, S // 3 + 1, S - 5])
        seg = ((torch.arange(S)[:, None] >= cuts).sum(-1) - 1).to(torch.int32)
        seg = seg[None].expand(B, S).contiguous()
    qs = seg if seg is not None else torch.zeros((B, S), dtype=torch.int32)
    ks = seg if seg is not None else torch.zeros((B, T), dtype=torch.int32)
    mask = fa.flash_mask(B, S, T, causal_mode="index" if causal else None,
                         qpos=None, qwin=None, qseg=qs, kpos=None, kseg=ks,
                         has_window=False)
    scale = D ** -0.5
    segp = 0 if seg is None else seg.data_ptr()
    dims = (B, S, T, Hq, Hkv, D, Dv, scale, float(cap or 0.0), int(causal),
            {torch.float32: 0, torch.bfloat16: 1}[dtype], None)

    out, lse = torch.empty_like(dout), torch.empty((B, Hq, S))
    assert lib.fa_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), segp, segp,
                          out.data_ptr(), lse.data_ptr(), *dims) == 0
    out_ref, lse_ref = fa.flash_attention_ref(q, k, v, mask, scale=scale,
                                              soft_cap=cap)
    assert _rel_err(out, out_ref) <= TOL[dtype]
    assert (lse - lse_ref).abs().max().item() <= TOL[dtype]

    delta = (dout.float() * out_ref.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse_ref.data_ptr(), delta.data_ptr(), segp, segp)
    assert lib.fa_backward_dq(*ptrs, dq.data_ptr(), *dims) == 0
    assert lib.fa_backward_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), *dims) == 0
    want = fa.flash_attention_bwd_ref(q, k, v, dout, lse_ref, delta, mask,
                                      scale=scale, soft_cap=cap)
    for got, ref in zip((dq, dk, dv), want):
        assert _rel_err(got, ref) <= TOL[dtype]
