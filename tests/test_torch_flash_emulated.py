"""K1-K3's CUDA source (`automodel_tpu_torch/csrc/flash_attention.cu`)
compiled for the CPU with g++ against `tests/cuda_emulation/
cuda_emulation.h`, which emulates threads, barriers, warp shuffles, votes
and ballots, `ldmatrix`, `mma.sync` and `cp.async`, and held to the plain
versions on the same inputs: the tensor-core bf16 K1-K3 and the CUDA-core
fp32 K1-K3, at every instantiated pair of head dims, MLA's q/k 192 with
v 128 and Gemma's 256 included, under every mask: causal by index, causal
by position with kv positions and segment ids of their own and T != S
(some q rows see no key), one- and two-sided windows on positions, packed
segments with positions restarting per document. This checks the kernels'
indexing, fragment layouts, masks, tile skipping and edges where no card is
present; their speed, and the hardware's own reading of the PTX, are
checked on the card (tests/test_torch_cuda.py, chip_smoke.py). Skips
without g++."""

import ctypes
import shutil

import pytest
import torch
from cuda_emulation import rewrite

from automodel_tpu_torch.ops import flash_attention as fa
from automodel_tpu_torch.ops.cuda import _build
from automodel_tpu_torch.ops.cuda import flash_attention as fa_cuda

# as on the card (tests/test_torch_cuda.py): fp32 differs by summation order,
# bf16 by where probabilities round; a share of the largest magnitude
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
CASES = {
    # B, S, T, Hq, Hkv, D (q/k), Dv, causal, packed segments, soft cap (q is
    # scaled so that the cap bends the logits: `capped_q`),
    # masks: window (on positions), "ring" (kv positions and segment ids of
    # their own: causal by position)
    "causal_gqa_ragged": (2, 200, 200, 4, 2, 64, 64, True, False, None, {}),
    "causal_d128_segments": (1, 192, 192, 8, 2, 128, 128, True, True, None, {}),
    "bidirectional_softcap": (1, 96, 96, 2, 1, 64, 64, False, False, 20.0, {}),
    "causal_s_gt_t_d128": (1, 130, 70, 4, 4, 128, 128, True, False, None, {}),
    "causal_s_lt_t_d16": (2, 70, 150, 4, 2, 16, 16, True, False, None, {}),
    "causal_softcap_d128": (1, 150, 150, 4, 2, 128, 128, True, False, 30.0, {}),
    # MLA's heads (Moonlight, DeepSeek-V3): q/k 192, v 128; G 1 and 2
    "mla_causal_g1": (1, 150, 150, 2, 2, 192, 128, True, False, None, {}),
    "mla_causal_segments_g2": (1, 140, 140, 4, 2, 192, 128, True, True, None, {}),
    "mla_softcap_s_gt_t_g2": (1, 100, 70, 2, 1, 192, 128, True, False, 25.0, {}),
    "mla_bidirectional_g1": (2, 70, 70, 1, 1, 192, 128, False, False, None, {}),
    # sliding windows: one-sided (causal), two-sided (bidirectional), over
    # packed documents whose positions restart, at 64, 128, 192/128 and 256
    "window_causal_gqa": (1, 230, 230, 4, 2, 64, 64, True, False, None,
                          {"window": 50}),
    "window_two_sided_softcap": (1, 150, 150, 2, 1, 64, 64, False, False, 10.0,
                                 {"window": 40}),
    "window_packed_d128": (1, 192, 192, 4, 2, 128, 128, True, True, None,
                           {"window": 48}),
    "window_mla": (1, 140, 140, 2, 1, 192, 128, True, False, None, {"window": 33}),
    # causal by position, T != S, kv segment ids of its own (ring-attention
    # shaped: the first q rows see no key)
    "ring_position_causal": (2, 96, 160, 4, 2, 64, 64, True, False, None,
                             {"ring": True}),
    "ring_position_causal_window_d128": (1, 100, 130, 2, 2, 128, 128, True,
                                         False, None, {"ring": True, "window": 30}),
    # Gemma's head dim 256: window and soft cap (Gemma-2), GQA 4 (Gemma-3's
    # MQA at 4 heads), causal by position
    "d256_window_softcap": (1, 130, 130, 4, 2, 256, 256, True, False, 50.0,
                            {"window": 40}),
    "d256_gqa4": (1, 100, 100, 4, 1, 256, 256, True, False, None, {}),
    "d256_ring": (1, 70, 100, 2, 1, 256, 256, True, False, None, {"ring": True}),
}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    so = rewrite.build(gxx, _build.CSRC / "flash_attention.cu",
                       tmp_path_factory.mktemp("fa_emulated"))
    lib = ctypes.CDLL(str(so))
    tail = [ctypes.c_int] * 7 + [ctypes.c_float] * 2 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.fa_forward.argtypes = [ctypes.c_void_p] * 11 + tail
    lib.fa_backward_dq.argtypes = [ctypes.c_void_p] * 13 + tail
    lib.fa_backward_dkv.argtypes = [ctypes.c_void_p] * 14 + tail
    return lib


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1.0)).item()


def case_masks(B, S, T, causal, packed, masks):
    """The case's mask keywords and the plain versions' (B, S, T) mask: four
    packed documents whose positions restart; a ring case puts the q rows
    at positions 40.., the kv rows at 70.. with the first 9 in a document
    of their own, so the q rows below 70 see no key."""
    seg = None
    if packed:
        cuts = torch.tensor([0, S // 3, S // 3 + 1, S - 5])
        doc = (torch.arange(S)[:, None] >= cuts).sum(-1) - 1
        seg = doc.to(torch.int32)[None].expand(B, S).contiguous()
    return fa.mask_case(B, S, T, device="cpu", causal=causal, segment_ids=seg,
                        sliding_window=masks.get("window"),
                        ring=(40, 70, 9) if masks.get("ring") else None)


def capped_q(q, cap):
    """q scaled by cap / 4: the unit-variance logits at scale D^-0.5 then
    spread over a quarter of the cap, so the largest reach it and the cap
    bends them (1 - tanh^2 falls to ~0.26), far past the tolerance."""
    return q if cap is None else (q.float() * (cap / 4)).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_kernels_match_plain_versions(lib, case, dtype):
    B, S, T, Hq, Hkv, D, Dv, causal, packed, cap, masks = CASES[case]
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dtype)

    q, k, v = randn(B, S, Hq, D), randn(B, T, Hkv, D), randn(B, T, Hkv, Dv)
    q = capped_q(q, cap)
    dout = randn(B, S, Hq, Dv)
    kw, mask = case_masks(B, S, T, causal, packed, masks)
    code, window, ints = fa_cuda.mask_args(q, k, **kw)
    if masks.get("window"):  # the window masks pairs the causal mask keeps
        causal_only = case_masks(B, S, T, causal, packed, {**masks, "window": None})[1]
        assert mask.sum() < causal_only.sum()
    if masks.get("ring"):
        assert not mask.any(-1).all()  # some q rows see no key
    scale = D ** -0.5
    iptrs = [0 if x is None else x.data_ptr() for x in ints]
    dims = (B, S, T, Hq, Hkv, D, Dv, scale, float(cap or 0.0), code, window,
            {torch.float32: 0, torch.bfloat16: 1}[dtype], None)

    out, lse = torch.empty_like(dout), torch.empty((B, Hq, S))
    assert lib.fa_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), *iptrs,
                          out.data_ptr(), lse.data_ptr(), *dims) == 0
    out_ref, lse_ref = fa.flash_attention_ref(q, k, v, mask, scale=scale,
                                              soft_cap=cap)
    assert _rel_err(out, out_ref) <= TOL[dtype]
    assert (lse - lse_ref).abs().max().item() <= TOL[dtype]

    delta = (dout.float() * out_ref.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse_ref.data_ptr(), delta.data_ptr(), *iptrs)
    assert lib.fa_backward_dq(*ptrs, dq.data_ptr(), *dims) == 0
    assert lib.fa_backward_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), *dims) == 0
    want = fa.flash_attention_bwd_ref(q, k, v, dout, lse_ref, delta, mask,
                                      scale=scale, soft_cap=cap)
    for got, ref in zip((dq, dk, dv), want):
        assert _rel_err(got, ref) <= TOL[dtype]


def test_emulated_kernels_refuse_inconsistent_masks(lib):
    """A window or causal masking by position without positions, and
    segment ids on one side only, are refused before any launch."""
    q = torch.zeros(1, 8, 2, 64)
    out, lse = torch.empty_like(q), torch.empty((1, 2, 8))
    seg = torch.zeros((1, 8), dtype=torch.int32)
    base = (1, 8, 8, 2, 2, 64, 64, 0.125, 0.0)
    for segs, code, window in (((0, 0), 1, 4), ((0, 0), 2, 0),
                               ((seg.data_ptr(), 0), 1, 0)):
        err = lib.fa_forward(q.data_ptr(), q.data_ptr(), q.data_ptr(), *segs,
                             0, 0, 0, 0, out.data_ptr(), lse.data_ptr(), *base,
                             code, window, 0, None)
        assert err != 0
