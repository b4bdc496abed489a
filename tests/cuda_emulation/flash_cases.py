"""K1-K3's emulated cases, shared by `tests/test_torch_flash_emulated_*.py`:
`flash_attention.cu` compiled for the CPU with g++ against
`cuda_emulation.h` (`build_lib`), the cases by group (`CASES`, `GROUPS`),
their masks (`case_masks`), capped queries (`capped_q`) and the check of
one case on both routes against the plain versions (`check_case`), which
runs the kernels through `ops.flash_attention.kernels_forward` and
`kernels_backward` (the head-dim padding of the CUDA route) with the
wrappers' launches replaced by the emulated library's (`emulated_wrappers`)."""

import ctypes
import shutil
from unittest import mock

import pytest
import torch

from automodel_tpu_torch.ops import flash_attention as fa
from automodel_tpu_torch.ops.cuda import _build
from automodel_tpu_torch.ops.cuda import flash_attention as fa_cuda
from cuda_emulation import rewrite

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
    # head dims the kernels run zero-padded: 8 -> 16 (the MoE families'
    # smoke YAMLs) over packed segments, 32 -> 64 under a window
    "pad_d8_segments": (2, 70, 70, 4, 2, 8, 8, True, True, None, {}),
    "pad_d32_window": (1, 100, 100, 4, 2, 32, 32, True, False, None, {"window": 20}),
}
# the test file of each case: base (head dims 16-128), MLA's heads, windows
# and ring-shaped position-causal masks, and head dim 256
GROUPS = {
    "base": ("causal_gqa_ragged", "causal_d128_segments", "bidirectional_softcap",
             "causal_s_gt_t_d128", "causal_s_lt_t_d16", "causal_softcap_d128"),
    "mla": ("mla_causal_g1", "mla_causal_segments_g2", "mla_softcap_s_gt_t_g2",
            "mla_bidirectional_g1"),
    "window": ("window_causal_gqa", "window_two_sided_softcap", "window_packed_d128",
               "window_mla", "ring_position_causal", "ring_position_causal_window_d128"),
    "d256": ("d256_window_softcap", "d256_gqa4", "d256_ring"),
    "padded": ("pad_d8_segments", "pad_d32_window"),
}
assert sorted(c for g in GROUPS.values() for c in g) == sorted(CASES)


def build_lib(tmp_path_factory):
    """flash_attention.cu built for the CPU, its entry points typed; skips
    without g++."""
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


def emulated_wrappers(lib) -> dict:
    """`ops.cuda.flash_attention`'s `flash_fwd_cuda`, `flash_dq_cuda` and
    `flash_dkv_cuda` over the emulated library, on CPU tensors: the same
    head-dim check and launch arguments, keywords `scale`, `soft_cap` and
    `masks`."""
    def dims(q, k, v, scale, soft_cap, masks):
        fa_cuda.check_supported(q, k, v)
        B, S, Hq, D = q.shape
        return (B, S, k.shape[1], Hq, k.shape[2], D, v.shape[3], scale,
                float(soft_cap or 0.0), masks.code, masks.window,
                {torch.float32: 0, torch.bfloat16: 1}[q.dtype], None)

    def ptrs(masks):
        return [0 if x is None else x.data_ptr() for x in masks.ints]

    def fwd(q, k, v, *, scale, soft_cap=None, masks):
        d = dims(q, k, v, scale, soft_cap, masks)
        B, S, Hq, _ = q.shape
        out = torch.empty((B, S, Hq, v.shape[3]), dtype=q.dtype)
        lse = torch.empty((B, Hq, S))
        assert lib.fa_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), *ptrs(masks),
                              out.data_ptr(), lse.data_ptr(), *d) == 0
        return out, lse

    def bwd_ptrs(q, k, v, dout, lse, delta, masks):
        return (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), *ptrs(masks))

    def dq(q, k, v, dout, lse, delta, *, scale, soft_cap=None, masks):
        d = dims(q, k, v, scale, soft_cap, masks)
        out = torch.empty_like(q)
        assert lib.fa_backward_dq(*bwd_ptrs(q, k, v, dout, lse, delta, masks),
                                  out.data_ptr(), *d) == 0
        return out

    def dkv(q, k, v, dout, lse, delta, *, scale, soft_cap=None, masks):
        d = dims(q, k, v, scale, soft_cap, masks)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        assert lib.fa_backward_dkv(*bwd_ptrs(q, k, v, dout, lse, delta, masks),
                                   dk.data_ptr(), dv.data_ptr(), *d) == 0
        return dk, dv

    return dict(flash_fwd_cuda=fwd, flash_dq_cuda=dq, flash_dkv_cuda=dkv)


def check_case(lib, case, dtype):
    """K1-K3 of `case` in `dtype` against the plain versions: out and lse,
    then dq, dk and dv. A head the kernels are not instantiated for runs
    zero-padded, as on the card."""
    B, S, T, Hq, Hkv, D, Dv, causal, packed, cap, masks = CASES[case]
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dtype)

    q, k, v = randn(B, S, Hq, D), randn(B, T, Hkv, D), randn(B, T, Hkv, Dv)
    q = capped_q(q, cap)
    dout = randn(B, S, Hq, Dv)
    kw, mask = case_masks(B, S, T, causal, packed, masks)
    if masks.get("window"):  # the window masks pairs the causal mask keeps
        causal_only = case_masks(B, S, T, causal, packed, {**masks, "window": None})[1]
        assert mask.sum() < causal_only.sum()
    if masks.get("ring"):
        assert not mask.any(-1).all()  # some q rows see no key
    scale = D ** -0.5
    masks_args = fa_cuda.mask_args(q, k, **kw)
    before = fa_cuda.launch_counts(by_head_dims=True, lib=lib)
    with mock.patch.multiple(fa_cuda, **emulated_wrappers(lib)):
        out, lse = fa.kernels_forward(q, k, v, scale=scale, soft_cap=cap,
                                      masks=masks_args)
        out_ref, lse_ref = fa.flash_attention_ref(q, k, v, mask, scale=scale,
                                                  soft_cap=cap)
        assert out.shape == out_ref.shape
        assert _rel_err(out, out_ref) <= TOL[dtype]
        assert (lse - lse_ref).abs().max().item() <= TOL[dtype]

        delta = (dout.float() * out_ref.float()).sum(-1).transpose(1, 2).contiguous()
        got = fa.kernels_backward(q, k, v, dout, lse_ref, delta, scale=scale,
                                  soft_cap=cap, masks=masks_args)
    want = fa.flash_attention_bwd_ref(q, k, v, dout, lse_ref, delta, mask,
                                      scale=scale, soft_cap=cap)
    for g, ref in zip(got, want):
        assert g.shape == ref.shape
        assert _rel_err(g, ref) <= TOL[dtype]
    # the C dispatch counted one launch of each of the route's K1-K3, at the
    # head dims they ran at
    after = fa_cuda.launch_counts(by_head_dims=True, lib=lib)
    dims = fa_cuda.padded_head_dims(D, Dv)
    assert {key: n - before[key] for key, n in after.items() if n != before[key]} == {
        (name, dims): 1 for name in fa_cuda.KERNELS[fa_cuda.route(dtype)]}


def check_refusals(lib):
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
