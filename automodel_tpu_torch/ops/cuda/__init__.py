"""Hand-written Hopper kernels: ctypes wrappers over `csrc/*.cu`.

Each wrapper checks its inputs, allocates its output with `torch.empty`,
launches on PyTorch's current stream and counts its launches in a plain
integer (K4 and K5: `ragged_paged_attention_cuda.launches` and
`ragged_paged_attention_quant_cuda.launches`; K6 and K7:
`paged_mla_attention_cuda.launches` and
`paged_mla_attention_quant_cuda.launches`; K1-K3: the module integers
`flash_attention.launches_fwd`, `launches_dq`, `launches_dkv`). Kernels are
built on first use.
"""
