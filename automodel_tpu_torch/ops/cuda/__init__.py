"""Hand-written Hopper kernels: ctypes wrappers over `csrc/*.cu`.

Each wrapper checks its inputs, allocates its output with `torch.empty`,
launches on PyTorch's current stream and counts its launches in a plain
integer (K4: `ragged_paged_attention_cuda.launches`; K1-K3: the module
integers `flash_attention.launches_fwd`, `launches_dq`, `launches_dkv`).
Kernels are built on first use.
"""
