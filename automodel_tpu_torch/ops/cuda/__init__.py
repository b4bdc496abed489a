"""Hand-written Hopper kernels: ctypes wrappers over `csrc/*.cu`.

Each wrapper checks its inputs, allocates its output with `torch.empty`,
launches on PyTorch's current stream and counts its launches in a plain
integer attribute (`wrapper.launches`). Kernels are built on first use.
"""
