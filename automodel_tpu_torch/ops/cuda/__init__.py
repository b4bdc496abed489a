"""Hand-written Hopper kernels: ctypes wrappers over `csrc/*.cu`.

Each wrapper checks its inputs, allocates its output with `torch.empty`,
launches on PyTorch's current stream. Each library's C dispatch counts the
launches of each device kernel it issues without error: each module's
`launch_counts()` reads them, keyed as its `KERNELS` names the device
kernels, `kernel_launches()` sums them by kernel (K1-K7) and
`reset_launch_counts()` sets them to 0. Kernels are built on
first use.
"""
