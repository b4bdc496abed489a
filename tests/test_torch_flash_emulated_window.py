"""K1-K3's CUDA source (`automodel_tpu_torch/csrc/flash_attention.cu`)
compiled for the CPU with g++ against `tests/cuda_emulation/
cuda_emulation.h` and held to the plain versions on the same inputs, on
the tensor-core bf16 route and the CUDA-core fp32 route,
under sliding windows on positions (one-sided when causal, two-sided
when not, over packed documents whose positions restart; at 64, 128 and
192/128) and causal masking by position with kv positions and segment ids
of their own and T != S (ring-attention shaped: some q rows see no key).
The cases, their masks and the check live in
`tests/cuda_emulation/flash_cases.py`; the speed of the kernels, and the
hardware's own reading of the PTX, are checked on the card
(tests/test_torch_cuda.py, chip_smoke.py). Skips without g++."""

import pytest
import torch
from cuda_emulation import flash_cases


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return flash_cases.build_lib(tmp_path_factory)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(flash_cases.GROUPS["window"]))
def test_emulated_kernels_match_plain_versions(lib, case, dtype):
    flash_cases.check_case(lib, case, dtype)
