"""K1-K3's CUDA source (`automodel_tpu_torch/csrc/flash_attention.cu`)
compiled for the CPU with g++ against `tests/cuda_emulation/
cuda_emulation.h` and held to the plain versions on the same inputs, on
the tensor-core bf16 route and the CUDA-core fp32 route,
at Gemma's head dim 256 (the split K3 with two warp groups): a window
with a soft cap (Gemma-2), GQA 4 (Gemma-3's MQA at 4 heads), and causal
masking by position.
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
@pytest.mark.parametrize("case", sorted(flash_cases.GROUPS["d256"]))
def test_emulated_kernels_match_plain_versions(lib, case, dtype):
    flash_cases.check_case(lib, case, dtype)
