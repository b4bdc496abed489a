"""K1-K3's CUDA source (`automodel_tpu_torch/csrc/flash_attention.cu`)
compiled for the CPU with g++ against `tests/cuda_emulation/
cuda_emulation.h` and held to the plain versions on the same inputs, on
the tensor-core bf16 route and the CUDA-core fp32 route,
at head dims 16, 64 and 128 (q/k and v alike): causal by index with GQA
and T != S either way, packed segments, bidirectional, and soft caps (q is
scaled so that the cap bends the logits); and at head dims 8 and 32, which
the kernels run zero-padded to 16 and 64.
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
@pytest.mark.parametrize("case", sorted(flash_cases.GROUPS["base"]))
def test_emulated_kernels_match_plain_versions(lib, case, dtype):
    flash_cases.check_case(lib, case, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(flash_cases.GROUPS["padded"]))
def test_emulated_kernels_take_padded_head_dims(lib, case, dtype):
    flash_cases.check_case(lib, case, dtype)


def test_emulated_kernels_refuse_inconsistent_masks(lib):
    """A window or causal masking by position without positions, and
    segment ids on one side only, are refused before any launch."""
    flash_cases.check_refusals(lib)
