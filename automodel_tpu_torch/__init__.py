"""PyTorch/CUDA port of `automodel_tpu`, for one NVIDIA H100.

The JAX package beside this one is the reference: every module here mirrors
the file of the same path there, keeps its parameter layout (stacked `(L, ...)`
layer weights, `(in, out)` kernels used as `x @ W`, the same dict keys) and is
held to it by the `tests/test_torch_*.py` parity tests. This package imports
`torch` and numpy, never `jax` and nothing of `automodel_tpu`.

Every TPU kernel on a ported path is a hand-written Hopper kernel
(`csrc/`, built on first use by `ops/cuda/_build.py`). Entry points take
`device=None`, meaning CUDA; without a CUDA device they raise unless the
caller passes `device="cpu"`.

Ported so far: dense-Llama paged-KV serving (`serving.ServingEngine`) and
single-device dense-Llama training (`recipes.llm.train_ft`, also as
`python -m automodel_tpu_torch <cfg.yaml> [--key.path=value ...]`).
"""
