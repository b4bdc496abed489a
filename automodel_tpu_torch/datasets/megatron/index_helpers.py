"""ctypes bindings for the native index-map builders (`index_helpers.cpp`,
the port's copy of the JAX package's source; the same C ABI).

g++ builds the library on first use into `build/` beside this file (git
ignores it), named by a hash of the source text and the flags, through a
temporary file and an atomic rename, so test workers and dataloader
workers that race never load half a library.

Deviation from `automodel_tpu/datasets/megatron/index_helpers.py`: there is
no numpy fallback. The JAX module falls back to numpy when the build
fails, and its `rng.permutation` is not the native splitmix64
Fisher-Yates, so the document and sample order would change without a
word. Here a failed build raises, with g++'s output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("index_helpers.cpp")
BUILD_DIR = SOURCE.parent / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None


def library_path() -> Path:
    """Where the source builds to: keyed by its text and the flags."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    # the "lib" prefix keeps the library out of Python's import candidates
    return BUILD_DIR / f"libindex_helpers-{digest}.so"


def _load() -> ctypes.CDLL:
    """The library, built first if needed. Raises if g++ is missing or
    fails."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.am_build_sample_index.restype = ctypes.c_int64
    lib.am_build_shuffle_index.restype = ctypes.c_int64
    lib.am_build_blending_indices.restype = ctypes.c_int64
    _lib = lib
    return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def build_sample_index(doc_lens: np.ndarray, seq_len: int, num_samples: int) -> np.ndarray:
    """(n + 1, 2) rows of (document, token offset) where each sample of
    seq_len + 1 tokens starts, n <= num_samples (fewer when the documents
    run out); the documents in `doc_lens` order."""
    doc_lens = np.ascontiguousarray(doc_lens, np.int32)
    out = np.zeros(((num_samples + 1) * 2,), np.int64)
    n = _load().am_build_sample_index(
        _ptr(doc_lens, ctypes.c_int32), ctypes.c_int64(len(doc_lens)),
        ctypes.c_int64(seq_len), ctypes.c_int64(num_samples), _ptr(out, ctypes.c_int64))
    if n < 0:
        raise ValueError("am_build_sample_index failed")
    return out.reshape(num_samples + 1, 2)[: n + 1]


def build_shuffle_index(n: int, seed: int) -> np.ndarray:
    """A permutation of [0, n): Fisher-Yates over a splitmix64 stream."""
    out = np.zeros((n,), np.int64)
    r = _load().am_build_shuffle_index(
        ctypes.c_int64(n), ctypes.c_uint64(seed), _ptr(out, ctypes.c_int64))
    if r < 0:
        raise ValueError("am_build_shuffle_index failed")
    return out


def build_blending_indices(weights: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(dataset of each of n samples, its index in that dataset): each
    sample goes to the dataset with the largest deficit against
    `weights`."""
    weights = np.ascontiguousarray(weights, np.float64)
    ds_index = np.zeros((n,), np.int32)
    ds_sample = np.zeros((n,), np.int64)
    r = _load().am_build_blending_indices(
        _ptr(weights, ctypes.c_double), ctypes.c_int64(len(weights)), ctypes.c_int64(n),
        _ptr(ds_index, ctypes.c_int32), _ptr(ds_sample, ctypes.c_int64))
    if r < 0:
        raise ValueError("am_build_blending_indices failed")
    return ds_index, ds_sample
