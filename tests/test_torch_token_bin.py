"""The port's token-bin pretraining dataset (`automodel_tpu_torch/datasets/
megatron/`) against the JAX package's on the CPU, on corpora the test
writes from a seed:

- the three native index maps (`build_sample_index`, `build_shuffle_index`,
  `build_blending_indices`) equal the JAX package's *native* ones bit for
  bit: the JAX module's `_load()` must return its library, or the
  comparison would be against its numpy fallback (another shuffle);
- `TokenBinDataset` rows equal JAX's for every index, in epochs 0-2 (by
  `set_epoch`), on a corpus with a document longer than `seq_len`, one
  whose stream `seq_len` does not divide, and an int32 stream with no
  `.doclens.npy` (one document);
- a failed g++ build raises (no fallback), and the library lands in the
  port's own build directory, not in the JAX tree.
"""

import numpy as np
import pytest

from automodel_tpu.datasets.megatron import gpt_dataset as j_gpt
from automodel_tpu.datasets.megatron import index_helpers as j_ih
from automodel_tpu_torch.datasets.megatron import gpt_dataset, index_helpers


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    lib = j_ih._load()
    assert lib is not None, "the JAX package's native index helpers did not load"
    return lib


def write_corpus(prefix, doc_lens, dtype, vocab, seed, doclens=True):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, int(np.sum(doc_lens))).astype(dtype)
    tokens.tofile(str(prefix) + ".bin")
    if doclens:
        np.save(str(prefix) + ".doclens.npy", np.asarray(doc_lens, np.int32))
    return tokens


# name -> (document lengths, seq_len, dtype, with .doclens.npy)
CORPORA = {
    # documents of 1-200 tokens and one of 700, longer than seq_len 64
    "long_document": ([*np.random.default_rng(1).integers(1, 200, 40), 700], 64,
                      "uint16", True),
    # 1001 tokens: seq_len 37 leaves a remainder, short documents
    "ragged_tail": (list(np.random.default_rng(2).integers(1, 30, 60)), 37, "uint16", True),
    # one int32 document (vocab past uint16), no doclens file
    "int32_single": ([2050], 128, "int32", False),
}


@pytest.mark.parametrize("n, seed", [(0, 0), (1, 5), (17, 0), (1000, 123456789),
                                     (4097, 2**63 + 11)])
def test_shuffle_index_is_native_jax_bit_for_bit(n, seed):
    got = index_helpers.build_shuffle_index(n, seed)
    np.testing.assert_array_equal(got, j_ih.build_shuffle_index(n, seed))
    assert got.dtype == np.int64 and sorted(got) == list(range(n))
    if n > 16:  # not the numpy permutation the JAX fallback would give
        assert not np.array_equal(got, np.random.default_rng(seed).permutation(n))


@pytest.mark.parametrize("case", sorted(CORPORA))
def test_sample_index_is_native_jax_bit_for_bit(case):
    lens, seq_len, _, _ = CORPORA[case]
    lens = np.asarray(lens, np.int32)
    for num in (0, 3, (int(lens.sum()) - 1) // seq_len, 10**4):  # past the end too
        got = index_helpers.build_sample_index(lens, seq_len, num)
        np.testing.assert_array_equal(got, j_ih.build_sample_index(lens, seq_len, num))
    # every sample holds seq_len + 1 tokens of the stream
    starts = np.concatenate([[0], np.cumsum(lens)])
    abs_start = starts[got[:, 0]] + got[:, 1]
    np.testing.assert_array_equal(np.diff(abs_start), seq_len + 1)
    assert abs_start[-1] <= lens.sum()


def test_blending_indices_are_native_jax_bit_for_bit():
    for weights, n in (([0.5, 0.5], 9), ([0.2, 0.3, 0.5], 1000),
                       ([1 / 3, 1 / 3, 1 / 3], 301), ([0.9, 0.05, 0.03, 0.02], 777)):
        w = np.asarray(weights)
        got = index_helpers.build_blending_indices(w, n)
        want = j_ih.build_blending_indices(w, n)
        for g, x in zip(got, want):
            assert g.dtype == x.dtype
            np.testing.assert_array_equal(g, x)
        counts = np.bincount(got[0], minlength=len(w))
        assert np.abs(counts - w * n).max() <= 1.0


@pytest.mark.parametrize("case", sorted(CORPORA))
def test_token_bin_rows_equal_jax_every_epoch(case, tmp_path):
    lens, seq_len, dtype, doclens = CORPORA[case]
    prefix = tmp_path / case
    tokens = write_corpus(prefix, lens, dtype, 50000 if dtype == "uint16" else 150000,
                          seed=3, doclens=doclens)
    kw = dict(prefix=str(prefix), seq_len=seq_len, seed=11, dtype=dtype)
    ds = gpt_dataset.TokenBinDatasetConfig(**kw).build()
    jds = j_gpt.TokenBinDatasetConfig(**kw).build()
    spans = 0
    for epoch in (0, 1, 2):
        ds.set_epoch(epoch)
        jds.set_epoch(epoch)
        for name in ("doc_order", "sample_idx", "sample_order", "doc_starts"):
            np.testing.assert_array_equal(getattr(ds, name), getattr(jds, name), name)
        assert len(ds) == len(jds) == len(tokens) // (seq_len + 1)
        for i in range(len(ds)):
            got, want = ds[i], jds[i]
            for key in ("input_ids", "labels"):
                assert got[key].dtype == np.int32 and got[key].shape == (seq_len,)
                np.testing.assert_array_equal(got[key], want[key], f"{key} {epoch} {i}")
            np.testing.assert_array_equal(got["input_ids"][1:], got["labels"][:-1])
            row = int(ds.sample_order[i])
            spans += int(ds.sample_idx[row + 1, 0] > ds.sample_idx[row, 0])
    if len(lens) > 1:  # samples cross document boundaries
        assert spans > 0
    # the epochs' orders differ
    ds.set_epoch(0)
    first = ds.sample_order.copy()
    ds.set_epoch(1)
    assert len(first) < 3 or not np.array_equal(first, ds.sample_order)


def test_doclens_must_sum_to_the_stream(tmp_path):
    write_corpus(tmp_path / "bad", [10, 20], "uint16", 100, seed=0)
    np.save(str(tmp_path / "bad") + ".doclens.npy", np.asarray([10, 21], np.int32))
    with pytest.raises(ValueError, match="sum to 31"):
        gpt_dataset.TokenBinDatasetConfig(prefix=str(tmp_path / "bad"), seq_len=4).build()


def test_failed_build_raises_and_builds_in_the_port(tmp_path, monkeypatch):
    """A source g++ refuses raises with g++'s message; nothing falls back.
    The real library is in the port's build directory."""
    path = index_helpers.library_path()
    index_helpers.build_shuffle_index(3, 0)
    assert path.exists() and "automodel_tpu_torch" in str(path)
    broken = tmp_path / "index_helpers.cpp"
    broken.write_text("extern \"C\" int64_t am_build_sample_index( {")
    monkeypatch.setattr(index_helpers, "SOURCE", broken)
    monkeypatch.setattr(index_helpers, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(index_helpers, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        index_helpers.build_shuffle_index(3, 0)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        index_helpers.build_sample_index(np.asarray([5], np.int32), 2, 1)
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ at all
    with pytest.raises(FileNotFoundError):
        index_helpers.build_blending_indices(np.asarray([1.0]), 2)


def test_yaml_target_resolves_to_the_port(tmp_path):
    from automodel_tpu_torch.config import ConfigNode

    write_corpus(tmp_path / "c", [30, 40], "uint16", 100, seed=0)
    node = ConfigNode({"_target_": "automodel_tpu.datasets.megatron.gpt_dataset."
                                   "TokenBinDatasetConfig",
                       "prefix": str(tmp_path / "c"), "seq_len": 8})
    cfg = node.instantiate()
    assert isinstance(cfg, gpt_dataset.TokenBinDatasetConfig)
    assert len(cfg.build()) == 70 // 9
