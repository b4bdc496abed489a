// Fast index-map builders for token-stream pretraining datasets.
//
// The port's own copy of automodel_tpu/datasets/megatron/index_helpers.cpp
// (the same C ABI and the same arithmetic, so both packages build the same
// maps). Native-code analog of the reference's C++ dataset helpers
// (reference: nemo_automodel/components/datasets/llm/megatron/helpers.cpp —
// build_sample_idx / build_shuffle_idx / build_blending_indices, exposed
// there via pybind11). This is an independent implementation exposed via a
// plain C ABI consumed through ctypes, built with g++ on first use by
// index_helpers.py. All functions are deterministic given their
// seeds and O(n) / O(n log n) — the reason to keep them native is that the
// sample maps for trillion-token corpora have billions of entries and the
// Python equivalents take minutes-to-hours.
//
// API contract: caller allocates output buffers (numpy arrays) and passes
// raw pointers; functions return 0 on success, negative on error.

#include <cstdint>
#include <cstring>

extern "C" {

// Build the (num_samples+1, 2) sample index for GPT-style contiguous token
// sampling: each row is (document_index, token_offset_in_document) marking
// where sample i begins; samples are seq_len+1 tokens crossing document
// boundaries. doc_lens holds per-document token counts in epoch order
// (already shuffled document order).
//   doc_lens:    int32[num_docs]
//   sample_idx:  int64[(num_samples+1) * 2]   (output)
// Returns number of samples written (excluding the terminal row), or -1.
int64_t am_build_sample_index(
    const int32_t* doc_lens,
    int64_t num_docs,
    int64_t seq_len,
    int64_t num_samples,
    int64_t* sample_idx) {
  if (!doc_lens || !sample_idx || seq_len <= 0) return -1;
  int64_t doc = 0;        // current document
  int64_t offset = 0;     // token offset within current document
  int64_t written = 0;
  sample_idx[0] = 0;
  sample_idx[1] = 0;
  for (int64_t s = 1; s <= num_samples; ++s) {
    int64_t remaining = seq_len + 1;  // +1: targets are inputs shifted by one
    while (remaining > 0) {
      if (doc >= num_docs) return written;  // corpus exhausted
      int64_t avail = (int64_t)doc_lens[doc] - offset;
      if (avail > remaining) {
        offset += remaining;
        remaining = 0;
      } else {
        remaining -= avail;
        ++doc;
        offset = 0;
      }
    }
    sample_idx[2 * s] = doc;
    sample_idx[2 * s + 1] = offset;
    written = s;
  }
  return written;
}

// Deterministic Fisher–Yates shuffle of [0, n) using splitmix64 streams —
// the shuffle-index builder (epoch-level sample order).
//   out: int64[n] (output)
static inline uint64_t splitmix64(uint64_t* state) {
  uint64_t z = (*state += 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

int64_t am_build_shuffle_index(int64_t n, uint64_t seed, int64_t* out) {
  if (!out || n < 0) return -1;
  for (int64_t i = 0; i < n; ++i) out[i] = i;
  uint64_t state = seed ^ 0xA5A5A5A5DEADBEEFULL;
  for (int64_t i = n - 1; i > 0; --i) {
    uint64_t j = splitmix64(&state) % (uint64_t)(i + 1);
    int64_t tmp = out[i];
    out[i] = out[(int64_t)j];
    out[(int64_t)j] = tmp;
  }
  return n;
}

// Weighted blending: assign each of n samples to one of k datasets so the
// running mix tracks `weights` (sum to ~1). Greedy largest-deficit
// assignment — identical semantics to the reference's blending builder.
//   weights:        double[k]
//   dataset_index:  int32[n]  (output) — which dataset serves sample i
//   dataset_sample: int64[n]  (output) — index within that dataset
int64_t am_build_blending_indices(
    const double* weights,
    int64_t k,
    int64_t n,
    int32_t* dataset_index,
    int64_t* dataset_sample) {
  if (!weights || !dataset_index || !dataset_sample || k <= 0) return -1;
  // running counts per dataset
  int64_t counts[1024];
  if (k > 1024) return -2;
  std::memset(counts, 0, sizeof(int64_t) * (size_t)k);
  for (int64_t i = 0; i < n; ++i) {
    // pick dataset with the largest deficit: weight*(i+1) - count
    double best = -1e300;
    int64_t best_d = 0;
    for (int64_t d = 0; d < k; ++d) {
      double deficit = weights[d] * (double)(i + 1) - (double)counts[d];
      if (deficit > best) {
        best = deficit;
        best_d = d;
      }
    }
    dataset_index[i] = (int32_t)best_d;
    dataset_sample[i] = counts[best_d];
    ++counts[best_d];
  }
  return n;
}

}  // extern "C"
