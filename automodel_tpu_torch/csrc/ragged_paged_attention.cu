// K4 and K5: ragged paged GQA attention for Hopper (sm_90a), over fp pages
// (K4) and over int8 pages with per-row scales (K5).
//
// K4 replaces automodel_tpu/ops/pallas/ragged_paged_attention.py:_gqa_kernel
// (launched by paged_attention_kernel); K5 replaces _gqa_quant_kernel in the
// same file (launched by paged_attention_quant_kernel). Both compute the same
// function as their Pallas kernel: each token row t attends over the pages
// of its page-table row up to global kv index positions[t], with an fp32
// online softmax, an optional logit soft cap, and a zero output for pad rows
// (positions[t] < 0). Beyond the Pallas kernels (which refuse both, so the
// JAX engine serves windowed and sinked models on its XLA path), both take
// a sliding window (kv j is attended iff positions[t] - j < window; 0 means
// none) and sinks (one logit per query head that joins the softmax
// denominator, not scaled, not capped, with no value row), as the plain
// version (ops/paged_attention.py ragged_paged_attention_ref) computes
// them. K5 dequantizes algebraically, as the Pallas kernel
// does: the score of kv row r is (q . k_int8[r]) * ks[r] * scale, before the
// soft cap and the mask; the V scale folds into the probabilities, so the
// value product is sum_r (p[r] * vs[r]) * v_int8[r]; the sum l takes the
// unscaled p. No dequantized copy of a page is ever written to device
// memory, and the output has q's dtype.
//
// Two designs, picked by the query dtype (route() in
// ops/cuda/ragged_paged_attention.py):
//
// gqa_split_kernel + gqa_combine_kernel (bfloat16 queries: K4 over bf16
// pages, K5 over int8 pages; tensor cores). The split-KV design of
// paged_split.cuh: the grid is (row x split, kv head x head tile); a split
// is a run of whole pages of ~128 kv positions (8 pages of 16), so the
// longest decode row spreads over several blocks and a split past its
// row's last live kv exits at once. The G = Hq / Hkv query heads of kv
// head h are the M of mma.sync m16n8k16 (zero rows pad the rest: the
// kernel is bound by bytes, so the unused rows cost nothing that matters).
// Each kv row's (D,) K and (Dv,) V slice of head h (strided by Hkv * D in
// the page) is gathered by 16-byte cp.async into a two-stage ring: bf16
// pages (K4) land as the padded bf16 tiles ldmatrix reads, with no
// conversion; int8 pages (K5) land as bytes, with the (ps,) scale rows
// beside them, and are converted to a padded bf16 tile (exact). Scores
// Q . K^T take K through ldmatrix, values V through ldmatrix.trans; fp32
// partials (m, l, the (G, Dv) accumulator) go to a workspace the combine
// merges per (row, head).
// - K4 has no deviation from the Pallas kernel: the A operand of the
//   value product is bf16(p), the Pallas kernel's own p.astype(v.dtype).
// - K5 deviates: the Pallas kernel keeps p * vs in fp32 for the value
//   product; the A operand of a bf16 mma rounds it to bf16, about 2^-9 of
//   each term (K7's deviation, too).
//
// gqa_kernel (float32 queries: K4 over fp32 pages, K5 over int8 pages;
// CUDA cores). The TPU grid (T, P) walks every page slot of every row in
// order and predicates the dead ones off, with the page table in scalar
// prefetch. Here one thread block owns one (token row, kv head) pair: it
// reads its own page_tables[t] and positions[t], loops only over pages
// 0 .. pos / ps, stages each page's (ps, D) K and (ps, Dv) V slice of its
// head in shared memory as fp32 (int8 values are exact in fp32), scores
// the G query heads of its group against them (one warp per (head, page
// row) dot product), and keeps the running max, sum and (G, Dv)
// accumulator in fp32 shared memory. Rows past pos in the last page are
// masked; the output is acc / sum, or 0 when the row had no page (pad
// rows). With a window the page loop starts at the page of the window's
// first kv lo and masks rows below lo in it; a sink rescales the output
// once after the loop.
//
// Bound. The work is bound by bytes from device memory: each needed page's
// K/V slice (with a window, each page that meets the window) is read once
// per block, and the arithmetic is 4 * G * Dv
// operations per K/V row, far below the card's operations-per-byte line.
// Both designs re-read a request's pages once per prefill row of the same
// request (a 48-row chunk reads its pages 48 times); L2 (50 MB) absorbs
// much of that. gqa_kernel walks a row's pages one after another in one
// block (a 999-token row is 63 pages): latency-bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_helpers.cuh"
#include "paged_split.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

size_t smem_bytes(int G, int D, int Dv, int ps) {
  // q (G, D) | K (ps, D) | V (ps, Dv) | scores (G, ps) | acc (G, Dv)
  // | running max, sum, rescale (G each) | K and V scales (ps each)
  return sizeof(float) *
         ((size_t)G * D + (size_t)ps * D + (size_t)ps * Dv + (size_t)G * ps +
          (size_t)G * Dv + 3 * (size_t)G + 2 * (size_t)ps);
}

// T: q and output dtype (float); TKV: page dtype (T for K4, int8_t for K5,
// which also takes k_scales / v_scales, (N+1, ps) fp32; K4 passes nullptr).
template <typename T, typename TKV>
__global__ void __launch_bounds__(kThreads)
gqa_kernel(const T* __restrict__ q,             // (T, Hq, D)
           const TKV* __restrict__ k_pages,     // (N+1, ps, Hkv, D)
           const TKV* __restrict__ v_pages,     // (N+1, ps, Hkv, Dv)
           const float* __restrict__ k_scales,  // (N+1, ps) or nullptr
           const float* __restrict__ v_scales,  // (N+1, ps) or nullptr
           const int* __restrict__ page_tables, // (T, P)
           const int* __restrict__ positions,   // (T,)
           const float* __restrict__ sinks,     // (Hq,) or nullptr
           T* __restrict__ out,                 // (T, Hq, Dv)
           int Hq, int Hkv, int D, int Dv, int ps, int P, float scale,
           float soft_cap, int window) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  const int t = blockIdx.x / Hkv;
  const int h = blockIdx.x - t * Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float* q_s = smem;            // (G, D)
  float* k_s = q_s + G * D;     // (ps, D)
  float* v_s = k_s + ps * D;    // (ps, Dv)
  float* p_s = v_s + ps * Dv;   // (G, ps) scores, then probabilities
  float* acc = p_s + G * ps;    // (G, Dv)
  float* m_s = acc + G * Dv;    // (G,) running max
  float* l_s = m_s + G;         // (G,) running sum
  float* a_s = l_s + G;         // (G,) this page's rescale factor
  float* ks_s = a_s + G;        // (ps,) K scales of this page (K5)
  float* vs_s = ks_s + ps;      // (ps,) V scales of this page (K5)

  const int pos = positions[t];
  const int n_pages = pos < 0 ? 0 : min(pos / ps + 1, P);
  const int lo = window_start(pos, window);  // first kv in the window

  // the G query heads of kv head h are rows h*G .. h*G+G-1 of q[t]
  const T* q_row = q + ((size_t)t * Hq + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) q_s[i] = to_float(q_row[i]);
  for (int i = tid; i < G * Dv; i += kThreads) acc[i] = 0.f;
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const size_t k_page_stride = (size_t)ps * Hkv * D;
  const size_t v_page_stride = (size_t)ps * Hkv * Dv;
  const int* pt_row = page_tables + (size_t)t * P;

  for (int j = lo / ps; j < n_pages; ++j) {
    const size_t page = (size_t)pt_row[j];
    const TKV* k_src = k_pages + page * k_page_stride + (size_t)h * D;
    const TKV* v_src = v_pages + page * v_page_stride + (size_t)h * Dv;
    for (int i = tid; i < ps * D; i += kThreads) {
      const int r = i / D;
      k_s[i] = to_float(k_src[(size_t)r * Hkv * D + (i - r * D)]);
    }
    for (int i = tid; i < ps * Dv; i += kThreads) {
      const int r = i / Dv;
      v_s[i] = to_float(v_src[(size_t)r * Hkv * Dv + (i - r * Dv)]);
    }
    if constexpr (kQuant) {
      for (int i = tid; i < ps; i += kThreads) {
        ks_s[i] = k_scales[page * ps + i];
        vs_s[i] = v_scales[page * ps + i];
      }
    }
    __syncthreads();

    // scores: one warp per (query head, page row); lanes split D
    const int base = j * ps;
    for (int pr = warp; pr < G * ps; pr += kWarps) {
      const int g = pr / ps;
      const int r = pr - g * ps;
      float s = 0.f;
      for (int c = lane; c < D; c += 32) s += q_s[g * D + c] * k_s[r * D + c];
      s = warp_sum(s);
      if (lane == 0) {
        if constexpr (kQuant) s *= ks_s[r];
        s *= scale;
        if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
        p_s[pr] = (base + r <= pos && base + r >= lo) ? s : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: one warp per query head. Every page of the loop holds
    // a kv in [lo, pos] (the first holds lo, the others start in
    // (lo, pos]), so the new max is finite.
    for (int g = warp; g < G; g += kWarps) {
      float mx = -INFINITY;
      for (int r = lane; r < ps; r += 32) mx = fmaxf(mx, p_s[g * ps + r]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < ps; r += 32) {
        const float e = (base + r <= pos && base + r >= lo)
                            ? expf(p_s[g * ps + r] - m_new)
                            : 0.f;
        sum += e;
        // K5: the V scale folds into the weight of its kv row
        if constexpr (kQuant)
          p_s[g * ps + r] = e * vs_s[r];
        else
          p_s[g * ps + r] = e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first page
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ V
    for (int i = tid; i < G * Dv; i += kThreads) {
      const int g = i / Dv;
      const int c = i - g * Dv;
      const float* pg = p_s + g * ps;
      float a = acc[i] * a_s[g];
      for (int r = 0; r < ps; ++r) a += pg[r] * v_s[r * Dv + c];
      acc[i] = a;
    }
    __syncthreads();
  }

  // each head's output factor: 1 / l, or with a sink logit s the rescale
  // to M = max(m, s) over l e^(m - M) + e^(s - M); 0 for pad rows (l 0,
  // m -inf)
  for (int g = tid; g < G; g += kThreads) {
    const float l = l_s[g];
    float f = l > 0.f ? 1.f / l : 0.f;
    if (sinks != nullptr) {
      const float s = sinks[h * G + g];
      const float mx = fmaxf(m_s[g], s);
      const float a = expf(m_s[g] - mx);
      f = a / (l * a + expf(s - mx));
    }
    a_s[g] = f;
  }
  __syncthreads();
  T* o_row = out + ((size_t)t * Hq + (size_t)h * G) * Dv;
  for (int i = tid; i < G * Dv; i += kThreads) o_row[i] = acc[i] * a_s[i / Dv];
}

// Launches issued without error since the counters were last reset (or the
// library loaded), by device kernel: gqa_kernel over fp32 (K4) and int8
// (K5) pages, then the split and the combine kernel over bf16 (K4) and over
// int8 (K5) pages; rpa_launch_counts reads them and rpa_reset_launch_counts
// resets them.
constexpr int kCountedKernels = 6;
long long g_launches[kCountedKernels];

template <typename TKV>
constexpr int int8_pages() { return std::is_same<TKV, int8_t>::value ? 1 : 0; }

// the launch's error, counting it as kernel `which` when there is none
int counted(int which) {
  const int e = (int)cudaGetLastError();
  if (e == 0) ++g_launches[which];
  return e;
}

template <typename T, typename TKV>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const float* k_scales, const float* v_scales,
           const int* page_tables, const int* positions, const float* sinks,
           void* out, int T_, int Hq, int Hkv, int D, int Dv, int ps, int P,
           float scale, float soft_cap, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(Hq / Hkv, D, Dv, ps);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gqa_kernel<T, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gqa_kernel<T, TKV><<<T_ * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TKV*>(k_pages),
      static_cast<const TKV*>(v_pages), k_scales, v_scales, page_tables,
      positions, sinks, static_cast<T*>(out), Hq, Hkv, D, Dv, ps, P, scale,
      soft_cap, window);
  return counted(int8_pages<TKV>());
}

// ---------------------------------------------------------------------------
// bfloat16 queries (K4 over bf16 pages, K5 over int8 pages): split-KV on the
// tensor cores (paged_split.cuh); GQA scores K (part a) and takes values
// from V (part b)
// ---------------------------------------------------------------------------

template <typename TKV, int KS, int NCH>
__global__ void __launch_bounds__(kSplitThreads)
gqa_split_kernel(const SplitArgs<TKV> a, const SplitShape sh) {
  split_attention<TKV, true, KS, NCH>(a, sh);
}

// TKV names the page type only, so that K4's and K5's combines are two
// device kernels a profiler tells apart; both write bf16
template <typename TKV>
__global__ void __launch_bounds__(kCombineThreads)
gqa_combine_kernel(const float* __restrict__ ws_acc,
                   const float* __restrict__ ws_ml,
                   const int* __restrict__ positions,
                   const float* __restrict__ sinks, bf16* __restrict__ out,
                   const SplitShape sh) {
  combine_splits(ws_acc, ws_ml, positions, sinks, out, sh);
}

// e: bytes per page value, 1 (int8, K5) or 2 (bf16, K4)
SplitShape gqa_shape(int Hq, int Hkv, int D, int Dv, int ps, int P,
                     float scale, float soft_cap, int window, int e,
                     const void* k, const void* v, const void* q) {
  SplitShape sh = split_shape(Hq / Hkv, Hkv, D, Dv, true, ps, P, scale,
                              soft_cap, e, k, v, q, nullptr);
  sh.window = window;
  return sh;
}

template <typename TKV, int KS, int NCH>
int launch_gqa_split_kernel(const SplitArgs<TKV>& a, const SplitShape& sh,
                            int T, cudaStream_t stream) {
  const size_t smem = split_smem(sh);
  const cudaError_t e = cudaFuncSetAttribute(
      gqa_split_kernel<TKV, KS, NCH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid = split_grid(sh, T);
  gqa_split_kernel<TKV, KS, NCH><<<grid, kSplitThreads, smem, stream>>>(a, sh);
  return counted(2 + 2 * int8_pages<TKV>());
}

// The split kernel for the shape's step rows (KS) and columns per warp
// (NCH 16-column chunks), then the combine into out (bf16) with the sink
// logits (null: none).
template <typename TKV>
int launch_gqa_split(const SplitArgs<TKV>& a, const float* sinks, void* out,
                     const SplitShape& sh, int T, cudaStream_t stream) {
  int e = split_launchable(sh, T);
  if (e != 0) return e;
  typedef int (*Launch)(const SplitArgs<TKV>&, const SplitShape&, int,
                        cudaStream_t);
  const Launch variants[2][4] = {
      {launch_gqa_split_kernel<TKV, 1, 1>, launch_gqa_split_kernel<TKV, 1, 2>,
       launch_gqa_split_kernel<TKV, 1, 4>, launch_gqa_split_kernel<TKV, 1, 8>},
      {launch_gqa_split_kernel<TKV, 2, 1>, launch_gqa_split_kernel<TKV, 2, 2>,
       launch_gqa_split_kernel<TKV, 2, 4>, launch_gqa_split_kernel<TKV, 2, 8>}};
  e = variants[split_ks(sh) - 1][split_nch_index(sh)](a, sh, T, stream);
  if (e != 0) return e;
  const unsigned blocks = (unsigned)((long long)T * sh.groups * sh.heads);
  gqa_combine_kernel<TKV><<<blocks, kCombineThreads,
                             sizeof(float) * kCombineThreads, stream>>>(
      a.ws_acc, a.ws_ml, a.positions, sinks, static_cast<bf16*>(out), sh);
  return counted(3 + 2 * int8_pages<TKV>());
}

}  // namespace

extern "C" {

// K4 for float32 queries and pages (the CUDA-core gqa_kernel); dtype must
// be 0 (float32). soft_cap <= 0 and window 0 mean none; sinks is (Hq,)
// fp32 or null. Returns cudaGetLastError() after the launch (0 = success).
int rpa_gqa_forward(const void* q, const void* k_pages, const void* v_pages,
                    const void* page_tables, const void* positions,
                    const void* sinks, void* out, int T, int Hq, int Hkv,
                    int D, int Dv, int ps, int P, float scale, float soft_cap,
                    int window, int dtype, void* stream) {
  if (T == 0) return 0;
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return launch<float, float>(
      q, k_pages, v_pages, nullptr, nullptr,
      static_cast<const int*>(page_tables), static_cast<const int*>(positions),
      static_cast<const float*>(sinks), out, T, Hq, Hkv, D, Dv, ps, P, scale,
      soft_cap, window, static_cast<cudaStream_t>(stream));
}

// K5 for float32 queries (the CUDA-core gqa_kernel): int8 pages with
// (N+1, ps) fp32 per-row scales; dtype (q and out) must be 0 (float32).
int rpa_gqa_quant_forward(const void* q, const void* k_pages,
                          const void* v_pages, const void* k_scales,
                          const void* v_scales, const void* page_tables,
                          const void* positions, const void* sinks, void* out,
                          int T, int Hq, int Hkv, int D, int Dv, int ps, int P,
                          float scale, float soft_cap, int window, int dtype,
                          void* stream) {
  if (T == 0) return 0;
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return launch<float, int8_t>(
      q, k_pages, v_pages, static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<const int*>(page_tables),
      static_cast<const int*>(positions), static_cast<const float*>(sinks),
      out, T, Hq, Hkv, D, Dv, ps, P, scale, soft_cap, window,
      static_cast<cudaStream_t>(stream));
}

// floats of the workspace the split route (rpa_gqa_split_forward,
// rpa_gqa_quant_split_forward) needs for this shape
long long rpa_split_workspace_floats(int T, int Hq, int Hkv, int D, int Dv,
                                     int ps, int P) {
  return split_workspace(gqa_shape(Hq, Hkv, D, Dv, ps, P, 1.f, 0.f, 0, 1,
                                   nullptr, nullptr, nullptr),
                         T);
}

// dynamic shared memory (bytes) of the split kernel at this shape, over
// pages of page_bytes per value (1: int8, K5; 2: bfloat16, K4)
int rpa_split_smem_bytes(int Hq, int Hkv, int D, int Dv, int ps, int P,
                         int page_bytes) {
  return (int)split_smem(gqa_shape(Hq, Hkv, D, Dv, ps, P, 1.f, 0.f, 0,
                                   page_bytes, nullptr, nullptr, nullptr));
}

// K4 for bfloat16 queries and pages: the split-KV kernel on the tensor
// cores and the combine; out (T, Hq, Dv) bfloat16. soft_cap <= 0 and
// window 0 mean none; sinks is (Hq,) fp32 or null. workspace:
// rpa_split_workspace_floats() fp32 values.
int rpa_gqa_split_forward(const void* q, const void* k_pages,
                          const void* v_pages, const void* page_tables,
                          const void* positions, const void* sinks, void* out,
                          void* workspace, int T, int Hq, int Hkv, int D,
                          int Dv, int ps, int P, float scale, float soft_cap,
                          int window, void* stream) {
  if (T == 0) return 0;
  const SplitShape sh = gqa_shape(Hq, Hkv, D, Dv, ps, P, scale, soft_cap,
                                  window, 2, k_pages, v_pages, q);
  float* ws = static_cast<float*>(workspace);
  const SplitArgs<bf16> a = {
      static_cast<const bf16*>(q), nullptr,
      static_cast<const bf16*>(k_pages), static_cast<const bf16*>(v_pages),
      nullptr, nullptr, static_cast<const int*>(page_tables),
      static_cast<const int*>(positions), ws,
      ws + (size_t)T * sh.n_splits * Hq * Dv};
  return launch_gqa_split(a, static_cast<const float*>(sinks), out, sh, T,
                          static_cast<cudaStream_t>(stream));
}

// K5 for bfloat16 queries: as rpa_gqa_split_forward over int8 pages with
// (N+1, ps) fp32 per-row scales.
int rpa_gqa_quant_split_forward(const void* q, const void* k_pages,
                                const void* v_pages, const void* k_scales,
                                const void* v_scales, const void* page_tables,
                                const void* positions, const void* sinks,
                                void* out, void* workspace, int T, int Hq,
                                int Hkv, int D, int Dv, int ps, int P,
                                float scale, float soft_cap, int window,
                                void* stream) {
  if (T == 0) return 0;
  const SplitShape sh = gqa_shape(Hq, Hkv, D, Dv, ps, P, scale, soft_cap,
                                  window, 1, k_pages, v_pages, q);
  float* ws = static_cast<float*>(workspace);
  const SplitArgs<int8_t> a = {
      static_cast<const bf16*>(q), nullptr,
      static_cast<const int8_t*>(k_pages), static_cast<const int8_t*>(v_pages),
      static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
      static_cast<const int*>(page_tables), static_cast<const int*>(positions),
      ws, ws + (size_t)T * sh.n_splits * Hq * Dv};
  return launch_gqa_split(a, static_cast<const float*>(sinks), out, sh, T,
                          static_cast<cudaStream_t>(stream));
}

const char* rpa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// the launch counters (g_launches), in their order: the first n into out;
// returns how many there are
int rpa_launch_counts(long long* out, int n) {
  for (int i = 0; i < n && i < kCountedKernels; ++i) out[i] = g_launches[i];
  return kCountedKernels;
}

// sets every launch counter to 0
void rpa_reset_launch_counts() {
  for (auto& n : g_launches) n = 0;
}

}  // extern "C"
