// K6 and K7: ragged paged absorbed-MLA attention for Hopper (sm_90a), over
// fp latent pages (K6) and over int8 latent pages with per-row scales (K7).
//
// K6 replaces automodel_tpu/ops/pallas/ragged_paged_attention.py:_mla_kernel
// (launched by paged_mla_attention_kernel); K7 replaces _mla_quant_kernel in
// the same file (:428, launched by paged_mla_attention_quant_kernel :501).
// The function is the Pallas kernels' own: token row t with absorbed queries
// q_abs (n, r) and q_rope (n, dr) attends over the pages of its page-table
// row up to global kv index positions[t], with scores
//   K6: s = scale * (q_abs . c + q_rope . kr)
//   K7: s = scale * ((q_abs . c_int8) * cs + (q_rope . kr_int8) * krs)
// an fp32 online softmax, and the output in latent space,
//   K6: out = sum_r p[r] * c[r], with p rounded to c's dtype first (bf16
//       pages round p to bf16, as the Pallas kernel casts p to c.dtype),
//   K7: out = sum_r (p[r] * cs[r]) * c_int8[r],
// divided by the softmax sum; pad rows (positions[t] < 0) output 0.
//
// Two designs, picked by the query dtype (route() in
// ops/cuda/paged_mla_attention.py):
//
// mla_split_kernel + mla_combine_kernel (bfloat16 queries: K6 over bf16
// pages, K7 over int8 pages; tensor cores). The split-KV design of
// paged_split.cuh: splits of ~128 kv positions (whole pages) across blocks,
// the 16 heads of a head tile as the M of mma.sync, latent and rope rows
// gathered through the page table by 16-byte cp.async into a two-stage
// ring (bf16 pages land as the bf16 tiles ldmatrix reads; int8 pages are
// converted to one, exactly), latent and rope scores in two accumulators,
// the value product on the latent columns, fp32 partials merged by the
// combine. Any n (head tiles over the grid) and r (column groups) that fit
// shared memory in at least one kv row per step.
// - K6 carries no deviation: the value product's A operand is bf16(p),
//   which is the Pallas kernel's p.astype(c.dtype) (_mla_kernel, :367).
// - K7's deviation from the Pallas kernel: it keeps p * cs in fp32 for the
//   value product (:488); the A operand of a bf16 mma rounds it to bf16,
//   about 2^-9 of each term (the plain version rounds p to bf16 too).
//
// mla_kernel (float32 queries: K6 and K7, CUDA cores). MLA is multi-query
// attention: all n heads of a row share one latent row c (r wide) and one
// rope row kr (dr wide) per kv position. So one thread block owns one token
// row and a tile of its heads, and each live page's (ps, r) latent slice
// and (ps, dr) rope slice are read from device memory once per head tile
// and staged in shared memory as fp32. The block's queries (n_tile,
// r + dr) sit in shared memory too; scores are one warp per (head, page
// row) dot product; the (n_tile, r) fp32 accumulator is spread over the
// block's threads in registers (element i = tid + k * 256, kAcc of them per
// thread), and only the tile's output is written back. Each head's softmax
// is its own, so the heads tile over the grid's second dimension: n_tile
// (head_tile()) is the most heads whose accumulators fit, n_tile * r <=
// 16384 (32 heads at r 512), and a row of n heads takes ceil(n / n_tile)
// blocks, each reading the row's pages itself (DeepSeek-V3's 128 heads at
// r 512: 4 blocks, 4x the page bytes; the fp32 route serves parity checks).
// It walks the row's pages one after another: latency-bound (~37 us per
// page).
//
// Bound. Bytes: each live page's latent and rope rows are read once per row
// that attends to them, and the arithmetic is 4 * n * r operations per kv
// position, below the card's operations-per-byte line at n = 16. Like K4,
// rows of one prefill chunk each re-read their request's pages (L2 absorbs
// part of it). At one serve step's 64 rows the bound is 2-4 us; the split
// kernel is latency-bound (four dependent steps of load, score and value
// product per split, 2 blocks of 4 warps per SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_helpers.cuh"
#include "paged_split.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the most fp32 accumulators per thread of mla_kernel
constexpr int kMaxAcc = 64;

// heads per block of mla_kernel: the most whose (n_tile, r) accumulators fit
// kThreads * kMaxAcc registers, at most n; 0 if not even one head's fit
int head_tile(int n, int r) {
  const int fit = kThreads * kMaxAcc / r;
  return n < fit ? n : fit;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

size_t smem_bytes(int n, int r, int dr, int ps) {
  // q_abs (n, r) | q_rope (n, dr) | c (ps, r) | kr (ps, dr) | p (n, ps)
  // | running max, sum, rescale (n each) | c and kr scales (ps each)
  return sizeof(float) *
         ((size_t)n * r + (size_t)n * dr + (size_t)ps * r + (size_t)ps * dr +
          (size_t)n * ps + 3 * (size_t)n + 2 * (size_t)ps);
}

// T: q and output dtype (float); TKV: page dtype (T for K6, int8_t for K7,
// which also takes c_scales / kr_scales, (N+1, ps) fp32; K6 passes nullptr).
// Block (t, y) takes row t's heads [y * n_tile, min(n, (y + 1) * n_tile));
// kAcc accumulators per thread cover n_tile * r <= kThreads * kAcc.
template <typename T, typename TKV, int kAcc>
__global__ void __launch_bounds__(kThreads)
mla_kernel(const T* __restrict__ q_abs,         // (T, n, r)
           const T* __restrict__ q_rope,        // (T, n, dr)
           const TKV* __restrict__ c_pages,     // (N+1, ps, r)
           const TKV* __restrict__ kr_pages,    // (N+1, ps, dr)
           const float* __restrict__ c_scales,  // (N+1, ps) or nullptr
           const float* __restrict__ kr_scales, // (N+1, ps) or nullptr
           const int* __restrict__ page_tables, // (T, P)
           const int* __restrict__ positions,   // (T,)
           T* __restrict__ out,                 // (T, n, r)
           int n_total, int n_tile, int r, int dr, int ps, int P,
           float scale) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int h0 = blockIdx.y * n_tile;  // this block's first head
  const int n = min(n_tile, n_total - h0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nr = n * r;

  float* qa_s = smem;           // (n, r)
  float* qr_s = qa_s + nr;      // (n, dr)
  float* c_s = qr_s + n * dr;   // (ps, r)
  float* kr_s = c_s + ps * r;   // (ps, dr)
  float* p_s = kr_s + ps * dr;  // (n, ps) scores, then value weights
  float* m_s = p_s + n * ps;    // (n,) running max
  float* l_s = m_s + n;         // (n,) running sum
  float* a_s = l_s + n;         // (n,) this page's rescale factor
  float* cs_s = a_s + n;        // (ps,) latent scales of this page (K7)
  float* krs_s = cs_s + ps;     // (ps,) rope scales of this page (K7)

  const int pos = positions[t];
  const int n_pages = pos < 0 ? 0 : min(pos / ps + 1, P);

  const T* qa_row = q_abs + ((size_t)t * n_total + h0) * r;
  const T* qr_row = q_rope + ((size_t)t * n_total + h0) * dr;
  for (int i = tid; i < nr; i += kThreads) qa_s[i] = to_float(qa_row[i]);
  for (int i = tid; i < n * dr; i += kThreads) qr_s[i] = to_float(qr_row[i]);
  if (tid < n) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
  __syncthreads();

  const int* pt_row = page_tables + (size_t)t * P;
  for (int j = 0; j < n_pages; ++j) {
    const size_t page = (size_t)pt_row[j];
    const TKV* c_src = c_pages + page * ps * r;
    const TKV* kr_src = kr_pages + page * ps * dr;
    for (int i = tid; i < ps * r; i += kThreads) c_s[i] = to_float(c_src[i]);
    for (int i = tid; i < ps * dr; i += kThreads)
      kr_s[i] = to_float(kr_src[i]);
    if constexpr (kQuant) {
      for (int i = tid; i < ps; i += kThreads) {
        cs_s[i] = c_scales[page * ps + i];
        krs_s[i] = kr_scales[page * ps + i];
      }
    }
    __syncthreads();

    // scores: one warp per (head, page row); lanes split r and dr
    const int base = j * ps;
    for (int pr = warp; pr < n * ps; pr += kWarps) {
      const int h = pr / ps;
      const int row = pr - h * ps;
      float sc = 0.f, sr = 0.f;
      for (int c = lane; c < r; c += 32) sc += qa_s[h * r + c] * c_s[row * r + c];
      for (int d = lane; d < dr; d += 32)
        sr += qr_s[h * dr + d] * kr_s[row * dr + d];
      sc = warp_sum(sc);
      sr = warp_sum(sr);
      if (lane == 0) {
        float s;
        if constexpr (kQuant)
          s = sc * cs_s[row] + sr * krs_s[row];
        else
          s = sc + sr;
        s *= scale;
        p_s[pr] = (base + row <= pos) ? s : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: one warp per head. Row j*ps <= pos always holds for a
    // live page, so the new max is finite.
    for (int h = warp; h < n; h += kWarps) {
      float mx = -INFINITY;
      for (int row = lane; row < ps; row += 32)
        mx = fmaxf(mx, p_s[h * ps + row]);
      mx = warp_max(mx);
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int row = lane; row < ps; row += 32) {
        const float e =
            (base + row <= pos) ? expf(p_s[h * ps + row] - m_new) : 0.f;
        sum += e;
        if constexpr (kQuant)
          p_s[h * ps + row] = e * cs_s[row];  // K7: fp32 p * cs
        else
          p_s[h * ps + row] = to_float(from_float<T>(e));  // K6: p in c's dtype
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first page
        a_s[h] = alpha;
        l_s[h] = l_s[h] * alpha + sum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ c over this thread's (head, column) elements
#pragma unroll
    for (int k = 0; k < kAcc; ++k) {
      const int i = tid + k * kThreads;
      if (i < nr) {
        const int h = i / r;
        const int col = i - h * r;
        const float* ph = p_s + h * ps;
        float a = acc[k] * a_s[h];
        for (int row = 0; row < ps; ++row) a += ph[row] * c_s[row * r + col];
        acc[k] = a;
      }
    }
    __syncthreads();
  }

  T* o_row = out + ((size_t)t * n_total + h0) * r;
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    const int i = tid + k * kThreads;
    if (i < nr) {
      const float l = l_s[i / r];
      o_row[i] = from_float<T>(l > 0.f ? acc[k] / l : 0.f);
    }
  }
}

// Launches issued without error since the counters were last reset (or the
// library loaded), by device kernel: the split kernel over bf16 (K6) and
// over int8 (K7) pages, the combine kernel (bf16 queries, K6 and K7 alike),
// mla_kernel over fp32 (K6) and over int8 (K7) pages; mla_launch_counts
// reads them and mla_reset_launch_counts resets them.
enum { kSplitCounter = 0, kCombineCounter = 2, kFmaCounter = 3, kCountedKernels = 5 };
long long g_launches[kCountedKernels];

template <typename TKV>
constexpr int int8_pages() { return std::is_same<TKV, int8_t>::value ? 1 : 0; }

// the launch's error, counting it as kernel `which` when there is none
int counted(int which) {
  const int e = (int)cudaGetLastError();
  if (e == 0) ++g_launches[which];
  return e;
}

template <typename T, typename TKV, int kAcc>
int launch_acc(const void* q_abs, const void* q_rope, const void* c_pages,
               const void* kr_pages, const float* c_scales,
               const float* kr_scales, const int* page_tables,
               const int* positions, void* out, int T_, int n, int r, int dr,
               int ps, int P, float scale, cudaStream_t stream) {
  const int n_tile = head_tile(n, r);
  const size_t smem = smem_bytes(n_tile, r, dr, ps);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_kernel<T, TKV, kAcc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(T_, (n + n_tile - 1) / n_tile);
  mla_kernel<T, TKV, kAcc><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q_abs), static_cast<const T*>(q_rope),
      static_cast<const TKV*>(c_pages), static_cast<const TKV*>(kr_pages),
      c_scales, kr_scales, page_tables, positions, static_cast<T*>(out), n,
      n_tile, r, dr, ps, P, scale);
  return counted(kFmaCounter + int8_pages<TKV>());
}

template <typename T, typename TKV>
int launch(const void* q_abs, const void* q_rope, const void* c_pages,
           const void* kr_pages, const float* c_scales,
           const float* kr_scales, const int* page_tables,
           const int* positions, void* out, int T_, int n, int r, int dr,
           int ps, int P, float scale, cudaStream_t stream) {
  const int n_tile = head_tile(n, r);
  if (n_tile < 1) return (int)cudaErrorInvalidValue;
  const int need = (n_tile * r + kThreads - 1) / kThreads;
#define MLA_LAUNCH(K)                                                       \
  return launch_acc<T, TKV, K>(q_abs, q_rope, c_pages, kr_pages, c_scales,  \
                               kr_scales, page_tables, positions, out, T_, n, \
                               r, dr, ps, P, scale, stream)
  if (need <= 4) MLA_LAUNCH(4);
  if (need <= 8) MLA_LAUNCH(8);
  if (need <= 16) MLA_LAUNCH(16);
  if (need <= 32) MLA_LAUNCH(32);
  static_assert(kMaxAcc == 64, "the largest instantiation is kMaxAcc");
  if (need <= 64) MLA_LAUNCH(64);
#undef MLA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16 queries (K6 over bf16 pages, K7 over int8 pages): split-KV on the
// tensor cores, paged_split.cuh; MLA scores latent and rope, values latent
// ---------------------------------------------------------------------------

template <typename TKV, int KS, int NCH>
__global__ void __launch_bounds__(kSplitThreads)
mla_split_kernel(const SplitArgs<TKV> a, const SplitShape sh) {
  split_attention<TKV, false, KS, NCH>(a, sh);
}

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
mla_combine_kernel(const float* __restrict__ ws_acc,
                   const float* __restrict__ ws_ml,
                   const int* __restrict__ positions, T* __restrict__ out,
                   const SplitShape sh) {
  combine_splits(ws_acc, ws_ml, positions, nullptr, out, sh);
}

SplitShape mla_shape(int n, int r, int dr, int ps, int P, float scale, int e,
                     const void* c, const void* kr, const void* qa,
                     const void* qr) {
  return split_shape(n, 1, r, dr, false, ps, P, scale, 0.f, e, c, kr, qa, qr);
}

template <typename TKV, int KS, int NCH>
int launch_mla_split_kernel(const SplitArgs<TKV>& a, const SplitShape& sh,
                            int T, cudaStream_t stream) {
  const size_t smem = split_smem(sh);
  const cudaError_t e = cudaFuncSetAttribute(
      mla_split_kernel<TKV, KS, NCH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid = split_grid(sh, T);
  mla_split_kernel<TKV, KS, NCH><<<grid, kSplitThreads, smem, stream>>>(a, sh);
  return counted(kSplitCounter + int8_pages<TKV>());
}

// The split kernel for the shape's step rows (KS) and columns per warp
// (NCH 16-column chunks), then the combine into out (bf16).
template <typename TKV>
int launch_mla_split(const SplitArgs<TKV>& a, void* out, const SplitShape& sh,
                     int T, cudaStream_t stream) {
  int e = split_launchable(sh, T);
  if (e != 0) return e;
  typedef int (*Launch)(const SplitArgs<TKV>&, const SplitShape&, int,
                        cudaStream_t);
  const Launch variants[2][4] = {
      {launch_mla_split_kernel<TKV, 1, 1>, launch_mla_split_kernel<TKV, 1, 2>,
       launch_mla_split_kernel<TKV, 1, 4>, launch_mla_split_kernel<TKV, 1, 8>},
      {launch_mla_split_kernel<TKV, 2, 1>, launch_mla_split_kernel<TKV, 2, 2>,
       launch_mla_split_kernel<TKV, 2, 4>, launch_mla_split_kernel<TKV, 2, 8>}};
  e = variants[split_ks(sh) - 1][split_nch_index(sh)](a, sh, T, stream);
  if (e != 0) return e;
  const unsigned blocks = (unsigned)((long long)T * sh.groups * sh.heads);
  mla_combine_kernel<bf16><<<blocks, kCombineThreads,
                              sizeof(float) * kCombineThreads, stream>>>(
      a.ws_acc, a.ws_ml, a.positions, static_cast<bf16*>(out), sh);
  return counted(kCombineCounter);
}

}  // namespace

extern "C" {

// Heads per block of the fp32 route at this shape (the blocks of a row:
// ceil(n / mla_head_tile(n, r))); 0 when one head's r accumulators do not
// fit a block.
int mla_head_tile(int n, int r) { return head_tile(n, r); }

// K6 for float32 queries and pages (the CUDA-core mla_kernel); dtype must
// be 0 (float32). Returns cudaGetLastError() after the launch (0 =
// success).
int mla_forward(const void* q_abs, const void* q_rope, const void* c_pages,
                const void* kr_pages, const void* page_tables,
                const void* positions, void* out, int T, int n, int r, int dr,
                int ps, int P, float scale, int dtype, void* stream) {
  if (T == 0) return 0;
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return launch<float, float>(
      q_abs, q_rope, c_pages, kr_pages, nullptr, nullptr,
      static_cast<const int*>(page_tables), static_cast<const int*>(positions),
      out, T, n, r, dr, ps, P, scale, static_cast<cudaStream_t>(stream));
}

// K7 for float32 queries: int8 latent and rope pages with (N+1, ps) fp32
// per-row scales; dtype must be 0 (float32 queries and out).
int mla_quant_forward(const void* q_abs, const void* q_rope,
                      const void* c_pages, const void* kr_pages,
                      const void* c_scales, const void* kr_scales,
                      const void* page_tables, const void* positions,
                      void* out, int T, int n, int r, int dr, int ps, int P,
                      float scale, int dtype, void* stream) {
  if (T == 0) return 0;
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return launch<float, int8_t>(
      q_abs, q_rope, c_pages, kr_pages, static_cast<const float*>(c_scales),
      static_cast<const float*>(kr_scales),
      static_cast<const int*>(page_tables), static_cast<const int*>(positions),
      out, T, n, r, dr, ps, P, scale, static_cast<cudaStream_t>(stream));
}

// floats of the workspace the split route (mla_split_forward,
// mla_quant_split_forward) needs for this shape
long long mla_split_workspace_floats(int T, int n, int r, int dr, int ps,
                                     int P) {
  return split_workspace(
      mla_shape(n, r, dr, ps, P, 1.f, 1, nullptr, nullptr, nullptr, nullptr),
      T);
}

// dynamic shared memory (bytes) of the split kernel at this shape, over
// pages of page_bytes per value (1: int8, K7; 2: bfloat16, K6)
int mla_split_smem_bytes(int n, int r, int dr, int ps, int P, int page_bytes) {
  return (int)split_smem(mla_shape(n, r, dr, ps, P, 1.f, page_bytes, nullptr,
                                   nullptr, nullptr, nullptr));
}

// K6 for bfloat16 queries and pages: the split-KV kernel on the tensor cores
// and the combine; out (T, n, r) bfloat16. workspace:
// mla_split_workspace_floats() fp32 values.
int mla_split_forward(const void* q_abs, const void* q_rope,
                      const void* c_pages, const void* kr_pages,
                      const void* page_tables, const void* positions,
                      void* out, void* workspace, int T, int n, int r, int dr,
                      int ps, int P, float scale, void* stream) {
  if (T == 0) return 0;
  const SplitShape sh =
      mla_shape(n, r, dr, ps, P, scale, 2, c_pages, kr_pages, q_abs, q_rope);
  float* ws = static_cast<float*>(workspace);
  const SplitArgs<bf16> a = {
      static_cast<const bf16*>(q_abs), static_cast<const bf16*>(q_rope),
      static_cast<const bf16*>(c_pages), static_cast<const bf16*>(kr_pages),
      nullptr, nullptr, static_cast<const int*>(page_tables),
      static_cast<const int*>(positions), ws,
      ws + (size_t)T * sh.n_splits * n * r};
  return launch_mla_split(a, out, sh, T, static_cast<cudaStream_t>(stream));
}

// K7 for bfloat16 queries: as mla_split_forward over int8 pages with
// (N+1, ps) fp32 per-row scales.
int mla_quant_split_forward(const void* q_abs, const void* q_rope,
                            const void* c_pages, const void* kr_pages,
                            const void* c_scales, const void* kr_scales,
                            const void* page_tables, const void* positions,
                            void* out, void* workspace, int T, int n, int r,
                            int dr, int ps, int P, float scale,
                            void* stream) {
  if (T == 0) return 0;
  const SplitShape sh =
      mla_shape(n, r, dr, ps, P, scale, 1, c_pages, kr_pages, q_abs, q_rope);
  float* ws = static_cast<float*>(workspace);
  const SplitArgs<int8_t> a = {
      static_cast<const bf16*>(q_abs), static_cast<const bf16*>(q_rope),
      static_cast<const int8_t*>(c_pages), static_cast<const int8_t*>(kr_pages),
      static_cast<const float*>(c_scales), static_cast<const float*>(kr_scales),
      static_cast<const int*>(page_tables), static_cast<const int*>(positions),
      ws, ws + (size_t)T * sh.n_splits * n * r};
  return launch_mla_split(a, out, sh, T, static_cast<cudaStream_t>(stream));
}

const char* mla_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// the launch counters (g_launches), in their order: the first n into out;
// returns how many there are
int mla_launch_counts(long long* out, int n) {
  for (int i = 0; i < n && i < kCountedKernels; ++i) out[i] = g_launches[i];
  return kCountedKernels;
}

// sets every launch counter to 0
void mla_reset_launch_counts() {
  for (auto& n : g_launches) n = 0;
}

}  // extern "C"
