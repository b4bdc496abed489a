// K4: ragged paged GQA attention for Hopper (sm_90a).
//
// Replaces automodel_tpu/ops/pallas/ragged_paged_attention.py:_gqa_kernel
// (launched by paged_attention_kernel). It computes the same function: each
// token row t attends over the pages of its page-table row up to global kv
// index positions[t], with an fp32 online softmax, an optional logit soft
// cap, and a zero output for pad rows (positions[t] < 0).
//
// Design. The TPU grid (T, P) walks every page slot of every row in order
// and predicates the dead ones off, with the page table in scalar prefetch.
// Here one thread block owns one (token row, kv head) pair: it reads its own
// page_tables[t] and positions[t], loops only over pages 0 .. pos / ps,
// stages each page's (ps, D) K and (ps, Dv) V slice of its head in shared
// memory as fp32, scores the G = Hq / Hkv query heads of its group against
// them (one warp per (head, page row) dot product), and keeps the running
// max, sum and (G, Dv) accumulator in fp32 shared memory. Rows past pos in
// the last page are masked; the output is acc / sum, or 0 when the row had
// no page (pad rows).
//
// Bound. The work is bound by bytes from device memory: each needed page's
// K/V slice is read once per block, and the arithmetic is 4 * G * Dv
// operations per K/V row, far below the card's operations-per-byte line.
// This simple design re-reads a request's pages once per prefill row of the
// same request (a 48-row chunk reads its pages 48 times); L2 (50 MB) may
// absorb much of that. wgmma, TMA and split-KV are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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
  // | running max, sum, rescale (G each)
  return sizeof(float) *
         ((size_t)G * D + (size_t)ps * D + (size_t)ps * Dv + (size_t)G * ps +
          (size_t)G * Dv + 3 * (size_t)G);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gqa_kernel(const T* __restrict__ q,             // (T, Hq, D)
           const T* __restrict__ k_pages,       // (N+1, ps, Hkv, D)
           const T* __restrict__ v_pages,       // (N+1, ps, Hkv, Dv)
           const int* __restrict__ page_tables, // (T, P)
           const int* __restrict__ positions,   // (T,)
           T* __restrict__ out,                 // (T, Hq, Dv)
           int Hq, int Hkv, int D, int Dv, int ps, int P, float scale,
           float soft_cap) {
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

  const int pos = positions[t];
  const int n_pages = pos < 0 ? 0 : min(pos / ps + 1, P);

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

  for (int j = 0; j < n_pages; ++j) {
    const size_t page = (size_t)pt_row[j];
    const T* k_src = k_pages + page * k_page_stride + (size_t)h * D;
    const T* v_src = v_pages + page * v_page_stride + (size_t)h * Dv;
    for (int i = tid; i < ps * D; i += kThreads) {
      const int r = i / D;
      k_s[i] = to_float(k_src[(size_t)r * Hkv * D + (i - r * D)]);
    }
    for (int i = tid; i < ps * Dv; i += kThreads) {
      const int r = i / Dv;
      v_s[i] = to_float(v_src[(size_t)r * Hkv * Dv + (i - r * Dv)]);
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
        s *= scale;
        if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
        p_s[pr] = (base + r <= pos) ? s : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: one warp per query head. Row j*ps <= pos always holds
    // for a live page, so the new max is finite.
    for (int g = warp; g < G; g += kWarps) {
      float mx = -INFINITY;
      for (int r = lane; r < ps; r += 32) mx = fmaxf(mx, p_s[g * ps + r]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < ps; r += 32) {
        const float e =
            (base + r <= pos) ? expf(p_s[g * ps + r] - m_new) : 0.f;
        p_s[g * ps + r] = e;
        sum += e;
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

  T* o_row = out + ((size_t)t * Hq + (size_t)h * G) * Dv;
  for (int i = tid; i < G * Dv; i += kThreads) {
    const float l = l_s[i / Dv];
    o_row[i] = from_float<T>(l > 0.f ? acc[i] / l : 0.f);
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const int* page_tables, const int* positions, void* out, int T_,
           int Hq, int Hkv, int D, int Dv, int ps, int P, float scale,
           float soft_cap, cudaStream_t stream) {
  const size_t smem = smem_bytes(Hq / Hkv, D, Dv, ps);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gqa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gqa_kernel<T><<<T_ * Hkv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), page_tables, positions,
      static_cast<T*>(out), Hq, Hkv, D, Dv, ps, P, scale, soft_cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. soft_cap <= 0 means none. Returns
// cudaGetLastError() after the launch (0 = success).
int rpa_gqa_forward(const void* q, const void* k_pages, const void* v_pages,
                    const void* page_tables, const void* positions, void* out,
                    int T, int Hq, int Hkv, int D, int Dv, int ps, int P,
                    float scale, float soft_cap, int dtype, void* stream) {
  if (T == 0) return 0;
  const int* pt = static_cast<const int*>(page_tables);
  const int* pos = static_cast<const int*>(positions);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, pt, pos, out, T, Hq, Hkv, D,
                         Dv, ps, P, scale, soft_cap, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, pt, pos, out, T, Hq,
                                 Hkv, D, Dv, ps, P, scale, soft_cap, s);
  return (int)cudaErrorInvalidValue;
}

const char* rpa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
