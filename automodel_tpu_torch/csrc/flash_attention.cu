// K1-K3: flash attention forward and backward for Hopper (sm_90a).
//
// Replaces three Pallas kernels of automodel_tpu/ops/pallas/flash_attention.py:
//   K1 fwd_kernel  <- _fwd_kernel (:140, launched by _flash_fwd_impl :377):
//      online-softmax attention; writes out and the fp32 row logsumexp, with
//      EMPTY_LSE and a zero output for fully masked rows;
//   K2 dq_kernel   <- _dq_kernel (:238, launched by _flash_bwd :469):
//      recomputes p = exp(s - lse), ds = p * (dO.V^T - delta) (the math of
//      _recompute_p_ds :216) and accumulates dq = scale * ds.K;
//   K3 dkv_kernel  <- _dkv_kernel (:283, launched by _flash_bwd :486):
//      per kv tile, over the G query heads of its group and the q tiles at or
//      below the diagonal: dv = p^T.dO and dk = scale * ds^T.Q.
// Masks: causal by global index, segment ids, logit soft cap. GQA maps query
// head h to kv head h / (Hq / Hkv). Any S and T: the ragged edge is masked.
// Head dims 16, 64 and 128 (any multiple of the 16-wide thread grid would do).
// Windows, position-causal masking and Dv != D are refused by the wrapper
// (automodel_tpu_torch/ops/cuda/flash_attention.py).
//
// Layout. q, out, dO, dq are (B, S, Hq, D); k, v, dk, dv are (B, T, Hkv, D),
// all contiguous, in float32 or bfloat16; lse and delta are (B, Hq, S) fp32;
// segment ids are (B, S) / (B, T) int32. The kernels read the public layout
// directly, so the wrapper transposes nothing.
//
// Design. The TPU walks a sequential kv grid axis and carries (m, l, acc) in
// VMEM scratch across grid steps; CUDA blocks run in no order, so each output
// tile has one owner block that loops over its kv (K1, K2) or q (K3) tiles
// itself. Tiles are 64 x 64, staged in shared memory as fp32 (rows padded to
// D + 1 floats so that neither the row-broadcast nor the column reads of the
// products conflict on banks). 256 threads form a 16 x 16 grid; each owns a
// 4 x 4 block of the score tile (rows ty + 16 i, columns tx + 16 j), so a
// row's 64 scores live on the 16 lanes of one half-warp and its softmax
// reductions are four xor-shuffles. The accumulators (K1: out, K2: dq, K3: dk
// and dv) stay in registers for the whole loop and are written once: no
// atomics. Softmax state and accumulators are fp32 for both input types.
// Causal masking ends K1's and K2's kv loop at the diagonal and starts K3's q
// loop there; K1 and K2 schedule their heaviest (last) q tiles first.
//
// Bound. At the training shapes (S = T = 4096, D = 128) the work is bound by
// operations: K1 does 4 D flops per unmasked (q, k) pair and head, K2 6 D and
// K3 8 D, against roughly 2 D bytes read per row; the card's bf16 tensor-core
// peak (989 TFLOP/s) gives the bound. This first version multiplies on the
// CUDA cores in fp32 from shared memory (one shared load per two FMAs), so it
// runs far from that bound; mma.sync/wgmma fragments and TMA-fed pipelines
// are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // q rows and kv rows per tile
constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kLdp = kTile + 1;
// the Pallas kernel's NEG_INF (-0.7 * float32 max) and EMPTY_LSE (its negation)
constexpr float kNegInf = -0.7f * 3.402823466e38f;
constexpr float kEmptyLse = 0.7f * 3.402823466e38f;

struct Problem {
  int B, S, T, Hq, Hkv;
  float scale;
  float soft_cap;  // <= 0: none
  int causal;      // 1: key index <= query index
  const int* q_seg;   // (B, S) or null
  const int* kv_seg;  // (B, T) or null
};

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

// reductions over the 16 lanes that share one score row (lane bits 0-3)
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows n0 .. n0+63 of head h of a (B, N, H, D) tensor into a (64, D + 1)
// fp32 tile; rows past N are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src, int b,
                                          int n0, int N, int H, int h) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int n = n0 + r;
    dst[r * (D + 1) + c] =
        n < N ? to_float(src[(((size_t)b * N + n) * H + h) * D + c]) : 0.f;
  }
}

// segment ids of rows n0 .. n0+63 (0 without segments or past N)
__device__ __forceinline__ void load_seg(int* __restrict__ dst,
                                         const int* __restrict__ seg, int b,
                                         int n0, int N) {
  if (threadIdx.x < kTile) {
    const int n = n0 + threadIdx.x;
    dst[threadIdx.x] = (seg != nullptr && n < N) ? seg[(size_t)b * N + n] : 0;
  }
}

// rows n0 .. n0+63 of one (b, h) row of a (B, H, N) fp32 array
__device__ __forceinline__ void load_row_vec(float* __restrict__ dst,
                                             const float* __restrict__ src,
                                             int b, int h, int H, int n0,
                                             int N) {
  if (threadIdx.x < kTile) {
    const int n = n0 + threadIdx.x;
    dst[threadIdx.x] = n < N ? src[((size_t)b * H + h) * N + n] : 0.f;
  }
}

__device__ __forceinline__ bool allowed(const Problem& p, int qi, int ki,
                                        int qseg, int kseg) {
  return qi < p.S && ki < p.T && (!p.causal || ki <= qi) && qseg == kseg;
}

// kv tiles a q tile starting at q0 must visit: all of them, or up to the
// diagonal under causal masking
__device__ __forceinline__ int kv_tiles(const Problem& p, int q0) {
  int n = (p.T + kTile - 1) / kTile;
  if (p.causal) n = min(n, (min(q0 + kTile, p.S) - 1) / kTile + 1);
  return n;
}

// ---------------------------------------------------------------------------
// K1: forward
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t fwd_smem() {
  // q, k, v tiles | probabilities | q and kv segment ids
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kLdp) +
         sizeof(int) * 2 * kTile;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out,
           float* __restrict__ lse, Problem p) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTile * LD;
  float* v_s = k_s + kTile * LD;
  float* p_s = v_s + kTile * LD;
  int* qseg_s = reinterpret_cast<int*>(p_s + kTile * kLdp);
  int* kseg_s = qseg_s + kTile;

  const int nq = (p.S + kTile - 1) / kTile;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, D>(q_s, q, b, q0, p.S, p.Hq, h);
  load_seg(qseg_s, p.q_seg, b, q0, p.S);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int n_kv = kv_tiles(p, q0);
  for (int it = 0; it < n_kv; ++it) {
    const int k0 = it * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(k_s, k, b, k0, p.T, p.Hkv, hk);
    load_tile<T, D>(v_s, v, b, k0, p.T, p.Hkv, hk);
    load_seg(kseg_s, p.kv_seg, b, k0, p.T);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = k_s[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        ok[j] = allowed(p, q0 + r, k0 + c, qseg_s[r], kseg_s[c]);
        float x = s[i][j] * p.scale;
        if (p.soft_cap > 0.f) x = p.soft_cap * tanhf(x / p.soft_cap);
        s[i][j] = ok[j] ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // explicit re-mask: in a row masked so far m_new is NEG_INF and
        // exp(s - m_new) would be 1
        const float e = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[r * kLdp + tx + 16 * j] = e;
        sum += e;
      }
      sum = row_sum(sum);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pr[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = p_s[(ty + 16 * i) * kLdp + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = v_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.S) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* o = out + (((size_t)b * p.S + qi) * p.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[tx + 16 * j] = from_float<T>(acc[i][j] * inv);
    if (tx == 0)
      lse[((size_t)b * p.Hq + h) * p.S + qi] =
          l[i] > 0.f ? m[i] + logf(l[i]) : kEmptyLse;
  }
}

// p = exp(s - lse) and ds = scale * p * (dp - delta) [* (1 - tanh^2)] for one
// score; 0 where masked (the math of _recompute_p_ds)
__device__ __forceinline__ void recompute_p_ds(const Problem& p, bool ok,
                                               float dot, float dp, float lse,
                                               float delta, float& prob,
                                               float& ds) {
  float x = dot * p.scale;
  float t = 0.f;
  if (p.soft_cap > 0.f) {
    t = tanhf(x / p.soft_cap);
    x = p.soft_cap * t;
  }
  if (!ok) {
    prob = 0.f;
    ds = 0.f;
    return;
  }
  prob = expf(x - lse);
  float g = prob * (dp - delta);
  if (p.soft_cap > 0.f) g *= 1.f - t * t;
  ds = g * p.scale;
}

// ---------------------------------------------------------------------------
// K2: dq
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dq_smem() {
  // q, dO, k, v tiles | ds | lse, delta | q and kv segment ids
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kLdp + 2 * kTile) +
         sizeof(int) * 2 * kTile;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, Problem p) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTile * LD;
  float* k_s = do_s + kTile * LD;
  float* v_s = k_s + kTile * LD;
  float* ds_s = v_s + kTile * LD;
  float* lse_s = ds_s + kTile * kLdp;
  float* delta_s = lse_s + kTile;
  int* qseg_s = reinterpret_cast<int*>(delta_s + kTile);
  int* kseg_s = qseg_s + kTile;

  const int nq = (p.S + kTile - 1) / kTile;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, D>(q_s, q, b, q0, p.S, p.Hq, h);
  load_tile<T, D>(do_s, dout, b, q0, p.S, p.Hq, h);
  load_row_vec(lse_s, lse, b, h, p.Hq, q0, p.S);
  load_row_vec(delta_s, delta, b, h, p.Hq, q0, p.S);
  load_seg(qseg_s, p.q_seg, b, q0, p.S);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int n_kv = kv_tiles(p, q0);
  for (int it = 0; it < n_kv; ++it) {
    const int k0 = it * kTile;
    __syncthreads();
    load_tile<T, D>(k_s, k, b, k0, p.T, p.Hkv, hk);
    load_tile<T, D>(v_s, v, b, k0, p.T, p.Hkv, hk);
    load_seg(kseg_s, p.kv_seg, b, k0, p.T);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], o[4], c[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = q_s[(ty + 16 * i) * LD + d];
        o[i] = do_s[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = k_s[(tx + 16 * j) * LD + d];
        w[j] = v_s[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], c[j], s[i][j]);
          dp[i][j] = fmaf(o[i], w[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = allowed(p, q0 + r, k0 + c, qseg_s[r], kseg_s[c]);
        float prob, ds;
        recompute_p_ds(p, ok, s[i][j], dp[i][j], lse_s[r], delta_s[r], prob,
                       ds);
        ds_s[r * kLdp + c] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float g[4], kk[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) g[i] = ds_s[(ty + 16 * i) * kLdp + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kk[j] = k_s[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(g[i], kk[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= p.S) continue;
    T* o = dq + (((size_t)b * p.S + qi) * p.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[tx + 16 * j] = from_float<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// K3: dk, dv
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dkv_smem() {
  // k, v, q, dO tiles | p^T, ds^T | lse, delta | kv and q segment ids
  return sizeof(float) *
             (4 * kTile * (D + 1) + 2 * kTile * kLdp + 2 * kTile) +
         sizeof(int) * 2 * kTile;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, Problem p) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * LD;
  float* q_s = v_s + kTile * LD;
  float* do_s = q_s + kTile * LD;
  float* pt_s = do_s + kTile * LD;
  float* dst_s = pt_s + kTile * kLdp;
  float* lse_s = dst_s + kTile * kLdp;
  float* delta_s = lse_s + kTile;
  int* kseg_s = reinterpret_cast<int*>(delta_s + kTile);
  int* qseg_s = kseg_s + kTile;

  const int k0 = blockIdx.x * kTile;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  const int tx = threadIdx.x & 15;  // q column of the transposed scores
  const int ty = threadIdx.x >> 4;  // kv row

  load_tile<T, D>(k_s, k, b, k0, p.T, p.Hkv, hk);
  load_tile<T, D>(v_s, v, b, k0, p.T, p.Hkv, hk);
  load_seg(kseg_s, p.kv_seg, b, k0, p.T);

  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int nq = (p.S + kTile - 1) / kTile;
  const int iq0 = p.causal ? k0 / kTile : 0;  // first q tile reaching k0
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int iq = iq0; iq < nq; ++iq) {
      const int q0 = iq * kTile;
      __syncthreads();
      load_tile<T, D>(q_s, q, b, q0, p.S, p.Hq, h);
      load_tile<T, D>(do_s, dout, b, q0, p.S, p.Hq, h);
      load_row_vec(lse_s, lse, b, h, p.Hq, q0, p.S);
      load_row_vec(delta_s, delta, b, h, p.Hq, q0, p.S);
      load_seg(qseg_s, p.q_seg, b, q0, p.S);
      __syncthreads();

      // transposed scores: [i] kv row ty + 16 i, [j] q row tx + 16 j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kk[4], vv[4], a[4], o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kk[i] = k_s[(ty + 16 * i) * LD + d];
          vv[i] = v_s[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[j] = q_s[(tx + 16 * j) * LD + d];
          o[j] = do_s[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kk[i], a[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], o[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const bool ok = allowed(p, q0 + r, k0 + c, qseg_s[r], kseg_s[c]);
          float prob, ds;
          recompute_p_ds(p, ok, s[i][j], dp[i][j], lse_s[r], delta_s[r], prob,
                         ds);
          pt_s[c * kLdp + r] = prob;
          dst_s[c * kLdp + r] = ds;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < kTile; ++r) {
        float pr[4], g_[4], o[NJ], a[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pr[i] = pt_s[(ty + 16 * i) * kLdp + r];
          g_[i] = dst_s[(ty + 16 * i) * kLdp + r];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          o[j] = do_s[r * LD + tx + 16 * j];
          a[j] = q_s[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dv_acc[i][j] = fmaf(pr[i], o[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(g_[i], a[j], dk_acc[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ki = k0 + ty + 16 * i;
    if (ki >= p.T) continue;
    const size_t off = (((size_t)b * p.T + ki) * p.Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[off + tx + 16 * j] = from_float<T>(dk_acc[i][j]);
      dv[off + tx + 16 * j] = from_float<T>(dv_acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, const Problem& p, cudaStream_t stream) {
  const size_t smem = fwd_smem<D>();
  const int e = prepare(fwd_kernel<T, D>, smem);
  if (e != 0) return e;
  const dim3 grid((p.S + kTile - 1) / kTile, p.Hq, p.B);
  fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, const Problem& p,
              cudaStream_t stream) {
  const size_t smem = dq_smem<D>();
  const int e = prepare(dq_kernel<T, D>, smem);
  if (e != 0) return e;
  const dim3 grid((p.S + kTile - 1) / kTile, p.Hq, p.B);
  dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const Problem& p, cudaStream_t stream) {
  const size_t smem = dkv_smem<D>();
  const int e = prepare(dkv_kernel<T, D>, smem);
  if (e != 0) return e;
  const dim3 grid((p.T + kTile - 1) / kTile, p.Hkv, p.B);
  dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), p);
  return (int)cudaGetLastError();
}

Problem make_problem(int B, int S, int T, int Hq, int Hkv, float scale,
                     float soft_cap, int causal, const void* q_seg,
                     const void* kv_seg) {
  Problem p;
  p.B = B;
  p.S = S;
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.scale = scale;
  p.soft_cap = soft_cap;
  p.causal = causal;
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  return p;
}

}  // namespace

// FN<T, D>(args...) for a dtype code (0 = float32, 1 = bfloat16) and a head
// dim; cudaErrorInvalidValue for any other
#define FA_DISPATCH_D(FN, T, D, ...)              \
  switch (D) {                                   \
    case 16: return FN<T, 16>(__VA_ARGS__);      \
    case 64: return FN<T, 64>(__VA_ARGS__);      \
    case 128: return FN<T, 128>(__VA_ARGS__);    \
    default: return (int)cudaErrorInvalidValue;  \
  }
#define FA_DISPATCH(FN, dtype, D, ...)                          \
  if (dtype == 0) { FA_DISPATCH_D(FN, float, D, __VA_ARGS__) }  \
  if (dtype == 1) {                                             \
    FA_DISPATCH_D(FN, __nv_bfloat16, D, __VA_ARGS__)            \
  }                                                             \
  return (int)cudaErrorInvalidValue;

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; D: 16, 64 or 128 (v's head dim equals
// D). q_seg / kv_seg: (B, S) / (B, T) int32, both null without
// segment ids. soft_cap <= 0 means none. Each returns cudaGetLastError()
// after its launch (0 = success), or cudaErrorInvalidValue for a dtype or D
// it does not take.

int fa_forward(const void* q, const void* k, const void* v, const void* q_seg,
               const void* kv_seg, void* out, void* lse, int B, int S, int T,
               int Hq, int Hkv, int D, float scale, float soft_cap,
               int causal, int dtype, void* stream) {
  const Problem p =
      make_problem(B, S, T, Hq, Hkv, scale, soft_cap, causal, q_seg, kv_seg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(launch_fwd, dtype, D, q, k, v, out, lse, p, s)
}

int fa_backward_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   const void* q_seg, const void* kv_seg, void* dq, int B,
                   int S, int T, int Hq, int Hkv, int D, float scale,
                   float soft_cap, int causal, int dtype, void* stream) {
  const Problem p =
      make_problem(B, S, T, Hq, Hkv, scale, soft_cap, causal, q_seg, kv_seg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(launch_dq, dtype, D, q, k, v, dout, lse, delta, dq, p, s)
}

int fa_backward_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    const void* q_seg, const void* kv_seg, void* dk, void* dv,
                    int B, int S, int T, int Hq, int Hkv, int D, float scale,
                    float soft_cap, int causal, int dtype, void* stream) {
  const Problem p =
      make_problem(B, S, T, Hq, Hkv, scale, soft_cap, causal, q_seg, kv_seg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(launch_dkv, dtype, D, q, k, v, dout, lse, delta, dk, dv, p, s)
}

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
