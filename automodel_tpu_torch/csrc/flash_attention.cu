// K1-K3: flash attention forward and backward for Hopper (sm_90a).
//
// Replaces three Pallas kernels of automodel_tpu/ops/pallas/flash_attention.py:
//   K1 <- _fwd_kernel (:140, launched by _flash_fwd_impl :377): online-softmax
//      attention; writes out and the fp32 row logsumexp, with EMPTY_LSE and a
//      zero output for fully masked rows. bf16: fwd_mma_kernel (tensor
//      cores); fp32: fwd_kernel<float> (CUDA cores).
//   K2 <- _dq_kernel (:238, launched by _flash_bwd :469): recomputes
//      p = exp(s - lse), ds = p * (dO.V^T - delta) (the math of
//      _recompute_p_ds :216) and accumulates dq = scale * ds.K. bf16:
//      dq_mma_kernel (tensor cores); fp32: dq_kernel<float> (CUDA cores).
//   K3 <- _dkv_kernel (:283, launched by _flash_bwd :486): per kv tile, over
//      the G query heads of its group and the q tiles at or below the
//      diagonal: dv = p^T.dO and dk = scale * ds^T.Q. bf16: dkv_mma_kernel
//      (tensor cores); fp32: dkv_kernel<float> (CUDA cores).
// The dtype picks the route (route() in ops/cuda/flash_attention.py): an fp32
// mma would run in TF32 and lose the fp32 results' ~1e-6 agreement with the
// plain versions, so fp32 keeps the CUDA-core kernels.
// Masks: causal by global index, segment ids, logit soft cap. GQA maps query
// head h to kv head h / (Hq / Hkv). Any S and T: the ragged edge is masked.
// Head dims 16, 64 and 128. Windows, position-causal masking and Dv != D are
// refused by the wrapper (automodel_tpu_torch/ops/cuda/flash_attention.py).
//
// Layout. q, out, dO, dq are (B, S, Hq, D); k, v, dk, dv are (B, T, Hkv, D),
// all contiguous, in float32 or bfloat16; lse and delta are (B, Hq, S) fp32;
// segment ids are (B, S) / (B, T) int32. The kernels read the public layout
// directly, so the wrapper transposes nothing.
//
// Order. The TPU walks a sequential kv grid axis and carries (m, l, acc) in
// VMEM scratch across grid steps; CUDA blocks run in no order, so each output
// tile has one owner block that loops over its kv (K1, K2) or q (K3) tiles
// itself, with its accumulators in registers, written once: no atomics.
// Causal masking ends K1's and K2's kv loop at the diagonal and starts K3's
// q loop there; the heaviest tiles are scheduled first.
//
// Bound. At the training shapes (B 1, S = T = 4096, Hq 32, Hkv 8, D 128,
// causal) the work is bound by operations: per unmasked (q, k) pair and
// query head K1 does 4 D flops, K2 6 D, K3 8 D, i.e. 137, 206 and 275 GFLOP
// against ~2 D bytes read per row; at the card's 989 TFLOP/s bf16 peak that
// is 0.139, 0.209 and 0.278 ms.
//
// bf16 K1 (fwd_mma_kernel): 4 warps own a 64-row q tile of one (b, h), 16
// rows each; 2048 blocks at the training shape, 2 per SM. Each warp keeps
// its Q fragments in registers (ldmatrix once) and walks 64-row K/V tiles:
// S = Q.K^T with mma.sync m16n8k16 (bf16 in, fp32 accumulate), the online
// softmax on the accumulator fragments (a row lives on the 4 lanes of a
// quad: two xor-shuffles per reduction; the scale folds into the exponent,
// exp2 on the special-function unit), P rounded to bf16 in registers and fed
// straight back as the A operand of P.V (the m16n8 C fragment and the
// m16n8k16 A fragment share a layout; V through ldmatrix.trans). Rounding P
// to bf16 is the Pallas kernel's own p.astype(v.dtype). O/l is written once
// in bf16, lse in fp32. The K and V fragments load kRing - 1 products ahead
// of their use (the first V fragments during the softmax), so ldmatrix
// latency hides behind the tensor cores.
// bf16 K3 (dkv_mma_kernel): 4 warps own a 64-row kv tile of one (b, kv head),
// 16 rows each, and loop over the G heads of the group and the 32-row q
// tiles from the diagonal on; 512 blocks at the training shape. In the
// transposed orientation, S^T = K.Q^T and dP^T = V.dO^T with the warp's kv
// rows as M, so P^T and dS^T come out in the A-fragment layout of
// dV += P^T.dO and dK += dS^T.Q (dO and Q through ldmatrix.trans), and the
// 16 x D dK and dV accumulators stay in registers for the whole loop; lse
// and delta are per column and staged in shared memory. Operand fragments
// load one product step ahead. P^T and dS^T are rounded to bf16 before their
// products; the Pallas kernel rounds ds the same way (ds.astype(q.dtype))
// but keeps p in fp32 for dv (do widened at :308, p.astype(do.dtype) at
// :322), so dv differs from it by that rounding (about 2^-9 of each term;
// the plain version keeps p in fp32 too).
// bf16 K2 (dq_mma_kernel): K1's skeleton. 4 warps own a 64-row q tile of
// one (b, h), 16 rows each, heaviest tiles first (2048 blocks at the
// training shape); Q fragments stay in registers, each lane keeps lse and
// delta of its two rows in registers, and 64-row K/V tiles stream in as in
// K1. S = Q.K^T and dP = dO.V^T run on mma.sync; dS = scale P (dP - delta)
// [(1 - t^2)] is computed on the accumulator fragments, rounded to bf16 in
// registers (the Pallas kernel's ds.astype(k.dtype)) and fed back as the A
// operand of dQ += dS.K, with K through ldmatrix.trans. The dO fragments
// are re-read from the shared dO tile on every kv tile: Q (32 registers at
// D = 128), dQ (64), S (32) and dP (32) already fill the budget, and dO
// beside them (32 more) would spill. dq is written once, no atomics.
// All three: bf16 operands in shared memory, in rows of 16-byte chunks XOR-
// swizzled by row so that ldmatrix reads and cp.async writes are free of
// bank conflicts; tiles stream in by 16-byte cp.async into two stages, the
// next tile's copy issued right after the one barrier of each step, so that
// it overlaps the current tile's products. Per-element masks run only on the
// tiles that need them (the causal diagonal, ragged edges, segment ids that
// vary within the tile); a masked score is -inf, so its probability is
// exactly 0, while K1's running max starts at (and a fully masked row keeps)
// the Pallas NEG_INF. Shared memory at D = 128: K1 82,688 bytes (Q tile 16
// KB, K and V 2 stages x 2 x 16 KB, segment ids), K2 99,072 bytes (K1's
// plus the dO tile), K3 66,560 bytes (K and V 2 x 16 KB, Q and dO 2 stages
// x 2 x 8 KB, lse, delta and segment ids); all above 48 KB, so prepare()
// raises the dynamic limit. Registers (ptxas, D =
// 128): K1 206, K2 243, K3 244, no spills. Softmax state, scores and accumulators
// are fp32.
//
// fp32 (fwd_kernel, dq_kernel, dkv_kernel): 64 x 64
// tiles staged in shared memory as fp32 (rows padded to D + 1 floats), 256
// threads in a 16 x 16 grid that each own a 4 x 4 block of the score tile
// and multiply on the CUDA cores; loads are synchronous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_helpers.cuh"

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
// bf16 K1-K3 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarpRows = 16;                  // rows of one warp's mma tiles
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kFwdM = kWarpRows * kMmaWarps;   // K1: q rows per block
constexpr int kFwdN = 64;                      // K1: kv rows per stage
constexpr int kDkvN = kWarpRows * kMmaWarps;   // K3: kv rows per block
constexpr int kDkvM = 32;                      // K3: q rows per stage
constexpr int kRing = 3;  // K1's operand fragments in flight per warp

// The A operand of an m16n8k16 product from two m16n8 accumulators that hold
// its columns 0-7 (c0) and 8-15 (c1): the C and A fragments share a layout,
// so scores turn into operands in registers.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// A (rows x D) bf16 tile in shared memory, rows of D / 8 16-byte chunks.
// Chunk c of row r sits at c ^ swz(r): the 8 rows that one ldmatrix phase
// reads (same logical chunk, 8 consecutive rows) land on 8 distinct
// 16-byte bank groups, and cp.async writes stay 16-byte aligned.
template <int D>
struct SwzTile {
  static constexpr int kChunks = D / 8;
  static constexpr int kPeriod = kChunks >= 8 ? 1 : 8 / kChunks;
  static constexpr int kMod = kChunks >= 8 ? 8 : kChunks;
  __device__ __forceinline__ static int offset(int row, int chunk) {
    return row * D + ((chunk ^ ((row / kPeriod) % kMod)) << 3);
  }
  // ldmatrix address of the lane's row of a 16 x 16 block at (row0, col0)
  // laid out as an A operand (matrices: rows 0-7 | 8-15, then cols 8-15);
  // through .trans the same addresses give a B operand whose k runs along
  // the tile's rows (k halves rows 0-7 | 8-15, n-tiles cols 0-7 | 8-15)
  __device__ __forceinline__ static uint32_t a_addr(const bf16* t, int row0,
                                                    int col0, int lane) {
    const int row = row0 + (lane & 7) + (((lane >> 3) & 1) << 3);
    return smem_addr(t + offset(row, (col0 >> 3) + (lane >> 4)));
  }
  // a B operand read row-wise (k along the tile's columns): n-tiles rows
  // row0 .. +7 and +8 .. +15, each with k halves cols col0 .. +7, +8 .. +15
  __device__ __forceinline__ static uint32_t b_addr(const bf16* t, int row0,
                                                    int col0, int lane) {
    const int row = row0 + (lane & 7) + ((lane >> 4) << 3);
    return smem_addr(t + offset(row, (col0 >> 3) + ((lane >> 3) & 1)));
  }
};

// rows n0 .. n0 + R - 1 of head h of a (B, N, H, D) bf16 tensor into a
// swizzled tile with cp.async; rows past N are zero-filled
template <int D, int R>
__device__ __forceinline__ void load_tile_async(bf16* dst,
                                                const bf16* __restrict__ src,
                                                int b, int n0, int N, int H,
                                                int h) {
  constexpr int C = D / 8;
  for (int i = threadIdx.x; i < R * C; i += kMmaThreads) {
    const int r = i / C;
    const int c = i - r * C;
    const int n = n0 + r;
    const bool in = n < N;
    const bf16* s = in ? src + (((size_t)b * N + n) * H + h) * D + c * 8 : src;
    cp_async16(smem_addr(dst + SwzTile<D>::offset(r, c)), s, in);
  }
}

// R consecutive 4-byte values src[base + i] for n0 + i < N into dst (zero
// past N), by threads first .. first + R - 1
template <int R, typename V>
__device__ __forceinline__ void load_vec_async(V* dst,
                                               const V* __restrict__ src,
                                               size_t base, int n0, int N,
                                               int first) {
  const int i = (int)threadIdx.x - first;
  if (i >= 0 && i < R) {
    const bool in = n0 + i < N;
    cp_async4(smem_addr(dst + i), in ? src + base + n0 + i : src, in);
  }
}

// ---------------------------------------------------------------------------
// K1 (bf16): forward on the tensor cores
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t fwd_mma_smem() {
  // q tile | k, v tiles x 2 stages (bf16) | q segment ids | kv ids x 2
  return sizeof(bf16) * (kFwdM * D + 4 * kFwdN * D) +
         sizeof(int) * (kFwdM + 2 * kFwdN);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out,
               float* __restrict__ lse, Problem p) {
  using Tile = SwzTile<D>;
  constexpr int KD = D / 16;  // k-steps of Q.K^T over the head dim
  constexpr int ND = D / 8;   // n-tiles of P.V over the head dim
  constexpr int NS = kFwdN / 8;
  // fragments of one tile's products, each feeding two mma, loaded kRing - 1
  // ahead of their use so that ldmatrix latency hides behind the products
  constexpr int NK = KD * (NS / 2);  // K fragments (b_addr)
  constexpr int NV = (NS / 2) * (ND / 2);  // V fragments (.trans)
  static_assert(NK >= kRing - 1 && NV >= kRing - 1, "ring deeper than a tile");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kFwdM * D;
  bf16* v_s = k_s + 2 * kFwdN * D;
  int* qseg_s = reinterpret_cast<int*>(v_s + 2 * kFwdN * D);
  int* kseg_s = qseg_s + kFwdM;

  // block -> (q tile, head, batch); the heaviest (last) q tiles of every
  // head come first
  const int nq = (p.S + kFwdM - 1) / kFwdM;
  const int heads = p.Hq * p.B;
  const int q0 = (nq - 1 - (int)(blockIdx.x / heads)) * kFwdM;
  const int h = (int)(blockIdx.x % heads) % p.Hq;
  const int b = (int)(blockIdx.x % heads) / p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kWarpRows;  // the warp's first q row
  const int g = lane >> 2, t = lane & 3;
  const bool segs = p.q_seg != nullptr;

  int n_kv = (p.T + kFwdN - 1) / kFwdN;
  if (p.causal) n_kv = min(n_kv, (min(q0 + kFwdM, p.S) - 1) / kFwdN + 1);

  auto load_kv = [&](int it) {
    const int st = it & 1;
    load_tile_async<D, kFwdN>(k_s + st * kFwdN * D, k, b, it * kFwdN, p.T,
                              p.Hkv, hk);
    load_tile_async<D, kFwdN>(v_s + st * kFwdN * D, v, b, it * kFwdN, p.T,
                              p.Hkv, hk);
    if (segs)
      load_vec_async<kFwdN>(kseg_s + st * kFwdN, p.kv_seg, (size_t)b * p.T,
                            it * kFwdN, p.T, 0);
  };
  load_tile_async<D, kFwdM>(q_s, q, b, q0, p.S, p.Hq, h);
  if (segs) load_vec_async<kFwdM>(qseg_s, p.q_seg, (size_t)b * p.S, q0, p.S, 0);
  load_kv(0);
  cp_async_commit();

  uint32_t qf[KD][4];
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // rows g and g + 8 of the warp: running max, this thread's share of the sum
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  int q_val = 0;
  bool q_uniform = true;
  const float unit = p.soft_cap > 0.f ? 1.f : p.scale;
  const float unit_log2e = unit * kLog2e;

  for (int it = 0; it < n_kv; ++it) {
    const int st = it & 1;
    const int k0 = it * kFwdN;
    cp_async_wait<0>();
    // tile it has landed for every thread, and every warp is done with tile
    // it - 1, whose stage the next copy refills
    __syncthreads();
    if (it + 1 < n_kv) {
      load_kv(it + 1);  // overlaps this tile's products
      cp_async_commit();
    }
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qf[kk], Tile::a_addr(q_s, r0, kk * 16, lane));
      if (segs) {
        const int s = qseg_s[r0 + (lane & 15)];
        q_val = __shfl_sync(0xffffffffu, s, 0);
        q_uniform = __all_sync(0xffffffffu, s == q_val);
      }
    }
    const bf16* ks = k_s + st * kFwdN * D;
    const bf16* vs = v_s + st * kFwdN * D;
    const int* kseg = kseg_s + st * kFwdN;
    auto k_frag = [&](int i, uint32_t (&r)[4]) {
      ldsm_x4(r, Tile::b_addr(ks, (i % (NS / 2)) * 16, (i / (NS / 2)) * 16,
                              lane));
    };
    auto v_frag = [&](int i, uint32_t (&r)[4]) {
      ldsm_x4_trans(r, Tile::a_addr(vs, (i / (ND / 2)) * 16,
                                     (i % (ND / 2)) * 16, lane));
    };

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    uint32_t fr[kRing][4];
#pragma unroll
    for (int i = 0; i < kRing - 1; ++i) k_frag(i, fr[i]);
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      if (i + kRing - 1 < NK)
        k_frag(i + kRing - 1, fr[(i + kRing - 1) % kRing]);
      const int kk = i / (NS / 2), np = i % (NS / 2);
      mma_bf16(s[2 * np], qf[kk], fr[i % kRing][0], fr[i % kRing][1]);
      mma_bf16(s[2 * np + 1], qf[kk], fr[i % kRing][2], fr[i % kRing][3]);
    }
    // the first V fragments load while the softmax runs
#pragma unroll
    for (int i = 0; i < kRing - 1; ++i) v_frag(i, fr[i]);

    // Scores stay in units of `unit`: raw products (logit = product x
    // scale), or capped logits under a soft cap (unit 1).
    if (p.soft_cap > 0.f) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = p.soft_cap * tanhf(s[j][e] * p.scale / p.soft_cap);
    }
    // per-element masks only where the tile needs them: the causal
    // diagonal, the ragged kv edge, segment ids that vary. A masked score
    // is -inf, so its probability is exactly 0, while the running max
    // starts at (and a fully masked row keeps) the Pallas NEG_INF.
    bool need_mask = k0 + kFwdN > p.T ||
                     (p.causal && k0 + kFwdN - 1 > q0 + r0);
    if (segs && !need_mask) {
      bool same = q_uniform;
      for (int c = lane; c < kFwdN; c += 32) same = same && kseg[c] == q_val;
      need_mask = !__all_sync(0xffffffffu, same);
    }
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = r0 + g + (e >> 1) * 8;
          const int kc = j * 8 + 2 * t + (e & 1);
          const int qi = q0 + qr;
          const int ki = k0 + kc;
          bool ok = qi < p.S && ki < p.T && (!p.causal || ki <= qi);
          if (segs) ok = ok && qseg_s[qr] == kseg[kc];
          if (!ok) s[j][e] = -INFINITY;
        }
    }

    // online softmax on the accumulator fragments: a row lives on the 4
    // lanes of a quad
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float ml[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      const float alpha = fast_exp2((m[i] - m_new) * unit_log2e);
      m[i] = m_new;
      // finite even for NEG_INF, so that -inf - ml stays -inf
      ml[i] = fmaxf(m_new, -1e30f) * unit_log2e;
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        o[j][2 * i] *= alpha;
        o[j][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = fast_exp2(s[j][e] * unit_log2e - ml[e >> 1]);
        s[j][e] = pr;
        l[e >> 1] += pr;
      }

    // O += P V: P rounded to bf16 in registers (the Pallas kernel's
    // p.astype(v.dtype)), V through ldmatrix.trans
    uint32_t pa[NS / 2][4];
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk)
      acc_to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i + kRing - 1 < NV)
        v_frag(i + kRing - 1, fr[(i + kRing - 1) % kRing]);
      const int kk = i / (ND / 2), dp = i % (ND / 2);
      mma_bf16(o[2 * dp], pa[kk], fr[i % kRing][0], fr[i % kRing][1]);
      mma_bf16(o[2 * dp + 1], pa[kk], fr[i % kRing][2], fr[i % kRing][3]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float sum = quad_sum(l[i]);
    const int qi = q0 + r0 + g + 8 * i;
    if (qi >= p.S) continue;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    bf16* orow = out + (((size_t)b * p.S + qi) * p.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t) =
          __floats2bfloat162_rn(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
    if (t == 0)
      lse[((size_t)b * p.Hq + h) * p.S + qi] =
          sum > 0.f ? m[i] * unit + logf(sum) : kEmptyLse;
  }
}

// ---------------------------------------------------------------------------
// K3 (bf16): dk, dv on the tensor cores
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dkv_mma_smem() {
  // k, v tiles | q, dO tiles x 2 stages (bf16) | lse, delta, q segment ids
  // x 2 stages | kv segment ids
  return sizeof(bf16) * (2 * kDkvN * D + 4 * kDkvM * D) +
         sizeof(float) * (6 * kDkvM + kDkvN);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, Problem p) {
  using Tile = SwzTile<D>;
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  constexpr int NS = kDkvM / 8;  // n-tiles of the transposed scores
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kDkvN * D;
  bf16* q_s = v_s + kDkvN * D;      // two stages
  bf16* do_s = q_s + 2 * kDkvM * D;  // two stages
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kDkvM * D);
  float* delta_s = lse_s + 2 * kDkvM;
  int* qseg_s = reinterpret_cast<int*>(delta_s + 2 * kDkvM);
  int* kseg_s = qseg_s + 2 * kDkvM;

  // block -> (kv tile, kv head, batch); under causal masking the first kv
  // tiles see the most q rows, and they come first for every head
  const int heads = p.Hkv * p.B;
  const int k0 = (int)(blockIdx.x / heads) * kDkvN;
  const int hk = (int)(blockIdx.x % heads) % p.Hkv;
  const int b = (int)(blockIdx.x % heads) / p.Hkv;
  const int G = p.Hq / p.Hkv;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kWarpRows;  // the warp's first kv row
  const int g = lane >> 2, t = lane & 3;
  const bool segs = p.q_seg != nullptr;

  // the steps: every q tile of every head of the group, from the first q
  // tile that reaches k0 under causal masking
  const int nq = (p.S + kDkvM - 1) / kDkvM;
  const int iq0 = p.causal ? min(k0 / kDkvM, nq) : 0;
  const int per_head = nq - iq0;
  const int n_steps = G * per_head;

  auto load_step = [&](int i) {
    const int st = i & 1;
    const int h = hk * G + i / per_head;
    const int q0 = (iq0 + i % per_head) * kDkvM;
    load_tile_async<D, kDkvM>(q_s + st * kDkvM * D, q, b, q0, p.S, p.Hq, h);
    load_tile_async<D, kDkvM>(do_s + st * kDkvM * D, dout, b, q0, p.S, p.Hq,
                              h);
    const size_t row = ((size_t)b * p.Hq + h) * p.S;
    load_vec_async<kDkvM>(lse_s + st * kDkvM, lse, row, q0, p.S, 0);
    load_vec_async<kDkvM>(delta_s + st * kDkvM, delta, row, q0, p.S, kDkvM);
    if (segs)
      load_vec_async<kDkvM>(qseg_s + st * kDkvM, p.q_seg, (size_t)b * p.S, q0,
                            p.S, 2 * kDkvM);
  };
  load_tile_async<D, kDkvN>(k_s, k, b, k0, p.T, p.Hkv, hk);
  load_tile_async<D, kDkvN>(v_s, v, b, k0, p.T, p.Hkv, hk);
  if (segs)
    load_vec_async<kDkvN>(kseg_s, p.kv_seg, (size_t)b * p.T, k0, p.T, 0);
  if (n_steps > 0) load_step(0);
  cp_async_commit();

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  int k_val = 0;
  bool k_uniform = true;

  for (int i = 0; i < n_steps; ++i) {
    const int st = i & 1;
    const int q0 = (iq0 + i % per_head) * kDkvM;
    cp_async_wait<0>();
    // step i has landed for every thread, and every warp is done with step
    // i - 1, whose stage the next copy refills
    __syncthreads();
    if (i + 1 < n_steps) {
      load_step(i + 1);  // overlaps this step's products
      cp_async_commit();
    }
    if (i == 0 && segs) {
      const int s = kseg_s[r0 + (lane & 15)];
      k_val = __shfl_sync(0xffffffffu, s, 0);
      k_uniform = __all_sync(0xffffffffu, s == k_val);
    }
    const bf16* qs = q_s + st * kDkvM * D;
    const bf16* dos = do_s + st * kDkvM * D;
    const float* lse_c = lse_s + st * kDkvM;
    const float* delta_c = delta_s + st * kDkvM;
    const int* qseg = qseg_s + st * kDkvM;

    // transposed scores S^T = K Q^T and dP^T = V dO^T: the warp's 16 kv
    // rows by the step's 32 q columns
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    // operands one (kk, np) step ahead of their products: K and V rows as
    // A, Q and dO rows as B
    auto a_frags = [&](int kk, uint32_t (&ka)[4], uint32_t (&va)[4]) {
      ldsm_x4(ka, Tile::a_addr(k_s, r0, kk * 16, lane));
      ldsm_x4(va, Tile::a_addr(v_s, r0, kk * 16, lane));
    };
    auto b_frags = [&](int i, uint32_t (&bq)[4], uint32_t (&bo)[4]) {
      const int kk = i / (NS / 2), np = i % (NS / 2);
      ldsm_x4(bq, Tile::b_addr(qs, np * 16, kk * 16, lane));
      ldsm_x4(bo, Tile::b_addr(dos, np * 16, kk * 16, lane));
    };
    auto t_frags = [&](int i, uint32_t (&bo)[4], uint32_t (&bq)[4]) {
      const int kk = i / (ND / 2), dd = i % (ND / 2);
      ldsm_x4_trans(bo, Tile::a_addr(dos, kk * 16, dd * 16, lane));
      ldsm_x4_trans(bq, Tile::a_addr(qs, kk * 16, dd * 16, lane));
    };
    uint32_t ka[2][4], va[2][4], bq[2][4], bo[2][4];
    a_frags(0, ka[0], va[0]);
    b_frags(0, bq[0], bo[0]);
#pragma unroll
    for (int i = 0; i < KD * (NS / 2); ++i) {
      if (i + 1 < KD * (NS / 2)) {
        const int kk1 = (i + 1) / (NS / 2);
        if ((i + 1) % (NS / 2) == 0) a_frags(kk1, ka[kk1 & 1], va[kk1 & 1]);
        b_frags(i + 1, bq[(i + 1) & 1], bo[(i + 1) & 1]);
      }
      const int kk = i / (NS / 2), np = i % (NS / 2);
      mma_bf16(s[2 * np], ka[kk & 1], bq[i & 1][0], bq[i & 1][1]);
      mma_bf16(s[2 * np + 1], ka[kk & 1], bq[i & 1][2], bq[i & 1][3]);
      mma_bf16(dp[2 * np], va[kk & 1], bo[i & 1][0], bo[i & 1][1]);
      mma_bf16(dp[2 * np + 1], va[kk & 1], bo[i & 1][2], bo[i & 1][3]);
    }

    // the first dO and Q fragments of dV and dK load meanwhile (the loop
    // above ended on slot 1)
    static_assert(KD * (NS / 2) % 2 == 0, "slot 0 is free here");
    t_frags(0, bo[0], bq[0]);

    // P^T = exp(S^T - lse) and dS^T = scale P^T (dP^T - delta) [(1 - t^2)]
    // (the math of _recompute_p_ds); lse and delta are per column here
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * p.scale;
        float cap_grad = 1.f;
        if (p.soft_cap > 0.f) {
          const float th = tanhf(x / p.soft_cap);
          x = p.soft_cap * th;
          cap_grad = 1.f - th * th;
        }
        const float pr = fast_exp2((x - lse_c[qc]) * kLog2e);
        s[j][e] = pr;
        dp[j][e] = pr * (dp[j][e] - delta_c[qc]) * cap_grad * p.scale;
      }
    // per-element masks only where the step needs them: the causal
    // diagonal, ragged edges, segment ids that vary
    bool need_mask = q0 + kDkvM > p.S || k0 + kDkvN > p.T ||
                     (p.causal && k0 + r0 + kWarpRows - 1 > q0);
    if (segs && !need_mask)
      need_mask = !(k_uniform && __all_sync(0xffffffffu, qseg[lane] == k_val));
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = j * 8 + 2 * t + (e & 1);
          const int kr = r0 + g + (e >> 1) * 8;
          const int qi = q0 + qc;
          const int ki = k0 + kr;
          bool ok = qi < p.S && ki < p.T && (!p.causal || ki <= qi);
          if (segs) ok = ok && qseg[qc] == kseg_s[kr];
          if (!ok) s[j][e] = dp[j][e] = 0.f;
        }
    }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16 in
    // registers; dO and Q through ldmatrix.trans
    uint32_t pa[NS / 2][4], da[NS / 2][4];
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      acc_to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
      acc_to_a(da[kk], dp[2 * kk], dp[2 * kk + 1]);
    }
#pragma unroll
    for (int i = 0; i < (NS / 2) * (ND / 2); ++i) {
      if (i + 1 < (NS / 2) * (ND / 2))
        t_frags(i + 1, bo[(i + 1) & 1], bq[(i + 1) & 1]);
      const int kk = i / (ND / 2), dd = i % (ND / 2);
      mma_bf16(dv_acc[2 * dd], pa[kk], bo[i & 1][0], bo[i & 1][1]);
      mma_bf16(dv_acc[2 * dd + 1], pa[kk], bo[i & 1][2], bo[i & 1][3]);
      mma_bf16(dk_acc[2 * dd], da[kk], bq[i & 1][0], bq[i & 1][1]);
      mma_bf16(dk_acc[2 * dd + 1], da[kk], bq[i & 1][2], bq[i & 1][3]);
    }
  }
  if (n_steps == 0) cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int ki = k0 + r0 + g + 8 * i;
    if (ki >= p.T) continue;
    const size_t off = (((size_t)b * p.T + ki) * p.Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + j * 8 + 2 * t) =
          __floats2bfloat162_rn(dk_acc[j][2 * i], dk_acc[j][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + j * 8 + 2 * t) =
          __floats2bfloat162_rn(dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K2 (bf16): dq on the tensor cores
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t dq_mma_smem() {
  // q, dO tiles | k, v tiles x 2 stages (bf16) | q segment ids | kv ids x 2
  return sizeof(bf16) * (2 * kFwdM * D + 4 * kFwdN * D) +
         sizeof(int) * (kFwdM + 2 * kFwdN);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, Problem p) {
  using Tile = SwzTile<D>;
  constexpr int KD = D / 16;  // k-steps of Q.K^T and dO.V^T over the head dim
  constexpr int ND = D / 8;   // n-tiles of dS.K over the head dim
  constexpr int NS = kFwdN / 8;
  constexpr int NK = KD * (NS / 2);        // steps of the two score products
  constexpr int NQ = (NS / 2) * (ND / 2);  // steps of dS.K
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kFwdM * D;
  bf16* k_s = do_s + kFwdM * D;
  bf16* v_s = k_s + 2 * kFwdN * D;
  int* qseg_s = reinterpret_cast<int*>(v_s + 2 * kFwdN * D);
  int* kseg_s = qseg_s + kFwdM;

  // block -> (q tile, head, batch), the heaviest q tiles first, as in K1
  const int nq = (p.S + kFwdM - 1) / kFwdM;
  const int heads = p.Hq * p.B;
  const int q0 = (nq - 1 - (int)(blockIdx.x / heads)) * kFwdM;
  const int h = (int)(blockIdx.x % heads) % p.Hq;
  const int b = (int)(blockIdx.x % heads) / p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * kWarpRows;  // the warp's first q row
  const int g = lane >> 2, t = lane & 3;
  const bool segs = p.q_seg != nullptr;

  int n_kv = (p.T + kFwdN - 1) / kFwdN;
  if (p.causal) n_kv = min(n_kv, (min(q0 + kFwdM, p.S) - 1) / kFwdN + 1);

  auto load_kv = [&](int it) {
    const int st = it & 1;
    load_tile_async<D, kFwdN>(k_s + st * kFwdN * D, k, b, it * kFwdN, p.T,
                              p.Hkv, hk);
    load_tile_async<D, kFwdN>(v_s + st * kFwdN * D, v, b, it * kFwdN, p.T,
                              p.Hkv, hk);
    if (segs)
      load_vec_async<kFwdN>(kseg_s + st * kFwdN, p.kv_seg, (size_t)b * p.T,
                            it * kFwdN, p.T, 0);
  };
  load_tile_async<D, kFwdM>(q_s, q, b, q0, p.S, p.Hq, h);
  load_tile_async<D, kFwdM>(do_s, dout, b, q0, p.S, p.Hq, h);
  if (segs) load_vec_async<kFwdM>(qseg_s, p.q_seg, (size_t)b * p.S, q0, p.S, 0);
  load_kv(0);
  cp_async_commit();

  // lse (in log2 units) and delta of the lane's rows g and g + 8
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + g + 8 * i;
    const size_t at = ((size_t)b * p.Hq + h) * p.S + qi;
    lse2[i] = qi < p.S ? lse[at] * kLog2e : 0.f;
    dlt[i] = qi < p.S ? delta[at] : 0.f;
  }
  uint32_t qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  int q_val = 0;
  bool q_uniform = true;
  const float scale_log2e = p.scale * kLog2e;

  for (int it = 0; it < n_kv; ++it) {
    const int st = it & 1;
    const int k0 = it * kFwdN;
    cp_async_wait<0>();
    // tile it has landed for every thread, and every warp is done with tile
    // it - 1, whose stage the next copy refills
    __syncthreads();
    if (it + 1 < n_kv) {
      load_kv(it + 1);  // overlaps this tile's products
      cp_async_commit();
    }
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qf[kk], Tile::a_addr(q_s, r0, kk * 16, lane));
      if (segs) {
        const int s = qseg_s[r0 + (lane & 15)];
        q_val = __shfl_sync(0xffffffffu, s, 0);
        q_uniform = __all_sync(0xffffffffu, s == q_val);
      }
    }
    const bf16* ks = k_s + st * kFwdN * D;
    const bf16* vs = v_s + st * kFwdN * D;
    const int* kseg = kseg_s + st * kFwdN;

    // S = Q K^T and dP = dO V^T, 16 rows x 64 keys per warp; operands one
    // step ahead of their products (dO fragments re-read from shared
    // memory: kept in registers beside Q, dQ, S and dP they would spill)
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    auto kv_frags = [&](int i, uint32_t (&kb)[4], uint32_t (&vb)[4]) {
      const int kk = i / (NS / 2), np = i % (NS / 2);
      ldsm_x4(kb, Tile::b_addr(ks, np * 16, kk * 16, lane));
      ldsm_x4(vb, Tile::b_addr(vs, np * 16, kk * 16, lane));
    };
    uint32_t kb[2][4], vb[2][4], of[2][4];
    ldsm_x4(of[0], Tile::a_addr(do_s, r0, 0, lane));
    kv_frags(0, kb[0], vb[0]);
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      if (i + 1 < NK) {
        const int kk1 = (i + 1) / (NS / 2);
        if ((i + 1) % (NS / 2) == 0)
          ldsm_x4(of[kk1 & 1], Tile::a_addr(do_s, r0, kk1 * 16, lane));
        kv_frags(i + 1, kb[(i + 1) & 1], vb[(i + 1) & 1]);
      }
      const int kk = i / (NS / 2), np = i % (NS / 2);
      mma_bf16(s[2 * np], qf[kk], kb[i & 1][0], kb[i & 1][1]);
      mma_bf16(s[2 * np + 1], qf[kk], kb[i & 1][2], kb[i & 1][3]);
      mma_bf16(dp[2 * np], of[kk & 1], vb[i & 1][0], vb[i & 1][1]);
      mma_bf16(dp[2 * np + 1], of[kk & 1], vb[i & 1][2], vb[i & 1][3]);
    }
    // the first K fragment of dS.K loads meanwhile (slot 0 is free: the
    // loop above ended on slot 1)
    static_assert(NK % 2 == 0, "slot 0 is free here");
    auto kt_frag = [&](int i, uint32_t (&r)[4]) {
      ldsm_x4_trans(r, Tile::a_addr(ks, (i / (ND / 2)) * 16,
                                     (i % (ND / 2)) * 16, lane));
    };
    kt_frag(0, kb[0]);

    // P = exp(S - lse) and dS = scale P (dP - delta) [(1 - t^2)] (the math
    // of _recompute_p_ds), on the accumulator fragments
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float pr;
        float cap_grad = 1.f;
        if (p.soft_cap > 0.f) {
          const float th = tanhf(s[j][e] * p.scale / p.soft_cap);
          cap_grad = 1.f - th * th;
          pr = fast_exp2(p.soft_cap * th * kLog2e - lse2[i]);
        } else {
          pr = fast_exp2(s[j][e] * scale_log2e - lse2[i]);
        }
        dp[j][e] = pr * (dp[j][e] - dlt[i]) * cap_grad * p.scale;
      }
    // per-element masks only where the tile needs them, as in K1
    bool need_mask = k0 + kFwdN > p.T ||
                     (p.causal && k0 + kFwdN - 1 > q0 + r0);
    if (segs && !need_mask) {
      bool same = q_uniform;
      for (int c = lane; c < kFwdN; c += 32) same = same && kseg[c] == q_val;
      need_mask = !__all_sync(0xffffffffu, same);
    }
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = r0 + g + (e >> 1) * 8;
          const int kc = j * 8 + 2 * t + (e & 1);
          const int qi = q0 + qr;
          const int ki = k0 + kc;
          bool ok = qi < p.S && ki < p.T && (!p.causal || ki <= qi);
          if (segs) ok = ok && qseg_s[qr] == kseg[kc];
          if (!ok) dp[j][e] = 0.f;
        }
    }

    // dQ += dS K: dS rounded to bf16 in registers (the Pallas kernel's
    // ds.astype(k.dtype)) as the A operand, K through ldmatrix.trans
    uint32_t da[NS / 2][4];
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) acc_to_a(da[kk], dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      if (i + 1 < NQ) kt_frag(i + 1, kb[(i + 1) & 1]);
      const int kk = i / (ND / 2), dd = i % (ND / 2);
      mma_bf16(acc[2 * dd], da[kk], kb[i & 1][0], kb[i & 1][1]);
      mma_bf16(acc[2 * dd + 1], da[kk], kb[i & 1][2], kb[i & 1][3]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + g + 8 * i;
    if (qi >= p.S) continue;
    bf16* row = dq + (((size_t)b * p.S + qi) * p.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
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

// a 1-D grid of `blocks`; cudaErrorInvalidConfiguration past its limit
int grid_1d(long long blocks, dim3& grid) {
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  grid = dim3((unsigned)blocks);
  return 0;
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

template <int D>
int launch_fwd_mma(const void* q, const void* k, const void* v, void* out,
                   void* lse, const Problem& p, cudaStream_t stream) {
  const size_t smem = fwd_mma_smem<D>();
  int e = prepare(fwd_mma_kernel<D>, smem);
  dim3 grid;
  if (e == 0)
    e = grid_1d((long long)((p.S + kFwdM - 1) / kFwdM) * p.Hq * p.B, grid);
  if (e != 0) return e;
  fwd_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
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

template <int D>
int launch_dq_mma(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, const Problem& p, cudaStream_t stream) {
  const size_t smem = dq_mma_smem<D>();
  int e = prepare(dq_mma_kernel<D>, smem);
  dim3 grid;
  if (e == 0)
    e = grid_1d((long long)((p.S + kFwdM - 1) / kFwdM) * p.Hq * p.B, grid);
  if (e != 0) return e;
  dq_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), p);
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

template <int D>
int launch_dkv_mma(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, const Problem& p, cudaStream_t stream) {
  const size_t smem = dkv_mma_smem<D>();
  int e = prepare(dkv_mma_kernel<D>, smem);
  dim3 grid;
  if (e == 0)
    e = grid_1d((long long)((p.T + kDkvN - 1) / kDkvN) * p.Hkv * p.B, grid);
  if (e != 0) return e;
  dkv_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), p);
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

// fn(std::integral_constant<int, D>()) for a head dim D of 16, 64 or 128;
// cudaErrorInvalidValue for any other
template <typename F>
int with_head_dim(int D, F fn) {
  switch (D) {
    case 16: return fn(std::integral_constant<int, 16>());
    case 64: return fn(std::integral_constant<int, 64>());
    case 128: return fn(std::integral_constant<int, 128>());
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; D: 16, 64 or 128 (v's head dim equals
// D). q_seg / kv_seg: (B, S) / (B, T) int32, both null without
// segment ids. soft_cap <= 0 means none. Each returns cudaGetLastError()
// after its launch (0 = success), or cudaErrorInvalidValue for a dtype or D
// it does not take. bfloat16 runs K1-K3 on the tensor cores, float32 on the
// CUDA cores.

int fa_forward(const void* q, const void* k, const void* v, const void* q_seg,
               const void* kv_seg, void* out, void* lse, int B, int S, int T,
               int Hq, int Hkv, int D, float scale, float soft_cap,
               int causal, int dtype, void* stream) {
  const Problem p =
      make_problem(B, S, T, Hq, Hkv, scale, soft_cap, causal, q_seg, kv_seg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (dtype == 0) return launch_fwd<float, kD>(q, k, v, out, lse, p, s);
    if (dtype == 1) return launch_fwd_mma<kD>(q, k, v, out, lse, p, s);
    return (int)cudaErrorInvalidValue;
  });
}

int fa_backward_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   const void* q_seg, const void* kv_seg, void* dq, int B,
                   int S, int T, int Hq, int Hkv, int D, float scale,
                   float soft_cap, int causal, int dtype, void* stream) {
  const Problem p =
      make_problem(B, S, T, Hq, Hkv, scale, soft_cap, causal, q_seg, kv_seg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (dtype == 0)
      return launch_dq<float, kD>(q, k, v, dout, lse, delta, dq, p, s);
    if (dtype == 1)
      return launch_dq_mma<kD>(q, k, v, dout, lse, delta, dq, p, s);
    return (int)cudaErrorInvalidValue;
  });
}

int fa_backward_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    const void* q_seg, const void* kv_seg, void* dk, void* dv,
                    int B, int S, int T, int Hq, int Hkv, int D, float scale,
                    float soft_cap, int causal, int dtype, void* stream) {
  const Problem p =
      make_problem(B, S, T, Hq, Hkv, scale, soft_cap, causal, q_seg, kv_seg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (dtype == 0)
      return launch_dkv<float, kD>(q, k, v, dout, lse, delta, dk, dv, p, s);
    if (dtype == 1)
      return launch_dkv_mma<kD>(q, k, v, dout, lse, delta, dk, dv, p, s);
    return (int)cudaErrorInvalidValue;
  });
}

// dynamic shared memory (bytes) of the bf16 tensor-core K1 (which = 0), K3
// (which = 1) or K2 (which = 2) at head dim D
int fa_mma_smem_bytes(int which, int D) {
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if (which == 0) return (int)fwd_mma_smem<kD>();
    if (which == 1) return (int)dkv_mma_smem<kD>();
    return (int)dq_mma_smem<kD>();
  });
}

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
