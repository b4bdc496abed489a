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
//      the G query heads of its group and the q tiles that can reach it:
//      dv = p^T.dO and dk = scale * ds^T.Q. bf16: dkv_mma_kernel (tensor
//      cores); fp32: dkv_kernel<float> (CUDA cores).
// The dtype picks the route (route() in ops/cuda/flash_attention.py): an fp32
// mma would run in TF32 and lose the fp32 results' ~1e-6 agreement with the
// plain versions, so fp32 keeps the CUDA-core kernels.
// Masks, those of the Pallas _block_mask (:94): causal by global index
// (causal 1) or by position (causal 2: kv position <= q position, the ring
// attention mode, where the kv side has positions and segment ids of its own
// and T may differ from S); segment ids (q and kv ids apart); a sliding
// window on positions, kpos >= qpos - window + 1, two-sided (also
// kpos <= qpos + window - 1) when the attention is not causal; a logit soft
// cap. GQA maps query head h to kv head h / (Hq / Hkv). Any S and T: the
// ragged edge is masked.
// The tensor-core kernels are instantiated twice per head-dim pair, with
// and without the position code (kPos: a window or causal masking by
// position), so that the masks the port had before cost the kernels that
// do not read positions nothing.
// Tile skipping (the Pallas _run_predicate :114, which skips by index only
// and only when positions are the index): index-causal tiles past the
// diagonal, and, under a window or position-causal masking, every tile pair
// whose position ranges prove it empty. The wrapper hands each kernel the
// min and max position of every 32-row granule (q_rng, kv_rng), computed on
// the device; a kernel skips a (q, kv) tile pair only where those ranges
// leave no allowed pair, so packed batches (positions restarting per
// document) stay exact, and no host read decides anything. Rows that see no
// key (whole rows can be empty under position-causal masking) keep the
// Pallas conventions: lse EMPTY_LSE, output 0, gradients 0.
// Head dims: every kernel is a template on the pair (DQK, DV), the head dim
// of q and k and that of v, as the Pallas kernels take MLA's asymmetric
// heads; instantiated for (16, 16), (64, 64), (128, 128), (192, 128)
// (MLA: qk_nope 128 + qk_rope 64, v 128) and (256, 256) (Gemma-2 and
// Gemma-3). S = scale Q.K^T and dS.K / dS^T.Q run over DQK; O = P.V,
// dP = dO.V^T, delta = rowsum(dO o O) and dV = P^T.dO over DV. 192 is 12
// k-steps of the m16n8k16 mma, so nothing is padded (the TPU pads it to 256
// lanes). Other pairs are refused by the wrapper
// (automodel_tpu_torch/ops/cuda/flash_attention.py).
//
// Layout. q, dq are (B, S, Hq, DQK); out, dO are (B, S, Hq, DV); k, dk are
// (B, T, Hkv, DQK) and v, dv (B, T, Hkv, DV), all contiguous, in float32 or
// bfloat16; lse and delta are (B, Hq, S) fp32; segment ids and positions are
// (B, S) / (B, T) int32. The kernels read the public layout directly, so the
// wrapper transposes nothing.
//
// Order. The TPU walks a sequential kv grid axis and carries (m, l, acc) in
// VMEM scratch across grid steps; CUDA blocks run in no order, so each output
// tile has one owner block that loops over its kv (K1, K2) or q (K3) tiles
// itself, with its accumulators in registers, written once: no atomics.
// Causal masking ends K1's and K2's kv loop at the diagonal and starts K3's
// q loop there; a window starts K1's and K2's kv loop at the window's first
// tile and ends K3's q loop window - 1 rows past its kv tile; the heaviest
// tiles are scheduled first.
//
// Bound. At the training shapes (B 1, S = T = 4096, Hq 32, Hkv 8, D 128,
// causal) the work is bound by operations: per unmasked (q, k) pair and
// query head K1 does 2 DQK + 2 DV flops (Q.K^T, P.V), K2 4 DQK + 2 DV
// (Q.K^T, dS.K, dO.V^T), K3 4 DQK + 4 DV (Q.K^T, dS^T.Q, dO.V^T, P^T.dO),
// i.e. 137, 206 and 275 GFLOP at D 128 against ~2 D bytes read per row; at
// the card's 989 TFLOP/s bf16 peak that is 0.139, 0.209 and 0.278 ms. Under a
// window only the window's pairs count.
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
// vary within the tile, a window edge or position-causal edge that crosses
// the tile); a masked score is -inf, so its probability is exactly 0, while
// K1's running max starts at (and a fully masked row keeps) the Pallas
// NEG_INF. Shared memory at D = 128: K1 83,456 bytes (Q tile 16 KB, K and V
// 2 stages x 2 x 16 KB, segment ids and positions), K2 99,840 bytes (K1's
// plus the dO tile), K3 67,072 bytes (K and V 2 x 16 KB, Q and dO 2 stages
// x 2 x 8 KB, lse, delta, segment ids and positions); all above 48 KB, so
// prepare() raises the dynamic limit. Registers (ptxas, D = 128, without
// the position code): K1 206, K2 243, K3 243, no spills. Softmax state,
// scores and accumulators are fp32.
// At (192, 128) the DQK-side fragments grow 1.5x (K1's Q, K2's dQ and K3's
// dK accumulators) while the DV side stays: K2 then re-reads its Q
// fragments from the shared Q tile per k-step, as it does dO (kQInRegs),
// and K1 and K3 keep theirs; shared memory K1 108,032 bytes, K2 124,416,
// K3 83,456 (Q and K tiles 64 x 192, V and dO 64 x 128).
// At (256, 256) a warp's 16 x 256 fp32 accumulator alone takes 128
// registers a thread: K1 (O) and K2 (dQ) re-read Q from the shared tile per
// k-step and walk 32-row K/V stages (fwd_kv_rows), so that scores and
// operands fit beside the accumulator and K1's shared memory (96 KB) leaves
// room for 2 blocks per SM. K3's dK and dV together (256 registers) fit no
// warp, so K3 splits its kv tile between two warp groups (dkv_split, 8
// warps): warps 0-3 compute S^T = K.Q^T, P^T and dV += P^T.dO, warps 4-7
// dP^T = V.dO^T, dS^T and dK += dS^T.Q, each with one 16 x 256 accumulator;
// the first group hands P^T (1 - t^2) scale to the second through 8 KB of
// shared memory in fragment order, one barrier per q tile. The products are
// the unsplit kernel's, none done twice.
//
// fp32 (fwd_kernel, dq_kernel, dkv_kernel): 64 x 64
// tiles staged in shared memory as fp32 (rows padded to D + 1 floats), 256
// threads in a 16 x 16 grid that each own a 4 x 4 block of the score tile
// and multiply on the CUDA cores; loads are synchronous. Past what fits in
// 227 KB of shared memory (at 256, four 64 x 257 fp32 tiles), K2 reads V and
// K3 reads its own K and V rows through the L1 cache instead of staging
// them.

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

// the largest dynamic shared memory a block can use (227 KB)
constexpr size_t kMaxSmem = 232448;

struct Problem {
  int B, S, T, Hq, Hkv;
  float scale;
  float soft_cap;  // <= 0: none
  int causal;      // 0: none; 1: key index <= query index; 2: by position
  // <= 0: none; else kpos >= qpos - window + 1, and kpos <= qpos + window - 1
  // when causal == 0 (two-sided)
  int window;
  const int* q_seg;   // (B, S) or null
  const int* kv_seg;  // (B, T); null iff q_seg is
  // positions (B, S) / (B, T) and their ranges per kGran-row granule
  // (B, ceil(N / kGran), 2) [min, max]: set iff window > 0 or causal == 2
  const int* q_pos;
  const int* kv_pos;
  const int* q_rng;
  const int* kv_rng;
};

// rows per granule of the position ranges: K3's q tile; K1's and K2's q
// tiles and every kv tile are one or two granules
constexpr int kGran = 32;

struct PosRange {
  int lo, hi;
};

// min and max position of rows n0 .. n0 + rows - 1 (n0 a multiple of kGran)
// from the per-granule ranges
__device__ __forceinline__ PosRange pos_range(const int* __restrict__ rng,
                                              int b, int N, int n0, int rows) {
  const int ng = (N + kGran - 1) / kGran;
  const int g1 = min((n0 + rows + kGran - 1) / kGran, ng);
  PosRange r{0x7fffffff, -0x7fffffff - 1};
  for (int g = n0 / kGran; g < g1; ++g) {
    const int* e = rng + ((size_t)b * ng + g) * 2;
    r.lo = min(r.lo, e[0]);
    r.hi = max(r.hi, e[1]);
  }
  return r;
}

// whether the position masks (position-causal, window) allow a q position
// qp to see a kv position kp
__device__ __forceinline__ bool pos_ok(const Problem& p, int qp, int kp) {
  bool ok = p.causal != 2 || kp <= qp;
  if (p.window > 0) {
    ok = ok && (long long)kp >= (long long)qp - p.window + 1;
    if (p.causal == 0) ok = ok && (long long)kp <= (long long)qp + p.window - 1;
  }
  return ok;
}

// whether the position masks allow no pair of q positions in q and kv
// positions in k: the tile pair is skipped
__device__ __forceinline__ bool pos_empty(const Problem& p, PosRange q,
                                          PosRange k) {
  if (p.causal == 2 && k.lo > q.hi) return true;
  if (p.window > 0) {
    if ((long long)k.hi < (long long)q.lo - p.window + 1) return true;
    if (p.causal == 0 && (long long)k.lo > (long long)q.hi + p.window - 1)
      return true;
  }
  return false;
}

// whether the position masks allow every such pair: no per-element
// positional mask is needed
__device__ __forceinline__ bool pos_full(const Problem& p, PosRange q,
                                         PosRange k) {
  if (p.causal == 2 && k.hi > q.lo) return false;
  if (p.window > 0) {
    if ((long long)k.lo < (long long)q.hi - p.window + 1) return false;
    if (p.causal == 0 && (long long)k.hi > (long long)q.lo + p.window - 1)
      return false;
  }
  return true;
}

// the first t in [t0, n) with pred(t), or n; called by every lane of a warp,
// which tests 32 candidates at a time
template <typename F>
__device__ __forceinline__ int first_where(int t0, int n, F pred) {
  const int lane = threadIdx.x & 31;
  for (int base = t0; base < n; base += 32) {
    const int t = base + lane;
    const unsigned hit = __ballot_sync(0xffffffffu, t < n && pred(t));
    if (hit) return base + __ffs(hit) - 1;
  }
  return n;
}

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

// element c of row n of head h of a (B, N, H, D) tensor, read from device
// memory (through L1); 0 past N
template <typename T, int D>
__device__ __forceinline__ float row_elt(const T* __restrict__ src, int b,
                                         int n, int N, int H, int h, int c) {
  return n < N ? to_float(src[(((size_t)b * N + n) * H + h) * D + c]) : 0.f;
}

// segment ids or positions of rows n0 .. n0+63 (0 without them or past N)
__device__ __forceinline__ void load_ints(int* __restrict__ dst,
                                          const int* __restrict__ src, int b,
                                          int n0, int N) {
  if (threadIdx.x < kTile) {
    const int n = n0 + threadIdx.x;
    dst[threadIdx.x] = (src != nullptr && n < N) ? src[(size_t)b * N + n] : 0;
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
                                        int qseg, int kseg, int qpos,
                                        int kpos) {
  return qi < p.S && ki < p.T && (p.causal != 1 || ki <= qi) &&
         qseg == kseg && (p.q_pos == nullptr || pos_ok(p, qpos, kpos));
}

// kv tiles a q tile starting at q0 must visit: all of them, or up to the
// diagonal under index-causal masking (tiles the positions prove empty are
// skipped inside the loop)
__device__ __forceinline__ int kv_tiles(const Problem& p, int q0) {
  int n = (p.T + kTile - 1) / kTile;
  if (p.causal == 1) n = min(n, (min(q0 + kTile, p.S) - 1) / kTile + 1);
  return n;
}

// whether the positions prove the 64-row q tile at q0 and kv tile at k0 empty
__device__ __forceinline__ bool tile_skipped(const Problem& p, int b, int q0,
                                             int k0) {
  return p.q_pos != nullptr &&
         pos_empty(p, pos_range(p.q_rng, b, p.S, q0, kTile),
                   pos_range(p.kv_rng, b, p.T, k0, kTile));
}

// ---------------------------------------------------------------------------
// K1: forward
// ---------------------------------------------------------------------------
template <int DQK, int DV>
constexpr size_t fwd_smem() {
  // q, k, v tiles | probabilities | q and kv segment ids and positions
  return sizeof(float) * (kTile * (2 * (DQK + 1) + DV + 1) + kTile * kLdp) +
         sizeof(int) * 4 * kTile;
}

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out,
           float* __restrict__ lse, Problem p) {
  constexpr int LD = DQK + 1;
  constexpr int LDV = DV + 1;
  constexpr int NJ = DV / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTile * LD;
  float* v_s = k_s + kTile * LD;
  float* p_s = v_s + kTile * LDV;
  int* qseg_s = reinterpret_cast<int*>(p_s + kTile * kLdp);
  int* kseg_s = qseg_s + kTile;
  int* qpos_s = kseg_s + kTile;
  int* kpos_s = qpos_s + kTile;

  const int nq = (p.S + kTile - 1) / kTile;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, DQK>(q_s, q, b, q0, p.S, p.Hq, h);
  load_ints(qseg_s, p.q_seg, b, q0, p.S);
  load_ints(qpos_s, p.q_pos, b, q0, p.S);

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
    if (tile_skipped(p, b, q0, k0)) continue;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DQK>(k_s, k, b, k0, p.T, p.Hkv, hk);
    load_tile<T, DV>(v_s, v, b, k0, p.T, p.Hkv, hk);
    load_ints(kseg_s, p.kv_seg, b, k0, p.T);
    load_ints(kpos_s, p.kv_pos, b, k0, p.T);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DQK; ++d) {
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
        ok[j] = allowed(p, q0 + r, k0 + c, qseg_s[r], kseg_s[c], qpos_s[r],
                        kpos_s[c]);
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
      for (int j = 0; j < NJ; ++j) vv[j] = v_s[c * LDV + tx + 16 * j];
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
    T* o = out + (((size_t)b * p.S + qi) * p.Hq + h) * DV;
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
template <int DQK, int DV>
__host__ __device__ constexpr size_t dq_smem(bool stage_v) {
  // q, dO, k[, v] tiles | ds | lse, delta | q and kv segment ids, positions
  return sizeof(float) * (kTile * (2 * DQK + DV + 3) +
                          (stage_v ? kTile * (DV + 1) : 0) + kTile * kLdp +
                          2 * kTile) +
         sizeof(int) * 4 * kTile;
}
// the V tile is staged where it fits (not at 256: V is then read through L1)
template <int DQK, int DV>
__host__ __device__ constexpr bool dq_stage_v() { return dq_smem<DQK, DV>(true) <= kMaxSmem; }

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, Problem p) {
  constexpr int LD = DQK + 1;
  constexpr int LDV = DV + 1;
  constexpr int NJ = DQK / 16;
  constexpr bool kStageV = dq_stage_v<DQK, DV>();
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTile * LD;
  float* k_s = do_s + kTile * LDV;
  float* v_s = k_s + kTile * LD;
  float* ds_s = v_s + (kStageV ? kTile * LDV : 0);
  float* lse_s = ds_s + kTile * kLdp;
  float* delta_s = lse_s + kTile;
  int* qseg_s = reinterpret_cast<int*>(delta_s + kTile);
  int* kseg_s = qseg_s + kTile;
  int* qpos_s = kseg_s + kTile;
  int* kpos_s = qpos_s + kTile;

  const int nq = (p.S + kTile - 1) / kTile;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, DQK>(q_s, q, b, q0, p.S, p.Hq, h);
  load_tile<T, DV>(do_s, dout, b, q0, p.S, p.Hq, h);
  load_row_vec(lse_s, lse, b, h, p.Hq, q0, p.S);
  load_row_vec(delta_s, delta, b, h, p.Hq, q0, p.S);
  load_ints(qseg_s, p.q_seg, b, q0, p.S);
  load_ints(qpos_s, p.q_pos, b, q0, p.S);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int n_kv = kv_tiles(p, q0);
  for (int it = 0; it < n_kv; ++it) {
    const int k0 = it * kTile;
    if (tile_skipped(p, b, q0, k0)) continue;
    __syncthreads();
    load_tile<T, DQK>(k_s, k, b, k0, p.T, p.Hkv, hk);
    if (kStageV) load_tile<T, DV>(v_s, v, b, k0, p.T, p.Hkv, hk);
    load_ints(kseg_s, p.kv_seg, b, k0, p.T);
    load_ints(kpos_s, p.kv_pos, b, k0, p.T);
    __syncthreads();

    // S = Q K^T over DQK and dP = dO V^T over DV (DV <= DQK)
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DQK; ++d) {
      const bool dv_col = DV == DQK || d < DV;
      float a[4], o[4], c[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = q_s[(ty + 16 * i) * LD + d];
        o[i] = dv_col ? do_s[(ty + 16 * i) * LDV + d] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = k_s[(tx + 16 * j) * LD + d];
        if (!dv_col)
          w[j] = 0.f;
        else if (kStageV)
          w[j] = v_s[(tx + 16 * j) * LDV + d];
        else
          w[j] = row_elt<T, DV>(v, b, k0 + tx + 16 * j, p.T, p.Hkv, hk, d);
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
        const bool ok = allowed(p, q0 + r, k0 + c, qseg_s[r], kseg_s[c],
                                qpos_s[r], kpos_s[c]);
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
    T* o = dq + (((size_t)b * p.S + qi) * p.Hq + h) * DQK;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[tx + 16 * j] = from_float<T>(acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// K3: dk, dv
// ---------------------------------------------------------------------------
template <int DQK, int DV>
__host__ __device__ constexpr size_t dkv_smem(bool stage_kv) {
  // [k, v tiles] | q, dO tiles | p^T, ds^T | lse, delta | kv and q segment
  // ids, positions
  return sizeof(float) * ((stage_kv ? 2 : 1) * kTile * (DQK + DV + 2) +
                          2 * kTile * kLdp + 2 * kTile) +
         sizeof(int) * 4 * kTile;
}
// the block's own K and V rows are staged where they fit (not at 256: they
// are then read through L1)
template <int DQK, int DV>
__host__ __device__ constexpr bool dkv_stage_kv() { return dkv_smem<DQK, DV>(true) <= kMaxSmem; }

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, Problem p) {
  constexpr int LD = DQK + 1;
  constexpr int LDV = DV + 1;
  constexpr int NJ = DQK / 16;   // dK columns per thread
  constexpr int NJV = DV / 16;   // dV columns per thread
  constexpr bool kStageKV = dkv_stage_kv<DQK, DV>();
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * LD;
  float* q_s = kStageKV ? v_s + kTile * LDV : smem;
  float* do_s = q_s + kTile * LD;
  float* pt_s = do_s + kTile * LDV;
  float* dst_s = pt_s + kTile * kLdp;
  float* lse_s = dst_s + kTile * kLdp;
  float* delta_s = lse_s + kTile;
  int* kseg_s = reinterpret_cast<int*>(delta_s + kTile);
  int* qseg_s = kseg_s + kTile;
  int* kpos_s = qseg_s + kTile;
  int* qpos_s = kpos_s + kTile;

  const int k0 = blockIdx.x * kTile;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  const int tx = threadIdx.x & 15;  // q column of the transposed scores
  const int ty = threadIdx.x >> 4;  // kv row

  if (kStageKV) {
    load_tile<T, DQK>(k_s, k, b, k0, p.T, p.Hkv, hk);
    load_tile<T, DV>(v_s, v, b, k0, p.T, p.Hkv, hk);
  }
  load_ints(kseg_s, p.kv_seg, b, k0, p.T);
  load_ints(kpos_s, p.kv_pos, b, k0, p.T);

  float dk_acc[4][NJ], dv_acc[4][NJV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < NJV; ++j) dv_acc[i][j] = 0.f;
  }

  const int nq = (p.S + kTile - 1) / kTile;
  const int iq0 = p.causal == 1 ? k0 / kTile : 0;  // first q tile reaching k0
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int iq = iq0; iq < nq; ++iq) {
      const int q0 = iq * kTile;
      if (tile_skipped(p, b, q0, k0)) continue;
      __syncthreads();
      load_tile<T, DQK>(q_s, q, b, q0, p.S, p.Hq, h);
      load_tile<T, DV>(do_s, dout, b, q0, p.S, p.Hq, h);
      load_row_vec(lse_s, lse, b, h, p.Hq, q0, p.S);
      load_row_vec(delta_s, delta, b, h, p.Hq, q0, p.S);
      load_ints(qseg_s, p.q_seg, b, q0, p.S);
      load_ints(qpos_s, p.q_pos, b, q0, p.S);
      __syncthreads();

      // transposed scores: [i] kv row ty + 16 i, [j] q row tx + 16 j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DQK; ++d) {
        const bool dv_col = DV == DQK || d < DV;
        float kk[4], vv[4], a[4], o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + 16 * i;
          if (kStageKV) {
            kk[i] = k_s[r * LD + d];
            vv[i] = dv_col ? v_s[r * LDV + d] : 0.f;
          } else {
            kk[i] = row_elt<T, DQK>(k, b, k0 + r, p.T, p.Hkv, hk, d);
            vv[i] = dv_col ? row_elt<T, DV>(v, b, k0 + r, p.T, p.Hkv, hk, d)
                           : 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[j] = q_s[(tx + 16 * j) * LD + d];
          o[j] = dv_col ? do_s[(tx + 16 * j) * LDV + d] : 0.f;
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
          const bool ok = allowed(p, q0 + r, k0 + c, qseg_s[r], kseg_s[c],
                                  qpos_s[r], kpos_s[c]);
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
        float pr[4], g_[4], o[NJV], a[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pr[i] = pt_s[(ty + 16 * i) * kLdp + r];
          g_[i] = dst_s[(ty + 16 * i) * kLdp + r];
        }
#pragma unroll
        for (int j = 0; j < NJV; ++j) o[j] = do_s[r * LDV + tx + 16 * j];
#pragma unroll
        for (int j = 0; j < NJ; ++j) a[j] = q_s[r * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < NJV; ++j)
            dv_acc[i][j] = fmaf(pr[i], o[j], dv_acc[i][j]);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            dk_acc[i][j] = fmaf(g_[i], a[j], dk_acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ki = k0 + ty + 16 * i;
    if (ki >= p.T) continue;
    const size_t row = ((size_t)b * p.T + ki) * p.Hkv + hk;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dk[row * DQK + tx + 16 * j] = from_float<T>(dk_acc[i][j]);
#pragma unroll
    for (int j = 0; j < NJV; ++j)
      dv[row * DV + tx + 16 * j] = from_float<T>(dv_acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// bf16 K1-K3 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarpRows = 16;                  // rows of one warp's mma tiles
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kFwdM = kWarpRows * kMmaWarps;   // K1, K2: q rows per block
constexpr int kDkvN = kWarpRows * kMmaWarps;   // K3: kv rows per block
constexpr int kDkvM = 32;                      // K3: q rows per stage
constexpr int kRing = 3;  // K1's operand fragments in flight per warp

// K1's and K2's kv rows per stage: 64, or 32 at a q/k head dim past 192,
// where 16 x 256 accumulators leave no registers for wider scores
template <int DQK>
__host__ __device__ constexpr int fwd_kv_rows() { return DQK > 192 ? 32 : 64; }

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
// swizzled tile with cp.async by NT threads; rows past N are zero-filled
template <int D, int R, int NT = kMmaThreads>
__device__ __forceinline__ void load_tile_async(bf16* dst,
                                                const bf16* __restrict__ src,
                                                int b, int n0, int N, int H,
                                                int h) {
  constexpr int C = D / 8;
  for (int i = threadIdx.x; i < R * C; i += NT) {
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
template <int DQK, int DV>
constexpr size_t fwd_mma_smem() {
  constexpr int N = fwd_kv_rows<DQK>();
  // q tile | k, v tiles x 2 stages (bf16) | q segment ids and positions |
  // kv ids and positions x 2
  return sizeof(bf16) * (kFwdM * DQK + 2 * N * (DQK + DV)) +
         sizeof(int) * 2 * (kFwdM + 2 * N);
}

template <int DQK, int DV, bool kPos>
__global__ void __launch_bounds__(kMmaThreads, 2)
fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out,
               float* __restrict__ lse, Problem p) {
  using Tile = SwzTile<DQK>;   // Q and K tiles
  using TileV = SwzTile<DV>;   // V tiles
  constexpr int BN = fwd_kv_rows<DQK>();
  constexpr int KD = DQK / 16;  // k-steps of Q.K^T over the qk head dim
  constexpr int ND = DV / 8;    // n-tiles of P.V over the v head dim
  constexpr int NS = BN / 8;
  // fragments of one tile's products, each feeding two mma, loaded kRing - 1
  // ahead of their use so that ldmatrix latency hides behind the products
  constexpr int NK = KD * (NS / 2);  // K fragments (b_addr)
  constexpr int NV = (NS / 2) * (ND / 2);  // V fragments (.trans)
  // Q fragments in registers for the whole kv loop up to DQK 192; past it
  // the O accumulators (ND x 4) leave no room, and Q is re-read from the
  // shared Q tile per k-step
  constexpr bool kQInRegs = DQK <= 192;
  static_assert(NK >= kRing - 1 && NV >= kRing - 1, "ring deeper than a tile");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kFwdM * DQK;
  bf16* v_s = k_s + 2 * BN * DQK;
  int* qseg_s = reinterpret_cast<int*>(v_s + 2 * BN * DV);
  int* kseg_s = qseg_s + kFwdM;
  int* qpos_s = kseg_s + 2 * BN;
  int* kpos_s = qpos_s + kFwdM;

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
  constexpr bool posm = kPos;  // positions read (window or causal 2)

  int n_kv = (p.T + BN - 1) / BN;
  if (p.causal == 1) n_kv = min(n_kv, (min(q0 + kFwdM, p.S) - 1) / BN + 1);
  PosRange q_rng{0, 0};
  if (posm) q_rng = pos_range(p.q_rng, b, p.S, q0, kFwdM);
  // the first kv tile from u on whose positions can meet this q tile's
  auto next_kv = [&](int u) {
    if (!posm) return u;
    return first_where(u, n_kv, [&](int w) {
      return !pos_empty(p, q_rng, pos_range(p.kv_rng, b, p.T, w * BN, BN));
    });
  };

  auto load_kv = [&](int st, int kt) {
    load_tile_async<DQK, BN>(k_s + st * BN * DQK, k, b, kt * BN, p.T, p.Hkv,
                             hk);
    load_tile_async<DV, BN>(v_s + st * BN * DV, v, b, kt * BN, p.T, p.Hkv, hk);
    if (segs)
      load_vec_async<BN>(kseg_s + st * BN, p.kv_seg, (size_t)b * p.T, kt * BN,
                         p.T, 0);
    if (posm)
      load_vec_async<BN>(kpos_s + st * BN, p.kv_pos, (size_t)b * p.T, kt * BN,
                         p.T, BN);
  };
  int kt = next_kv(0);
  load_tile_async<DQK, kFwdM>(q_s, q, b, q0, p.S, p.Hq, h);
  if (segs) load_vec_async<kFwdM>(qseg_s, p.q_seg, (size_t)b * p.S, q0, p.S, 0);
  if (posm)
    load_vec_async<kFwdM>(qpos_s, p.q_pos, (size_t)b * p.S, q0, p.S, kFwdM);
  if (kt < n_kv) load_kv(0, kt);
  cp_async_commit();

  uint32_t qf[kQInRegs ? KD : 2][4];
  auto q_frag = [&](int kk) -> uint32_t (&)[4] {
    return qf[kQInRegs ? kk : (kk & 1)];
  };
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

  for (int it = 0; kt < n_kv; ++it) {
    const int st = it & 1;
    const int k0 = kt * BN;
    const int kt_next = next_kv(kt + 1);
    cp_async_wait<0>();
    // tile kt has landed for every thread, and every warp is done with the
    // previous tile, whose stage the next copy refills
    __syncthreads();
    if (kt_next < n_kv) {
      load_kv(st ^ 1, kt_next);  // overlaps this tile's products
      cp_async_commit();
    }
    if (it == 0) {
      if (kQInRegs) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          ldsm_x4(q_frag(kk), Tile::a_addr(q_s, r0, kk * 16, lane));
      }
      if (segs) {
        const int s = qseg_s[r0 + (lane & 15)];
        q_val = __shfl_sync(0xffffffffu, s, 0);
        q_uniform = __all_sync(0xffffffffu, s == q_val);
      }
    }
    const bf16* ks = k_s + st * BN * DQK;
    const bf16* vs = v_s + st * BN * DV;
    const int* kseg = kseg_s + st * BN;
    const int* kpos = kpos_s + st * BN;
    auto k_frag = [&](int i, uint32_t (&r)[4]) {
      ldsm_x4(r, Tile::b_addr(ks, (i % (NS / 2)) * 16, (i / (NS / 2)) * 16,
                              lane));
    };
    auto v_frag = [&](int i, uint32_t (&r)[4]) {
      ldsm_x4_trans(r, TileV::a_addr(vs, (i / (ND / 2)) * 16,
                                      (i % (ND / 2)) * 16, lane));
    };

    // S = Q K^T: 16 rows x BN keys per warp
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    uint32_t fr[kRing][4];
#pragma unroll
    for (int i = 0; i < kRing - 1; ++i) k_frag(i, fr[i]);
    if (!kQInRegs) ldsm_x4(q_frag(0), Tile::a_addr(q_s, r0, 0, lane));
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      if (i + kRing - 1 < NK)
        k_frag(i + kRing - 1, fr[(i + kRing - 1) % kRing]);
      const int kk = i / (NS / 2), np = i % (NS / 2);
      // past DQK 192 the next k-step's Q fragment loads a k-step ahead
      if (!kQInRegs && np == 0 && kk + 1 < KD)
        ldsm_x4(q_frag(kk + 1), Tile::a_addr(q_s, r0, (kk + 1) * 16, lane));
      mma_bf16(s[2 * np], q_frag(kk), fr[i % kRing][0], fr[i % kRing][1]);
      mma_bf16(s[2 * np + 1], q_frag(kk), fr[i % kRing][2], fr[i % kRing][3]);
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
    // diagonal, the ragged kv edge, a window or position-causal edge,
    // segment ids that vary. A masked score is -inf, so its probability is
    // exactly 0, while the running max starts at (and a fully masked row
    // keeps) the Pallas NEG_INF.
    bool need_mask = k0 + BN > p.T ||
                     (p.causal == 1 && k0 + BN - 1 > q0 + r0);
    if (posm && !need_mask)
      need_mask = !pos_full(p, q_rng, pos_range(p.kv_rng, b, p.T, k0, BN));
    if (segs && !need_mask) {
      bool same = q_uniform;
      for (int c = lane; c < BN; c += 32) same = same && kseg[c] == q_val;
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
          bool ok = qi < p.S && ki < p.T && (p.causal != 1 || ki <= qi);
          if (segs) ok = ok && qseg_s[qr] == kseg[kc];
          if (posm) ok = ok && pos_ok(p, qpos_s[qr], kpos[kc]);
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
    kt = kt_next;
  }
  cp_async_wait<0>();  // nothing in flight at exit, also when no tile ran

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float sum = quad_sum(l[i]);
    const int qi = q0 + r0 + g + 8 * i;
    if (qi >= p.S) continue;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    bf16* orow = out + (((size_t)b * p.S + qi) * p.Hq + h) * DV;
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
// At DQK = DV >= 256 a kv tile's work is split between two warp groups (see
// the header): 8 warps instead of 4
template <int DQK, int DV>
__host__ __device__ constexpr bool dkv_split() { return DQK == DV && DQK >= 256; }
template <int DQK, int DV>
__host__ __device__ constexpr int dkv_threads() {
  return dkv_split<DQK, DV>() ? 2 * kMmaThreads : kMmaThreads;
}

template <int DQK, int DV>
constexpr size_t dkv_mma_smem() {
  // k, v tiles | q, dO tiles x 2 stages (bf16) | lse, delta, q segment ids,
  // q positions x 2 stages | kv segment ids, kv positions | split: the
  // hand-over of P^T (1 - t^2) scale, fp32
  return sizeof(bf16) * (kDkvN + 2 * kDkvM) * (DQK + DV) +
         sizeof(float) * (8 * kDkvM + 2 * kDkvN) +
         (dkv_split<DQK, DV>() ? sizeof(float) * kDkvN * kDkvM : 0);
}

template <int DQK, int DV, bool kPos>
__global__ void __launch_bounds__(dkv_threads<DQK, DV>(),
                                  dkv_split<DQK, DV>() ? 1 : 2)
dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, Problem p) {
  static_assert(DV <= DQK, "the v head dim is at most the qk head dim");
  constexpr bool kSplit = dkv_split<DQK, DV>();
  constexpr int NT = dkv_threads<DQK, DV>();
  using Tile = SwzTile<DQK>;   // K and Q tiles
  using TileV = SwzTile<DV>;   // V and dO tiles
  constexpr int KD = DQK / 16;   // k-steps of K.Q^T
  constexpr int KDV = DV / 16;   // k-steps of V.dO^T (the first KDV of KD)
  constexpr int ND = DQK / 8;    // n-tiles of dK
  constexpr int NDV = DV / 8;    // n-tiles of dV (the first NDV of ND)
  constexpr int NS = kDkvM / 8;  // n-tiles of the transposed scores
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kDkvN * DQK;
  bf16* q_s = v_s + kDkvN * DV;        // two stages
  bf16* do_s = q_s + 2 * kDkvM * DQK;  // two stages
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kDkvM * DV);
  float* delta_s = lse_s + 2 * kDkvM;
  int* qseg_s = reinterpret_cast<int*>(delta_s + 2 * kDkvM);
  int* qpos_s = qseg_s + 2 * kDkvM;
  int* kseg_s = qpos_s + 2 * kDkvM;
  int* kpos_s = kseg_s + kDkvN;
  float* hand_s = reinterpret_cast<float*>(kpos_s + kDkvN);  // split only

  // block -> (kv tile, kv head, batch); under causal masking the first kv
  // tiles see the most q rows, and they come first for every head
  const int heads = p.Hkv * p.B;
  const int k0 = (int)(blockIdx.x / heads) * kDkvN;
  const int hk = (int)(blockIdx.x % heads) % p.Hkv;
  const int b = (int)(blockIdx.x % heads) / p.Hkv;
  const int G = p.Hq / p.Hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = (warp % kMmaWarps) * kWarpRows;  // the warp's first kv row
  // split: 0 computes S^T, P^T and dV, 1 dP^T, dS^T and dK
  const int role = kSplit ? warp / kMmaWarps : 0;
  const int g = lane >> 2, t = lane & 3;
  const bool segs = p.q_seg != nullptr;
  constexpr bool posm = kPos;  // positions read (window or causal 2)

  // the steps: every q tile of every head of the group that can reach this
  // kv tile, from the first q tile at the diagonal under index-causal
  // masking, those the positions prove empty skipped
  const int nq = (p.S + kDkvM - 1) / kDkvM;
  const int iq0 = p.causal == 1 ? min(k0 / kDkvM, nq) : 0;
  PosRange kv_rng{0, 0};
  if (posm) kv_rng = pos_range(p.kv_rng, b, p.T, k0, kDkvN);
  auto next_q = [&](int u) {
    if (!posm) return u;
    return first_where(u, nq, [&](int w) {
      return !pos_empty(p, pos_range(p.q_rng, b, p.S, w * kDkvM, kDkvM),
                        kv_rng);
    });
  };
  const int first = next_q(iq0);

  auto load_step = [&](int st, int gi, int iq) {
    const int h = hk * G + gi;
    const int q0 = iq * kDkvM;
    load_tile_async<DQK, kDkvM, NT>(q_s + st * kDkvM * DQK, q, b, q0, p.S,
                                    p.Hq, h);
    load_tile_async<DV, kDkvM, NT>(do_s + st * kDkvM * DV, dout, b, q0, p.S,
                                   p.Hq, h);
    const size_t row = ((size_t)b * p.Hq + h) * p.S;
    load_vec_async<kDkvM>(lse_s + st * kDkvM, lse, row, q0, p.S, 0);
    load_vec_async<kDkvM>(delta_s + st * kDkvM, delta, row, q0, p.S, kDkvM);
    if (segs)
      load_vec_async<kDkvM>(qseg_s + st * kDkvM, p.q_seg, (size_t)b * p.S, q0,
                            p.S, 2 * kDkvM);
    if (posm)
      load_vec_async<kDkvM>(qpos_s + st * kDkvM, p.q_pos, (size_t)b * p.S, q0,
                            p.S, 3 * kDkvM);
  };
  load_tile_async<DQK, kDkvN, NT>(k_s, k, b, k0, p.T, p.Hkv, hk);
  load_tile_async<DV, kDkvN, NT>(v_s, v, b, k0, p.T, p.Hkv, hk);
  if (segs)
    load_vec_async<kDkvN>(kseg_s, p.kv_seg, (size_t)b * p.T, k0, p.T, 0);
  if (posm)
    load_vec_async<kDkvN>(kpos_s, p.kv_pos, (size_t)b * p.T, k0, p.T, kDkvN);
  if (first < nq) load_step(0, 0, first);
  cp_async_commit();

  // the unsplit kernel's dK (split: dV for role 0, dK for role 1) and dV
  float acc[ND][4], dv_acc[kSplit ? 1 : NDV][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < (kSplit ? 1 : NDV); ++j) dv_acc[j][e] = 0.f;
  }
  int k_val = 0;
  bool k_uniform = true;

  int gi = first < nq ? 0 : G, iq = first;
  for (int i = 0; gi < G; ++i) {
    const int st = i & 1;
    const int q0 = iq * kDkvM;
    int gi_next = gi, iq_next = next_q(iq + 1);
    if (iq_next >= nq) {
      ++gi_next;
      iq_next = first;
    }
    cp_async_wait<0>();
    // step i has landed for every thread, and every warp is done with step
    // i - 1, whose stage the next copy refills
    __syncthreads();
    if (gi_next < G) {
      load_step(st ^ 1, gi_next, iq_next);  // overlaps this step's products
      cp_async_commit();
    }
    if (i == 0 && segs) {
      const int s = kseg_s[r0 + (lane & 15)];
      k_val = __shfl_sync(0xffffffffu, s, 0);
      k_uniform = __all_sync(0xffffffffu, s == k_val);
    }
    const bf16* qs = q_s + st * kDkvM * DQK;
    const bf16* dos = do_s + st * kDkvM * DV;
    const float* lse_c = lse_s + st * kDkvM;
    const float* delta_c = delta_s + st * kDkvM;
    const int* qseg = qseg_s + st * kDkvM;
    const int* qpos = qpos_s + st * kDkvM;

    // per-element masks only where the step needs them: the causal
    // diagonal, ragged edges, window and position-causal edges, segment ids
    // that vary
    bool need_mask = q0 + kDkvM > p.S || k0 + kDkvN > p.T ||
                     (p.causal == 1 && k0 + r0 + kWarpRows - 1 > q0);
    if (posm && !need_mask)
      need_mask = !pos_full(p, pos_range(p.q_rng, b, p.S, q0, kDkvM), kv_rng);
    if (segs && !need_mask)
      need_mask = !(k_uniform && __all_sync(0xffffffffu, qseg[lane] == k_val));
    // zeroes the masked entries of P^T (and dS^T) in fragment order
    auto apply_mask = [&](float (&pt)[NS][4], float (&dst)[NS][4]) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = j * 8 + 2 * t + (e & 1);
          const int kr = r0 + g + (e >> 1) * 8;
          const int qi = q0 + qc;
          const int ki = k0 + kr;
          bool ok = qi < p.S && ki < p.T && (p.causal != 1 || ki <= qi);
          if (segs) ok = ok && qseg[qc] == kseg_s[kr];
          if (posm) ok = ok && pos_ok(p, qpos[qc], kpos_s[kr]);
          if (!ok) pt[j][e] = dst[j][e] = 0.f;
        }
    };

    if constexpr (kSplit) {
      // role 0: S^T = K Q^T; role 1: dP^T = V dO^T (DV == DQK): the warp's
      // 16 kv rows by the step's 32 q columns, operands one step ahead
      const bf16* at = role ? v_s : k_s;
      const bf16* bt = role ? dos : qs;
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      uint32_t af[2][4], bf[2][4];
      ldsm_x4(af[0], Tile::a_addr(at, r0, 0, lane));
      ldsm_x4(bf[0], Tile::b_addr(bt, 0, 0, lane));
#pragma unroll
      for (int i2 = 0; i2 < KD * (NS / 2); ++i2) {
        if (i2 + 1 < KD * (NS / 2)) {
          const int kk1 = (i2 + 1) / (NS / 2), np1 = (i2 + 1) % (NS / 2);
          if (np1 == 0) ldsm_x4(af[kk1 & 1], Tile::a_addr(at, r0, kk1 * 16, lane));
          ldsm_x4(bf[(i2 + 1) & 1], Tile::b_addr(bt, np1 * 16, kk1 * 16, lane));
        }
        const int kk = i2 / (NS / 2), np = i2 % (NS / 2);
        mma_bf16(s[2 * np], af[kk & 1], bf[i2 & 1][0], bf[i2 & 1][1]);
        mma_bf16(s[2 * np + 1], af[kk & 1], bf[i2 & 1][2], bf[i2 & 1][3]);
      }
      // this row group's hand-over buffer, in fragment order (conflict-free)
      float* hand = hand_s + (warp % kMmaWarps) * (NS * 4 * 32);
      if (role == 0) {
        // P^T = exp(S^T - lse), and P^T (1 - t^2) scale for role 1
        float pt[NS][4];
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
            pt[j][e] = pr * cap_grad * p.scale;
          }
        if (need_mask) apply_mask(s, pt);
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) hand[(j * 4 + e) * 32 + lane] = pt[j][e];
      }
      __syncthreads();
      if (role == 1) {
        // dS^T = P^T (1 - t^2) scale (dP^T - delta); 0 where P^T is masked
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = j * 8 + 2 * t + (e & 1);
            s[j][e] = hand[(j * 4 + e) * 32 + lane] * (s[j][e] - delta_c[qc]);
          }
      }
      // role 0: dV += P^T dO; role 1: dK += dS^T Q; the operand rounded to
      // bf16 in registers, dO / Q through ldmatrix.trans
      uint32_t xa[NS / 2][4];
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) acc_to_a(xa[kk], s[2 * kk], s[2 * kk + 1]);
      const bf16* tt = role ? qs : dos;
      uint32_t tf[2][4];
      ldsm_x4_trans(tf[0], Tile::a_addr(tt, 0, 0, lane));
#pragma unroll
      for (int i2 = 0; i2 < (NS / 2) * (ND / 2); ++i2) {
        if (i2 + 1 < (NS / 2) * (ND / 2)) {
          const int kk1 = (i2 + 1) / (ND / 2), dd1 = (i2 + 1) % (ND / 2);
          ldsm_x4_trans(tf[(i2 + 1) & 1], Tile::a_addr(tt, kk1 * 16, dd1 * 16, lane));
        }
        const int kk = i2 / (ND / 2), dd = i2 % (ND / 2);
        mma_bf16(acc[2 * dd], xa[kk], tf[i2 & 1][0], tf[i2 & 1][1]);
        mma_bf16(acc[2 * dd + 1], xa[kk], tf[i2 & 1][2], tf[i2 & 1][3]);
      }
    } else {
      // transposed scores S^T = K Q^T over DQK and dP^T = V dO^T over DV:
      // the warp's 16 kv rows by the step's 32 q columns
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      // operands one (kk, np) step ahead of their products: K and V rows as
      // A, Q and dO rows as B; the V and dO operands only for the k-steps
      // within DV
      auto a_frags = [&](int kk, uint32_t (&ka)[4], uint32_t (&va)[4]) {
        ldsm_x4(ka, Tile::a_addr(k_s, r0, kk * 16, lane));
        if (kk < KDV) ldsm_x4(va, TileV::a_addr(v_s, r0, kk * 16, lane));
      };
      auto b_frags = [&](int i2, uint32_t (&bq)[4], uint32_t (&bo)[4]) {
        const int kk = i2 / (NS / 2), np = i2 % (NS / 2);
        ldsm_x4(bq, Tile::b_addr(qs, np * 16, kk * 16, lane));
        if (kk < KDV) ldsm_x4(bo, TileV::b_addr(dos, np * 16, kk * 16, lane));
      };
      // dV's dO operand for the n-tiles within DV, dK's Q operand for all
      auto t_frags = [&](int i2, uint32_t (&bo)[4], uint32_t (&bq)[4]) {
        const int kk = i2 / (ND / 2), dd = i2 % (ND / 2);
        if (dd < NDV / 2)
          ldsm_x4_trans(bo, TileV::a_addr(dos, kk * 16, dd * 16, lane));
        ldsm_x4_trans(bq, Tile::a_addr(qs, kk * 16, dd * 16, lane));
      };
      uint32_t ka[2][4], va[2][4], bq[2][4], bo[2][4];
      a_frags(0, ka[0], va[0]);
      b_frags(0, bq[0], bo[0]);
#pragma unroll
      for (int i2 = 0; i2 < KD * (NS / 2); ++i2) {
        if (i2 + 1 < KD * (NS / 2)) {
          const int kk1 = (i2 + 1) / (NS / 2);
          if ((i2 + 1) % (NS / 2) == 0) a_frags(kk1, ka[kk1 & 1], va[kk1 & 1]);
          b_frags(i2 + 1, bq[(i2 + 1) & 1], bo[(i2 + 1) & 1]);
        }
        const int kk = i2 / (NS / 2), np = i2 % (NS / 2);
        mma_bf16(s[2 * np], ka[kk & 1], bq[i2 & 1][0], bq[i2 & 1][1]);
        mma_bf16(s[2 * np + 1], ka[kk & 1], bq[i2 & 1][2], bq[i2 & 1][3]);
        if (kk < KDV) {
          mma_bf16(dp[2 * np], va[kk & 1], bo[i2 & 1][0], bo[i2 & 1][1]);
          mma_bf16(dp[2 * np + 1], va[kk & 1], bo[i2 & 1][2], bo[i2 & 1][3]);
        }
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
      if (need_mask) apply_mask(s, dp);

      // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16 in
      // registers; dO and Q through ldmatrix.trans
      uint32_t pa[NS / 2][4], da[NS / 2][4];
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        acc_to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
        acc_to_a(da[kk], dp[2 * kk], dp[2 * kk + 1]);
      }
#pragma unroll
      for (int i2 = 0; i2 < (NS / 2) * (ND / 2); ++i2) {
        if (i2 + 1 < (NS / 2) * (ND / 2))
          t_frags(i2 + 1, bo[(i2 + 1) & 1], bq[(i2 + 1) & 1]);
        const int kk = i2 / (ND / 2), dd = i2 % (ND / 2);
        if (dd < NDV / 2) {
          mma_bf16(dv_acc[2 * dd], pa[kk], bo[i2 & 1][0], bo[i2 & 1][1]);
          mma_bf16(dv_acc[2 * dd + 1], pa[kk], bo[i2 & 1][2], bo[i2 & 1][3]);
        }
        mma_bf16(acc[2 * dd], da[kk], bq[i2 & 1][0], bq[i2 & 1][1]);
        mma_bf16(acc[2 * dd + 1], da[kk], bq[i2 & 1][2], bq[i2 & 1][3]);
      }
    }
    gi = gi_next;
    iq = iq_next;
  }
  cp_async_wait<0>();  // nothing in flight at exit, also when no step ran

  // split: role 0 holds dV, role 1 dK; unsplit: acc is dK
  bf16* dkv_out = kSplit && role == 0 ? dv : dk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int ki = k0 + r0 + g + 8 * i;
    if (ki >= p.T) continue;
    const size_t row = ((size_t)b * p.T + ki) * p.Hkv + hk;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dkv_out + row * DQK + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * i], acc[j][2 * i + 1]);
    if (!kSplit) {
#pragma unroll
      for (int j = 0; j < (kSplit ? 1 : NDV); ++j)
        *reinterpret_cast<__nv_bfloat162*>(dv + row * DV + j * 8 + 2 * t) =
            __floats2bfloat162_rn(dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K2 (bf16): dq on the tensor cores
// ---------------------------------------------------------------------------
template <int DQK, int DV>
constexpr size_t dq_mma_smem() {
  constexpr int N = fwd_kv_rows<DQK>();
  // q, dO tiles | k, v tiles x 2 stages (bf16) | q segment ids and
  // positions | kv ids and positions x 2
  return sizeof(bf16) * (kFwdM + 2 * N) * (DQK + DV) +
         sizeof(int) * 2 * (kFwdM + 2 * N);
}

template <int DQK, int DV, bool kPos>
__global__ void __launch_bounds__(kMmaThreads, 2)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, Problem p) {
  static_assert(DV <= DQK, "the v head dim is at most the qk head dim");
  using Tile = SwzTile<DQK>;   // Q and K tiles
  using TileV = SwzTile<DV>;   // dO and V tiles
  constexpr int BN = fwd_kv_rows<DQK>();
  constexpr int KD = DQK / 16;  // k-steps of Q.K^T
  constexpr int KDV = DV / 16;  // k-steps of dO.V^T (the first KDV of KD)
  constexpr int ND = DQK / 8;   // n-tiles of dS.K
  constexpr int NS = BN / 8;
  constexpr int NK = KD * (NS / 2);        // steps of the two score products
  constexpr int NQ = (NS / 2) * (ND / 2);  // steps of dS.K
  // Q fragments in registers for the whole kv loop up to DQK 128; past it
  // the dQ accumulators (ND x 4) leave no room, and Q is re-read from the
  // shared Q tile per k-step, as dO is
  constexpr bool kQInRegs = DQK <= 128;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kFwdM * DQK;
  bf16* k_s = do_s + kFwdM * DV;
  bf16* v_s = k_s + 2 * BN * DQK;
  int* qseg_s = reinterpret_cast<int*>(v_s + 2 * BN * DV);
  int* kseg_s = qseg_s + kFwdM;
  int* qpos_s = kseg_s + 2 * BN;
  int* kpos_s = qpos_s + kFwdM;

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
  constexpr bool posm = kPos;  // positions read (window or causal 2)

  int n_kv = (p.T + BN - 1) / BN;
  if (p.causal == 1) n_kv = min(n_kv, (min(q0 + kFwdM, p.S) - 1) / BN + 1);
  PosRange q_rng{0, 0};
  if (posm) q_rng = pos_range(p.q_rng, b, p.S, q0, kFwdM);
  // the first kv tile from u on whose positions can meet this q tile's
  auto next_kv = [&](int u) {
    if (!posm) return u;
    return first_where(u, n_kv, [&](int w) {
      return !pos_empty(p, q_rng, pos_range(p.kv_rng, b, p.T, w * BN, BN));
    });
  };

  auto load_kv = [&](int st, int kt) {
    load_tile_async<DQK, BN>(k_s + st * BN * DQK, k, b, kt * BN, p.T, p.Hkv,
                             hk);
    load_tile_async<DV, BN>(v_s + st * BN * DV, v, b, kt * BN, p.T, p.Hkv, hk);
    if (segs)
      load_vec_async<BN>(kseg_s + st * BN, p.kv_seg, (size_t)b * p.T, kt * BN,
                         p.T, 0);
    if (posm)
      load_vec_async<BN>(kpos_s + st * BN, p.kv_pos, (size_t)b * p.T, kt * BN,
                         p.T, BN);
  };
  int kt = next_kv(0);
  load_tile_async<DQK, kFwdM>(q_s, q, b, q0, p.S, p.Hq, h);
  load_tile_async<DV, kFwdM>(do_s, dout, b, q0, p.S, p.Hq, h);
  if (segs) load_vec_async<kFwdM>(qseg_s, p.q_seg, (size_t)b * p.S, q0, p.S, 0);
  if (posm)
    load_vec_async<kFwdM>(qpos_s, p.q_pos, (size_t)b * p.S, q0, p.S, kFwdM);
  if (kt < n_kv) load_kv(0, kt);
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
  uint32_t qf[kQInRegs ? KD : 2][4];
  auto q_frag = [&](int kk) -> uint32_t (&)[4] {
    return qf[kQInRegs ? kk : (kk & 1)];
  };
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  int q_val = 0;
  bool q_uniform = true;
  const float scale_log2e = p.scale * kLog2e;

  for (int it = 0; kt < n_kv; ++it) {
    const int st = it & 1;
    const int k0 = kt * BN;
    const int kt_next = next_kv(kt + 1);
    cp_async_wait<0>();
    // tile kt has landed for every thread, and every warp is done with the
    // previous tile, whose stage the next copy refills
    __syncthreads();
    if (kt_next < n_kv) {
      load_kv(st ^ 1, kt_next);  // overlaps this tile's products
      cp_async_commit();
    }
    if (it == 0) {
      if (kQInRegs) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          ldsm_x4(q_frag(kk), Tile::a_addr(q_s, r0, kk * 16, lane));
      }
      if (segs) {
        const int s = qseg_s[r0 + (lane & 15)];
        q_val = __shfl_sync(0xffffffffu, s, 0);
        q_uniform = __all_sync(0xffffffffu, s == q_val);
      }
    }
    const bf16* ks = k_s + st * BN * DQK;
    const bf16* vs = v_s + st * BN * DV;
    const int* kseg = kseg_s + st * BN;
    const int* kpos = kpos_s + st * BN;

    // S = Q K^T over DQK and dP = dO V^T over DV, 16 rows x BN keys per
    // warp; operands one step ahead of their products (dO fragments, and
    // past DQK 128 the Q fragments, re-read from shared memory: kept in
    // registers beside dQ, S and dP they would spill)
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    uint32_t kb[2][4], vb[2][4], of[2][4];
    auto row_frags = [&](int kk) {  // this warp's Q and dO rows at k-step kk
      if (!kQInRegs) ldsm_x4(q_frag(kk), Tile::a_addr(q_s, r0, kk * 16, lane));
      if (kk < KDV) ldsm_x4(of[kk & 1], TileV::a_addr(do_s, r0, kk * 16, lane));
    };
    auto kv_frags = [&](int i, uint32_t (&kb)[4], uint32_t (&vb)[4]) {
      const int kk = i / (NS / 2), np = i % (NS / 2);
      ldsm_x4(kb, Tile::b_addr(ks, np * 16, kk * 16, lane));
      if (kk < KDV) ldsm_x4(vb, TileV::b_addr(vs, np * 16, kk * 16, lane));
    };
    row_frags(0);
    kv_frags(0, kb[0], vb[0]);
#pragma unroll
    for (int i = 0; i < NK; ++i) {
      if (i + 1 < NK) {
        if ((i + 1) % (NS / 2) == 0) row_frags((i + 1) / (NS / 2));
        kv_frags(i + 1, kb[(i + 1) & 1], vb[(i + 1) & 1]);
      }
      const int kk = i / (NS / 2), np = i % (NS / 2);
      mma_bf16(s[2 * np], q_frag(kk), kb[i & 1][0], kb[i & 1][1]);
      mma_bf16(s[2 * np + 1], q_frag(kk), kb[i & 1][2], kb[i & 1][3]);
      if (kk < KDV) {
        mma_bf16(dp[2 * np], of[kk & 1], vb[i & 1][0], vb[i & 1][1]);
        mma_bf16(dp[2 * np + 1], of[kk & 1], vb[i & 1][2], vb[i & 1][3]);
      }
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
    bool need_mask = k0 + BN > p.T ||
                     (p.causal == 1 && k0 + BN - 1 > q0 + r0);
    if (posm && !need_mask)
      need_mask = !pos_full(p, q_rng, pos_range(p.kv_rng, b, p.T, k0, BN));
    if (segs && !need_mask) {
      bool same = q_uniform;
      for (int c = lane; c < BN; c += 32) same = same && kseg[c] == q_val;
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
          bool ok = qi < p.S && ki < p.T && (p.causal != 1 || ki <= qi);
          if (segs) ok = ok && qseg_s[qr] == kseg[kc];
          if (posm) ok = ok && pos_ok(p, qpos_s[qr], kpos[kc]);
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
    kt = kt_next;
  }
  cp_async_wait<0>();  // nothing in flight at exit, also when no tile ran

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + g + 8 * i;
    if (qi >= p.S) continue;
    bf16* row = dq + (((size_t)b * p.S + qi) * p.Hq + h) * DQK;
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

// Launches issued without error since the counters were last reset (or the
// library loaded), by kernel (fa_smem_bytes's codes: K1, K3, K2 on the
// tensor cores, then on the CUDA cores) and head-dim pair (with_head_dims's
// order); fa_launch_counts reads them and fa_reset_launch_counts resets them.
constexpr int kCountedKernels = 6, kCountedPairs = 5;
long long g_launches[kCountedKernels][kCountedPairs];
enum { kFwdMma = 0, kDkvMma = 1, kDqMma = 2, kFwdFma = 3, kDkvFma = 4, kDqFma = 5 };

template <int DQK, int DV>
constexpr int pair_index() {
  return DQK == 16 ? 0 : DQK == 64 ? 1 : DQK == 128 ? 2 : DQK == 192 ? 3 : 4;
}

// the launch's error, counting it as kernel `which` when there is none
template <int DQK, int DV>
int counted(int which) {
  const int e = (int)cudaGetLastError();
  if (e == 0) ++g_launches[which][pair_index<DQK, DV>()];
  return e;
}

template <typename T, int DQK, int DV>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, const Problem& p, cudaStream_t stream) {
  const size_t smem = fwd_smem<DQK, DV>();
  const int e = prepare(fwd_kernel<T, DQK, DV>, smem);
  if (e != 0) return e;
  const dim3 grid((p.S + kTile - 1) / kTile, p.Hq, p.B);
  fwd_kernel<T, DQK, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), p);
  return counted<DQK, DV>(kFwdFma);
}

template <int DQK, int DV, bool kPos>
int launch_fwd_mma_as(const void* q, const void* k, const void* v, void* out,
                      void* lse, const Problem& p, cudaStream_t stream) {
  const size_t smem = fwd_mma_smem<DQK, DV>();
  int e = prepare(fwd_mma_kernel<DQK, DV, kPos>, smem);
  dim3 grid;
  if (e == 0)
    e = grid_1d((long long)((p.S + kFwdM - 1) / kFwdM) * p.Hq * p.B, grid);
  if (e != 0) return e;
  fwd_mma_kernel<DQK, DV, kPos><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), p);
  return counted<DQK, DV>(kFwdMma);
}

// positions read (a window, or causal masking by position) or not: two
// instantiations, so that the others compile to no position code
template <int DQK, int DV>
int launch_fwd_mma(const void* q, const void* k, const void* v, void* out,
                   void* lse, const Problem& p, cudaStream_t stream) {
  return p.q_pos != nullptr
             ? launch_fwd_mma_as<DQK, DV, true>(q, k, v, out, lse, p, stream)
             : launch_fwd_mma_as<DQK, DV, false>(q, k, v, out, lse, p, stream);
}

template <typename T, int DQK, int DV>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, const Problem& p,
              cudaStream_t stream) {
  const size_t smem = dq_smem<DQK, DV>(dq_stage_v<DQK, DV>());
  const int e = prepare(dq_kernel<T, DQK, DV>, smem);
  if (e != 0) return e;
  const dim3 grid((p.S + kTile - 1) / kTile, p.Hq, p.B);
  dq_kernel<T, DQK, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), p);
  return counted<DQK, DV>(kDqFma);
}

template <int DQK, int DV, bool kPos>
int launch_dq_mma_as(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, const Problem& p, cudaStream_t stream) {
  const size_t smem = dq_mma_smem<DQK, DV>();
  int e = prepare(dq_mma_kernel<DQK, DV, kPos>, smem);
  dim3 grid;
  if (e == 0)
    e = grid_1d((long long)((p.S + kFwdM - 1) / kFwdM) * p.Hq * p.B, grid);
  if (e != 0) return e;
  dq_mma_kernel<DQK, DV, kPos><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), p);
  return counted<DQK, DV>(kDqMma);
}

template <int DQK, int DV>
int launch_dq_mma(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, const Problem& p, cudaStream_t stream) {
  return p.q_pos != nullptr
             ? launch_dq_mma_as<DQK, DV, true>(q, k, v, dout, lse, delta, dq,
                                               p, stream)
             : launch_dq_mma_as<DQK, DV, false>(q, k, v, dout, lse, delta, dq,
                                                p, stream);
}

template <typename T, int DQK, int DV>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const Problem& p, cudaStream_t stream) {
  const size_t smem = dkv_smem<DQK, DV>(dkv_stage_kv<DQK, DV>());
  const int e = prepare(dkv_kernel<T, DQK, DV>, smem);
  if (e != 0) return e;
  const dim3 grid((p.T + kTile - 1) / kTile, p.Hkv, p.B);
  dkv_kernel<T, DQK, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), p);
  return counted<DQK, DV>(kDkvFma);
}

template <int DQK, int DV, bool kPos>
int launch_dkv_mma_as(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, const Problem& p,
                      cudaStream_t stream) {
  const size_t smem = dkv_mma_smem<DQK, DV>();
  int e = prepare(dkv_mma_kernel<DQK, DV, kPos>, smem);
  dim3 grid;
  if (e == 0)
    e = grid_1d((long long)((p.T + kDkvN - 1) / kDkvN) * p.Hkv * p.B, grid);
  if (e != 0) return e;
  const int threads = dkv_threads<DQK, DV>();
  dkv_mma_kernel<DQK, DV, kPos><<<grid, threads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), p);
  return counted<DQK, DV>(kDkvMma);
}

template <int DQK, int DV>
int launch_dkv_mma(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, const Problem& p, cudaStream_t stream) {
  return p.q_pos != nullptr
             ? launch_dkv_mma_as<DQK, DV, true>(q, k, v, dout, lse, delta, dk,
                                                dv, p, stream)
             : launch_dkv_mma_as<DQK, DV, false>(q, k, v, dout, lse, delta, dk,
                                                 dv, p, stream);
}

Problem make_problem(int B, int S, int T, int Hq, int Hkv, float scale,
                     float soft_cap, int causal, int window, const void* q_seg,
                     const void* kv_seg, const void* q_pos, const void* kv_pos,
                     const void* q_rng, const void* kv_rng) {
  Problem p;
  p.B = B;
  p.S = S;
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.scale = scale;
  p.soft_cap = soft_cap;
  p.causal = causal;
  p.window = window > 0 ? window : 0;
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  // positions only where a mask reads them
  const bool posm = p.window > 0 || causal == 2;
  p.q_pos = posm ? static_cast<const int*>(q_pos) : nullptr;
  p.kv_pos = posm ? static_cast<const int*>(kv_pos) : nullptr;
  p.q_rng = posm ? static_cast<const int*>(q_rng) : nullptr;
  p.kv_rng = posm ? static_cast<const int*>(kv_rng) : nullptr;
  return p;
}

// whether the launch arguments are consistent: segment ids on both sides or
// neither, and positions with their ranges wherever a mask reads them
bool valid(const Problem& p) {
  if ((p.q_seg == nullptr) != (p.kv_seg == nullptr)) return false;
  if (p.causal < 0 || p.causal > 2) return false;
  if (p.window > 0 || p.causal == 2)
    return p.q_pos && p.kv_pos && p.q_rng && p.kv_rng;
  return true;
}

// fn(DQK, DV) as two std::integral_constant for an instantiated pair of head
// dims (q/k, v): (16, 16), (64, 64), (128, 128), (192, 128) (MLA) or
// (256, 256) (Gemma-2, Gemma-3); cudaErrorInvalidValue for any other
template <typename F>
int with_head_dims(int DQK, int DV, F fn) {
  using std::integral_constant;
  if (DQK == 16 && DV == 16)
    return fn(integral_constant<int, 16>(), integral_constant<int, 16>());
  if (DQK == 64 && DV == 64)
    return fn(integral_constant<int, 64>(), integral_constant<int, 64>());
  if (DQK == 128 && DV == 128)
    return fn(integral_constant<int, 128>(), integral_constant<int, 128>());
  if (DQK == 192 && DV == 128)
    return fn(integral_constant<int, 192>(), integral_constant<int, 128>());
  if (DQK == 256 && DV == 256)
    return fn(integral_constant<int, 256>(), integral_constant<int, 256>());
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; (D, Dv): the head dims of q/k and of v,
// one of the pairs of with_head_dims. q_seg / kv_seg: (B, S) / (B, T) int32,
// both null without segment ids. causal: 0 none, 1 by index, 2 by position.
// window <= 0 means none. q_pos / kv_pos: (B, S) / (B, T) int32 positions,
// and q_rng / kv_rng their per-32-row [min, max] ranges, (B, ceil(N / 32),
// 2) int32: read only under a window or causal 2, where they must be set.
// soft_cap <= 0 means none. Each returns cudaGetLastError() after its launch
// (0 = success), or cudaErrorInvalidValue for a dtype, head dims or
// arguments it does not take. bfloat16 runs K1-K3 on the tensor cores,
// float32 on the CUDA cores.

int fa_forward(const void* q, const void* k, const void* v, const void* q_seg,
               const void* kv_seg, const void* q_pos, const void* kv_pos,
               const void* q_rng, const void* kv_rng, void* out, void* lse,
               int B, int S, int T, int Hq, int Hkv, int D, int Dv,
               float scale, float soft_cap, int causal, int window, int dtype,
               void* stream) {
  const Problem p = make_problem(B, S, T, Hq, Hkv, scale, soft_cap, causal,
                                 window, q_seg, kv_seg, q_pos, kv_pos, q_rng,
                                 kv_rng);
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_head_dims(D, Dv, [&](auto dqk, auto dv) {
    constexpr int kDQK = decltype(dqk)::value, kDV = decltype(dv)::value;
    if (dtype == 0) return launch_fwd<float, kDQK, kDV>(q, k, v, out, lse, p, s);
    if (dtype == 1) return launch_fwd_mma<kDQK, kDV>(q, k, v, out, lse, p, s);
    return (int)cudaErrorInvalidValue;
  });
}

int fa_backward_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   const void* q_seg, const void* kv_seg, const void* q_pos,
                   const void* kv_pos, const void* q_rng, const void* kv_rng,
                   void* dq, int B, int S, int T, int Hq, int Hkv, int D,
                   int Dv, float scale, float soft_cap, int causal,
                   int window, int dtype, void* stream) {
  const Problem p = make_problem(B, S, T, Hq, Hkv, scale, soft_cap, causal,
                                 window, q_seg, kv_seg, q_pos, kv_pos, q_rng,
                                 kv_rng);
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_head_dims(D, Dv, [&](auto dqk, auto dv) {
    constexpr int kDQK = decltype(dqk)::value, kDV = decltype(dv)::value;
    if (dtype == 0)
      return launch_dq<float, kDQK, kDV>(q, k, v, dout, lse, delta, dq, p, s);
    if (dtype == 1)
      return launch_dq_mma<kDQK, kDV>(q, k, v, dout, lse, delta, dq, p, s);
    return (int)cudaErrorInvalidValue;
  });
}

int fa_backward_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    const void* q_seg, const void* kv_seg, const void* q_pos,
                    const void* kv_pos, const void* q_rng, const void* kv_rng,
                    void* dk, void* dv, int B, int S, int T, int Hq, int Hkv,
                    int D, int Dv, float scale, float soft_cap, int causal,
                    int window, int dtype, void* stream) {
  const Problem p = make_problem(B, S, T, Hq, Hkv, scale, soft_cap, causal,
                                 window, q_seg, kv_seg, q_pos, kv_pos, q_rng,
                                 kv_rng);
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_head_dims(D, Dv, [&](auto dqk, auto dvd) {
    constexpr int kDQK = decltype(dqk)::value, kDV = decltype(dvd)::value;
    if (dtype == 0)
      return launch_dkv<float, kDQK, kDV>(q, k, v, dout, lse, delta, dk, dv,
                                          p, s);
    if (dtype == 1)
      return launch_dkv_mma<kDQK, kDV>(q, k, v, dout, lse, delta, dk, dv, p,
                                       s);
    return (int)cudaErrorInvalidValue;
  });
}

// dynamic shared memory (bytes) of the bf16 tensor-core K1 (which = 0), K3
// (1) or K2 (2), or of the fp32 CUDA-core K1 (3), K3 (4) or K2 (5), at head
// dims (D, Dv)
int fa_smem_bytes(int which, int D, int Dv) {
  return with_head_dims(D, Dv, [&](auto dqk, auto dv) {
    constexpr int kDQK = decltype(dqk)::value, kDV = decltype(dv)::value;
    switch (which) {
      case 0: return (int)fwd_mma_smem<kDQK, kDV>();
      case 1: return (int)dkv_mma_smem<kDQK, kDV>();
      case 2: return (int)dq_mma_smem<kDQK, kDV>();
      case 3: return (int)fwd_smem<kDQK, kDV>();
      case 4: return (int)dkv_smem<kDQK, kDV>(dkv_stage_kv<kDQK, kDV>());
      case 5: return (int)dq_smem<kDQK, kDV>(dq_stage_v<kDQK, kDV>());
    }
    return -1;
  });
}

// the launch counters (g_launches), kernel by kernel, each kernel's head-dim
// pairs in with_head_dims's order: the first n into out; returns how many
// there are
int fa_launch_counts(long long* out, int n) {
  const int total = kCountedKernels * kCountedPairs;
  for (int i = 0; i < n && i < total; ++i)
    out[i] = g_launches[i / kCountedPairs][i % kCountedPairs];
  return total;
}

// sets every launch counter to 0
void fa_reset_launch_counts() {
  for (auto& row : g_launches)
    for (auto& n : row) n = 0;
}

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
