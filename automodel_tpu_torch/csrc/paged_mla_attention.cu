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
// mla_kernel (K6 for both dtypes, K7 for fp32 queries, CUDA cores). MLA is
// multi-query attention: all n heads of a row share one latent row c (r
// wide) and one rope row kr (dr wide) per kv position. So one thread block
// owns one token row and ALL its heads, and each live page's (ps, r) latent
// slice and (ps, dr) rope slice are read from device memory once per row
// and staged in shared memory as fp32. The block's queries (n, r + dr) sit
// in shared memory too; scores are one warp per (head, page row) dot
// product; the (n, r) fp32 accumulator is spread over the block's threads in
// registers (element i = tid + k * 256, kAcc of them per thread), and only
// the output row is written back. It walks the row's pages one after
// another, one block per row: latency-bound (~37 us per page).
//
// mla_split_kernel + mla_combine_kernel (K7 for bf16 queries, tensor cores;
// a template on the page type, so that K6 can instantiate it for bf16 pages).
// - Split-KV (flash decoding): the grid is (row x split, head tile, column
//   group). A split is a fixed run of whole pages, about 128 kv positions
//   (8 pages of 16), so the grid is static (from the page-table width); a
//   split past its row's last live kv exits at once. Each split writes fp32
//   partials (running max m, sum l, the unnormalised (n, r) accumulator) to
//   a workspace the wrapper allocates; the combine kernel (one block per
//   (row, head)) merges the live splits and writes out in q's dtype, 0 for
//   pad rows. The Pallas kernel's sequential page walk is not kept; the
//   output is the same.
// - Heads as M: the 16 heads of a head tile are the M of mma.sync m16n8k16
//   (bf16 in, fp32 accumulate); heads past n read a zero row. Scores are
//   (16 x (r + dr)) . ((r + dr) x 32 kv) per step of 32 kv rows, one
//   8-column n-tile per warp, the latent and rope parts in separate
//   accumulators (cs and krs multiply them after their products, as in the
//   Pallas kernel). The online softmax runs on fragments: every warp
//   reads the step's 16 x 32 scores from shared memory and builds the A
//   operand p * cs itself. The value product acc += (p cs)(16 x 32) .
//   c(32 x r) gives each of the 4 warps 128 of the r = 512 output columns
//   (64 fp32 registers), with c through ldmatrix.trans.
// - Pages: each kv row is gathered through the page table with 16-byte
//   cp.async (4-byte or byte copies for narrower rows) into a two-stage
//   int8 ring; the next step's copies are issued before this step's
//   products. ldmatrix cannot convert, so each step converts its int8 rows
//   into a bf16 tile in shared memory (exact: int8 values are bf16
//   integers), whose rows are padded by 16 bytes so that ldmatrix reads
//   are free of bank conflicts. Widths that are not multiples of 16 are
//   zero-padded in shared memory; a step shrinks to 16 (or fewer) kv rows
//   where 32 would not fit shared memory.
// - Deviation from the Pallas kernel: it keeps p * cs in fp32 for the value
//   product (:488); the A operand of a bf16 mma rounds it to bf16, about
//   2^-9 of each term (the plain version rounds p to bf16 too).
//
// Bound. Bytes: each live page's latent and rope rows are read once per row
// that attends to them, and the arithmetic is 4 * n * r operations per kv
// position, below the card's operations-per-byte line at n = 16. Like K4,
// rows of one prefill chunk each re-read their request's pages (L2 absorbs
// part of it). At one serve step's 64 rows the bound is ~2 us; the split
// kernel is latency-bound (four dependent steps of load, convert, score and
// value product per split, 2 blocks of 4 warps per SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_helpers.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
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

size_t smem_bytes(int n, int r, int dr, int ps) {
  // q_abs (n, r) | q_rope (n, dr) | c (ps, r) | kr (ps, dr) | p (n, ps)
  // | running max, sum, rescale (n each) | c and kr scales (ps each)
  return sizeof(float) *
         ((size_t)n * r + (size_t)n * dr + (size_t)ps * r + (size_t)ps * dr +
          (size_t)n * ps + 3 * (size_t)n + 2 * (size_t)ps);
}

// T: q and output dtype; TKV: page dtype (T for K6, int8_t for K7, which
// also takes c_scales / kr_scales, (N+1, ps) fp32; K6 passes nullptr).
// kAcc accumulators per thread cover n * r <= kThreads * kAcc.
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
           int n, int r, int dr, int ps, int P, float scale) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  extern __shared__ float smem[];
  const int t = blockIdx.x;
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

  const T* qa_row = q_abs + (size_t)t * nr;
  const T* qr_row = q_rope + (size_t)t * n * dr;
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

  T* o_row = out + (size_t)t * nr;
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    const int i = tid + k * kThreads;
    if (i < nr) {
      const float l = l_s[i / r];
      o_row[i] = from_float<T>(l > 0.f ? acc[k] / l : 0.f);
    }
  }
}

template <typename T, typename TKV, int kAcc>
int launch_acc(const void* q_abs, const void* q_rope, const void* c_pages,
               const void* kr_pages, const float* c_scales,
               const float* kr_scales, const int* page_tables,
               const int* positions, void* out, int T_, int n, int r, int dr,
               int ps, int P, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, r, dr, ps);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mla_kernel<T, TKV, kAcc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mla_kernel<T, TKV, kAcc><<<T_, kThreads, smem, stream>>>(
      static_cast<const T*>(q_abs), static_cast<const T*>(q_rope),
      static_cast<const TKV*>(c_pages), static_cast<const TKV*>(kr_pages),
      c_scales, kr_scales, page_tables, positions, static_cast<T*>(out), n, r,
      dr, ps, P, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename TKV>
int launch(const void* q_abs, const void* q_rope, const void* c_pages,
           const void* kr_pages, const float* c_scales,
           const float* kr_scales, const int* page_tables,
           const int* positions, void* out, int T_, int n, int r, int dr,
           int ps, int P, float scale, cudaStream_t stream) {
  const int need = (n * r + kThreads - 1) / kThreads;
#define MLA_LAUNCH(K)                                                       \
  return launch_acc<T, TKV, K>(q_abs, q_rope, c_pages, kr_pages, c_scales,  \
                               kr_scales, page_tables, positions, out, T_, n, \
                               r, dr, ps, P, scale, stream)
  if (need <= 4) MLA_LAUNCH(4);
  if (need <= 8) MLA_LAUNCH(8);
  if (need <= 16) MLA_LAUNCH(16);
  if (need <= 32) MLA_LAUNCH(32);
  if (need <= 64) MLA_LAUNCH(64);
#undef MLA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bf16-query K7 on the tensor cores: split-KV (flash decoding)
// ---------------------------------------------------------------------------

constexpr int kSplitThreads = 128;  // 4 warps
constexpr int kSplitKv = 128;       // kv positions per split (whole pages)
constexpr int kHeadTile = 16;       // heads per block: the M of mma.sync
constexpr int kColGroup = 512;      // output columns per block: 4 warps x 128
constexpr int kMaxSmem = 232448;    // dynamic shared memory a block may use
constexpr int kCombineThreads = 128;  // one block per (row, head)
constexpr int kCombineCols = 4;       // columns per thread: r <= 512 in one pass

// four staged page values -> four bf16 in two words (exact for int8)
__device__ __forceinline__ uint2 to_bf16x4(const int8_t* p) {
  const int w = *reinterpret_cast<const int*>(p);
  return make_uint2(pack_bf16((float)(int8_t)w, (float)(int8_t)(w >> 8)),
                    pack_bf16((float)(int8_t)(w >> 16), (float)(w >> 24)));
}
__device__ __forceinline__ uint2 to_bf16x4(const bf16* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// The layout one launch shares between host and device. A staged page row
// holds the latent columns [0, r) and the rope columns at [r_al, r_al + dr);
// r_al and dr_al are r and dr rounded up to 16 (zero columns in between).
struct SplitShape {
  int n, r, dr, ps, P;
  int r_al, dr_al;
  int w8;        // staged row stride, bytes: (r_al + dr_al) values + 16
  int wb;        // bf16 row stride, elements: r_al + dr_al + 8
  int kv_rows;   // kv rows per step
  int split_kv;  // kv positions per split: whole pages, about kSplitKv
  int n_splits;  // splits of a page-table row
  int vec;       // bytes per page-row copy: 16, 4 or 1
  int qvec;      // 1: query rows copy in 16-byte pieces
  float scale;
};

// The ldmatrix row stride 2 wb bytes is an odd multiple of 16 (wb - 8 is a
// multiple of 16), so the 8 rows of one ldmatrix phase fall on 8 distinct
// 16-byte bank groups.
size_t split_smem(const SplitShape& sh) {
  const int rows = sh.kv_rows;
  const int hq = sh.n < kHeadTile ? sh.n : kHeadTile;
  const int ks = rows > 16 ? 2 : 1;
  return (size_t)2 * rows * sh.w8           // staged pages, 2 stages
         + sizeof(float) * 4 * rows         // latent and rope scales, 2 stages
         + sizeof(bf16) * (size_t)(rows + 1 + hq) * sh.wb  // tile, zero row, q
         + sizeof(float) * kHeadTile * (16 * ks + 4);       // scores
}

// The fp32 partials of every (row, split, head): the running max and sum,
// then the unnormalised (n, r) accumulator of every split that has live kv.
template <typename TKV, int KS, int NCH>
__global__ void __launch_bounds__(kSplitThreads)
mla_split_kernel(const bf16* __restrict__ q_abs,       // (T, n, r)
                 const bf16* __restrict__ q_rope,      // (T, n, dr)
                 const TKV* __restrict__ c_pages,      // (N+1, ps, r)
                 const TKV* __restrict__ kr_pages,     // (N+1, ps, dr)
                 const float* __restrict__ c_scales,   // (N+1, ps) or null
                 const float* __restrict__ kr_scales,  // (N+1, ps) or null
                 const int* __restrict__ page_tables,  // (T, P)
                 const int* __restrict__ positions,    // (T,)
                 float* __restrict__ ws_acc,  // (T, n_splits, n, r)
                 float* __restrict__ ws_ml,   // (T, n_splits, n, 2)
                 SplitShape sh) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int E = sizeof(TKV);
  constexpr int LDS = 16 * KS + 4;  // score tile row stride, floats
  extern __shared__ __align__(128) unsigned char smem_raw[];

  const int t = blockIdx.x / sh.n_splits;
  const int split = blockIdx.x % sh.n_splits;
  const int h0 = blockIdx.y * kHeadTile;
  const int pos = positions[t];
  const int end = min(pos + 1, sh.P * sh.ps);
  const int j0 = split * sh.split_kv;
  // no live kv in this split (or a pad row): nothing to write, the combine
  // reads only the splits that hold live kv
  if (pos < 0 || j0 >= end) return;
  const int j1 = min(j0 + sh.split_kv, end);
  const int rows = sh.kv_rows;
  const int n_steps = (j1 - j0 + rows - 1) / rows;
  const int hq = min(kHeadTile, sh.n - h0);

  unsigned char* stage = smem_raw;  // 2 stages x rows x w8 bytes
  float* scl = reinterpret_cast<float*>(stage + 2 * rows * sh.w8);
  bf16* tile = reinterpret_cast<bf16*>(scl + 4 * rows);  // rows x wb
  bf16* zero = tile + rows * sh.wb;                       // wb zeros
  bf16* q_s = zero + sh.wb;                               // hq x wb
  float* s_s = reinterpret_cast<float*>(q_s + hq * sh.wb);  // 16 x LDS

  const int* pt = page_tables + (size_t)t * sh.P;
  // Each kv row of a step belongs to kSplitThreads / rows threads (rows
  // divides kSplitThreads): a thread looks its row's page up once per step
  // and walks the row's copies and conversions with no division.
  const int tpr = kSplitThreads / rows;
  const int my_row = threadIdx.x / tpr;
  const int my_sub = threadIdx.x % tpr;
  // the kv rows of step i into stage i & 1: each row gathered through the
  // page table, latent and rope parts by 16-byte (or 4-byte) cp.async; rows
  // past j1 are not copied (the conversion writes them as zeros)
  auto load_step = [&](int i) {
    const int st = i & 1;
    const int j = j0 + i * rows + my_row;
    if (j >= j1) return;
    const size_t row = (size_t)pt[j / sh.ps] * sh.ps + j % sh.ps;
    unsigned char* dst = stage + st * rows * sh.w8 + my_row * sh.w8;
    const unsigned char* c_src =
        reinterpret_cast<const unsigned char*>(c_pages + row * sh.r);
    const unsigned char* kr_src =
        reinterpret_cast<const unsigned char*>(kr_pages + row * sh.dr);
    const int V = sh.vec;
    const int cl = sh.r * E / V, cr = sh.dr * E / V;  // copies per part
    for (int k = my_sub; k < cl + cr; k += tpr) {
      const bool lat = k < cl;
      const unsigned char* src = lat ? c_src + k * V : kr_src + (k - cl) * V;
      unsigned char* d = dst + (lat ? k * V : sh.r_al * E + (k - cl) * V);
      if (V == 16)
        cp_async16(smem_addr(d), src, true);
      else if (V == 4)
        cp_async4(smem_addr(d), src, true);
      else
        *d = *src;  // rows of odd byte widths: plain loads
    }
    if constexpr (kQuant) {
      if (my_sub < 2) {
        float* cs_d = scl + st * 2 * rows + my_sub * rows + my_row;
        cp_async4(smem_addr(cs_d), (my_sub == 0 ? c_scales : kr_scales) + row,
                  true);
      }
    }
  };

  load_step(0);
  // the block's query rows (zero-padded columns): 16-byte copies where the
  // rows allow them, else element by element; and the zero row that stands
  // in for every row past hq (heads) or past kv_rows (keys)
  const int wal = sh.r_al + sh.dr_al;
  if (sh.qvec) {
    for (int i = threadIdx.x; i < hq * (wal / 8); i += kSplitThreads) {
      const int h = i / (wal / 8);
      const int c = (i - h * (wal / 8)) * 8;
      const size_t qrow = (size_t)t * sh.n + h0 + h;
      const bf16* src = q_abs;
      bool full = true;
      if (c < sh.r)
        src = q_abs + qrow * sh.r + c;
      else if (c >= sh.r_al && c < sh.r_al + sh.dr)
        src = q_rope + qrow * sh.dr + c - sh.r_al;
      else
        full = false;
      cp_async16(smem_addr(q_s + h * sh.wb + c), src, full);
    }
  } else {
    for (int i = threadIdx.x; i < hq * wal; i += kSplitThreads) {
      const int h = i / wal;
      const int c = i - h * wal;
      const size_t qrow = (size_t)t * sh.n + h0 + h;
      bf16 x = __float2bfloat16(0.f);
      if (c < sh.r)
        x = q_abs[qrow * sh.r + c];
      else if (c >= sh.r_al && c < sh.r_al + sh.dr)
        x = q_rope[qrow * sh.dr + c - sh.r_al];
      q_s[h * sh.wb + c] = x;
    }
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < sh.wb; i += kSplitThreads)
    zero[i] = __float2bfloat16(0.f);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  // ldmatrix row addresses: rows past `n_rows` read the zero row
  auto row_at = [&](const bf16* base, int row, int n_rows, int col) {
    return smem_addr((row < n_rows ? base + row * sh.wb : zero) + col);
  };
  // A operand (16 rows x 16 columns at col0) of a row-major bf16 matrix;
  // through .trans the same addresses give the B operands of two n-tiles
  // (columns col0 .. +7, +8 .. +15) whose k runs along the rows
  auto a_addr = [&](const bf16* base, int row0, int n_rows, int col0) {
    return row_at(base, row0 + (lane & 7) + (((lane >> 3) & 1) << 3), n_rows,
                  col0 + ((lane >> 4) << 3));
  };

  float acc[NCH][2][4];
#pragma unroll
  for (int i = 0; i < NCH; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // rows g and g + 8 (heads): running max, this lane's share of the sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float scale_log2e = sh.scale * kLog2e;
  const int chunk0 = blockIdx.z * (kColGroup / 16) + warp;  // 16-column chunks

  for (int it = 0; it < n_steps; ++it) {
    const int st = it & 1;
    const int jb = j0 + it * rows;
    cp_async_wait<0>();
    // step it has landed; every warp is done with step it - 1's tile and
    // scores, and with the stage the next copy refills
    __syncthreads();
    if (it + 1 < n_steps) {
      load_step(it + 1);  // overlaps this step's products
      cp_async_commit();
    }
    // staged page rows -> bf16 tile (int8 is exact in bf16); padding
    // columns and rows past j1 become zeros
    {
      const bool live = jb + my_row < j1;
      const TKV* src = reinterpret_cast<const TKV*>(
          stage + st * rows * sh.w8 + my_row * sh.w8);
      bf16* dst = tile + my_row * sh.wb;
      for (int c = my_sub * 4; c < wal; c += tpr * 4) {
        const int lim = c < sh.r_al ? sh.r : sh.r_al + sh.dr;
        uint2 v = make_uint2(0u, 0u);
        if (live && c + 4 <= lim) {
          v = to_bf16x4(src + c);
        } else if (live && c < lim) {
          float f[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            f[e] = c + e < lim ? to_float(src[c + e]) : 0.f;
          v = make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
        }
        *reinterpret_cast<uint2*>(dst + c) = v;
      }
    }
    __syncthreads();

    // scores of this step's kv columns w*8 .. w*8+7 (warp w < 2 KS):
    // latent and rope products in two accumulators, two k-steps per B load
    if (warp < 2 * KS) {
      float sc[4] = {0.f, 0.f, 0.f, 0.f}, sr[4] = {0.f, 0.f, 0.f, 0.f};
      const int kv0 = warp * 8;
      // the two k-steps of a B load accumulate apart: two short chains
      auto part = [&](float (&s)[4], int col_begin, int col_end) {
        float s2[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k0 = col_begin; k0 < col_end; k0 += 32) {
          const bool two = k0 + 16 < col_end;
          // n-tile rows kv0 .. +7; lanes 8i .. 8i+7 read k columns k0 + 8i
          const int kc = k0 + (lane >> 3) * 8;
          uint32_t b[4], a0[4], a1[4];
          ldsm_x4(b, row_at(tile, kv0 + (lane & 7), rows,
                            two || kc < k0 + 16 ? kc : kc - 16));
          ldsm_x4(a0, a_addr(q_s, 0, hq, k0));
          mma_bf16(s, a0, b[0], b[1]);
          if (two) {
            ldsm_x4(a1, a_addr(q_s, 0, hq, k0 + 16));
            mma_bf16(s2, a1, b[2], b[3]);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] += s2[e];
      };
      part(sc, 0, sh.r_al);
      part(sr, sh.r_al, wal);
      const float* cs = scl + st * 2 * rows;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + 2 * tq + (e & 1);
        float s = -INFINITY;
        if (col < rows && jb + col < j1) {
          if constexpr (kQuant)
            s = (sc[e] * cs[col] + sr[e] * cs[rows + col]) * sh.scale;
          else
            s = (sc[e] + sr[e]) * sh.scale;
        }
        s_s[(g + 8 * (e >> 1)) * LDS + col] = s;
      }
    }
    __syncthreads();

    // online softmax on A fragments (every warp, for its value product): a
    // head row lives on the 4 lanes of a quad; the step holds >= 1 live kv,
    // so the new max is finite
    const float* cs = scl + st * 2 * rows;
    float sv[KS][2][4];  // [k-step][row g, g + 8][cols 2t, 2t+1, 2t+8, 2t+9]
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kk * 16 + 2 * tq + (e & 1) + (e >> 1) * 8;
          sv[kk][i][e] = s_s[(g + 8 * i) * LDS + col];
          mx[i] = fmaxf(mx[i], sv[kk][i][e]);
        }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = fast_exp2((m[i] - m_new) * kLog2e);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
    // value weights p * cs, rounded to bf16 as the A operand of P.C
    uint32_t pa[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      float w[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kk * 16 + 2 * tq + (e & 1) + (e >> 1) * 8;
          const float pr = fast_exp2((sv[kk][i][e] - m[i]) * kLog2e);
          l[i] += pr;
          float c = 1.f;
          // rows past j1 have no scale (p is 0 there)
          if constexpr (kQuant) c = col < rows && jb + col < j1 ? cs[col] : 0.f;
          w[i][e] = pr * c;
        }
      pa[kk][0] = pack_bf16(w[0][0], w[0][1]);
      pa[kk][1] = pack_bf16(w[1][0], w[1][1]);
      pa[kk][2] = pack_bf16(w[0][2], w[0][3]);
      pa[kk][3] = pack_bf16(w[1][2], w[1][3]);
    }
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        acc[ch][j][0] *= alpha[0];
        acc[ch][j][1] *= alpha[0];
        acc[ch][j][2] *= alpha[1];
        acc[ch][j][3] *= alpha[1];
      }
    // acc += (p cs) . C over the warp's 16-column chunks w, w + 4, ...
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int col0 = (chunk0 + 4 * ch) * 16;
      if (col0 >= sh.r_al) break;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t b[4];
        ldsm_x4_trans(b, a_addr(tile, kk * 16, rows, col0));
        mma_bf16(acc[ch][0], pa[kk], b[0], b[1]);
        mma_bf16(acc[ch][1], pa[kk], b[2], b[3]);
      }
    }
  }

  // partials: this block's heads and columns
  const size_t base = ((size_t)t * sh.n_splits + split) * sh.n + h0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lsum = quad_sum(l[i]);
    const int h = g + 8 * i;
    if (h >= hq) continue;
    float* row = ws_acc + (base + h) * sh.r;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int col0 = (chunk0 + 4 * ch) * 16;
      if (col0 >= sh.r_al) break;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = col0 + 8 * j + 2 * tq;
        if (c < sh.r) row[c] = acc[ch][j][2 * i];
        if (c + 1 < sh.r) row[c + 1] = acc[ch][j][2 * i + 1];
      }
    }
    if (blockIdx.z == 0 && warp == 0 && tq == 0) {
      ws_ml[(base + h) * 2] = m[i];
      ws_ml[(base + h) * 2 + 1] = lsum;
    }
  }
}

// out[t, h, c] = sum_s e^(m_s - M) acc_s[h, c] / sum_s e^(m_s - M) l_s over
// the row's live splits s (M their largest max); 0 for pad rows. One block
// per (row, head): its threads share the split weights and each writes
// columns of the head's output row.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
mla_combine_kernel(const float* __restrict__ ws_acc,
                   const float* __restrict__ ws_ml,
                   const int* __restrict__ positions, T* __restrict__ out,
                   SplitShape sh) {
  extern __shared__ float w_s[];  // kCombineThreads split weights
  const int t = blockIdx.x / sh.n;
  const int h = blockIdx.x % sh.n;
  const int pos = positions[t];
  const int end = min(pos + 1, sh.P * sh.ps);
  const int live = pos < 0 ? 0 : (end + sh.split_kv - 1) / sh.split_kv;
  const size_t at0 = (size_t)t * sh.n_splits * sh.n + h;  // split 0's (t, h)
  float mx = -INFINITY;
  for (int s = 0; s < live; ++s)
    mx = fmaxf(mx, ws_ml[(at0 + (size_t)s * sh.n) * 2]);
  float den = 0.f;
  for (int s = 0; s < live; ++s) {
    const float* ml = ws_ml + (at0 + (size_t)s * sh.n) * 2;
    den += expf(ml[0] - mx) * ml[1];
  }
  const float inv = den > 0.f ? 1.f / den : 0.f;
  float num[kCombineCols];
#pragma unroll
  for (int k = 0; k < kCombineCols; ++k) num[k] = 0.f;
  // kCombineThreads splits' weights at a time through shared memory
  for (int s0 = 0; s0 < live; s0 += kCombineThreads) {
    const int s = s0 + (int)threadIdx.x;
    __syncthreads();
    if (s < live) w_s[threadIdx.x] =
        expf(ws_ml[(at0 + (size_t)s * sh.n) * 2] - mx) * inv;
    __syncthreads();
    const int n_s = min(kCombineThreads, live - s0);
    for (int i = 0; i < n_s; ++i) {
      const float* a = ws_acc + (at0 + (size_t)(s0 + i) * sh.n) * sh.r;
#pragma unroll
      for (int k = 0; k < kCombineCols; ++k) {
        const int c = threadIdx.x + k * kCombineThreads;
        if (c < sh.r) num[k] += w_s[i] * a[c];
      }
    }
  }
  T* o = out + ((size_t)t * sh.n + h) * sh.r;
#pragma unroll
  for (int k = 0; k < kCombineCols; ++k) {
    const int c = threadIdx.x + k * kCombineThreads;
    if (c < sh.r) o[c] = from_float<T>(num[k]);
  }
  // columns past kCombineCols * kCombineThreads (r > 512): a second pass
  for (int c = threadIdx.x + kCombineCols * kCombineThreads; c < sh.r;
       c += kCombineThreads) {
    float v = 0.f;
    for (int s = 0; s < live; ++s) {
      const size_t at = at0 + (size_t)s * sh.n;
      v += expf(ws_ml[at * 2] - mx) * inv * ws_acc[at * sh.r + c];
    }
    o[c] = from_float<T>(v);
  }
}

// E bytes per page value; a, b: the page arrays (their alignment picks the
// copy width)
SplitShape split_shape(int n, int r, int dr, int ps, int P, float scale,
                       int E, const void* a, const void* b, const void* qa,
                       const void* qr) {
  SplitShape sh;
  sh.n = n;
  sh.r = r;
  sh.dr = dr;
  sh.ps = ps;
  sh.P = P;
  sh.r_al = (r + 15) / 16 * 16;
  sh.dr_al = (dr + 15) / 16 * 16;
  sh.w8 = (sh.r_al + sh.dr_al) * E + 16;
  sh.wb = sh.r_al + sh.dr_al + 8;
  const int pps = ps >= kSplitKv ? 1 : kSplitKv / ps;
  sh.split_kv = pps * ps;
  sh.n_splits = (P + pps - 1) / pps;
  const uintptr_t al = reinterpret_cast<uintptr_t>(a) |
                       reinterpret_cast<uintptr_t>(b);
  const int rb = r * E, drb = dr * E;
  sh.vec = (rb % 16 == 0 && drb % 16 == 0 && al % 16 == 0) ? 16
           : (rb % 4 == 0 && drb % 4 == 0 && al % 4 == 0)  ? 4
                                                            : 1;
  const uintptr_t qal = reinterpret_cast<uintptr_t>(qa) |
                        reinterpret_cast<uintptr_t>(qr);
  sh.qvec = r % 8 == 0 && dr % 8 == 0 && qal % 16 == 0;
  sh.scale = scale;
  // 32 kv rows per step, fewer where a step's rows would not fit
  for (sh.kv_rows = 32; sh.kv_rows > 1 && split_smem(sh) > kMaxSmem;
       sh.kv_rows /= 2) {
  }
  return sh;
}

// floats of the split partials (acc, then max and sum) of one launch
long long split_workspace(const SplitShape& sh, int T) {
  return (long long)T * sh.n_splits * sh.n * (sh.r + 2);
}

template <typename TKV, int KS, int NCH>
int launch_split_kernel(const void* q_abs, const void* q_rope,
                        const void* c_pages, const void* kr_pages,
                        const float* c_scales, const float* kr_scales,
                        const int* page_tables, const int* positions,
                        float* ws, const SplitShape& sh, int T,
                        cudaStream_t stream) {
  const size_t smem = split_smem(sh);
  cudaError_t e = cudaFuncSetAttribute(
      mla_split_kernel<TKV, KS, NCH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)T * sh.n_splits;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (sh.n + kHeadTile - 1) / kHeadTile,
                  (sh.r_al + kColGroup - 1) / kColGroup);
  float* ws_ml = ws + (size_t)T * sh.n_splits * sh.n * sh.r;
  mla_split_kernel<TKV, KS, NCH><<<grid, kSplitThreads, smem, stream>>>(
      static_cast<const bf16*>(q_abs), static_cast<const bf16*>(q_rope),
      static_cast<const TKV*>(c_pages), static_cast<const TKV*>(kr_pages),
      c_scales, kr_scales, page_tables, positions, ws, ws_ml, sh);
  return (int)cudaGetLastError();
}

// The split kernel for the shape's step rows (KS) and columns per warp
// (NCH 16-column chunks), then the combine into out (bf16).
template <typename TKV>
int launch_split(const void* q_abs, const void* q_rope, const void* c_pages,
                 const void* kr_pages, const float* c_scales,
                 const float* kr_scales, const int* page_tables,
                 const int* positions, void* out, float* ws,
                 const SplitShape& sh, int T, cudaStream_t stream) {
  if (split_smem(sh) > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int chunks = sh.r_al / 16 < kColGroup / 16 ? sh.r_al / 16
                                                   : kColGroup / 16;
  const int per_warp = (chunks + 3) / 4;
  const bool ks2 = sh.kv_rows > 16;
  int e;
#define MLA_SPLIT(KS, NCH)                                                   \
  e = launch_split_kernel<TKV, KS, NCH>(q_abs, q_rope, c_pages, kr_pages,    \
                                        c_scales, kr_scales, page_tables,    \
                                        positions, ws, sh, T, stream)
  if (per_warp <= 1) {
    if (ks2) MLA_SPLIT(2, 1); else MLA_SPLIT(1, 1);
  } else if (per_warp <= 2) {
    if (ks2) MLA_SPLIT(2, 2); else MLA_SPLIT(1, 2);
  } else if (per_warp <= 4) {
    if (ks2) MLA_SPLIT(2, 4); else MLA_SPLIT(1, 4);
  } else {
    if (ks2) MLA_SPLIT(2, 8); else MLA_SPLIT(1, 8);
  }
#undef MLA_SPLIT
  if (e != 0) return e;
  const long long rows = (long long)T * sh.n;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  mla_combine_kernel<bf16><<<(unsigned)rows, kCombineThreads,
                              sizeof(float) * kCombineThreads, stream>>>(
      ws, ws + (size_t)T * sh.n_splits * sh.n * sh.r, positions,
      static_cast<bf16*>(out), sh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest n * r one block's accumulators cover (kThreads * 64).
int mla_max_heads_x_rank() { return kThreads * 64; }

// K6. dtype (queries, pages and out): 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() after the launch (0 = success).
int mla_forward(const void* q_abs, const void* q_rope, const void* c_pages,
                const void* kr_pages, const void* page_tables,
                const void* positions, void* out, int T, int n, int r, int dr,
                int ps, int P, float scale, int dtype, void* stream) {
  if (T == 0) return 0;
  const int* pt = static_cast<const int*>(page_tables);
  const int* pos = static_cast<const int*>(positions);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float>(q_abs, q_rope, c_pages, kr_pages, nullptr,
                                nullptr, pt, pos, out, T, n, r, dr, ps, P,
                                scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q_abs, q_rope, c_pages, kr_pages, nullptr, nullptr, pt, pos, out, T,
        n, r, dr, ps, P, scale, s);
  return (int)cudaErrorInvalidValue;
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
  const int* pt = static_cast<const int*>(page_tables);
  const int* pos = static_cast<const int*>(positions);
  const float* cs = static_cast<const float*>(c_scales);
  const float* krs = static_cast<const float*>(kr_scales);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, int8_t>(q_abs, q_rope, c_pages, kr_pages, cs, krs,
                                 pt, pos, out, T, n, r, dr, ps, P, scale, s);
  return (int)cudaErrorInvalidValue;
}

// floats of the workspace mla_quant_split_forward needs for this shape
long long mla_split_workspace_floats(int T, int n, int r, int dr, int ps,
                                     int P) {
  return split_workspace(
      split_shape(n, r, dr, ps, P, 1.f, 1, nullptr, nullptr, nullptr, nullptr), T);
}

// dynamic shared memory (bytes) of the split kernel at this shape
int mla_split_smem_bytes(int n, int r, int dr, int ps, int P) {
  return (int)split_smem(
      split_shape(n, r, dr, ps, P, 1.f, 1, nullptr, nullptr, nullptr, nullptr));
}

// K7 for bfloat16 queries: the split-KV kernel on the tensor cores and the
// combine; out (T, n, r) bfloat16. workspace: mla_split_workspace_floats()
// fp32 values.
int mla_quant_split_forward(const void* q_abs, const void* q_rope,
                            const void* c_pages, const void* kr_pages,
                            const void* c_scales, const void* kr_scales,
                            const void* page_tables, const void* positions,
                            void* out, void* workspace, int T, int n, int r,
                            int dr, int ps, int P, float scale,
                            void* stream) {
  if (T == 0) return 0;
  const SplitShape sh =
      split_shape(n, r, dr, ps, P, scale, 1, c_pages, kr_pages, q_abs, q_rope);
  return launch_split<int8_t>(
      q_abs, q_rope, c_pages, kr_pages, static_cast<const float*>(c_scales),
      static_cast<const float*>(kr_scales),
      static_cast<const int*>(page_tables), static_cast<const int*>(positions),
      out, static_cast<float*>(workspace), sh, T,
      static_cast<cudaStream_t>(stream));
}

const char* mla_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
