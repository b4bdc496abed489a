// Split-KV paged attention on the tensor cores (flash decoding), shared by
// the bf16-query routes of K4 and K5 (GQA over bf16 and int8 pages,
// ragged_paged_attention.cu), K6 and K7 (absorbed MLA over bf16 and int8
// latent pages, paged_mla_attention.cu). Include after mma_helpers.cuh.
//
// Both functions are "scores against part a (and b) of a page row, values
// from part a (or b)" over two page arrays gathered row by row through the
// page table:
//   MLA: a = latent c (r wide), b = rope kr (dr wide); scores use a and b
//        (two products, cs and krs scale each), values use a (cs);
//   GQA: a = K (D wide), b = V (Dv wide) of kv head `group`; scores use a
//        (ks scales them, then the soft cap), values use b (vs).
//
// - Grid: (row x split, group x head tile, value-column group). A split is
//   a fixed run of whole pages, about kSplitKv kv positions, so the grid is
//   static (from the page-table width); a split past its row's last live
//   kv exits at once. Each split writes fp32 partials (running max m, sum
//   l, the unnormalised accumulator) to a workspace the wrapper allocates;
//   the combine (one block per (row, head)) merges the live splits and
//   writes bf16, 0 for pad rows.
// - Heads as M: up to 16 query heads of a group are the M of mma.sync
//   m16n8k16 (bf16 in, fp32 accumulate); missing heads read a zero row.
//   Each step of up to 32 kv rows scores (16 x width) . (width x 32), one
//   8-column n-tile per warp; the online softmax runs on fragments (every
//   warp reads the step's scores from shared memory and builds its own A
//   operand p * value scale, rounded to bf16); the value product gives
//   each of the 4 warps 16-column chunks of the output, the page rows
//   through ldmatrix.trans.
// - Pages: each kv row is gathered through the page table with 16-byte
//   cp.async (4-byte or byte copies for narrower rows) into a two-stage
//   ring; the next step's copies are issued before this step's products.
//   bf16 pages land in the ring as the padded bf16 tiles ldmatrix reads;
//   int8 pages land as bytes and each step converts them into one bf16
//   tile (exact: int8 values are bf16 integers). Tile rows are padded by
//   16 bytes so that ldmatrix reads are free of bank conflicts. Rows past
//   a step's live kv read a zero row; widths that are not multiples of 16
//   are zero-padded; a step shrinks below 32 kv rows where 32 would not
//   fit shared memory, and outputs wider than 512 columns run in column
//   groups.
// - Sliding windows (GQA): row t attends kv j iff j <= pos and
//   pos - j < window. A split wholly below the window's first kv
//   lo = pos - window + 1 exits at once, as one past the row's end does,
//   so pages wholly below the window are never read; the others start at
//   max(j0, lo), mid-page if need be (rows are gathered one by one), so
//   no kv row any step reads lies outside the window and nothing is masked
//   inside a step. The combine reads the splits [lo / split_kv, live).
// - Sinks (GQA): one logit per query head joins the combine's softmax
//   denominator, unscaled and uncapped, with no value row.

#pragma once

#include <type_traits>

namespace {

constexpr int kSplitThreads = 128;    // 4 warps
constexpr int kSplitKv = 128;         // kv positions per split (whole pages)
constexpr int kHeadTile = 16;         // heads per block: the M of mma.sync
constexpr int kColGroup = 512;        // value columns per block: 4 warps x 128
constexpr int kMaxSmem = 232448;      // dynamic shared memory a block may use
constexpr int kCombineThreads = 128;  // one block per (row, head)
constexpr int kCombineCols = 4;       // columns per thread: 512 in one pass

// four staged page values -> four bf16 in two words (exact for int8)
__device__ __forceinline__ uint2 to_bf16x4(const int8_t* p) {
  const int w = *reinterpret_cast<const int*>(p);
  return make_uint2(pack_bf16((float)(int8_t)w, (float)(int8_t)(w >> 8)),
                    pack_bf16((float)(int8_t)(w >> 16), (float)(w >> 24)));
}

// The layout one launch shares between host and device. A staged page row
// holds part a's columns [0, aw) and part b's at [a_al, a_al + bw); a_al
// and b_al are aw and bw rounded up to 16 (zero columns in between).
struct SplitShape {
  int heads;      // query heads per group (MLA: n; GQA: Hq / Hkv)
  int groups;     // kv groups (MLA: 1; GQA: Hkv); a page row holds all
  int aw, bw;     // widths of one group's slice of the two page arrays
  int a_al, b_al;
  int s_al;       // scored columns: a_al + b_al (MLA) or a_al (GQA)
  int v0, vw;     // value columns [v0, v0 + vw): part a (MLA) or b (GQA)
  int v_al;       // vw rounded up to 16
  int ps, P;
  int e;          // bytes per page value: 1 (int8) or 2 (bf16)
  int stage_w;    // staged row stride, bytes (bf16 pages: the tile row)
  int wb;         // bf16 tile row stride, elements: a_al + b_al + 8
  int kv_rows;    // kv rows per step
  int split_kv;   // kv positions per split: whole pages, about kSplitKv
  int n_splits;   // splits of a page-table row
  int window;     // GQA: kv j is attended iff pos - j < window; 0: none
  int vec;        // bytes per page-row copy: 16, 4 or 1
  int qvec;       // 1: query rows copy in 16-byte pieces
  float scale;
  float soft_cap;  // GQA; <= 0 means none
};

template <typename TKV>
struct SplitArgs {
  const bf16* qa;         // (T, groups * heads, aw) queries against part a
  const bf16* qb;         // (T, heads, bw) MLA's rope queries; GQA: null
  const TKV* a_pages;     // (N+1, ps, groups, aw)
  const TKV* b_pages;     // (N+1, ps, groups, bw)
  const float* a_scales;  // (N+1, ps) per-row scales (int8), else null
  const float* b_scales;
  const int* page_tables;  // (T, P)
  const int* positions;    // (T,)
  float* ws_acc;  // (T, n_splits, groups * heads, vw)
  float* ws_ml;   // (T, n_splits, groups * heads, 2): max and sum
};

// The ldmatrix row stride 2 wb bytes is an odd multiple of 16 (wb - 8 is a
// multiple of 16), so the 8 rows of one ldmatrix phase fall on 8 distinct
// 16-byte bank groups.
size_t split_smem(const SplitShape& sh) {
  const int rows = sh.kv_rows;
  const int hq = sh.heads < kHeadTile ? sh.heads : kHeadTile;
  const int ks = rows > 16 ? 2 : 1;
  size_t bytes = (size_t)2 * rows * sh.stage_w  // staged rows, 2 stages
                 + sizeof(bf16) * (size_t)(1 + hq) * sh.wb  // zero row, q
                 + sizeof(float) * kHeadTile * (16 * ks + 4);  // scores
  if (sh.e == 1)  // int8: the scale rows of 2 stages, the converted tile
    bytes += sizeof(float) * 4 * rows + sizeof(bf16) * (size_t)rows * sh.wb;
  return bytes;
}

// e bytes per page value; a, b: the page arrays and qa, qb the query arrays
// (their alignment picks the copy widths; qb null for GQA)
SplitShape split_shape(int heads, int groups, int aw, int bw, bool gqa,
                       int ps, int P, float scale, float soft_cap, int e,
                       const void* a, const void* b, const void* qa,
                       const void* qb) {
  SplitShape sh;
  sh.heads = heads;
  sh.groups = groups;
  sh.aw = aw;
  sh.bw = bw;
  sh.a_al = (aw + 15) / 16 * 16;
  sh.b_al = (bw + 15) / 16 * 16;
  sh.s_al = gqa ? sh.a_al : sh.a_al + sh.b_al;
  sh.v0 = gqa ? sh.a_al : 0;
  sh.vw = gqa ? bw : aw;
  sh.v_al = gqa ? sh.b_al : sh.a_al;
  sh.ps = ps;
  sh.P = P;
  sh.e = e;
  sh.wb = sh.a_al + sh.b_al + 8;
  sh.stage_w = e == 1 ? sh.a_al + sh.b_al + 16 : 2 * sh.wb;
  const int pps = ps >= kSplitKv ? 1 : kSplitKv / ps;
  sh.split_kv = pps * ps;
  sh.n_splits = (P + pps - 1) / pps;
  const uintptr_t al = reinterpret_cast<uintptr_t>(a) |
                       reinterpret_cast<uintptr_t>(b);
  const int ab = aw * e, bb = bw * e;  // a group's row slice, bytes
  sh.vec = (ab % 16 == 0 && bb % 16 == 0 && al % 16 == 0) ? 16
           : (ab % 4 == 0 && bb % 4 == 0 && al % 4 == 0)  ? 4
                                                          : 1;
  const uintptr_t qal = reinterpret_cast<uintptr_t>(qa) |
                        reinterpret_cast<uintptr_t>(qb);
  sh.qvec = aw % 8 == 0 && (gqa || bw % 8 == 0) && qal % 16 == 0;
  sh.scale = scale;
  sh.soft_cap = soft_cap;
  sh.window = 0;
  // 32 kv rows per step, fewer where a step's rows would not fit
  for (sh.kv_rows = 32; sh.kv_rows > 1 && split_smem(sh) > kMaxSmem;
       sh.kv_rows /= 2) {
  }
  return sh;
}

// floats of the split partials (acc, then max and sum) of one launch
long long split_workspace(const SplitShape& sh, int T) {
  return (long long)T * sh.n_splits * sh.groups * sh.heads * (sh.vw + 2);
}

dim3 split_grid(const SplitShape& sh, int T) {
  return dim3((unsigned)((long long)T * sh.n_splits),
              sh.groups * ((sh.heads + kHeadTile - 1) / kHeadTile),
              (sh.v_al + kColGroup - 1) / kColGroup);
}

// cudaSuccess, or why the shape cannot launch
int split_launchable(const SplitShape& sh, int T) {
  if (split_smem(sh) > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)sh.groups * ((sh.heads + kHeadTile - 1) / kHeadTile);
  if ((long long)T * sh.n_splits > 0x7fffffffLL || tiles > 65535 ||
      (long long)T * sh.groups * sh.heads > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  return 0;
}

// The instantiation a shape takes: KS 16-row k-steps per step (1 or 2) and
// NCH 16-column value chunks per warp, as split_ks() - 1 and the index of
// NCH in 1, 2, 4, 8.
int split_ks(const SplitShape& sh) { return sh.kv_rows > 16 ? 2 : 1; }
int split_nch_index(const SplitShape& sh) {
  const int chunks = sh.v_al / 16 < kColGroup / 16 ? sh.v_al / 16
                                                   : kColGroup / 16;
  const int per_warp = (chunks + 3) / 4;
  return per_warp <= 1 ? 0 : per_warp <= 2 ? 1 : per_warp <= 4 ? 2 : 3;
}

// the first kv a row at `pos` attends under `window` (0: none)
__device__ __forceinline__ int window_start(int pos, int window) {
  return window > 0 ? max(pos - window + 1, 0) : 0;
}

// One split of one (row, group, head tile, column group): the body of
// mla_split_kernel and gqa_split_kernel.
template <typename TKV, bool kGqa, int KS, int NCH>
__device__ __forceinline__ void split_attention(const SplitArgs<TKV>& a,
                                                const SplitShape& sh) {
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int E = sizeof(TKV);
  constexpr int LDS = 16 * KS + 4;  // score tile row stride, floats
  extern __shared__ __align__(128) unsigned char smem_raw[];

  const int t = blockIdx.x / sh.n_splits;
  const int split = blockIdx.x % sh.n_splits;
  const int tiles = (sh.heads + kHeadTile - 1) / kHeadTile;
  const int grp = blockIdx.y / tiles;
  const int h0 = (blockIdx.y % tiles) * kHeadTile;
  const int pos = a.positions[t];
  const int end = min(pos + 1, sh.P * sh.ps);
  const int lo = window_start(pos, sh.window);
  const int j0 = split * sh.split_kv;
  // no live kv in this split (a pad row, past the row's end or wholly below
  // its window): nothing to write, the combine reads only the splits that
  // hold live kv
  if (pos < 0 || j0 >= end || j0 + sh.split_kv <= lo) return;
  const int jlo = max(j0, lo);  // the split's first live kv
  const int j1 = min(j0 + sh.split_kv, end);
  const int rows = sh.kv_rows;
  const int n_steps = (j1 - jlo + rows - 1) / rows;
  const int hq = min(kHeadTile, sh.heads - h0);
  const int wal = sh.a_al + sh.b_al;

  unsigned char* stage = smem_raw;  // 2 stages x rows x stage_w bytes
  float* scl = reinterpret_cast<float*>(stage + 2 * rows * sh.stage_w);
  // int8: 4 x rows scales (a and b of 2 stages), then the converted tile
  bf16* tile = reinterpret_cast<bf16*>(kQuant ? scl + 4 * rows : scl);
  bf16* zero = kQuant ? tile + rows * sh.wb : tile;  // wb zeros
  bf16* q_s = zero + sh.wb;                          // hq x wb
  float* s_s = reinterpret_cast<float*>(q_s + hq * sh.wb);  // 16 x LDS

  const int* pt = a.page_tables + (size_t)t * sh.P;
  // Each kv row of a step belongs to kSplitThreads / rows threads (rows
  // divides kSplitThreads): a thread looks its row's page up once per step
  // and walks the row's copies and conversions with no division.
  const int tpr = kSplitThreads / rows;
  const int my_row = threadIdx.x / tpr;
  const int my_sub = threadIdx.x % tpr;
  // the kv rows of step i into stage i & 1: each row's slices of the two
  // page arrays gathered through the page table; rows past j1 are not
  // copied (they read the zero row, or convert to zeros)
  auto load_step = [&](int i) {
    const int st = i & 1;
    const int j = jlo + i * rows + my_row;
    if (j >= j1) return;
    const size_t row = (size_t)pt[j / sh.ps] * sh.ps + j % sh.ps;
    unsigned char* dst = stage + (st * rows + my_row) * sh.stage_w;
    const unsigned char* a_src = reinterpret_cast<const unsigned char*>(
        a.a_pages + (row * sh.groups + grp) * sh.aw);
    const unsigned char* b_src = reinterpret_cast<const unsigned char*>(
        a.b_pages + (row * sh.groups + grp) * sh.bw);
    const int V = sh.vec;
    const int ca = sh.aw * E / V, cb = sh.bw * E / V;  // copies per part
    for (int k = my_sub; k < ca + cb; k += tpr) {
      const bool in_a = k < ca;
      const unsigned char* src = in_a ? a_src + k * V : b_src + (k - ca) * V;
      unsigned char* d = dst + (in_a ? k * V : sh.a_al * E + (k - ca) * V);
      if (V == 16)
        cp_async16(smem_addr(d), src, true);
      else if (V == 4)
        cp_async4(smem_addr(d), src, true);
      else
        *d = *src;  // rows of odd byte widths: plain loads
    }
    if constexpr (kQuant) {
      if (my_sub < 2) {
        float* sd = scl + st * 2 * rows + my_sub * rows + my_row;
        cp_async4(smem_addr(sd), (my_sub == 0 ? a.a_scales : a.b_scales) + row,
                  true);
      }
    }
  };

  load_step(0);
  // the block's query rows (zero-padded columns): 16-byte copies where the
  // rows allow them, else element by element
  const size_t qrow0 = ((size_t)t * sh.groups + grp) * sh.heads + h0;
  if (sh.qvec) {
    for (int i = threadIdx.x; i < hq * (sh.s_al / 8); i += kSplitThreads) {
      const int h = i / (sh.s_al / 8);
      const int c = (i - h * (sh.s_al / 8)) * 8;
      const bf16* src = a.qa;
      bool full = true;
      if (c < sh.aw)
        src = a.qa + (qrow0 + h) * sh.aw + c;
      else if (!kGqa && c >= sh.a_al && c < sh.a_al + sh.bw)
        src = a.qb + (qrow0 + h) * sh.bw + c - sh.a_al;
      else
        full = false;
      cp_async16(smem_addr(q_s + h * sh.wb + c), src, full);
    }
  } else {
    for (int i = threadIdx.x; i < hq * sh.s_al; i += kSplitThreads) {
      const int h = i / sh.s_al;
      const int c = i - h * sh.s_al;
      bf16 x = __float2bfloat16(0.f);
      if (c < sh.aw)
        x = a.qa[(qrow0 + h) * sh.aw + c];
      else if (!kGqa && c >= sh.a_al && c < sh.a_al + sh.bw)
        x = a.qb[(qrow0 + h) * sh.bw + c - sh.a_al];
      q_s[h * sh.wb + c] = x;
    }
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < sh.wb; i += kSplitThreads)
    zero[i] = __float2bfloat16(0.f);
  if constexpr (!kQuant) {
    // bf16 pages: the padding columns of both stages' tiles, which no copy
    // writes, are zeros once and for all
    if (sh.aw < sh.a_al || sh.bw < sh.b_al) {
      for (int i = threadIdx.x; i < 2 * rows * wal; i += kSplitThreads) {
        const int c = i % wal;
        if ((c >= sh.aw && c < sh.a_al) || c >= sh.a_al + sh.bw)
          reinterpret_cast<bf16*>(stage + (i / wal) * sh.stage_w)[c] =
              __float2bfloat16(0.f);
      }
    }
  }

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
  const int chunk0 = blockIdx.z * (kColGroup / 16) + warp;  // 16-column chunks

  for (int it = 0; it < n_steps; ++it) {
    const int st = it & 1;
    const int jb = jlo + it * rows;
    const int live = min(rows, j1 - jb);  // kv rows of this step
    cp_async_wait<0>();
    // step it has landed; every warp is done with step it - 1's tile and
    // scores, and with the stage the next copy refills
    __syncthreads();
    if (it + 1 < n_steps) {
      load_step(it + 1);  // overlaps this step's products
      cp_async_commit();
    }
    const bf16* tl = tile;
    if constexpr (kQuant) {
      // staged int8 rows -> bf16 tile (exact); padding columns become zeros
      const int8_t* src = reinterpret_cast<const int8_t*>(
          stage + (st * rows + my_row) * sh.stage_w);
      bf16* dst = tile + my_row * sh.wb;
      if (my_row < live) {
        for (int c = my_sub * 4; c < wal; c += tpr * 4) {
          const int lim = c < sh.a_al ? sh.aw : sh.a_al + sh.bw;
          uint2 v = make_uint2(0u, 0u);
          if (c + 4 <= lim) {
            v = to_bf16x4(src + c);
          } else if (c < lim) {
            float f[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              f[e] = c + e < lim ? static_cast<float>(src[c + e]) : 0.f;
            v = make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
          }
          *reinterpret_cast<uint2*>(dst + c) = v;
        }
      }
      __syncthreads();
    } else {
      tl = reinterpret_cast<const bf16*>(stage + st * rows * sh.stage_w);
    }

    // scores of this step's kv columns w*8 .. w*8+7 (warp w < 2 KS); MLA
    // keeps the latent and rope products in two accumulators; two k-steps
    // per B load
    const float* sa = scl + st * 2 * rows;  // int8: part a's scales
    const float* sb = sa + rows;            // int8: part b's scales
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
          ldsm_x4(b, row_at(tl, kv0 + (lane & 7), live,
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
      part(sc, 0, sh.a_al);
      if (!kGqa) part(sr, sh.a_al, wal);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + 2 * tq + (e & 1);
        float s = -INFINITY;
        if (col < live) {
          if constexpr (kQuant)
            s = kGqa ? sc[e] * sa[col] : sc[e] * sa[col] + sr[e] * sb[col];
          else
            s = sc[e] + sr[e];
          s *= sh.scale;
          if (kGqa && sh.soft_cap > 0.f)
            s = sh.soft_cap * tanhf(s / sh.soft_cap);
        }
        s_s[(g + 8 * (e >> 1)) * LDS + col] = s;
      }
    }
    __syncthreads();

    // online softmax on A fragments (every warp, for its value product): a
    // head row lives on the 4 lanes of a quad; the step holds >= 1 live kv,
    // so the new max is finite
    const float* vs = kGqa ? sb : sa;  // int8: the value rows' scales
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
    // value weights p (times the value scale), rounded to bf16 as the A
    // operand of the value product; l sums the unscaled p
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
          // rows past the step's live kv have no scale (p is 0 there)
          if constexpr (kQuant) c = col < live ? vs[col] : 0.f;
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
    // acc += p . values over the warp's 16-column chunks w, w + 4, ...
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int col0 = (chunk0 + 4 * ch) * 16;
      if (col0 >= sh.v_al) break;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t b[4];
        ldsm_x4_trans(b, a_addr(tl, kk * 16, live, sh.v0 + col0));
        mma_bf16(acc[ch][0], pa[kk], b[0], b[1]);
        mma_bf16(acc[ch][1], pa[kk], b[2], b[3]);
      }
    }
  }

  // partials: this block's heads and columns
  const size_t base = ((size_t)t * sh.n_splits + split) * sh.groups * sh.heads +
                      (size_t)grp * sh.heads + h0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lsum = quad_sum(l[i]);
    const int h = g + 8 * i;
    if (h >= hq) continue;
    float* row = a.ws_acc + (base + h) * sh.vw;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int col0 = (chunk0 + 4 * ch) * 16;
      if (col0 >= sh.v_al) break;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = col0 + 8 * j + 2 * tq;
        if (c < sh.vw) row[c] = acc[ch][j][2 * i];
        if (c + 1 < sh.vw) row[c + 1] = acc[ch][j][2 * i + 1];
      }
    }
    if (blockIdx.z == 0 && warp == 0 && tq == 0) {
      a.ws_ml[(base + h) * 2] = m[i];
      a.ws_ml[(base + h) * 2 + 1] = lsum;
    }
  }
}

// out[t, h, c] = sum_s e^(m_s - M) acc_s[h, c] / sum_s e^(m_s - M) l_s over
// the row's live splits s (M their largest max); with sinks (the GQA sink
// logit of query head h) M also covers sink[h] and the denominator gains
// e^(sink[h] - M). 0 for pad rows. The live splits are
// [window_start / split_kv, ceil(end / split_kv)): the splits outside never
// wrote their workspace slots. One block per (row, head) of the
// groups * heads output heads: its threads share the split weights and each
// writes columns of the head's output row. The body of mla_combine_kernel
// and gqa_combine_kernel.
__device__ __forceinline__ void combine_splits(const float* __restrict__ ws_acc,
                                               const float* __restrict__ ws_ml,
                                               const int* __restrict__ positions,
                                               const float* __restrict__ sinks,
                                               bf16* __restrict__ out,
                                               const SplitShape& sh) {
  extern __shared__ float w_s[];  // kCombineThreads split weights
  const int H = sh.groups * sh.heads;
  const int W = sh.vw;
  const int t = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int pos = positions[t];
  const int end = min(pos + 1, sh.P * sh.ps);
  const int first = pos < 0 ? 0 : window_start(pos, sh.window) / sh.split_kv;
  const int live = pos < 0 ? 0 : (end + sh.split_kv - 1) / sh.split_kv;
  const size_t at0 = (size_t)t * sh.n_splits * H + h;  // split 0's (t, h)
  float mx = -INFINITY;
  for (int s = first; s < live; ++s)
    mx = fmaxf(mx, ws_ml[(at0 + (size_t)s * H) * 2]);
  float den = 0.f;
  if (sinks != nullptr) {
    mx = fmaxf(mx, sinks[h]);
    den = expf(sinks[h] - mx);
  }
  for (int s = first; s < live; ++s) {
    const float* ml = ws_ml + (at0 + (size_t)s * H) * 2;
    den += expf(ml[0] - mx) * ml[1];
  }
  const float inv = den > 0.f ? 1.f / den : 0.f;
  float num[kCombineCols];
#pragma unroll
  for (int k = 0; k < kCombineCols; ++k) num[k] = 0.f;
  // kCombineThreads splits' weights at a time through shared memory
  for (int s0 = first; s0 < live; s0 += kCombineThreads) {
    const int s = s0 + (int)threadIdx.x;
    __syncthreads();
    if (s < live) w_s[threadIdx.x] = expf(ws_ml[(at0 + (size_t)s * H) * 2] - mx) * inv;
    __syncthreads();
    const int n_s = min(kCombineThreads, live - s0);
    for (int i = 0; i < n_s; ++i) {
      const float* a = ws_acc + (at0 + (size_t)(s0 + i) * H) * W;
#pragma unroll
      for (int k = 0; k < kCombineCols; ++k) {
        const int c = threadIdx.x + k * kCombineThreads;
        if (c < W) num[k] += w_s[i] * a[c];
      }
    }
  }
  bf16* o = out + ((size_t)t * H + h) * W;
#pragma unroll
  for (int k = 0; k < kCombineCols; ++k) {
    const int c = threadIdx.x + k * kCombineThreads;
    if (c < W) o[c] = __float2bfloat16(num[k]);
  }
  // columns past kCombineCols * kCombineThreads (W > 512): a second pass
  for (int c = threadIdx.x + kCombineCols * kCombineThreads; c < W;
       c += kCombineThreads) {
    float v = 0.f;
    for (int s = first; s < live; ++s) {
      const size_t at = at0 + (size_t)s * H;
      v += expf(ws_ml[at * 2] - mx) * inv * ws_acc[at * W + c];
    }
    o[c] = __float2bfloat16(v);
  }
}

}  // namespace
