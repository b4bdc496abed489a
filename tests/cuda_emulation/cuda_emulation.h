// CPU emulation of the CUDA features that csrc/flash_attention.cu uses, so
// that its kernels run on a machine without a GPU (tests/
// test_torch_flash_emulated.py). One std::thread per CUDA thread; blocks run
// one after another; __syncthreads is a block barrier; warp collectives
// (shuffles, votes, ldmatrix, mma.sync m16n8k16 bf16) exchange operands
// through a per-warp buffer between two warp barriers. cp.async copies at
// once, so the emulation checks indexing, layouts and masks, not the
// timing of the copy pipeline. The kernel source's own inline-asm helpers
// are replaced by the ones below (the test strips them by name).
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <memory>
#include <thread>
#include <type_traits>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __align__(n)
#define __launch_bounds__(...)
struct uint3_ { unsigned x = 0, y = 0, z = 0; };
inline thread_local uint3_ threadIdx, blockIdx;
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct __nv_bfloat16 { uint16_t v; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __bfloat162float(__nv_bfloat16 b) { uint32_t u = (uint32_t)b.v << 16; float f; memcpy(&f, &u, 4); return f; }
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u; memcpy(&u, &f, 4);
  if ((u & 0x7fffffff) > 0x7f800000) return {(uint16_t)((u >> 16) | 0x40)};
  u += 0x7fff + ((u >> 16) & 1);
  return {(uint16_t)(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {__float2bfloat16(a), __float2bfloat16(b)}; }
using std::min; using std::max;
typedef int cudaError_t;
enum { cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
typedef void* cudaStream_t;
template <typename K> int cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emu"; }

// ---- launch state
inline unsigned char* g_smem = nullptr;
inline std::barrier<>* g_block_bar = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> g_warp_bar;
struct WarpBuf { uint32_t u[32][8]; };
inline WarpBuf* g_wbuf = nullptr;
inline void __syncthreads() { g_block_bar->arrive_and_wait(); }
inline void wsync() { g_warp_bar[threadIdx.x >> 5]->arrive_and_wait(); }
inline WarpBuf& wb() { return g_wbuf[threadIdx.x >> 5]; }
inline int lane_() { return threadIdx.x & 31; }

template <typename F>
void emu_launch(dim3 grid, unsigned threads, size_t smem, F f) {
  std::vector<unsigned char> buf(smem + 1024);
  g_smem = buf.data();
  std::barrier<> bb(threads);
  g_block_bar = &bb;
  g_warp_bar.clear();
  for (unsigned w = 0; w < threads / 32; ++w) g_warp_bar.emplace_back(new std::barrier<>(32));
  std::vector<WarpBuf> wbuf(threads / 32);
  g_wbuf = wbuf.data();
  memset(g_smem, 0xAB, smem + 1024);  // garbage, like uninitialised shared memory
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < threads; ++t)
    ts.emplace_back([&, t] {
      threadIdx.x = t;
      for (unsigned z = 0; z < grid.z; ++z)
        for (unsigned y = 0; y < grid.y; ++y)
          for (unsigned x = 0; x < grid.x; ++x) {
            blockIdx.x = x; blockIdx.y = y; blockIdx.z = z;
            f();
            bb.arrive_and_wait();
          }
    });
  for (auto& t : ts) t.join();
}

template <typename T> inline T shfl_impl(T v, int src) {
  static_assert(sizeof(T) == 4);
  uint32_t u; memcpy(&u, &v, 4);
  wb().u[lane_()][0] = u; wsync();
  uint32_t r = wb().u[src & 31][0]; wsync();
  T o; memcpy(&o, &r, 4); return o;
}
inline float __shfl_xor_sync(unsigned, float v, int o) { return shfl_impl(v, lane_() ^ o); }
inline int __shfl_sync(unsigned, int v, int s) { return shfl_impl(v, s); }
inline float __shfl_sync(unsigned, float v, int s) { return shfl_impl(v, s); }
inline bool __all_sync(unsigned, bool v) {
  wb().u[lane_()][0] = v; wsync();
  bool r = true; for (int i = 0; i < 32; ++i) r = r && wb().u[i][0]; wsync();
  return r;
}
inline size_t __cvta_generic_to_shared(const void* p) { return (const unsigned char*)p - g_smem; }

// ---- emulated asm helpers
inline void cp_async16(uint32_t dst, const void* src, bool full) {
  if (full) memcpy(g_smem + dst, src, 16); else memset(g_smem + dst, 0, 16);
}
inline void cp_async4(uint32_t dst, const void* src, bool full) {
  if (full) memcpy(g_smem + dst, src, 4); else memset(g_smem + dst, 0, 4);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}

inline uint16_t smem_b16(uint32_t addr) { uint16_t v; memcpy(&v, g_smem + addr, 2); return v; }
inline void ldsm_impl(uint32_t (&r)[4], uint32_t addr, bool trans) {
  if (addr % 16) { fprintf(stderr, "ldmatrix: unaligned row address\n"); abort(); }
  wb().u[lane_()][0] = addr; wsync();
  const int l = lane_();
  for (int i = 0; i < 4; ++i) {
    uint16_t e[2];
    for (int j = 0; j < 2; ++j) {
      int row, col;
      if (!trans) { row = l / 4; col = 2 * (l % 4) + j; }
      else { row = 2 * (l % 4) + j; col = l / 4; }
      e[j] = smem_b16(wb().u[8 * i + row][0] + 2 * col);
    }
    r[i] = e[0] | ((uint32_t)e[1] << 16);
  }
  wsync();
}
inline void ldsm_x4(uint32_t (&r)[4], uint32_t addr) { ldsm_impl(r, addr, false); }
inline void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) { ldsm_impl(r, addr, true); }

inline float bf_lo(uint32_t u) { __nv_bfloat16 b{(uint16_t)(u & 0xffff)}; return __bfloat162float(b); }
inline float bf_hi(uint32_t u) { __nv_bfloat16 b{(uint16_t)(u >> 16)}; return __bfloat162float(b); }
// PTX m16n8k16 .row.col bf16 fragment layouts (groupID g = lane / 4,
// threadID_in_group t = lane % 4):
//  A: a0 (g, 2t..2t+1) a1 (g+8, 2t..) a2 (g, 2t+8..) a3 (g+8, 2t+8..)
//  B: b0 (k 2t..2t+1, n g) b1 (k 2t+8.., n g)
//  C: c0,c1 (g, 2t..2t+1) c2,c3 (g+8, 2t..2t+1)
inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  const int l = lane_();
  auto& B = wb();
  for (int i = 0; i < 4; ++i) B.u[l][i] = a[i];
  B.u[l][4] = b0; B.u[l][5] = b1;
  wsync();
  float A[16][16], Bm[16][8];
  for (int ln = 0; ln < 32; ++ln) {
    int g = ln / 4, t = ln % 4;
    const uint32_t* f = B.u[ln];
    A[g][2*t] = bf_lo(f[0]); A[g][2*t+1] = bf_hi(f[0]);
    A[g+8][2*t] = bf_lo(f[1]); A[g+8][2*t+1] = bf_hi(f[1]);
    A[g][2*t+8] = bf_lo(f[2]); A[g][2*t+9] = bf_hi(f[2]);
    A[g+8][2*t+8] = bf_lo(f[3]); A[g+8][2*t+9] = bf_hi(f[3]);
    Bm[2*t][g] = bf_lo(f[4]); Bm[2*t+1][g] = bf_hi(f[4]);
    Bm[2*t+8][g] = bf_lo(f[5]); Bm[2*t+9][g] = bf_hi(f[5]);
  }
  wsync();
  int g = l / 4, t = l % 4;
  int rows[4] = {g, g, g + 8, g + 8}, cols[4] = {2*t, 2*t+1, 2*t, 2*t+1};
  for (int e = 0; e < 4; ++e) {
    float s = 0.f;
    for (int kk = 0; kk < 16; ++kk) s += A[rows[e]][kk] * Bm[kk][cols[e]];
    c[e] += s;
  }
}
inline float fast_exp2(float x) { return exp2f(x); }  // ex2.approx.ftz
