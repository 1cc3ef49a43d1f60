// Tensor-core building blocks of the bf16 flash-attention kernels
// (flash_attention_fwd_tc.cu, flash_attention_bwd_tc.cu): cp.async tile
// loads into swizzled shared memory and warpgroup products on wgmma
// (sm_90a; bf16 in, float32 accumulate).
//
// A block is one warpgroup (4 warps, 128 threads) that owns 64 rows: warp
// w holds rows 16w .. 16w + 15 of every 64 x N accumulator, lane l four
// floats per 8 columns: [0], [1] at row g = l / 4, columns 2t and 2t + 1
// (t = l % 4); [2], [3] at row g + 8 (the layout of wgmma's D, the same as
// mma.m16n8's C).  wgmma's A operand from registers has the layout of
// mma.m16n8k16's A fragment, so two neighbouring 8-column accumulator
// tiles, rounded to bf16, are the A operand of the next product over those
// 16 columns (`to_a`): P and dS never leave registers.
//
// Tiles hold rows of hd bf16, swizzled as wgmma's descriptors read them:
// 128-byte rows (hd 64) swizzle their 16-byte chunks over 8 rows, 64-byte
// rows (hd 32) over 4 pairs of rows, 32-byte rows (hd 16) over 2 quads;
// hd 128 is two 64-column atoms, one after the other.  hd 112 (1.75
// atoms) takes a tile of 128 columns (`tile_cols`): its last 16 columns
// are zero-filled on load and never stored.  One tile serves as
// a K-major operand (its rows along M or N, its columns along K: Q K^T)
// and, through a second descriptor, as an MN-major one (its rows along K,
// its columns along N: P V).  Tile bases are 1024-byte aligned.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace tc {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
//! rows a warpgroup owns, and the rows of each streamed tile
constexpr int ROWS = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

//! 16 bytes from global to shared memory, asynchronously; `src_bytes` 0
//! reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

//! the same for 4 bytes
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

//! wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

//! attn::allow_smem, once per device for the kernel that owns `done`:
//! the launchers run it on every call, and the attribute stays set
template <typename K>
inline cudaError_t allow_smem_once(K kernel, size_t bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = attn::allow_smem(kernel, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

//! two floats rounded to nearest-even bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

//! 2^x on the special-function unit (ex2.approx.ftz: relative error
//! 2^-22; NEG_INF and below give 0)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

//! the 64 x N accumulator, rounded to bf16, as the A operands of a
//! product whose depth is those N columns, 16 at a time
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&af)[N / 16][4],
                                     const float (&c)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    af[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    af[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    af[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    af[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

//! columns of a tile that holds rows of hd bf16: hd for the head dims
//! that whole swizzle atoms tile (16, 32, 64, 128), else hd rounded up
//! to whole 64-column atoms (112 -> 128)
__host__ __device__ constexpr int tile_cols(int hd) {
  return hd <= 64 ? hd : (hd + 63) / 64 * 64;
}

//! this lane's share of a 64 x N accumulator, row g of the warp's 16
//! times mul0 and row g + 8 times mul1, as bf16 into rows row0 + g (+ 8)
//! of a (B, S, H, hd) tensor at `dst` (its (b, 0, h, 0)), rows `rs`
//! apart, its first NV columns (hd); rows at or past S are skipped
template <int N, int NV = N>
__device__ __forceinline__ void store_rows(bf16* dst, long long rs, int row0,
                                           int S, const float (&acc)[N / 8][4],
                                           float mul0, float mul1,
                                           int lane) {
  static_assert(NV % 8 == 0 && NV <= N, "whole 8-column groups");
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= S) continue;
    const float m = half ? mul1 : mul0;
    bf16* p = dst + row * rs + 2 * t;
#pragma unroll
    for (int n = 0; n < NV / 8; ++n)
      *reinterpret_cast<uint32_t*>(p + 8 * n) =
          pack_bf16(acc[n][2 * half] * m, acc[n][2 * half + 1] * m);
  }
}

//! the swizzled layout of a tile of rows of HD bf16
template <int HD>
struct Tile {
  //! columns per swizzle atom, and the atom's layout type in a wgmma
  //! descriptor: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr int AW = HD < 64 ? HD : 64;
  static constexpr int LAYOUT = AW == 64 ? 1 : AW == 32 ? 2 : 3;
  //! bytes between groups of 8 rows of an atom
  static constexpr uint32_t SBO = 8 * AW * 2;
  //! the 16-byte chunk of row r that holds its chunk c
  __device__ static __forceinline__ int chunk(int r, int c) {
    return c ^ (AW == 64 ? r % 8 : AW == 32 ? (r / 2) % 4 : (r / 4) % 2);
  }
};

//! rows [s0, s0 + R) of one head of a (B, S, H, HV) bf16 tensor (`src`
//! points at its (b, 0, h, 0), rows `rs` elements apart) into a swizzled
//! tile of HD columns at `dst`; rows past S, and columns HV .. HD - 1,
//! are zero-filled.  Asynchronous: all NT threads call it, then commit
//! and wait.
template <int R, int HD, int NT, int HV = HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long rs, int s0, int S,
                                          int tid) {
  using L = Tile<HD>;
  constexpr int CH = HD / 8;       // 16-byte chunks per row
  constexpr int CA = L::AW / 8;    // of them per atom
  constexpr int CV = HV / 8;       // of them holding data
  static_assert(HV % 8 == 0 && HV <= HD, "whole 16-byte chunks");
#pragma unroll
  for (int i = 0; i < (R * CH + NT - 1) / NT; ++i) {
    const int idx = tid + i * NT;
    if ((R * CH) % NT == 0 || idx < R * CH) {
      const int r = idx / CH, c = idx % CH;
      const int s = s0 + r;
      const bool in = s < S && c < CV;
      bf16* d = dst + (c / CA) * R * L::AW + r * L::AW +
                L::chunk(r, c % CA) * 8;
      cp_async16(d, in ? src + s * rs + c * 8 : src, in ? 16 : 0);
    }
  }
}

__device__ __forceinline__ uint64_t desc(const bf16* p, uint32_t lbo,
                                         uint32_t sbo, int layout) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(layout) << 62);
}

//! descriptor of a tile of R rows as a K-major operand, columns
//! [16 kk, 16 kk + 16) of every row
template <int HD, int R>
__device__ __forceinline__ uint64_t kdesc(const bf16* tile, int kk) {
  using L = Tile<HD>;
  constexpr int KA = L::AW / 16;  // k-steps per atom
  return desc(tile + (kk / KA) * R * L::AW, 16, L::SBO, L::LAYOUT) +
         2 * (kk % KA);  // 32 bytes further along the row, pre-swizzle
}

//! descriptor of rows [16 kk, 16 kk + 16) of a tile of R rows as an
//! MN-major operand, all HD columns (atoms R rows apart)
template <int HD, int R>
__device__ __forceinline__ uint64_t mndesc(const bf16* tile, int kk) {
  using L = Tile<HD>;
  return desc(tile + kk * 16 * L::AW, R * L::AW * 2, L::SBO, L::LAYOUT);
}

//! this thread's writes to shared memory (cp.async included) become
//! visible to wgmma's reads (the async proxy); a barrier follows
__device__ __forceinline__ void fence_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

//! keeps the compiler from moving reads or writes of an accumulator
//! across the asynchronous wgmma window
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}

//! d (64 x 64) (+)= A (64 x 16) * B (16 x 64), both K-major in shared
//! memory; `acc` 0 overwrites d
__device__ __forceinline__ void mma_ss(float (&d)[8][4], uint64_t da,
                                       uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(acc));
}

//! d (64 x N) (+)= A (64 x 16, registers, `to_a`) * B (16 x N), B
//! MN-major in shared memory; `acc` 0 overwrites d
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 8][4],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int acc) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
  }
}

}  // namespace tc
