// The SMLA cascaded-pipeline matmul for Hopper (sm_90a): x (M, K) times a
// weight striped over L stacked layers, w (L, K/L, N), into (M, N) float32
// with float32-accurate products (bf16 inputs upcast exactly).
//
// Replaces the TPU kernel src/repro/kernels/smla_pipe/kernel.py:
// matmul_cascaded (_cascade_kernel, pallas_call at :68).  There the
// sequential grid axis walks layer 0's stripe chunks, then layer 1's, ...
// through one VMEM staging buffer into one accumulator: the Cascaded-IO
// slot rotation, the VMEM buffer playing the shared TSV bus.
// matmul_dedicated (Dedicated-IO: one call per layer slab into a private
// partial, the partials summed after) is L launches of the product kernel
// below, one per slab's chunk range, and one launch of the sum kernel.
//
// What bounds it on this card: operations.  At the realistic shape (the
// tinyllama-1.1b MLP up-projection over one training batch, x (8192,
// 2048), w (4, 512, 5632)) the product is 1.89e11 FLOP, 2.821 ms at the 67
// TFLOP/s of float32 FMA on the CUDA cores, against 0.089 ms for its 298
// MB.  The tensor cores multiply float32 only as TF32 (10 mantissa bits),
// one pass of which misses the kernel's float32 promise (1e-5 of max
// |ref|; tests/test_torch_smla_pipe.py emulates it).  So the design is
// 3xTF32: a = hi + lo with hi = tf32(a), lo = tf32(a - hi), and
// x w ~ x_hi w_hi + x_hi w_lo + x_lo w_hi, three wgmma products per chunk
// at the 495 TFLOP/s of dense TF32: 1.146 ms at the realistic shape, the
// least time float32-accurate products take on this card.  bf16 inputs
// are exact in TF32 (lo = 0), so they take one product per chunk.
//
// Three kernels:
//   stage_kernel    x and w to TF32 hi (and lo) planes, one pass.  wgmma
//                   takes TF32 operands only K-major, and w is N-major, so
//                   w is transposed here.  The planes are stacks of tiles
//                   of 128 rows (x rows, w columns) x one 32-float chunk
//                   of one layer's stripe, zero-padded past M, N and the
//                   stripe's end, each tile 16 KB, contiguous, with its
//                   128-byte rows already in wgmma's 128-byte swizzle
//                   (16-byte piece c of row r at c ^ (r % 8)).  Tile t of
//                   a row block is chunk t % n_k of layer t / n_k: the
//                   Cascaded-IO order is the planes' order.
//   product_kernel  persistent, one block per SM, each taking 128 x 128
//                   output tiles in turn: one producer warp streams the
//                   tiles' chunks t0 .. t1 - 1 with bulk copies (TMA, no
//                   tensor map: each staged tile is one contiguous run)
//                   into a ring of shared-memory stages under mbarriers,
//                   on across tiles; two consumer warpgroups of 64 rows
//                   issue the wgmma products.  The ring is the shared TSV
//                   bus: every layer's stripes pass through it in turn,
//                   into one accumulator.  Each chunk's products start
//                   from zero and are added into a float32 register
//                   accumulator: tensor-core accumulation truncates, and
//                   kept in the tensor cores' accumulator over a whole K
//                   of 2048 its bias crossed the 1e-5 tolerance at the
//                   realistic shape on an H100; summed per chunk it stays
//                   well inside it.
//   sum_kernel      Dedicated-IO's L partials, ((p0 + p1) + p2) + ...,
//                   in float32: bit-identical to the same torch adds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TR = 128;                  // rows of a staged tile
constexpr int TK = 32;                   // stripe rows per chunk
constexpr int TILE = TR * TK;            // floats of a staged tile
constexpr uint32_t TILE_BYTES = TILE * 4;
constexpr int BM = 128, BN = 128;        // output tile of a block
constexpr int NCONS = 256;               // two consumer warpgroups
constexpr int NT = NCONS + 32;           // and one producer warp
constexpr int GROUP_M = 8;               // row tiles per raster group
constexpr int RING_BYTES = 196608;       // the stages' shared memory

//! the ring of one product kernel: per stage the A (x) tile and the B (w)
//! tile of the hi plane, then, for float32 inputs, of the lo plane
template <bool THREE>
struct Ring {
  static constexpr int PLANES = THREE ? 2 : 1;
  static constexpr uint32_t PLANE = 2 * TILE_BYTES;
  static constexpr uint32_t STAGE = PLANES * PLANE;
  static constexpr int STAGES = RING_BYTES / STAGE;
  //! the stages, their full and empty barriers, 1024 bytes of alignment
  static constexpr size_t SMEM = STAGES * (STAGE + 16) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

//! a rounded to TF32, to nearest with ties away from zero (cvt.rna), as a
//! float32 whose 13 low mantissa bits are 0
__device__ __forceinline__ float tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return __uint_as_float(r & 0xFFFFE000u);
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(smem_u32(bar))
      : "memory");
}

//! wait until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

//! `bytes` from global to shared memory by the copy engine; completion
//! counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ------------------------------------------------------------------- wgmma

//! descriptor of a staged tile's rows as a K-major operand with the
//! 128-byte swizzle, k-step kk (8 TF32, 32 bytes) of each row
__device__ __forceinline__ uint64_t desc(const void* tile, int kk) {
  const uint64_t addr = smem_u32(tile) + 32 * kk;
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

//! wait until at most N committed wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

//! keeps the compiler from moving reads or writes of an accumulator
//! across the asynchronous wgmma window
__device__ __forceinline__ void fence_acc(float (&d)[16][4]) {
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}

//! d (64 x 128) (+)= A (64 x 8) B (8 x 128), TF32, both K-major in shared
//! memory; `acc` 0 overwrites d
__device__ __forceinline__ void mma(float (&d)[16][4], uint64_t da,
                                    uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(acc));
}

// ----------------------------------------------------------------- kernels

//! v's four floats, rounded to TF32, into 16 bytes at `hi`; with LO their
//! remainders, rounded the same way, `lo_off` floats further
template <bool LO>
__device__ __forceinline__ void put(float* hi, long long lo_off,
                                    const float (&v)[4]) {
  const float4 h = make_float4(tf32_rna(v[0]), tf32_rna(v[1]),
                               tf32_rna(v[2]), tf32_rna(v[3]));
  *reinterpret_cast<float4*>(hi) = h;
  if (LO)
    *reinterpret_cast<float4*>(hi + lo_off) =
        make_float4(tf32_rna(v[0] - h.x), tf32_rna(v[1] - h.y),
                    tf32_rna(v[2] - h.z), tf32_rna(v[3] - h.w));
}

//! one block per staged tile: blocks [0, x_tiles) the x tiles, the rest
//! the w tiles, each in plane order (row block, then chunk t of n_t)
template <typename T, bool LO>
__global__ void __launch_bounds__(256)
    stage_kernel(const T* __restrict__ x, long long ldx,
                 const T* __restrict__ w, float* __restrict__ planes, int M,
                 int N, int KPL, int n_k, int n_t, long long x_tiles,
                 long long lo_off) {
  __shared__ float wt[TK][TR + 1];  // a w chunk, for the transpose
  long long b = blockIdx.x;
  float* tile = planes + b * TILE;
  const bool is_x = b < x_tiles;
  if (!is_x) b -= x_tiles;
  const int r0 = (int)(b / n_t) * TR, t = (int)(b % n_t);
  const int layer = t / n_k, k0 = (t % n_k) * TK;
  const int kmax = min(TK, KPL - k0);
  if (!is_x) {
    const T* wc = w + ((long long)layer * KPL + k0) * N;
    for (int i = threadIdx.x; i < TK * TR; i += 256) {
      const int k = i / TR, r = i % TR, n = r0 + r;
      wt[k][r] = (k < kmax && n < N) ? to_f32(wc[(long long)k * N + n]) : 0.f;
    }
    __syncthreads();
  }
  const T* xc = x + (long long)layer * KPL + k0;
  // 16-byte piece q of the tile: row r, stored at c ^ (r % 8), holding the
  // row's floats 4 c .. 4 c + 3 of the chunk
  for (int q = threadIdx.x; q < TR * 8; q += 256) {
    const int r = q / 8, c = (q % 8) ^ (r % 8);
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * c + j;
      if (!is_x)
        v[j] = wt[k][r];
      else
        v[j] = (r0 + r < M && k < kmax)
                   ? to_f32(xc[(long long)(r0 + r) * ldx + k])
                   : 0.f;
    }
    put<LO>(tile + 4 * q, lo_off, v);
  }
}

//! the grouped raster: output tile `tile` is row block r of x and column
//! block c of w
__device__ __forceinline__ void tile_rc(int tile, int MT, int per_group,
                                        int& r, int& c) {
  const int g0 = tile / per_group * GROUP_M;
  const int gm = min(MT - g0, GROUP_M);
  r = g0 + tile % per_group % gm;
  c = tile % per_group / gm;
}

//! persistent: block b takes output tiles b, b + gridDim.x, ... (grouped
//! raster) and computes each, out (M, N) = the sum over chunks t0 .. t1 - 1
//! of A_t B_t, A from the x tiles, B from the w tiles (w_off floats into
//! the planes; the lo planes lo_off floats after the hi ones).  The ring
//! runs on across tiles, so the next tile's chunks load during a tile's
//! output store.
template <bool THREE>
__global__ void __launch_bounds__(NT, 1)
    product_kernel(const float* __restrict__ planes, float* __restrict__ out,
                   int M, int N, int n_t, int t0, int t1, int MT, int NT_w,
                   long long w_off, long long lo_off) {
  using R = Ring<THREE>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + R::STAGES * R::STAGE);
  uint64_t* empty = full + R::STAGES;
  const int tiles = MT * NT_w;
  const int per_group = GROUP_M * NT_w;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCONS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NCONS / 32) {  // the producer warp: one lane streams chunks
    if (lane != 0) return;
    int i = 0;  // chunks through the ring so far
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int r, c;  // this tile's first A and B tiles in the planes
      tile_rc(tile, MT, per_group, r, c);
      const long long a0 = (long long)r * n_t, b0 = (long long)c * n_t;
      for (int t = t0; t < t1; ++t, ++i) {
        const int s = i % R::STAGES;
        mbar_wait(&empty[s], ((i / R::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], R::STAGE);
        uint8_t* st = ring + s * R::STAGE;
#pragma unroll
        for (int p = 0; p < R::PLANES; ++p) {
          const float* pl = planes + p * lo_off;
          bulk_load(st + p * R::PLANE, pl + (a0 + t) * TILE, TILE_BYTES,
                    &full[s]);
          bulk_load(st + p * R::PLANE + TILE_BYTES,
                    pl + w_off + (b0 + t) * TILE, TILE_BYTES, &full[s]);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64 wg .. 64 wg + 63 of each tile; this
  // lane's share of them: rows g and g + 8 of its warp's 16, columns 2 tq
  // and 2 tq + 1 of each 8
  const int wg = warp / 4, g = lane / 4, tq = lane % 4;
  const bool pairs = N % 2 == 0;  // 8-byte aligned column pairs
  float d[16][4], acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[n][e] = 0.f;
  int i = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    for (int t = t0; t < t1; ++t, ++i) {
      const int s = i % R::STAGES;
      mbar_wait(&full[s], (i / R::STAGES) & 1);
      const uint8_t* a_hi = ring + s * R::STAGE + wg * (TILE_BYTES / 2);
      const uint8_t* b_hi = ring + s * R::STAGE + TILE_BYTES;
      fence_acc(d);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 8; ++kk) {  // the chunk's first overwrites
        mma(d, desc(a_hi, kk), desc(b_hi, kk), kk > 0);
        if (THREE) {
          mma(d, desc(a_hi, kk), desc(b_hi + R::PLANE, kk), 1);
          mma(d, desc(a_hi + R::PLANE, kk), desc(b_hi, kk), 1);
        }
      }
      wg_commit();
      wg_wait<0>();
      fence_acc(d);
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += d[n][e];
    }

    int r, c;
    tile_rc(tile, MT, per_group, r, c);
    const int row0 = r * BM + wg * 64 + (warp % 4) * 16 + g;
    const int col0 = c * BN + 2 * tq;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int col = col0 + 8 * n;
      if (col >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + 8 * half;
        if (row >= M) continue;
        float* o = out + (long long)row * N + col;
        const float v0 = acc[n][2 * half], v1 = acc[n][2 * half + 1];
        if (pairs) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (col + 1 < N) o[1] = v1;
        }
      }
    }
  }
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

//! out[i] = ((parts[0][i] + parts[1][i]) + parts[2][i]) + ..., L parts of
//! n elements each; one element per thread
template <typename V>
__global__ void __launch_bounds__(256)
    sum_kernel(const V* __restrict__ parts, V* __restrict__ out, long long n,
               int L) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= n) return;
  V s = parts[i];
#pragma unroll 4
  for (int l = 1; l < L; ++l) s = add(s, parts[l * n + i]);
  out[i] = s;
}

//! the planes' geometry: chunks per stripe, chunks in all, row blocks of
//! x and of w, and the offsets of the w tiles and of the lo planes
struct Planes {
  int n_k, n_t, MT, NT_w;
  long long w_off, lo_off;
  Planes(int M, int N, int KPL, int L)
      : n_k((KPL + TK - 1) / TK),
        n_t(L * n_k),
        MT((M + TR - 1) / TR),
        NT_w((N + TR - 1) / TR),
        w_off((long long)MT * n_t * TILE),
        lo_off((long long)(MT + NT_w) * n_t * TILE) {}
};

template <typename T>
cudaError_t stage(const void* x, long long ldx, const void* w, void* planes,
                  int M, int N, int KPL, int L, cudaStream_t s) {
  const Planes p(M, N, KPL, L);
  const long long x_tiles = (long long)p.MT * p.n_t;
  const long long blocks = x_tiles + (long long)p.NT_w * p.n_t;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  // float32 inputs need the lo planes; bf16 ones are exact in TF32
  constexpr bool LO = sizeof(T) == 4;
  stage_kernel<T, LO><<<(unsigned)blocks, 256, 0, s>>>(
      static_cast<const T*>(x), ldx, static_cast<const T*>(w),
      static_cast<float*>(planes), M, N, KPL, p.n_k, p.n_t, x_tiles,
      p.lo_off);
  return cudaGetLastError();
}

template <bool THREE>
cudaError_t product(const void* planes, void* out, int M, int N, int KPL,
                    int L, int t0, int t1, cudaStream_t s) {
  using R = Ring<THREE>;
  static int sms[64] = {};  // per device: its SMs, once the attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int n_sm = dev < 64 ? sms[dev] : 0;
  if (n_sm == 0) {
    err = cudaFuncSetAttribute(product_kernel<THREE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)R::SMEM);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return err;
    if (dev < 64) sms[dev] = n_sm;
  }
  const Planes p(M, N, KPL, L);
  if (t0 < 0 || t1 > p.n_t || t0 >= t1) return cudaErrorInvalidValue;
  const long long tiles = (long long)p.MT * p.NT_w;
  if (tiles > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const int blocks = (int)(tiles < n_sm ? tiles : n_sm);  // one per SM
  product_kernel<THREE><<<blocks, NT, R::SMEM, s>>>(
      static_cast<const float*>(planes), static_cast<float*>(out), M, N,
      p.n_t, t0, t1, p.MT, p.NT_w, p.w_off, p.lo_off);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M, K): rows `ldx` elements apart, each row contiguous; w (L, KPL, N)
// contiguous, of x's dtype (0 = float32, 1 = bfloat16), K = L * KPL.
// Writes the planes (float32; stage_kernel's layout: the x hi tiles, the
// w hi tiles, then, for float32, the lo tiles in the same order).
int smla_pipe_stage_launch(const void* x, const void* w, void* planes,
                           long long ldx, int M, int N, int KPL, int L,
                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || KPL < 1 || L < 1) return cudaErrorInvalidValue;
  if (dtype == 0)
    return stage<float>(x, ldx, w, planes, M, N, KPL, L, s);
  if (dtype == 1)
    return stage<__nv_bfloat16>(x, ldx, w, planes, M, N, KPL, L, s);
  return cudaErrorInvalidValue;
}

// out (M, N) float32, contiguous, = the products of chunks t0 .. t1 - 1 of
// the planes staged for (M, N, KPL, L); three = 1 for float32 inputs (hi
// and lo planes, three products), 0 for bf16 (hi only, one product).
int smla_pipe_product_launch(const void* planes, void* out, int M, int N,
                             int KPL, int L, int t0, int t1, int three,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || KPL < 1 || L < 1) return cudaErrorInvalidValue;
  return three ? product<true>(planes, out, M, N, KPL, L, t0, t1, s)
               : product<false>(planes, out, M, N, KPL, L, t0, t1, s);
}

// out (n) = ((parts[0] + parts[1]) + parts[2]) + ..., parts (L, n), all
// float32 and contiguous.
int smla_pipe_sum_launch(const void* parts, void* out, long long n, int L,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || L < 1) return cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && (uintptr_t)parts % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const long long m = vec ? n / 4 : n;
  const long long blocks = (m + 255) / 256;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  if (vec)
    sum_kernel<float4><<<(unsigned)blocks, 256, 0, s>>>(
        static_cast<const float4*>(parts), static_cast<float4*>(out), m, L);
  else
    sum_kernel<float><<<(unsigned)blocks, 256, 0, s>>>(
        static_cast<const float*>(parts), static_cast<float*>(out), m, L);
  return cudaGetLastError();
}

}  // extern "C"
