// The SMLA cascaded-pipeline matmul for Hopper (sm_90a): x (M, K) times a
// weight striped over L stacked layers, w (L, K/L, N), into (M, N) float32,
// both operands upcast to float32 before the product.
//
// Replaces the TPU kernel src/repro/kernels/smla_pipe/kernel.py:
// matmul_cascaded (_cascade_kernel).  There the sequential grid axis
// walks layer 0's stripe chunks, then layer 1's, ... through one VMEM
// staging buffer into one accumulator: the Cascaded-IO slot rotation,
// the VMEM buffer playing the shared TSV bus.  Here one block owns one
// 64 x 64 output tile and walks the same order itself (blocks run in no
// order on the card): each x chunk (64 x 16) and w chunk (16 x 64) passes
// through ONE shared-memory buffer, the bus, into one float32 accumulator
// in registers (a 4 x 4 micro-tile per thread), and the tile is written
// once.  matmul_dedicated (Dedicated-IO: one call per layer slab into a
// private partial, summed after) is L launches of this kernel, one per
// slab, as the reference makes L pallas_calls.
//
// Ragged shapes: any M, N and K/L are right.  Rows and columns past M
// and N are masked, and so is the tail of a stripe when K/L % 16 != 0:
// each masked element is staged as 0, which adds exactly 0.  (The
// reference's grid drops both: ROADMAP queue 3.)
//
// What bounds it on this card: operations.  At the realistic shape (the
// tinyllama-1.1b MLP up-projection over one training batch, x (8192,
// 2048), w (4, 512, 5632)) it does 1.89e11 FLOP, 2.8 ms at the 67 TFLOP/s
// of float32 FMA on the CUDA cores, against 0.09 ms for its 298 MB.  The
// reference promises float32 products, so no TF32 and no bf16 tensor
// cores; each thread reads its micro-tile's operands as two 16-byte
// shared-memory loads per 16 FMAs.  wgmma with TMA into a multi-stage
// ring is a later PR's work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 16;        // stripe rows per chunk through the bus
constexpr int NT = 256;       // threads: a 16 x 16 grid of 4 x 4 tiles
constexpr int LDX = BM + 4;   // padded, 16-byte aligned rows

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    cascade_kernel(const T* __restrict__ x, long long ldx,
                   const T* __restrict__ w, float* __restrict__ out, int M,
                   int N, int KPL, int L) {
  // the bus: one x chunk (transposed, k-major) and one w chunk
  __shared__ __align__(16) float xs[BK][LDX];
  __shared__ __align__(16) float ws[BK][BN];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tr = (tid / 16) * 4;  // this thread's rows in the tile
  const int tc = (tid % 16) * 4;  // and its columns

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int n_k = (KPL + BK - 1) / BK;  // chunks per layer stripe
  for (int t = 0; t < L * n_k; ++t) {
    const int layer = t / n_k;          // the reference's grid order
    const int k0 = (t % n_k) * BK;
    const int kmax = min(BK, KPL - k0);
    const T* xl = x + (long long)layer * KPL + k0;
    const T* wl = w + ((long long)layer * KPL + k0) * N;
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int r = idx / BK, c = idx % BK;
      const int gm = m0 + r;
      xs[c][r] = (gm < M && c < kmax) ? to_f32(xl[gm * ldx + c]) : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += NT) {
      const int r = idx / BN, c = idx % BN;
      const int gn = n0 + c;
      ws[r][c] = (r < kmax && gn < N) ? to_f32(wl[(long long)r * N + gn])
                                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][tr]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tc]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // the bus is free for the next chunk
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + tr + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tc + j;
      if (gn < N) out[(long long)gm * N + gn] = acc[i][j];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, long long ldx, const void* w, void* out,
                   int M, int N, int KPL, int L, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cascade_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), ldx, static_cast<const T*>(w),
      static_cast<float*>(out), M, N, KPL, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M, K): rows `ldx` elements apart, each row contiguous; w (L, KPL, N)
// contiguous, of x's dtype (0 = float32, 1 = bfloat16), K = L * KPL;
// out (M, N) float32, contiguous.  Launches on `stream`; returns
// cudaGetLastError().
int smla_pipe_cascaded_launch(const void* x, const void* w, void* out,
                              long long ldx, int M, int N, int KPL, int L,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || KPL < 1 || L < 1 || (M + BM - 1) / BM > 65535)
    return cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(x, ldx, w, out, M, N, KPL, L, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, ldx, w, out, M, N, KPL, L, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
