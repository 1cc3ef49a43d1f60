// Flash-decode for Hopper (sm_90a): one new token per lane attends to its
// KV cache, GQA, with per-lane valid lengths.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py:
// decode_attention (_decode_kernel).  That kernel walks a sequential
// chunk grid axis per (lane, kv head) with m, l and the accumulator in
// VMEM scratch and skips chunks past the lane's length.  Here the cache
// rows of a (lane, kv head) are split over blocks (split-KV): grid
// (splits, Hkv, B), each block one contiguous range of rows, and a second
// kernel merges the blocks' partial softmax states.
//
// What bounds it on this card: bytes, and at the serving shape latency.
// A decode step reads the cache (len·Hkv·hd·2 values per lane) and does 4
// FLOPs per value read per q head of the group, far below the ~295 FLOPs
// per byte at which the tensor cores would bind, so the products stay on
// the CUDA cores in float32.  At the serving shape (B 8, Hkv 4, 512 rows)
// the whole cache is ~1 MB: one block per (lane, kv head) gave 32 blocks
// on 132 SMs, each walking its rows chunk after chunk.  What the design
// does about it:
//   * split-KV: the host picks the split count from Smax, B, Hkv and the
//     SM count (never from the lengths, which stay on the card), so that
//     about two blocks per SM load their chunks at once;
//   * each block keeps all G = Hq/Hkv query heads of its kv head, so each
//     cache byte is read from HBM once per kv head, not once per q head;
//   * the cache is read in place in the model's (B, Smax, Hkv, hd) layout
//     with 16-byte loads (8 bf16 or 4 float32 per thread; neighbouring
//     threads on neighbouring 16 bytes of a row) into an unpadded tile;
//     K's 16-byte units are XOR-swizzled by row within whole groups of 8
//     units (of all of a row's units below 8), so the lanes of a warp,
//     one row each, read without bank conflicts; a row of hd 112 (14
//     bf16 or 28 float32 units, zamba2-7b's shared attention) keeps its
//     last 6 or 4 units in place;
//   * a warp takes a q head: its lanes hold two rows' scores each, the
//     softmax max and sum are warp shuffles, and P reaches the PV product
//     by shuffles, not through shared memory;
//   * positions at or past the lane's length are never read: a split that
//     starts there writes the empty partial (m = -inf, l = 0, acc = 0)
//     and exits, the last chunk stops at the length.
// The combine merges a (lane, kv head)'s partials in split order, so the
// result is deterministic, and writes o in q's dtype; its arithmetic is
// ref.combine_splits's, step for step (expf, then separately rounded
// products and sums), so the two agree bit for bit.
//
// The combine runs as a second kernel, launched by the same C call, so
// the host pays one call for both.  The alternative, the last-arriving
// block of each (lane, kv head) merging behind an atomic counter, was
// built and timed beside it at the serving shape (PERF.md, PR 17): the
// same device time (the split blocks that arrive last wait on the merge
// either way), but it needs counters that persist, zeroed, from call to
// call, and a fault in one call would leave them wrong for the next.  So
// the second kernel.
//
// Any Smax is right (the reference drops the tail when Smax % 256 != 0);
// lengths are clamped to [0, Smax]; a lane of length 0 gives zeros, as
// the reference's Pallas kernel does.
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using attn::Strides;

constexpr int BK = 64;   // cache rows per chunk
constexpr int NT = 256;  // threads per split block (8 warps)
constexpr int NW = NT / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int MAX_DEVICES = 64;

// A 16-byte unit of cache elements, widened to float32 (exactly).
template <typename C>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* x) {
    x[0] = __uint_as_float(u.x);
    x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z);
    x[3] = __uint_as_float(u.w);
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* x) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i is the low half
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Where unit c of row j of a K tile lies in its row (CPR units of 16
// bytes a row): XOR-swizzled by the row within whole groups of 8 units
// (all CPR when CPR < 8, a power of two); the units past the last whole
// group (hd 112: 6 of 14 bf16 units, 4 of 28 float32) stay in place.
template <int CPR>
__device__ __forceinline__ int swizzled(int j, int c) {
  constexpr int SWW = CPR < 8 ? CPR : 8;  // units one swizzle permutes
  constexpr int SWC = CPR - CPR % SWW;    // units that are swizzled
  return c < SWC ? c ^ (j & (SWW - 1)) : c;
}

template <typename C, int HD>
size_t smem_bytes(int G) {
  // K and V tiles (BK x HD cache elements), Q and acc (G x HD), m, l (G)
  return 2 * sizeof(C) * BK * HD + sizeof(float) * (2 * G * HD + 2 * G);
}

template <typename T, typename C, int HD>
__global__ void __launch_bounds__(NT)
    decode_split_kernel(const T* __restrict__ q, const C* __restrict__ kc,
                        const C* __restrict__ vc,
                        const int* __restrict__ lengths, float* ws,
                        Strides sq, Strides sk, Strides sv, int Smax, int G,
                        int rows, float scale) {
  using V = Vec16<C>;
  constexpr int EPV = V::N;            // cache elements per 16 bytes
  constexpr int CPR = HD / EPV;        // 16-byte units per row
  constexpr int DPL = (HD + 31) / 32;        // PV outputs per lane
  extern __shared__ uint4 smem_u4[];
  uint4* Ks = smem_u4;
  uint4* Vs4 = Ks + BK * CPR;
  const C* Vs = reinterpret_cast<const C*>(Vs4);
  float* Qs = reinterpret_cast<float*>(Vs4 + BK * CPR);
  float* Acc = Qs + G * HD;
  float* Ms = Acc + G * HD;
  float* Ls = Ms + G;

  const int s = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int S = gridDim.x, Hkv = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(lengths[b], 0), Smax);
  const int r0 = s * rows, r1 = min(r0 + rows, len);
  // the workspace: m and l (B, Hkv, S, G), then acc (B, Hkv, S, G, HD)
  const long long n_part = (long long)gridDim.z * Hkv * S * G;
  const long long at = ((long long)(b * Hkv + hk) * S + s) * G;
  float* const wm = ws + at;
  float* const wl = ws + n_part + at;
  float* const wacc = ws + 2 * n_part + at * HD;

  if (r0 >= r1) {  // nothing of this lane here: the empty partial
    for (int idx = tid; idx < G * HD; idx += NT) wacc[idx] = 0.f;
    for (int g = tid; g < G; g += NT) {
      wm[g] = -INFINITY;
      wl[g] = 0.f;
    }
  } else {
    const T* qb = q + b * sq.b + (long long)hk * G * sq.h;
    for (int idx = tid; idx < G * HD; idx += NT) {
      Qs[idx] = attn::to_f32(qb[(idx / HD) * sq.h + idx % HD]);
      Acc[idx] = 0.f;
    }
    for (int g = tid; g < G; g += NT) {
      Ms[g] = -INFINITY;
      Ls[g] = 0.f;
    }
    const C* kb = kc + b * sk.b + (long long)hk * sk.h;
    const C* vb = vc + b * sv.b + (long long)hk * sv.h;
    for (int p0 = r0; p0 < r1; p0 += BK) {
      const int n = min(BK, r1 - p0);
      // the previous chunk's readers are done (the first chunk's loads
      // fly with q's)
      if (p0 != r0) __syncthreads();
      for (int idx = tid; idx < n * CPR; idx += NT) {
        const int j = idx / CPR, c = idx % CPR;
        const long long row = p0 + j;
        Ks[j * CPR + swizzled<CPR>(j, c)] =
            *reinterpret_cast<const uint4*>(kb + row * sk.s + c * EPV);
        Vs4[j * CPR + c] =
            *reinterpret_cast<const uint4*>(vb + row * sv.s + c * EPV);
      }
      __syncthreads();
      for (int g = warp; g < G; g += NW) {
        const float* qg = Qs + g * HD;
        float sc[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = lane + 32 * h;
          float dot[2] = {0.f, 0.f};  // two chains, half the latency
          if (j < n) {
#pragma unroll
            for (int c = 0; c < CPR; ++c) {
              float kv[EPV];
              V::unpack(Ks[j * CPR + swizzled<CPR>(j, c)], kv);
#pragma unroll
              for (int e = 0; e < EPV; ++e)
                dot[e & 1] += qg[c * EPV + e] * kv[e];
            }
          }
          sc[h] = j < n ? (dot[0] + dot[1]) * scale : -INFINITY;
        }
        float mx = fmaxf(sc[0], sc[1]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        const float m_old = Ms[g];
        const float m_new = fmaxf(m_old, mx);  // finite: the chunk has a row
        const float p0v = expf(sc[0] - m_new), p1v = expf(sc[1] - m_new);
        float sum = p0v + p1v;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(FULL, sum, off);
        const float alpha = expf(m_old - m_new);  // 0 on the first chunk
        float a[DPL], b2[DPL];  // even and odd rows: two chains
#pragma unroll
        for (int u = 0; u < DPL; ++u) {
          const int d = lane + 32 * u;
          a[u] = d < HD ? Acc[g * HD + d] * alpha : 0.f;
          b2[u] = 0.f;
        }
        for (int j = 0; j < n; j += 2) {
          const float pa = __shfl_sync(FULL, j < 32 ? p0v : p1v, j & 31);
          const float pb =
              __shfl_sync(FULL, j + 1 < 32 ? p0v : p1v, (j + 1) & 31);
          const bool odd = j + 1 < n;
#pragma unroll
          for (int u = 0; u < DPL; ++u) {
            const int d = lane + 32 * u;
            if (d < HD) {
              a[u] += pa * attn::to_f32(Vs[j * HD + d]);
              if (odd) b2[u] += pb * attn::to_f32(Vs[(j + 1) * HD + d]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < DPL; ++u) {
          const int d = lane + 32 * u;
          if (d < HD) Acc[g * HD + d] = a[u] + b2[u];
        }
        __syncwarp();  // every lane has read Ms[g] and Ls[g]
        if (lane == 0) {
          Ms[g] = m_new;
          Ls[g] = Ls[g] * alpha + sum;
        }
      }
    }
    __syncthreads();
    for (int idx = tid; idx < G * HD; idx += NT) wacc[idx] = Acc[idx];
    for (int g = tid; g < G; g += NT) {
      wm[g] = Ms[g];
      wl[g] = Ls[g];
    }
  }
}

// Merges the S partials of each (lane, kv head) in split order, as
// ref.combine_splits does.  Grid (G, Hkv, B): a block per q head of a
// (lane, kv head), a thread per output (blockDim.x = max(HD, 32)), so each
// thread's loads of the S partials fly together.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ ws, T* o,
                                      Strides so, int S, int HD) {
  const int g = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = gridDim.x, Hkv = gridDim.y, d = threadIdx.x;
  if (d >= HD) return;
  const long long n_part = (long long)gridDim.z * Hkv * S * G;
  const long long at = (long long)(b * Hkv + hk) * S * G + g;
  const float* pm = ws + at;            // m of split s at pm[s * G]
  const float* pl = ws + n_part + at;
  const float* pa = ws + 2 * n_part + at * HD + d;
  float M = -INFINITY;
#pragma unroll 8
  for (int s = 0; s < S; ++s) M = fmaxf(M, pm[s * G]);
  float L = 0.f, A = 0.f;
#pragma unroll 8
  for (int s = 0; s < S; ++s) {
    const float m = pm[s * G];
    const float w = m == -INFINITY ? 0.f : expf(m - M);
    L = __fadd_rn(L, __fmul_rn(w, pl[s * G]));
    A = __fadd_rn(A, __fmul_rn(w, pa[(long long)s * G * HD]));
  }
  attn::store(o + b * so.b + (long long)(hk * G + g) * so.h + d,
              __fdiv_rn(A, fmaxf(L, 1e-30f)));
}

struct Args {
  const void *q, *kc, *vc, *lengths;
  void *o, *ws;
  const long long* strides;
  int B, Smax, Hkv, G, S, rows;
  float scale;
  cudaStream_t stream;
};

//! dynamic shared memory above 48 KB, asked for once per kernel, device
//! and size (it is a property of the function, not of the launch);
//! `allowed` is the kernel's own record, per device, of what it was
//! granted
template <typename K>
cudaError_t allow_smem_once(K kernel, size_t bytes, size_t* allowed) {
  if (bytes <= SMEM_DEFAULT) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= MAX_DEVICES) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && bytes > allowed[dev]) {
    err = attn::allow_smem(kernel, bytes);
    if (err == cudaSuccess) allowed[dev] = bytes;
  }
  if (err != cudaSuccess) cudaGetLastError();  // not left for a later launch
  return err;
}

template <typename T>
cudaError_t launch_combine(const Args& a, int HD) {
  decode_combine_kernel<T><<<dim3(a.G, a.Hkv, a.B), HD < 32 ? 32 : HD, 0,
                             a.stream>>>(static_cast<const float*>(a.ws),
                                         static_cast<T*>(a.o),
                                         attn::strides_at(a.strides, 3),
                                         a.S, HD);
  return cudaGetLastError();
}

template <typename T, typename C, int HD>
cudaError_t launch(const Args& a) {
  static size_t allowed[MAX_DEVICES] = {};
  auto kern = decode_split_kernel<T, C, HD>;
  const size_t smem = smem_bytes<C, HD>(a.G);
  cudaError_t err = allow_smem_once(kern, smem, allowed);
  if (err != cudaSuccess) return err;
  kern<<<dim3(a.S, a.Hkv, a.B), NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const C*>(a.kc),
      static_cast<const C*>(a.vc), static_cast<const int*>(a.lengths),
      static_cast<float*>(a.ws), attn::strides_at(a.strides, 0),
      attn::strides_at(a.strides, 1), attn::strides_at(a.strides, 2),
      a.Smax, a.G, a.rows, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.o == nullptr) return err;
  return launch_combine<T>(a, HD);
}

template <typename T, typename C>
cudaError_t launch_hd(int hd, const Args& a) {
  switch (hd) {
    case 16: return launch<T, C, 16>(a);
    case 32: return launch<T, C, 32>(a);
    case 64: return launch<T, C, 64>(a);
    case 112: return launch<T, C, 112>(a);
    case 128: return launch<T, C, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_cache(int cache_dtype, int hd, const Args& a) {
  if (cache_dtype == 0) return launch_hd<T, float>(hd, a);
  if (cache_dtype == 1) return launch_hd<T, __nv_bfloat16>(hd, a);
  return cudaErrorInvalidValue;
}

template <typename C>
size_t smem_hd(int hd, int G) {
  switch (hd) {
    case 16: return smem_bytes<C, 16>(G);
    case 32: return smem_bytes<C, 32>(G);
    case 64: return smem_bytes<C, 64>(G);
    case 112: return smem_bytes<C, 112>(G);
    case 128: return smem_bytes<C, 128>(G);
    default: return 0;
  }
}

}  // namespace

extern "C" {

// Shared memory (bytes) one split block needs for head dim `hd`, group G
// and cache dtype `cache_dtype` (0 = float32, 1 = bfloat16).
size_t decode_attention_smem(int hd, int G, int cache_dtype) {
  return cache_dtype == 0 ? smem_hd<float>(hd, G)
                          : smem_hd<__nv_bfloat16>(hd, G);
}

// q (B,1,Hq,hd) and o (B,1,Hq,hd) of dtype `dtype`; k/v caches
// (B,Smax,Hkv,hd) of dtype `cache_dtype` (0 = float32, 1 = bfloat16), last
// dims contiguous, bases and strides 16-byte aligned; `strides` holds 12
// element strides (dims 0-2 of q, k, v, o).  lengths (B,) int32.  `ws`:
// float32 workspace of 2·B·Hkv·S·G + B·Hkv·S·G·hd words (S = `splits`,
// each of `rows` cache rows, a multiple of 64).  Launches the split kernel
// and then the combine kernel on `stream`; returns cudaGetLastError().
// With `o` null it launches the split kernel alone: the partials stay in
// `ws` for a combine over several ranks' workspaces (a sequence-sharded
// cache), which decode_attention_combine_launch then runs.
int decode_attention_launch(const void* q, const void* kc, const void* vc,
                            const void* lengths, void* o, void* ws,
                            const void* strides, int B, int Smax, int Hkv,
                            int G, int hd, int dtype, int cache_dtype,
                            int splits, int rows, float scale,
                            void* stream) {
  const Args a{q, kc, vc, lengths, o, ws,
               static_cast<const long long*>(strides), B, Smax, Hkv, G,
               splits, rows, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_cache<float>(cache_dtype, hd, a);
  if (dtype == 1) return launch_cache<__nv_bfloat16>(cache_dtype, hd, a);
  return cudaErrorInvalidValue;
}

// The combine kernel alone, over a workspace the split kernel filled:
// o (B,1,Hq,hd) of dtype `dtype` with the element strides `o_strides`
// (dims 0-2).  Launches on `stream`; returns cudaGetLastError().
int decode_attention_combine_launch(void* ws, void* o, const void* o_strides,
                                    int B, int Hkv, int G, int hd,
                                    int splits, int dtype, void* stream) {
  const long long* st = static_cast<const long long*>(o_strides);
  const long long strides[12] = {0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 st[0], st[1], st[2]};
  const Args a{nullptr, nullptr, nullptr, nullptr, o, ws,
               strides, B, 0, Hkv, G, splits, 0, 0.f,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_combine<float>(a, hd);
  if (dtype == 1) return launch_combine<__nv_bfloat16>(a, hd);
  return cudaErrorInvalidValue;
}

}  // extern "C"
