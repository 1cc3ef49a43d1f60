// Flash-decode for Hopper (sm_90a): one new token per lane attends to its
// KV cache, GQA, with per-lane valid lengths.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py:
// decode_attention (_decode_kernel).  That kernel walks a sequential
// chunk grid axis per (lane, kv head) with m, l and the accumulator in
// VMEM scratch and skips chunks past the lane's length; here one block
// owns one (lane, kv head) and loops over the chunks itself, stopping at
// the lane's length.
//
// What bounds it on this card: bytes.  A decode step reads the cache
// (len·Hkv·hd·2 values per lane) and does 4 FLOPs per value read per q
// head of the group, far below the ~295 FLOPs per byte at which the
// tensor cores would bind.  What the design does about it: the block
// holds all G = Hq/Hkv query heads of its kv head, so each cache byte is
// read from HBM once per kv head, not once per q head; positions at or
// past the lane's length are never read (whole chunks are skipped, the
// last chunk's tail is masked without a load); the cache is read in place
// in the model's (B, Smax, Hkv, hd) layout, with no transposed copy (the
// reference transposes the whole cache on every call).  One block per
// (lane, kv head) leaves most SMs idle at small batch: splitting the
// sequence over blocks is a later PR's work.
//
// Any Smax is right (the reference drops the tail when Smax % 256 != 0);
// lengths are clamped to [0, Smax].
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using attn::NEG_INF;
using attn::Strides;

constexpr int BK = 64;   // cache rows per chunk: two per lane of a warp
constexpr int NT = 128;  // threads per block (4 warps)

template <int HD>
size_t smem_bytes(int G) {
  // Q (G x HD), K (BK x HD+1), V (BK x HD), P (G x BK), acc (G x HD),
  // m, l, alpha (G each), float32
  return sizeof(float) * (G * HD + BK * (HD + 1) + BK * HD + G * BK +
                          G * HD + 3 * G);
}

template <typename T, typename C, int HD>
__global__ void __launch_bounds__(NT)
    decode_kernel(const T* __restrict__ q, const C* __restrict__ kc,
                  const C* __restrict__ vc, const int* __restrict__ lengths,
                  T* __restrict__ o, Strides sq, Strides sk, Strides sv,
                  Strides so, int Smax, int G, float scale) {
  constexpr int LD = HD + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + G * HD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * HD;
  float* Acc = Ps + G * BK;
  float* Ms = Acc + G * HD;
  float* Ls = Ms + G;
  float* Al = Ls + G;

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(lengths[b], 0), Smax);

  const T* qb = q + b * sq.b + (long long)hk * G * sq.h;
  for (int idx = tid; idx < G * HD; idx += NT) {
    const int g = idx / HD, d = idx % HD;
    Qs[idx] = attn::to_f32(qb[g * sq.h + d]);
    Acc[idx] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    Ms[g] = NEG_INF;
    Ls[g] = 0.f;
  }

  const C* kb = kc + b * sk.b + hk * sk.h;
  const C* vb = vc + b * sv.b + hk * sv.h;
  const int n_chunks = (len + BK - 1) / BK;
  for (int c = 0; c < n_chunks; ++c) {
    const int p0 = c * BK;
    __syncthreads();  // the previous chunk's readers are done
    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int j = idx / HD, d = idx % HD;
      const int pos = p0 + j;
      const bool in = pos < len;
      Ks[j * LD + d] = in ? attn::to_f32(kb[pos * sk.s + d]) : 0.f;
      Vs[j * HD + d] = in ? attn::to_f32(vb[pos * sv.s + d]) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < G * BK; idx += NT) {
      const int g = idx / BK, j = idx % BK;
      const float* qr = Qs + g * HD;
      const float* kr = Ks + j * LD;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot += qr[d] * kr[d];
      Ps[idx] = p0 + j < len ? dot * scale : NEG_INF;
    }
    __syncthreads();
    // online softmax, one warp per query head of the group
    for (int g = warp; g < G; g += NT / 32) {
      float* pr = Ps + g * BK;
      const float s0 = pr[lane], s1 = pr[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0v = expf(s0 - m_new), p1v = expf(s1 - m_new);
      pr[lane] = p0v;
      pr[lane + 32] = p1v;
      float sum = p0v + p1v;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Al[g] = alpha;
        Ls[g] = Ls[g] * alpha + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < G * HD; idx += NT) {
      const int g = idx / HD, d = idx % HD;
      const float* pr = Ps + g * BK;
      float a = Acc[idx] * Al[g];
      for (int j = 0; j < BK; ++j) a += pr[j] * Vs[j * HD + d];
      Acc[idx] = a;
    }
  }
  __syncthreads();
  T* ob = o + b * so.b + (long long)hk * G * so.h;
  for (int idx = tid; idx < G * HD; idx += NT) {
    const int g = idx / HD, d = idx % HD;
    attn::store(ob + g * so.h + d, Acc[idx] / fmaxf(Ls[g], 1e-30f));
  }
}

template <typename T, typename C, int HD>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* lengths, void* o, const long long* strides,
                   int B, int Smax, int Hkv, int G, float scale,
                   cudaStream_t stream) {
  auto kern = decode_kernel<T, C, HD>;
  const size_t smem = smem_bytes<HD>(G);
  cudaError_t err = attn::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(Hkv, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const C*>(kc),
      static_cast<const C*>(vc), static_cast<const int*>(lengths),
      static_cast<T*>(o), attn::strides_at(strides, 0),
      attn::strides_at(strides, 1), attn::strides_at(strides, 2),
      attn::strides_at(strides, 3), Smax, G, scale);
  return cudaGetLastError();
}

template <typename T, typename C>
cudaError_t launch_hd(int hd, const void* q, const void* kc, const void* vc,
                      const void* lengths, void* o, const long long* strides,
                      int B, int Smax, int Hkv, int G, float scale,
                      cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, C, 16>(q, kc, vc, lengths, o, strides, B, Smax, Hkv,
                              G, scale, stream);
    case 32:
      return launch<T, C, 32>(q, kc, vc, lengths, o, strides, B, Smax, Hkv,
                              G, scale, stream);
    case 64:
      return launch<T, C, 64>(q, kc, vc, lengths, o, strides, B, Smax, Hkv,
                              G, scale, stream);
    case 128:
      return launch<T, C, 128>(q, kc, vc, lengths, o, strides, B, Smax, Hkv,
                               G, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_cache(int cache_dtype, int hd, const void* q,
                         const void* kc, const void* vc, const void* lengths,
                         void* o, const long long* strides, int B, int Smax,
                         int Hkv, int G, float scale, cudaStream_t stream) {
  if (cache_dtype == 0)
    return launch_hd<T, float>(hd, q, kc, vc, lengths, o, strides, B, Smax,
                               Hkv, G, scale, stream);
  if (cache_dtype == 1)
    return launch_hd<T, __nv_bfloat16>(hd, q, kc, vc, lengths, o, strides, B,
                                       Smax, Hkv, G, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block needs for head dim `hd` and group G.
size_t decode_attention_smem(int hd, int G) {
  switch (hd) {
    case 16: return smem_bytes<16>(G);
    case 32: return smem_bytes<32>(G);
    case 64: return smem_bytes<64>(G);
    case 128: return smem_bytes<128>(G);
    default: return 0;
  }
}

// q (B,1,Hq,hd) and o (B,1,Hq,hd) of dtype `dtype`; k/v caches
// (B,Smax,Hkv,hd) of dtype `cache_dtype` (0 = float32, 1 = bfloat16); last
// dims contiguous; `strides` holds 12 element strides (dims 0-2 of q, k,
// v, o).  lengths (B,) int32.  Launches on `stream`; returns
// cudaGetLastError().
int decode_attention_launch(const void* q, const void* kc, const void* vc,
                            const void* lengths, void* o, const void* strides,
                            int B, int Smax, int Hkv, int G, int hd,
                            int dtype, int cache_dtype, float scale,
                            void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_cache<float>(cache_dtype, hd, q, kc, vc, lengths, o, st, B,
                               Smax, Hkv, G, scale, s);
  if (dtype == 1)
    return launch_cache<__nv_bfloat16>(cache_dtype, hd, q, kc, vc, lengths, o,
                                       st, B, Smax, Hkv, G, scale, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
