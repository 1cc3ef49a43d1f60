// Flash-attention forward for Hopper (sm_90a), float32, on the CUDA
// cores: causal or full GQA attention with an online softmax, returning
// (o, lse).  bf16 inputs, the dtype of the serving and training paths,
// go to flash_attention_fwd_tc.cu (tensor cores); this kernel serves the
// float32 replays, whose 1e-5 tolerances TF32 products could not meet.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention_fwd (_fwd_kernel).  That kernel walks a sequential
// kv-block grid axis with m, l and the accumulator in VMEM scratch; here
// one block owns one (batch, q head, q tile) and loops over the kv tiles
// itself, since blocks run in no order on the card.
//
// What bounds it on this card: at the serving shapes (S a few hundred,
// hd 64) the bytes — q, k, v read once, o and lse written once — over
// the 3.35 TB/s of HBM; the FLOPs (4·S²/2·hd per head, causal) are below
// that at 989 TFLOP/s bf16.  What the design does about it: q is read
// once per block into shared memory and stays there, each k/v tile is
// staged once per block in shared memory and read by all 64 q rows of
// the tile, and when causal the loop stops at the diagonal tile, so
// tiles above it are never read (the reference's skip never fires).
// It computes in float32 on the CUDA cores.
//
// Layout: the model's (B, S, H, hd), read and written through strides,
// so the caller makes no transposed copy.  The kv head of q head h is
// h / (Hq / Hkv).  A ragged last tile (S % 64 != 0) is masked: any S is
// right.
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using attn::NEG_INF;
using attn::Strides;

constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // kv rows per tile
constexpr int NT = 128;  // threads: two per q row

template <int HD>
constexpr size_t smem_bytes() {
  // Q (BQ x HD+1), K (BK x HD+1), V (BK x HD), P (BQ x BK+1), float32
  return sizeof(float) *
         (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, Strides sq, Strides sk,
                     Strides sv, Strides so, int S, int Hq, int group,
                     int causal, float scale) {
  constexpr int LD = HD + 1;   // padded rows: no bank conflicts across rows
  constexpr int LP = BK + 1;
  constexpr int D2 = HD / 2;   // output columns per thread
  constexpr int J2 = BK / 2;   // score columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * HD;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x;
  const int r = tid >> 1;      // this thread's q row in the tile
  const int half = tid & 1;    // which half of the kv columns / hd
  const int q0 = qt * BQ;
  const int qi = q0 + r;       // its absolute position

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  for (int idx = tid; idx < BQ * HD; idx += NT) {
    const int rr = idx / HD, d = idx % HD;
    const int s = q0 + rr;
    Qs[rr * LD + d] = s < S ? attn::to_f32(qb[s * sq.s + d]) : 0.f;
  }

  float acc[D2];
#pragma unroll
  for (int i = 0; i < D2; ++i) acc[i] = 0.f;
  float m = NEG_INF, l = 0.f;

  const int n_all = (S + BK - 1) / BK;
  // causal: tiles past the one holding the tile's last row are all masked
  const int n_kv = causal ? min(n_all, (q0 + BQ - 1) / BK + 1) : n_all;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int j = idx / HD, d = idx % HD;
      const int s = k0 + j;
      const bool in = s < S;
      Ks[j * LD + d] = in ? attn::to_f32(kb[s * sk.s + d]) : 0.f;
      Vs[j * HD + d] = in ? attn::to_f32(vb[s * sv.s + d]) : 0.f;
    }
    __syncthreads();

    float sc[J2];
    float mx = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < J2; ++jj) {
      const int j = half * J2 + jj;
      const float* qr = Qs + r * LD;
      const float* kr = Ks + j * LD;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot += qr[d] * kr[d];
      const int kj = k0 + j;
      const bool ok = kj < S && (!causal || kj <= qi);
      sc[jj] = ok ? dot * scale : NEG_INF;
      mx = fmaxf(mx, sc[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < J2; ++jj) {
      const float p = expf(sc[jj] - m_new);
      Ps[r * LP + half * J2 + jj] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's other half (lane ^ 1) wrote its P columns

#pragma unroll
    for (int i = 0; i < D2; ++i) acc[i] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float p = Ps[r * LP + j];
      const float* vr = Vs + j * HD + half * D2;
#pragma unroll
      for (int i = 0; i < D2; ++i) acc[i] += p * vr[i];
    }
  }

  if (qi < S) {
    const float lc = fmaxf(l, 1e-30f);
    T* orow = o + b * so.b + qi * so.s + h * so.h + half * D2;
#pragma unroll
    for (int i = 0; i < D2; ++i) attn::store(orow + i, acc[i] / lc);
    if (half == 0) lse[((long long)b * Hq + h) * S + qi] = m + logf(lc);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, const long long* strides, int B, int S, int Hq,
                   int Hkv, int causal, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, HD>;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = attn::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      attn::strides_at(strides, 0), attn::strides_at(strides, 1),
      attn::strides_at(strides, 2), attn::strides_at(strides, 3), S, Hq,
      Hq / Hkv, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,S,Hq,hd), k/v (B,S,Hkv,hd), o (B,S,Hq,hd): float32, last dim
// contiguous; `strides` holds 12 element strides (dims 0-2 of q, k, v,
// o).  lse (B,Hq,S) float32, contiguous.  Launches on `stream`; returns
// cudaGetLastError().
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* o, void* lse, const void* strides,
                               int B, int S, int Hq, int Hkv, int hd,
                               int causal, float scale, void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<float, 16>(q, k, v, o, lse, st, B, S, Hq, Hkv, causal,
                               scale, s);
    case 32:
      return launch<float, 32>(q, k, v, o, lse, st, B, S, Hq, Hkv, causal,
                               scale, s);
    case 64:
      return launch<float, 64>(q, k, v, o, lse, st, B, S, Hq, Hkv, causal,
                               scale, s);
    case 112:  // zamba2-7b's shared attention
      return launch<float, 112>(q, k, v, o, lse, st, B, S, Hq, Hkv, causal,
                                scale, s);
    case 128:
      return launch<float, 128>(q, k, v, o, lse, st, B, S, Hq, Hkv, causal,
                                scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
