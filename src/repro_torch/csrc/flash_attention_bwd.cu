// Flash-attention backward for Hopper (sm_90a), float32, on the CUDA
// cores: dq, dk and dv of causal or full GQA attention, from the
// forward's o (through delta) and lse.  bf16 inputs, the dtype of the
// training path, go to flash_attention_bwd_tc.cu (tensor cores); this
// kernel serves the float32 replay, whose 1e-5 tolerance on every
// gradient leaf TF32 products could not meet.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention/kernel.py:
// flash_attention_bwd (_bwd_dkv_kernel, _bwd_dq_kernel).  Those walk a
// sequential grid axis with dk/dv (or dq) in VMEM scratch and write dk/dv
// per q head, summed into the kv heads afterwards in XLA.  Here, as the
// reference does, the backward is two kernels, but each block loops over
// its own tiles since blocks run in no order on the card:
//
//   dkdv: one block per (batch, kv head, 64-row kv tile).  It stages its
//         k and v tile once, walks the G q heads of its group and, for
//         each, the q tiles from the diagonal on (causal) or all of them,
//         and accumulates dk and dv in float32 registers.  So the GQA sum
//         happens in the kernel: each kv head's dk/dv is written once, no
//         (B, Hq, S, hd) float32 intermediate, no atomics.
//   dq:   one block per (batch, q head, 64-row q tile).  It stages q, do,
//         lse and delta once and walks the kv tiles up to the diagonal
//         (causal) or all of them, accumulating dq in float32 registers.
//
// Both are deterministic: every output element is summed by one thread in
// a fixed order.  delta = rowsum(do * o) comes in from the wrapper (the
// reference also computes it outside its Pallas calls).
//
// What bounds it on this card: at the training shape (B 4, S 2048, Hq 32,
// hd 64, causal) the FLOPs — five S x S x hd products per (batch, q head),
// halved by the causal mask — over the tensor cores' 989 TFLOP/s are
// above the bytes (q, k, v, o, do, lse read once; dq, dk, dv written
// once) over 3.35 TB/s.  This kernel does its products in float32 on the
// CUDA cores out of shared memory, seven products instead of five (s and
// dp are computed in both kernels), with each thread holding a 4 x 4
// micro-tile of the score tile so that every shared-memory load feeds two
// FMAs.
//
// Layout: the model's (B, S, H, hd) for q, k, v, do, dq, dk, dv, read and
// written through strides; lse and delta (B, Hq, S) float32, contiguous.
// The kv head of q head h is h / (Hq / Hkv).  A ragged last tile
// (S % 64 != 0) is masked: any S is right.
//
// Head dims 16, 32, 64, 112 and 128: any multiple of the thread grid's
// side (16) works, each thread holding hd / 16 output columns.  hd 112
// (zamba2-7b's shared attention) asks for 149,504 bytes of shared memory
// in dk/dv and 132,864 in dq, under hd 128's 165,888 and 149,248.
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using attn::Strides;

constexpr int BQ = 64;   // q rows per tile
constexpr int BK = 64;   // kv rows per tile
constexpr int TW = 16;   // threads per side of the 16 x 16 thread grid
constexpr int NT = TW * TW;
constexpr int MT = BQ / TW;  // rows (and score columns) per thread: 4
constexpr int LP = BK + 1;   // padded row of a score tile

static_assert(BQ == BK, "the causal tile bounds assume square tiles");

template <int HD>
constexpr size_t dkdv_smem_bytes() {
  // K, V, Q, dO (64 x HD+1), P, dS (64 x 65), lse, delta (64), float32
  return sizeof(float) * (4 * BQ * (HD + 1) + 2 * BQ * LP + 2 * BQ);
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  // K, V, Q, dO (64 x HD+1), dS (64 x 65), lse, delta (64), float32
  return sizeof(float) * (4 * BQ * (HD + 1) + BQ * LP + 2 * BQ);
}

//! rows [s0, s0 + 64) of one head of a (B, S, H, hd) tensor (`src` points
//! at its (b, 0, h, 0)) into shared memory as float32, rows past S zero
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int s0,
                                          int S, int tid) {
  constexpr int LD = HD + 1;
  for (int idx = tid; idx < BQ * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    const int s = s0 + r;
    dst[r * LD + d] = s < S ? attn::to_f32(src[s * row_stride + d]) : 0.f;
  }
}

//! 64 entries [s0, s0 + 64) of a float32 row (lse or delta), past S zero
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int s0, int S, int tid) {
  if (tid < BQ) dst[tid] = s0 + tid < S ? src[s0 + tid] : 0.f;
}

//! For the q tile at q0 and the kv tile at k0, both staged: the
//! probabilities p = exp(q.k * scale - lse) (0 where masked) and
//! ds = p * (do.v - delta) * scale, into Ps (if WRITE_P) and dSs.  Thread
//! (tx, ty) computes rows ty + 16a and columns tx + 16c, a, c < 4.
template <int HD, bool WRITE_P>
__device__ __forceinline__ void tile_ds(const float* Qs, const float* dOs,
                                        const float* Ks, const float* Vs,
                                        const float* lse_s,
                                        const float* del_s, float* Ps,
                                        float* dSs, int q0, int k0, int S,
                                        int causal, float scale, int tx,
                                        int ty) {
  constexpr int LD = HD + 1;
  float s[MT][MT], dp[MT][MT];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int c = 0; c < MT; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qa[MT], oa[MT], kc[MT], vc[MT];
#pragma unroll
    for (int a = 0; a < MT; ++a) {
      qa[a] = Qs[(ty + TW * a) * LD + d];
      oa[a] = dOs[(ty + TW * a) * LD + d];
      kc[a] = Ks[(tx + TW * a) * LD + d];
      vc[a] = Vs[(tx + TW * a) * LD + d];
    }
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
      for (int c = 0; c < MT; ++c) {
        s[a][c] += qa[a] * kc[c];
        dp[a][c] += oa[a] * vc[c];
      }
  }
#pragma unroll
  for (int a = 0; a < MT; ++a) {
    const int i = ty + TW * a;
    const int qi = q0 + i;
    const float lse = lse_s[i], del = del_s[i];
#pragma unroll
    for (int c = 0; c < MT; ++c) {
      const int j = tx + TW * c;
      const int kj = k0 + j;
      const bool ok = qi < S && kj < S && (!causal || kj <= qi);
      const float p = ok ? expf(s[a][c] * scale - lse) : 0.f;
      if (WRITE_P) Ps[i * LP + j] = p;
      dSs[i * LP + j] = p * (dp[a][c] - del) * scale;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, Strides sq, Strides sk,
                          Strides sv, Strides sdo, Strides sdk, Strides sdv,
                          int S, int Hq, int group, int causal, float scale) {
  constexpr int LD = HD + 1;
  constexpr int DC = HD / TW;  // output columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LP;
  float* lse_s = dSs + BQ * LP;
  float* del_s = lse_s + BQ;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % TW, ty = tid / TW;
  const int k0 = kt * BK;
  load_tile<T, HD>(Ks, k + b * sk.b + hk * sk.h, sk.s, k0, S, tid);
  load_tile<T, HD>(Vs, v + b * sv.b + hk * sv.h, sv.s, k0, S, tid);

  // dk, dv rows ty + 16a of the kv tile, columns tx + 16c
  float dk_acc[MT][DC], dv_acc[MT][DC];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  const int n_q = (S + BQ - 1) / BQ;
  // causal: q tiles wholly above the diagonal see none of this kv tile
  const int qt0 = causal ? k0 / BQ : 0;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = q + b * sq.b + h * sq.h;
    const T* ob = dout + b * sdo.b + h * sdo.h;
    const long long row0 = ((long long)b * Hq + h) * S;
    for (int qt = qt0; qt < n_q; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, HD>(Qs, qb, sq.s, q0, S, tid);
      load_tile<T, HD>(dOs, ob, sdo.s, q0, S, tid);
      load_rows(lse_s, lse + row0, q0, S, tid);
      load_rows(del_s, delta + row0, q0, S, tid);
      __syncthreads();
      tile_ds<HD, true>(Qs, dOs, Ks, Vs, lse_s, del_s, Ps, dSs, q0, k0, S,
                        causal, scale, tx, ty);
      __syncthreads();
      // dv[j] += sum_i p[i][j] do[i];  dk[j] += sum_i ds[i][j] q[i]
      for (int i = 0; i < BQ; ++i) {
        float pa[MT], sa[MT], oc[DC], qc[DC];
#pragma unroll
        for (int a = 0; a < MT; ++a) {
          pa[a] = Ps[i * LP + ty + TW * a];
          sa[a] = dSs[i * LP + ty + TW * a];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          oc[c] = dOs[i * LD + tx + TW * c];
          qc[c] = Qs[i * LD + tx + TW * c];
        }
#pragma unroll
        for (int a = 0; a < MT; ++a)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dv_acc[a][c] += pa[a] * oc[c];
            dk_acc[a][c] += sa[a] * qc[c];
          }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < MT; ++a) {
    const int kj = k0 + ty + TW * a;
    if (kj >= S) continue;
    T* dkr = dk + b * sdk.b + kj * sdk.s + hk * sdk.h;
    T* dvr = dv + b * sdv.b + kj * sdv.s + hk * sdv.h;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      attn::store(dkr + tx + TW * c, dk_acc[a][c]);
      attn::store(dvr + tx + TW * c, dv_acc[a][c]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        Strides sq, Strides sk, Strides sv, Strides sdo,
                        Strides sdq, int S, int Hq, int group, int causal,
                        float scale) {
  constexpr int LD = HD + 1;
  constexpr int DC = HD / TW;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* dSs = dOs + BQ * LD;
  float* lse_s = dSs + BQ * LP;
  float* del_s = lse_s + BQ;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x, tx = tid % TW, ty = tid / TW;
  const int q0 = qt * BQ;
  const long long row0 = ((long long)b * Hq + h) * S;
  load_tile<T, HD>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, tid);
  load_tile<T, HD>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S, tid);
  load_rows(lse_s, lse + row0, q0, S, tid);
  load_rows(del_s, delta + row0, q0, S, tid);

  // dq rows ty + 16a of the q tile, columns tx + 16c
  float dq_acc[MT][DC];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq_acc[a][c] = 0.f;

  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  const int n_all = (S + BK - 1) / BK;
  // causal: kv tiles past the one holding the tile's last row are masked
  const int n_kv = causal ? min(n_all, (q0 + BQ - 1) / BK + 1) : n_all;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, HD>(Ks, kb, sk.s, k0, S, tid);
    load_tile<T, HD>(Vs, vb, sv.s, k0, S, tid);
    __syncthreads();
    tile_ds<HD, false>(Qs, dOs, Ks, Vs, lse_s, del_s, nullptr, dSs, q0, k0,
                       S, causal, scale, tx, ty);
    __syncthreads();
    // dq[i] += sum_j ds[i][j] k[j]
    for (int j = 0; j < BK; ++j) {
      float sa[MT], kc[DC];
#pragma unroll
      for (int a = 0; a < MT; ++a) sa[a] = dSs[(ty + TW * a) * LP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) kc[c] = Ks[j * LD + tx + TW * c];
#pragma unroll
      for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int c = 0; c < DC; ++c) dq_acc[a][c] += sa[a] * kc[c];
    }
  }

#pragma unroll
  for (int a = 0; a < MT; ++a) {
    const int qi = q0 + ty + TW * a;
    if (qi >= S) continue;
    T* dqr = dq + b * sdq.b + qi * sdq.s + h * sdq.h;
#pragma unroll
    for (int c = 0; c < DC; ++c) attn::store(dqr + tx + TW * c, dq_acc[a][c]);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, const long long* st, int B,
                   int S, int Hq, int Hkv, int causal, float scale,
                   cudaStream_t stream) {
  static_assert(HD % TW == 0, "head dim must be a multiple of 16");
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* op = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  const Strides sq = attn::strides_at(st, 0), sk = attn::strides_at(st, 1),
                sv = attn::strides_at(st, 2), sdo = attn::strides_at(st, 3),
                sdq = attn::strides_at(st, 4), sdk = attn::strides_at(st, 5),
                sdv = attn::strides_at(st, 6);
  const int group = Hq / Hkv;

  auto dkdv = flash_bwd_dkdv_kernel<T, HD>;
  const size_t smem1 = dkdv_smem_bytes<HD>();
  cudaError_t err = attn::allow_smem(dkdv, smem1);
  if (err != cudaSuccess) return err;
  dim3 grid1((S + BK - 1) / BK, Hkv, B);
  dkdv<<<grid1, NT, smem1, stream>>>(qp, kp, vp, op, lp, dp,
                                     static_cast<T*>(dk), static_cast<T*>(dv),
                                     sq, sk, sv, sdo, sdk, sdv, S, Hq, group,
                                     causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_kernel<T, HD>;
  const size_t smem2 = dq_smem_bytes<HD>();
  err = attn::allow_smem(dqk, smem2);
  if (err != cudaSuccess) return err;
  dim3 grid2((S + BQ - 1) / BQ, Hq, B);
  dqk<<<grid2, NT, smem2, stream>>>(qp, kp, vp, op, lp, dp,
                                    static_cast<T*>(dq), sq, sk, sv, sdo, sdq,
                                    S, Hq, group, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, do, dq (B,S,Hq,hd) and k, v, dk, dv (B,S,Hkv,hd): float32, last dim
// contiguous; `strides` holds 21 element strides (dims 0-2 of q, k, v,
// do, dq, dk, dv).  lse and delta (B,Hq,S) float32, contiguous.  Launches
// the dk/dv kernel, then the dq kernel, on `stream`; returns the first
// launch error, else cudaGetLastError().
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, void* dk,
                               void* dv, const void* strides, int B, int S,
                               int Hq, int Hkv, int hd, int causal,
                               float scale, void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<float, 16>(q, k, v, dout, lse, delta, dq, dk, dv, st, B,
                               S, Hq, Hkv, causal, scale, s);
    case 32:
      return launch<float, 32>(q, k, v, dout, lse, delta, dq, dk, dv, st, B,
                               S, Hq, Hkv, causal, scale, s);
    case 64:
      return launch<float, 64>(q, k, v, dout, lse, delta, dq, dk, dv, st, B,
                               S, Hq, Hkv, causal, scale, s);
    case 112:
      return launch<float, 112>(q, k, v, dout, lse, delta, dq, dk, dv, st, B,
                                S, Hq, Hkv, causal, scale, s);
    case 128:
      return launch<float, 128>(q, k, v, dout, lse, delta, dq, dk, dv, st, B,
                                S, Hq, Hkv, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
