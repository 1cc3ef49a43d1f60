// Flash-attention backward for Hopper (sm_90a), bf16, on the tensor cores:
// dq, dk and dv of causal or full GQA attention, from the forward's o
// (through delta) and lse.  float32 inputs go to flash_attention_bwd.cu
// (CUDA cores) instead.
//
// Replaces the TPU kernels src/repro/kernels/flash_attention/kernel.py:219
// flash_attention_bwd (_bwd_dkv_kernel, _bwd_dq_kernel).  As there, and
// as flash_attention_bwd.cu, two kernels; each block loops over its own
// tiles, since blocks run in no order on the card:
//
//   dkdv: one block per (batch, kv head, 64-row kv tile), or per pair of
//         kv tiles when causal (see below).  It keeps its k and v tile in
//         shared memory, walks the G q heads of its group and, for each,
//         the q tiles from the diagonal on (causal) or all of them, and
//         accumulates dk and dv in float32 registers: S^T = K Q^T,
//         dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q.  So GQA is
//         summed in the kernel and each kv head's dk/dv is written once.
//   dq:   one block per (batch, q head, 64-row q tile): S = Q K^T,
//         dP = dO V^T, dQ += dS K over the kv tiles up to the diagonal
//         (causal) or all of them.
//
// No atomics: every output element is summed by one lane in a fixed
// order, so two calls on the same inputs give the same bits.  The price
// is seven S x S x hd products where five would do (S and dP are
// computed in both kernels); one kernel with a deterministic dq
// write-back is a later change (ROADMAP queue 2).  delta = rowsum(do * o)
// comes in from the wrapper (the reference also computes it outside its
// Pallas calls).
//
// What bounds it on this card: at the training shape (B 4, S 2048, Hq 32,
// hd 64, causal) the FLOPs, five S x S x hd products per (batch, q head)
// halved by the mask, over the 989 TFLOP/s of bf16 tensor cores
// (0.1738 ms); the bytes are far below.  What the design does about it:
//
//  * one warpgroup (4 warps) per block owns 64 rows (kv rows in dkdv, q
//    rows in dq), and every product is a wgmma instruction that reads its
//    shared-memory operands directly (attention_tc.cuh): S^T = K Q^T,
//    dP^T = V dO^T, S = Q K^T and dP = dO V^T as wgmma.m64n64k16 with
//    both operands K-major in swizzled tiles; dV += P^T dO, dK += dS^T Q
//    and dQ += dS K as wgmma.m64n{hd}k16 with P, dS from registers,
//    rounded to bf16 from the S and dP accumulators, and dO, Q, K through
//    transposing (MN-major) descriptors of the same tiles;
//  * the streamed 64-row tiles (q, do, lse, delta in dkdv; k, v in dq)
//    come through a three-stage cp.async ring, one barrier per tile;
//    only tiles that cross the diagonal or the ragged end are masked;
//  * causal balance: dkdv pairs kv tile p (which walks n - p q tiles)
//    with tile n - 1 - p, so every block does the same work; dq hands out
//    the longest q tiles first;
//  * lse, delta and the accumulators stay float32.
//
// Layout: the model's (B, S, H, hd) for q, k, v, do, dq, dk, dv, read and
// written through strides that are multiples of 8 elements with
// 16-byte-aligned bases (the wrapper checks); lse and delta (B, Hq, S)
// float32, contiguous.  The kv head of q head h is h / (Hq / Hkv).  Rows
// past S load as zeros and are masked: any S is right.
//
// Head dims 16, 32, 64 and 128 fill whole swizzle atoms.  hd 112
// (zamba2-7b's shared attention) keeps every tile 128 columns wide in
// shared memory (tc::tile_cols), as the forward does: each load, of the
// block's own tiles and of every streamed one, zero-fills columns
// 112-127.  S^T = K Q^T, dP^T = V dO^T, S = Q K^T and dP = dO V^T run the
// 7 k-steps that hold data; dV += P^T dO, dK += dS^T Q and dQ += dS K run
// at n = 128 (the instruction and MN-major descriptor of hd 128, whose
// atoms are whole), the zero columns feeding accumulator columns that are
// never stored; dq, dk and dv store their first 112 columns.  The scale
// stays 1/sqrt(112) (the wrapper's).
#include "attention_tc.cuh"

namespace {

using attn::Strides;
using tc::bf16;

constexpr int R = tc::ROWS;  // rows a block owns, rows of a streamed tile
constexpr int STAGES = 3;

template <int HD>
constexpr size_t dkdv_smem_bytes() {
  // alignment slack; K, V; per stage Q, dO (swizzled tiles of R rows)
  // and lse, delta
  return 1024 + sizeof(bf16) * R * tc::tile_cols(HD) * (2 + 2 * STAGES) +
         sizeof(float) * 2 * R * STAGES;
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  // alignment slack; Q, dO; per stage K, V
  return 1024 + sizeof(bf16) * R * tc::tile_cols(HD) * (2 + 2 * STAGES);
}

//! the block's tiles, from a 1024-byte-aligned base
__device__ __forceinline__ bf16* tiles(unsigned char* smem_raw) {
  const uint32_t raw = tc::smem_u32(smem_raw);
  return reinterpret_cast<bf16*>(smem_raw + ((1024 - (raw & 1023)) & 1023));
}

template <int HD>
__global__ void __launch_bounds__(128)
    flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             Strides sq, Strides sk, Strides sv, Strides sdo,
                             Strides sdk, Strides sdv, int S, int Hq,
                             int Hkv, int n_bh, int group, int causal,
                             float scale, float scale_log2) {
  constexpr int HP = tc::tile_cols(HD);  // columns of a tile
  constexpr int NS = STAGES, T = R * HP;
  extern __shared__ unsigned char smem_raw[];
  bf16* Ks = tiles(smem_raw);
  bf16* Vs = Ks + T;
  bf16* Qs = Vs + T;  // stage st: Q at Qs + 2 st T, dO T further
  float* rows_s = reinterpret_cast<float*>(Qs + 2 * NS * T);  // lse, delta

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // causal: kv tile p is paired with tile n_kt - 1 - p, so that every
  // block walks the same number of q tiles (tile 0 walks all of them)
  const int n_kt = (S + R - 1) / R;
  const int bh = blockIdx.x % n_bh;
  const int p = blockIdx.x / n_bh;
  const int hk = bh % Hkv, b = bh / Hkv;
  const int n_tiles = causal && 2 * p + 1 != n_kt ? 2 : 1;
  const bf16* kb = k + b * sk.b + hk * sk.h;
  const bf16* vb = v + b * sv.b + hk * sv.h;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kt = tile == 0 ? p : n_kt - 1 - p;
    const int k0 = kt * R;
    const int kr0 = k0 + warp * 16;  // this warp's first kv row
    // causal: q tiles wholly above the diagonal see none of this kv tile
    const int qt0 = causal ? kt : 0;
    const int per_head = n_kt - qt0;
    const int n_it = group * per_head;  // (q head, q tile) pairs

    auto tile_of = [&](int j, int& h, int& q0) {
      h = hk * group + j / per_head;
      q0 = (qt0 + j % per_head) * R;
    };
    // step j's q, do, lse and delta into stage j % NS: one commit group
    // per step, even empty
    auto load_step = [&](int j) {
      if (j < n_it) {
        int h, q0;
        tile_of(j, h, q0);
        bf16* dst = Qs + 2 * (j % NS) * T;
        tc::load_rows<R, HP, 128, HD>(dst, q + b * sq.b + h * sq.h, sq.s,
                                      q0, S, tid);
        tc::load_rows<R, HP, 128, HD>(dst + T, dout + b * sdo.b + h * sdo.h,
                                      sdo.s, q0, S, tid);
        // lse (tid < R), then delta: their rows need not be aligned
        const int r = tid % R;
        const float* src = (tid < R ? lse : delta) +
                           ((long long)b * Hq + h) * S + q0 + r;
        tc::cp_async4(rows_s + (j % NS) * 2 * R + tid, src,
                      q0 + r < S ? 4 : 0);
      }
      tc::cp_async_commit();
    };

    __syncthreads();  // the previous tile's readers of K and V are done
    tc::load_rows<R, HP, 128, HD>(Ks, kb, sk.s, k0, S, tid);
    tc::load_rows<R, HP, 128, HD>(Vs, vb, sv.s, k0, S, tid);
    tc::cp_async_commit();
#pragma unroll
    for (int j = 0; j < NS - 1; ++j) load_step(j);

    float dk_acc[HP / 8][4], dv_acc[HP / 8][4];
    tc::zero(dk_acc);
    tc::zero(dv_acc);
    for (int j = 0; j < n_it; ++j) {
      const int st = j % NS;
      tc::cp_async_wait<NS - 2>();
      tc::fence_proxy();
      // step j is in (K and V too), and the warpgroup is done with step
      // j - 1, whose stage the next load refills while this one computes
      __syncthreads();
      load_step(j + NS - 1);

      int h, q0;
      tile_of(j, h, q0);
      if (causal && q0 + R - 1 < k0) continue;  // wholly above the diagonal
      const bf16* Qt = Qs + 2 * st * T;
      const bf16* dOt = Qt + T;
      const float* lt = rows_s + st * 2 * R;
      const float* dlt = lt + R;
      float s[8][4], dp[8][4];
      tc::zero(s);
      tc::zero(dp);
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)  // S^T = K Q^T
        tc::mma_ss(s, tc::kdesc<HP, R>(Ks, kk), tc::kdesc<HP, R>(Qt, kk),
                   kk);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)  // dP^T = V dO^T
        tc::mma_ss(dp, tc::kdesc<HP, R>(Vs, kk), tc::kdesc<HP, R>(dOt, kk),
                   kk);
      tc::wg_commit();
      tc::wg_wait();
      tc::fence_acc(s);
      tc::fence_acc(dp);

      const bool masked = q0 + R > S || k0 + R > S ||
                          (causal && q0 < k0 + R - 1);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * jj + 2 * t + (e % 2);  // q row in the tile
          float pr = tc::exp2_fast(s[jj][e] * scale_log2 -
                                   lt[c] * tc::LOG2E);
          if (masked) {
            const int kj = kr0 + g + 8 * (e / 2);
            const int qi = q0 + c;
            if (qi >= S || kj >= S || (causal && kj > qi)) pr = 0.f;
          }
          s[jj][e] = pr;
          dp[jj][e] = pr * (dp[jj][e] - dlt[c]) * scale;
        }
      uint32_t pf[4][4], sf[4][4];
      tc::to_a<64>(pf, s);
      tc::to_a<64>(sf, dp);
      tc::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dV += P^T dO, q rows 16 kk ..
        tc::mma_rs<HP>(dv_acc, pf[kk], tc::mndesc<HP, R>(dOt, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // dK += dS^T Q
        tc::mma_rs<HP>(dk_acc, sf[kk], tc::mndesc<HP, R>(Qt, kk), 1);
      tc::wg_commit();
      tc::wg_wait();
      tc::fence_acc(dv_acc);
      tc::fence_acc(dk_acc);
    }
    tc::cp_async_wait<0>();  // (only empty groups are left)

    tc::store_rows<HP, HD>(dk + b * sdk.b + hk * sdk.h, sdk.s, kr0, S,
                           dk_acc, 1.f, 1.f, lane);
    tc::store_rows<HP, HD>(dv + b * sdv.b + hk * sdv.h, sdv.s, kr0, S,
                           dv_acc, 1.f, 1.f, lane);
  }
}

template <int HD>
__global__ void __launch_bounds__(128)
    flash_bwd_dq_tc_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dq, Strides sq, Strides sk,
                           Strides sv, Strides sdo, Strides sdq, int S,
                           int Hq, int n_bh, int group, int causal,
                           float scale, float scale_log2) {
  constexpr int HP = tc::tile_cols(HD);  // columns of a tile
  constexpr int NS = STAGES, T = R * HP;
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = tiles(smem_raw);
  bf16* dOs = Qs + T;
  bf16* Ks = dOs + T;  // stage st: K at Ks + 2 st T, V T further

  // longest q tiles first: the q tile is the slowest-varying index
  const int n_qt = (S + R - 1) / R;
  const int bh = blockIdx.x % n_bh;
  const int qt = n_qt - 1 - blockIdx.x / n_bh;
  const int h = bh % Hq, b = bh / Hq, hk = h / group;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = qt * R;
  const int r0 = q0 + warp * 16;  // this warp's first q row

  const bf16* kb = k + b * sk.b + hk * sk.h;
  const bf16* vb = v + b * sv.b + hk * sv.h;
  // causal: kv tiles past the diagonal one are masked
  const int n_kv = causal ? qt + 1 : n_qt;
  auto load_kv = [&](int kt) {  // one commit group per tile, even empty
    if (kt < n_kv) {
      bf16* dst = Ks + 2 * (kt % NS) * T;
      tc::load_rows<R, HP, 128, HD>(dst, kb, sk.s, kt * R, S, tid);
      tc::load_rows<R, HP, 128, HD>(dst + T, vb, sv.s, kt * R, S, tid);
    }
    tc::cp_async_commit();
  };
  tc::load_rows<R, HP, 128, HD>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S,
                                tid);
  tc::load_rows<R, HP, 128, HD>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0,
                                S, tid);
#pragma unroll
  for (int kt = 0; kt < NS - 1; ++kt) load_kv(kt);

  // this lane's rows' lse (pre-scaled by log2 e) and delta
  float lr[2], dr[2];
  const long long row0 = ((long long)b * Hq + h) * S;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + g + 8 * hf;
    lr[hf] = row < S ? lse[row0 + row] * tc::LOG2E : 0.f;
    dr[hf] = row < S ? delta[row0 + row] : 0.f;
  }

  float dq_acc[HP / 8][4];
  tc::zero(dq_acc);
  for (int kt = 0; kt < n_kv; ++kt) {
    tc::cp_async_wait<NS - 2>();
    tc::fence_proxy();
    // tile kt is in (q and do too), and the warpgroup is done with tile
    // kt - 1, whose stage the next load refills while this one computes
    __syncthreads();
    load_kv(kt + NS - 1);

    const int k0 = kt * R;
    const bf16* Kt = Ks + 2 * (kt % NS) * T;
    float s[8][4], dp[8][4];
    tc::zero(s);
    tc::zero(dp);
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)  // S = Q K^T
      tc::mma_ss(s, tc::kdesc<HP, R>(Qs, kk), tc::kdesc<HP, R>(Kt, kk), kk);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)  // dP = dO V^T
      tc::mma_ss(dp, tc::kdesc<HP, R>(dOs, kk),
                 tc::kdesc<HP, R>(Kt + T, kk), kk);
    tc::wg_commit();
    tc::wg_wait();
    tc::fence_acc(s);
    tc::fence_acc(dp);

    const bool masked = k0 + R > S || q0 + R > S ||
                        (causal && k0 + R - 1 > q0);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e / 2;
        float pr = tc::exp2_fast(s[jj][e] * scale_log2 - lr[hf]);
        if (masked) {
          const int qi = r0 + g + 8 * hf;
          const int kj = k0 + 8 * jj + 2 * t + (e % 2);
          if (qi >= S || kj >= S || (causal && kj > qi)) pr = 0.f;
        }
        dp[jj][e] = pr * (dp[jj][e] - dr[hf]) * scale;
      }
    uint32_t sf[4][4];
    tc::to_a<64>(sf, dp);
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // dQ += dS K, kv rows 16 kk ..
      tc::mma_rs<HP>(dq_acc, sf[kk], tc::mndesc<HP, R>(Kt, kk), 1);
    tc::wg_commit();
    tc::wg_wait();
    tc::fence_acc(dq_acc);
  }
  tc::cp_async_wait<0>();  // (only empty groups are left)

  tc::store_rows<HP, HD>(dq + b * sdq.b + h * sdq.h, sdq.s, r0, S, dq_acc,
                         1.f, 1.f, lane);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, const long long* st, int B,
                   int S, int Hq, int Hkv, int causal, float scale,
                   cudaStream_t stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* op = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  const Strides sq = attn::strides_at(st, 0), sk = attn::strides_at(st, 1),
                sv = attn::strides_at(st, 2), sdo = attn::strides_at(st, 3),
                sdq = attn::strides_at(st, 4), sdk = attn::strides_at(st, 5),
                sdv = attn::strides_at(st, 6);
  const int group = Hq / Hkv;
  const float scale_log2 = scale * tc::LOG2E;
  const long long n_t = (S + R - 1) / R;
  // causal: a dkdv block takes kv tiles p and n_t - 1 - p
  const long long kv_blocks = (causal ? (n_t + 1) / 2 : n_t) * B * Hkv;
  const long long q_blocks = n_t * B * Hq;
  if (q_blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;

  auto dkdv = flash_bwd_dkdv_tc_kernel<HD>;
  const size_t smem1 = dkdv_smem_bytes<HD>();
  static bool done1[64], done2[64];
  cudaError_t err = tc::allow_smem_once(dkdv, smem1, done1);
  if (err != cudaSuccess) return err;
  dkdv<<<static_cast<unsigned>(kv_blocks), 128, smem1, stream>>>(
      qp, kp, vp, op, lp, dp, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      sq, sk, sv, sdo, sdk, sdv, S, Hq, Hkv, B * Hkv, group, causal, scale,
      scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_tc_kernel<HD>;
  const size_t smem2 = dq_smem_bytes<HD>();
  err = tc::allow_smem_once(dqk, smem2, done2);
  if (err != cudaSuccess) return err;
  dqk<<<static_cast<unsigned>(q_blocks), 128, smem2, stream>>>(
      qp, kp, vp, op, lp, dp, static_cast<bf16*>(dq), sq, sk, sv, sdo, sdq, S,
      Hq, B * Hq, group, causal, scale, scale_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, do, dq (B,S,Hq,hd) and k, v, dk, dv (B,S,Hkv,hd): bfloat16, last dim
// contiguous, 16-byte-aligned bases and strides a multiple of 8;
// `strides` holds 21 element strides (dims 0-2 of q, k, v, do, dq, dk,
// dv).  lse and delta (B,Hq,S) float32, contiguous.  Launches the dk/dv
// kernel, then the dq kernel, on `stream`; returns the first launch
// error, else cudaGetLastError().
int flash_attention_bwd_tc_launch(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, void* dk, void* dv,
                                  const void* strides, int B, int S, int Hq,
                                  int Hkv, int hd, int causal, float scale,
                                  void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, dout, lse, delta, dq, dk, dv, st, B, S, Hq,
                        Hkv, causal, scale, s);
    case 32:
      return launch<32>(q, k, v, dout, lse, delta, dq, dk, dv, st, B, S, Hq,
                        Hkv, causal, scale, s);
    case 64:
      return launch<64>(q, k, v, dout, lse, delta, dq, dk, dv, st, B, S, Hq,
                        Hkv, causal, scale, s);
    case 112:
      return launch<112>(q, k, v, dout, lse, delta, dq, dk, dv, st, B, S, Hq,
                         Hkv, causal, scale, s);
    case 128:
      return launch<128>(q, k, v, dout, lse, delta, dq, dk, dv, st, B, S, Hq,
                         Hkv, causal, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
