// Flash-attention forward for Hopper (sm_90a), bf16, on the tensor cores:
// causal or full GQA attention with an online softmax, returning (o, lse).
// float32 inputs go to flash_attention_fwd.cu (CUDA cores) instead.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:82
// flash_attention_fwd (_fwd_kernel).  That kernel walks a sequential
// kv-block grid axis with m, l and the accumulator in VMEM scratch; here
// one block owns one (batch, q head, q tile) and loops over the kv tiles
// itself, since blocks run in no order on the card.
//
// What bounds it on this card: at the training shape (B 4, S 2048, Hq 32,
// hd 64, causal) the FLOPs, 4 S^2/2 hd per (batch, q head), over the
// 989 TFLOP/s of bf16 tensor cores (0.0695 ms); at the serving shape
// (B 8, S 256) the bytes, q, k, v read once and o, lse written once, over
// 3.35 TB/s (0.00571 ms).  What the design does about it:
//
//  * one warpgroup (4 warps) per block owns 64 q rows; both products are
//    wgmma instructions that read their shared-memory operands directly
//    (attention_tc.cuh): S = Q K^T as wgmma.m64n64k16 with Q and K
//    K-major in swizzled tiles, and O += P V as wgmma.m64n{hd}k16 with P
//    from registers, rounded to bf16 from the S accumulators, and V
//    through a transposing (MN-major) descriptor of its tile;
//  * 64-row k/v tiles stream through a three-stage cp.async ring: tiles
//    t+1 and t+2 load while tile t computes, one barrier per tile;
//  * the online softmax stays in float32 registers, with ex2.approx on
//    logits pre-scaled by log2(e) / sqrt(hd), and l summed per lane until
//    the end;
//  * causal: the loop stops at the diagonal tile, only the diagonal tile
//    and the ragged end are masked, and the grid hands out the longest q
//    tiles first so that the last wave is short.
// Loads are cp.async by every thread, not TMA by a producer warp feeding
// two consumer warpgroups that overlap one's softmax with the other's
// products (FlashAttention-3): a later change (ROADMAP queue 2).
//
// Layout: the model's (B, S, H, hd), read and written through strides,
// which must be multiples of 8 elements with 16-byte-aligned bases (the
// wrapper checks).  The kv head of q head h is h / (Hq / Hkv).  Rows past
// S load as zeros and their scores as NEG_INF: any S is right.
//
// Head dims 16, 32, 64 and 128 fill whole swizzle atoms.  hd 112
// (zamba2-7b's shared attention) keeps tiles of 128 columns in shared
// memory (tc::tile_cols), the last 16 zero-filled on load: Q K^T runs the
// 7 k-steps that hold data, O += P V runs at n = 128 (the instruction and
// MN-major descriptor of hd 128, whose atoms are whole), and only the
// first 112 columns of o are stored.  The scale stays 1/sqrt(112) (the
// wrapper's).
#include "attention_tc.cuh"

namespace {

using attn::NEG_INF;
using attn::Strides;
using tc::bf16;

constexpr int R = tc::ROWS;  // q rows per block, kv rows per tile
constexpr int STAGES = 3;    // k/v ring: tiles t+1, t+2 load while t computes

template <int HD>
constexpr size_t smem_bytes() {
  // alignment slack; Q; per stage K and V, swizzled tiles of R rows
  return 1024 + sizeof(bf16) * R * tc::tile_cols(HD) * (1 + 2 * STAGES);
}

template <int HD>
__global__ void __launch_bounds__(128)
    flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, Strides sq, Strides sk,
                        Strides sv, Strides so, int S, int Hq, int n_bh,
                        int group, int causal, float scale_log2) {
  constexpr int HP = tc::tile_cols(HD);  // columns of a tile
  constexpr int T = R * HP;               // bf16 of one tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = tc::smem_u32(smem_raw);
  bf16* Qs =
      reinterpret_cast<bf16*>(smem_raw + ((1024 - (raw & 1023)) & 1023));
  bf16* Ks = Qs + T;  // stage st: K at Ks + 2 st T, V T further

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
      bf16* dst = Ks + 2 * (kt % STAGES) * T;
      tc::load_rows<R, HP, 128, HD>(dst, kb, sk.s, kt * R, S, tid);
      tc::load_rows<R, HP, 128, HD>(dst + T, vb, sv.s, kt * R, S, tid);
    }
    tc::cp_async_commit();
  };
  tc::load_rows<R, HP, 128, HD>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S,
                                tid);
#pragma unroll
  for (int kt = 0; kt < STAGES - 1; ++kt) load_kv(kt);

  float acc[HP / 8][4];
  tc::zero(acc);
  // running max (of the scores times log2(e) / sqrt(hd)) and this lane's
  // share of the row sums, rows g and g + 8 of the warp's 16
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < n_kv; ++kt) {
    tc::cp_async_wait<STAGES - 2>();
    tc::fence_proxy();
    // tile kt is in (q too), and the warpgroup is done with tile kt - 1,
    // whose stage the next load refills while this one computes
    __syncthreads();
    load_kv(kt + STAGES - 1);

    const int k0 = kt * R;
    const bf16* Kt = Ks + 2 * (kt % STAGES) * T;
    float s[8][4];
    tc::zero(s);
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)  // S = Q K^T, 16 of hd at a time
      tc::mma_ss(s, tc::kdesc<HP, R>(Qs, kk), tc::kdesc<HP, R>(Kt, kk), kk);
    tc::wg_commit();
    tc::wg_wait();
    tc::fence_acc(s);

    const bool masked = k0 + R > S || (causal && k0 + R - 1 > q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (masked) {
          const int row = r0 + g + 8 * (e / 2);
          const int col = k0 + 8 * j + 2 * t + (e % 2);
          if (col >= S || (causal && col > row)) x = NEG_INF;
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float x = mx[hf];
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float alpha = tc::exp2_fast(m[hf] - x);
      m[hf] = x;
      l[hf] *= alpha;
#pragma unroll
      for (int n = 0; n < HP / 8; ++n) {
        acc[n][2 * hf] *= alpha;
        acc[n][2 * hf + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = tc::exp2_fast(s[j][e] - m[e / 2]);
        s[j][e] = pr;
        l[e / 2] += pr;  // this lane's columns; summed at the end
      }
    uint32_t pf[4][4];
    tc::to_a<64>(pf, s);
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // O += P V, kv rows 16 kk .. 16 kk + 15
      tc::mma_rs<HP>(acc, pf[kk], tc::mndesc<HP, R>(Kt + T, kk), 1);
    tc::wg_commit();
    tc::wg_wait();
    tc::fence_acc(acc);
  }
  tc::cp_async_wait<0>();  // (only empty groups are left)

  if (r0 >= S) return;
  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float x = l[hf];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    l[hf] = fmaxf(x, 1e-30f);
    inv[hf] = 1.f / l[hf];
  }
  tc::store_rows<HP, HD>(o + b * so.b + h * so.h, so.s, r0, S, acc, inv[0],
                         inv[1], lane);
  if (t == 0) {
    float* lrow = lse + ((long long)b * Hq + h) * S;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + g + 8 * hf;
      if (row < S) lrow[row] = (m[hf] + log2f(l[hf])) * tc::LN2;
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, const long long* strides, int B, int S, int Hq,
                   int Hkv, int causal, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_tc_kernel<HD>;
  const size_t smem = smem_bytes<HD>();
  static bool done[64];
  cudaError_t err = tc::allow_smem_once(kern, smem, done);
  if (err != cudaSuccess) return err;
  const int n_bh = B * Hq;
  const long long blocks = (long long)((S + R - 1) / R) * n_bh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<static_cast<unsigned>(blocks), 128, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), attn::strides_at(strides, 0),
      attn::strides_at(strides, 1), attn::strides_at(strides, 2),
      attn::strides_at(strides, 3), S, Hq, n_bh, Hq / Hkv, causal,
      scale * tc::LOG2E);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,S,Hq,hd), k/v (B,S,Hkv,hd), o (B,S,Hq,hd): bfloat16, last dim
// contiguous, 16-byte-aligned bases and strides a multiple of 8;
// `strides` holds 12 element strides (dims 0-2 of q, k, v, o).  lse
// (B,Hq,S) float32, contiguous.  Launches on `stream`; returns
// cudaGetLastError().
int flash_attention_fwd_tc_launch(const void* q, const void* k,
                                  const void* v, void* o, void* lse,
                                  const void* strides, int B, int S, int Hq,
                                  int Hkv, int hd, int causal, float scale,
                                  void* stream) {
  const long long* st = static_cast<const long long*>(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, o, lse, st, B, S, Hq, Hkv, causal, scale, s);
    case 32:
      return launch<32>(q, k, v, o, lse, st, B, S, Hq, Hkv, causal, scale, s);
    case 64:
      return launch<64>(q, k, v, o, lse, st, B, S, Hq, Hkv, causal, scale, s);
    case 112:
      return launch<112>(q, k, v, o, lse, st, B, S, Hq, Hkv, causal, scale,
                         s);
    case 128:
      return launch<128>(q, k, v, o, lse, st, B, S, Hq, Hkv, causal, scale,
                         s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
