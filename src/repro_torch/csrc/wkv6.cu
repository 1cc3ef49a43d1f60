// The RWKV-6 (WKV6) chunked linear recurrence for Hopper (sm_90a): per
// (batch, head), with data-dependent per-channel decay,
//
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
//   y_t = r_t . S_{t-1} + (r_t . (u * k_t)) v_t,
//
// evaluated chunk by chunk from a zero state, returning y and the final
// state.
//
// Replaces the TPU kernel src/repro/kernels/wkv6/kernel.py: wkv6
// (_wkv_kernel).  That kernel walks a sequential chunk axis with the
// (hd, hd) state in VMEM scratch and builds the intra-chunk (cs, cs, hd)
// decay tensor exp(texc_i - scum_j) in VMEM.
//
// What bounds it on this card: bytes.  At the training shape (B 4, H 40,
// S 2048, hd 64, chunk 64) the function reads r, k, v, logw once and
// writes y and the state once: 422 MB in float32, 254 MB with the
// model's bf16 r, k, v and y (0.126 and 0.076 ms at 3.35 TB/s).  Its
// products (the scores, scores v, the inter-chunk and state terms) are
// 8.1e9 float32 FLOP, 0.049 ms as three TF32 passes at 495 TFLOP/s; its
// exps, most of them in the diagonal blocks, 0.13e9, 0.032 ms at the
// SFUs' 4.18e12/s (chip_smoke.py's `wkv_work` counts them).
//
// What the design does about it:
// - Chunk-parallel, one launch.  A block owns one chunk of one (batch,
//   head), all hd value columns: 5120 blocks at the training shape.  All
//   of a chunk's work that does not need the state runs at once in every
//   block: the scores, y's intra-chunk part (scores v + bonus v) and the
//   chunk's state increment (k o e^(s_last - scum))^T v.  Only the state
//   step S_{c+1} = S_c o e^(s_last) + increment is serial: each block
//   waits for S_c from its chunk's predecessor, adds, hands S_{c+1} on
//   through a two-slot ring in a workspace (L2), and only then computes
//   y's inter-chunk part (r o e^(texc)) S_c.  Blocks take their chunk by
//   an atomic ticket in (chunk, batch x head) order, so a block waits only
//   for a block that is already running: no deadlock, whatever order the
//   card starts blocks in.  The last block to finish zeroes the
//   workspace's counters for the next launch.
// - Sub-chunk factorised decays.  Each chunk is cut into sub-blocks of 16
//   rows.  For rows i of sub-block I and j of an earlier sub-block J,
//   exp(texc_i - scum_j) = exp(texc_i - rho_J) exp(rho_J - scum_j), rho_J
//   the cumulative log-decay at J's last row: both factors are <= 1 (the
//   log-decays are negative), so neither overflows, and where one
//   underflows the true term is smaller still.  The off-diagonal score
//   blocks are then plain products (r_I o e^(texc_I - rho_J)) (k_J o
//   e^(rho_J - scum_J))^T.  In the 16 x 16 diagonal blocks, the 4 x 4
//   micro-tiles below the diagonal factorise the same way at their column
//   tile's last row, and only the micro-tiles on it keep one exp per
//   (i, j < i, channel).  A whole-chunk factorisation would overflow: 64
//   rows of strong decay sum to hundreds.
// - Local sums.  The cumulative log-decays are kept per sub-block (16-row
//   sums in registers, one thread per (sub-block, channel)) with the
//   sub-blocks' totals beside them; texc_i is the previous row's sum
//   itself, so exp(texc_i - scum_{i-1}) is exactly 1 and the exponents
//   near the diagonal never come from the difference of two sums of
//   hundreds (where float32 loses ~6e-5 at strong decays).
// - 3xTF32 on the tensor cores: every product runs as mma.sync m16n8k8
//   TF32 on hi/lo planes split in registers (a_lo b_hi + a_hi b_lo + a_hi
//   b_hi, in three accumulators), float32-accurate.  Each product starts
//   from zero and is added to the others on the CUDA cores, in the
//   reference's order of terms.
// - The model's tensors as they are: r, k, v in bf16 or float32, logw and
//   u float32, read through strides (the hd axis of unit stride; 16-byte
//   loads of r, k, v, so 16-byte aligned bases and strides), upcast in
//   registers (exact); y written in r's dtype, rounded once, laid out
//   (B, S, H, hd).  Nothing depends on the dtype but the loads and y's
//   store, so bf16 inputs give the float32 kernel's y on equal values.
//
// Every exp is of an x <= 0, as ex2.approx.ftz of x log2(e) (`exp_neg`):
// its relative error, ~2^-22 plus |x| 2^-24 from the scaling, is far
// inside the 1e-5 tolerance on terms of size exp(x) <= 1, and a result
// flushed to zero is a term below 2^-126.
//
// Built for chunk in {16, 32, 64} and hd in {16, 32, 64}; S a multiple of
// the chunk, which the caller guarantees, as in the reference.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads: 8 warps
constexpr int NW = NT / 32;
constexpr int SB = 16;       // rows of a sub-block
//! polls of a predecessor's flag before a block gives up (~seconds): a
//! broken hand-off traps, and the launch fails, instead of hanging
constexpr long long MAX_POLLS = 1ll << 26;

struct Strides {
  long long b, h, s;  // elements; the hd axis has unit stride
};

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;
  void* y;            // (B, S, H, hd), r's dtype
  float* st;          // (B, H, hd, hd) float32
  int* sync;          // workspace: ticket, blocks done, per (b, h) flag
  float* ring;        // workspace: (B H, 2, hd, hd) states handed on
  Strides sr, sk, sv, sw;
  long long su;       // u's head stride
  int H, S, BH, NC;   // heads, time, batch x heads, chunks
};

//! shared-memory layout, in floats.  Tiles read as mma A operands
//! [row][k] have a row stride = 4 (mod 32), tiles read as B operands
//! [k][col] one = 8 or 24 (mod 32): fragment loads without bank conflicts.
template <int CS, int HD>
struct Layout {
  static constexpr int NSB = CS / SB;
  static constexpr int NP = NSB * (NSB - 1) / 2;   // sub-block pairs I > J
  static constexpr int LDA = HD + 4;               // r, k, cumulative sums
  static constexpr int LDS = CS + 4;               // scores
  static constexpr int LDV = HD + 8;               // v, the state
  static constexpr int R = 0;                      // r, then r o e^(E)
  static constexpr int K = R + CS * LDA;           // k, then k o e^(T - L)
  static constexpr int L = K + CS * LDA;           // logw's 16-row sums
  static constexpr int A = L + CS * LDA;           // scores (CS x CS)
  static constexpr int V = A + CS * LDS;           // v (CS x HD)
  static constexpr int ST = V + CS * LDV;          // the state S_c (HD x HD)
  static constexpr int EP = ST + HD * LDV;         // e^(P_I), (NSB, HD)
  static constexpr int EQ = EP + NSB * HD;         // e^(Q_J), (NSB, HD)
  static constexpr int EM = EQ + NSB * HD;         // e^(M_JI), (NP, HD)
  static constexpr int DEC = EM + NP * HD;         // e^(s_last), (HD)
  static constexpr int DSC = DEC + HD;             // bonus, (CS)
  static constexpr int TOTAL = DSC + CS;
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t out;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(out) : "f"(x));
  return out;
}

//! x ~ hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

//! acc (a 16 x 16 tile: two m16n8 fragments) = sum over k in [0, kn) of
//! a(row, k) b(k, col), 3xTF32, from zero: the hi.hi, hi.lo and lo.hi
//! products in three accumulators (independent chains of mma), summed at
//! the end.  Fragment (nb, q) holds row g + 8 (q / 2), column 8 nb + 2 t
//! + q % 2 (g = lane / 4, t = lane % 4).
template <class FA, class FB>
__device__ __forceinline__ void product16(float (&acc)[2][4], int kn, FA a,
                                          FB b, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float hl[2][4], lh[2][4];
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nb][q] = hl[nb][q] = lh[nb][q] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < kn; kk += 8) {
    uint32_t ah[4], al[4];
    split_tf32(a(g, kk + t), ah[0], al[0]);
    split_tf32(a(g + 8, kk + t), ah[1], al[1]);
    split_tf32(a(g, kk + t + 4), ah[2], al[2]);
    split_tf32(a(g + 8, kk + t + 4), ah[3], al[3]);
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(b(kk + t, 8 * nb + g), bh0, bl0);
      split_tf32(b(kk + t + 4, 8 * nb + g), bh1, bl1);
      mma_tf32(lh[nb], al, bh0, bh1);
      mma_tf32(hl[nb], ah, bl0, bl1);
      mma_tf32(acc[nb], ah, bh0, bh1);
    }
  }
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nb][q] += lh[nb][q] + hl[nb][q];
}

//! e^x, x <= 0: ex2.approx, results below float32's normal range flushed
//! to zero
__device__ __forceinline__ float exp_neg(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

//! 16 bytes of T from global memory as floats (exact upcast)
template <class T>
struct Piece;
template <>
struct Piece<float> {
  static constexpr int N = 4;
  float x[4];
  __device__ __forceinline__ void load(const float* p) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
};
template <>
struct Piece<__nv_bfloat16> {
  static constexpr int N = 8;
  float x[8];
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

template <class T, int CS, int HD>
__global__ void __launch_bounds__(NT, 2) wkv6_kernel(const Params p) {
  using Lo = Layout<CS, HD>;
  constexpr int NSB = Lo::NSB, NP = Lo::NP, LDA = Lo::LDA, LDS = Lo::LDS;
  constexpr int LDV = Lo::LDV;
  constexpr int VE = Piece<T>::N;      // elements per 16-byte piece
  constexpr int PR = HD / VE;          // pieces per row of r, k, v
  constexpr int NC16 = HD / 16;        // 16-column tiles of v and the state
  extern __shared__ __align__(16) float sm[];
  __shared__ int ticket;
  float* Rs = sm + Lo::R;
  float* Ks = sm + Lo::K;
  float* Ls = sm + Lo::L;
  float* As = sm + Lo::A;
  float* Vs = sm + Lo::V;
  float* St = sm + Lo::ST;
  float* eP = sm + Lo::EP;
  float* eQ = sm + Lo::EQ;
  float* eM = sm + Lo::EM;
  float* dec = sm + Lo::DEC;
  float* dsc = sm + Lo::DSC;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  if (tid == 0) ticket = atomicAdd(p.sync, 1);
  __syncthreads();
  const int c = ticket / p.BH, bh = ticket % p.BH;  // this block's chunk
  const int b = bh / p.H, h = bh % p.H;
  const int c0 = c * CS;
  const T* rp = static_cast<const T*>(p.r) + b * p.sr.b + h * p.sr.h +
                c0 * p.sr.s;
  const T* kp = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h +
                c0 * p.sk.s;
  const T* vp = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h +
                c0 * p.sv.s;
  const float* wp = p.w + b * p.sw.b + h * p.sw.h + c0 * p.sw.s;
  const float* up = p.u + h * p.su;

  // every global load first (logw by (sub-block, channel) column; r, k
  // and v in 16-byte pieces), then their uses: logw's inclusive sums
  // within each 16-row sub-block (16 adds in registers), r, k, v to
  // shared memory
  constexpr int NWC = (NSB * HD + NT - 1) / NT;
  constexpr int NRK = (CS * PR + NT - 1) / NT;
  float wv[NWC][SB];
  Piece<T> rv[NRK], kv[NRK], vv[NRK];
#pragma unroll
  for (int n = 0; n < NWC; ++n) {
    const int q = tid + n * NT, J = q / HD, d = q % HD;
    if (q < NSB * HD)
#pragma unroll
      for (int x = 0; x < SB; ++x)
        wv[n][x] = __ldg(wp + (SB * J + x) * p.sw.s + d);
  }
#pragma unroll
  for (int n = 0; n < NRK; ++n) {
    const int q = tid + n * NT, i = q / PR, d = (q % PR) * VE;
    if (q < CS * PR) {
      rv[n].load(rp + i * p.sr.s + d);
      kv[n].load(kp + i * p.sk.s + d);
      vv[n].load(vp + i * p.sv.s + d);
    }
  }
#pragma unroll
  for (int n = 0; n < NWC; ++n) {
    const int q = tid + n * NT, J = q / HD, d = q % HD;
    if (q < NSB * HD) {
      float acc = 0.f;
#pragma unroll
      for (int x = 0; x < SB; ++x) {
        acc += wv[n][x];
        Ls[(SB * J + x) * LDA + d] = acc;
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NRK; ++n) {
    const int q = tid + n * NT, i = q / PR, d = (q % PR) * VE;
    if (q < CS * PR) {   // whole warps: CS PR % 32 == 0
      // the bonus r . (u o k) per row, in one order whatever T: sums of
      // 4 channels, then pairs of neighbours, then of pairs, ... (so bf16
      // and float32 inputs of equal values give equal sums)
      float part[VE / 4];
#pragma unroll
      for (int gq = 0; gq < VE / 4; ++gq) {
        part[gq] = 0.f;
#pragma unroll
        for (int e = 4 * gq; e < 4 * gq + 4; ++e)
          part[gq] += rv[n].x[e] * __ldg(up + d + e) * kv[n].x[e];
      }
      float bonus = part[0];
#pragma unroll
      for (int gq = 1; gq < VE / 4; ++gq) bonus += part[gq];
#pragma unroll
      for (int e = 0; e < VE; e += 4) {
        st4(Rs + i * LDA + d + e, make_float4(rv[n].x[e], rv[n].x[e + 1],
                                              rv[n].x[e + 2], rv[n].x[e + 3]));
        st4(Ks + i * LDA + d + e, make_float4(kv[n].x[e], kv[n].x[e + 1],
                                              kv[n].x[e + 2], kv[n].x[e + 3]));
        st4(Vs + i * LDV + d + e, make_float4(vv[n].x[e], vv[n].x[e + 1],
                                              vv[n].x[e + 2], vv[n].x[e + 3]));
      }
      // a row's PR pieces are PR consecutive lanes of one warp
#pragma unroll
      for (int o = 1; o < PR; o <<= 1)
        bonus += __shfl_xor_sync(0xffffffffu, bonus, o);
      if (q % PR == 0) dsc[i] = bonus;
    }
  }
  __syncthreads();

  // the diagonal blocks' scores in jobs of 4 x 4 micro-tiles: per block
  // I, the six below its diagonal (16 pairs each, exp(E_i - L_j)
  // factorised at the column tile's last row: 7 exps a channel), then
  // two jobs of two on it (6 pairs each, an exp per pair), so that a
  // warp's jobs are alike; DQ lanes share a job, each over its own
  // channels, and sum by shuffles
  {
    constexpr int DQ = HD / 4 < 8 ? HD / 4 : 8;
    for (int it = tid; it < 8 * NSB * DQ; it += NT) {
      const int job = it / DQ, dq = it % DQ;
      const bool tri = job >= 6 * NSB;
      int I, ta, tb;
      if (!tri) {        // micro-tile (ta, tb), tb < ta
        I = job / 6;
        const int t6 = job % 6;
        ta = 1 + (t6 >= 1) + (t6 >= 3);
        tb = t6 - ta * (ta - 1) / 2;
      } else {           // micro-tiles (ta, ta) and (tb, tb) = (3 - ta)
        I = (job - 6 * NSB) / 2;
        ta = (job - 6 * NSB) % 2;
        tb = 3 - ta;
      }
      float acc[2][4][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[hf][x][y] = 0.f;
#pragma unroll
      for (int m = 0; m < HD / (4 * DQ); ++m) {
        const int d = 4 * dq + 4 * DQ * m;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (!tri && hf == 1) break;
          const int ra = tri ? (hf ? tb : ta) : ta;  // rows' micro-tile
          const int ca = tri ? ra : tb;               // columns'
          const int ri = SB * I + 4 * ra, kj = SB * I + 4 * ca;
          float4 rv[4], lp[4], kv[4], lk[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            rv[x] = ld4(Rs + (ri + x) * LDA + d);
            lp[x] = (4 * ra + x > 0) ? ld4(Ls + (ri + x - 1) * LDA + d)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
            kv[x] = ld4(Ks + (kj + x) * LDA + d);
            lk[x] = ld4(Ls + (kj + x) * LDA + d);
          }
          if (!tri) {
            // below the diagonal: once more factorised, at the column
            // tile's last row (both factors <= 1 again)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float rho = at(lk[3], e);
              float rf[4], kf[4];
#pragma unroll
              for (int x = 0; x < 4; ++x)
                rf[x] = at(rv[x], e) * exp_neg(at(lp[x], e) - rho);
#pragma unroll
              for (int y = 0; y < 4; ++y)
                kf[y] = y == 3 ? at(kv[3], e)
                               : at(kv[y], e) * exp_neg(rho - at(lk[y], e));
#pragma unroll
              for (int x = 0; x < 4; ++x)
#pragma unroll
                for (int y = 0; y < 4; ++y) acc[0][x][y] += rf[x] * kf[y];
            }
          } else {
            // on the diagonal: one exp per pair
#pragma unroll
            for (int x = 0; x < 4; ++x)
#pragma unroll
              for (int y = 0; y < x; ++y)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  acc[hf][x][y] += at(rv[x], e) * at(kv[y], e) *
                                   exp_neg(at(lp[x], e) - at(lk[y], e));
          }
        }
      }
      const unsigned mask = ((1u << DQ) - 1) << (lane & ~(DQ - 1));
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y)
            if (tri ? y < x : hf == 0)
#pragma unroll
              for (int o = 1; o < DQ; o <<= 1)
                acc[hf][x][y] += __shfl_xor_sync(mask, acc[hf][x][y], o, DQ);
      if (dq < 2 && (tri || dq == 0)) {  // a tile's sums
        const int hf = tri ? dq : 0;
        const int ra = tri ? (hf ? tb : ta) : ta, ca = tri ? ra : tb;
#pragma unroll
        for (int x = 0; x < 4; ++x)
          st4(As + (SB * I + 4 * ra + x) * LDS + SB * I + 4 * ca,
              make_float4(acc[hf][x][0], acc[hf][x][1], acc[hf][x][2],
                          acc[hf][x][3]));
      } else if (!tri && dq == 1) {        // the mirrored tile: zeros
#pragma unroll
        for (int x = 0; x < 4; ++x)
          st4(As + (SB * I + 4 * tb + x) * LDS + SB * I + 4 * ta,
              make_float4(0.f, 0.f, 0.f, 0.f));
      }
    }
  }
  __syncthreads();

  // r decayed from its sub-block's start (E_i, the previous row's sum),
  // k to its sub-block's end (T_J - L_j), in place; and the per-channel
  // factors from the sub-blocks' totals T_J:
  //   P_I = sum_{K<I} T_K, Q_J = sum_{K>J} T_K, M_JI = sum_{J<K<I} T_K
  for (int q = tid; q < CS * HD / 4; q += NT) {
    const int i = q / (HD / 4), d = (q % (HD / 4)) * 4;
    const int last = (i / SB) * SB + SB - 1;
    const float4 l = ld4(Ls + i * LDA + d), tl = ld4(Ls + last * LDA + d);
    const float4 e = (i % SB) ? ld4(Ls + (i - 1) * LDA + d)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 rv = ld4(Rs + i * LDA + d), kv = ld4(Ks + i * LDA + d);
    rv.x *= exp_neg(e.x); rv.y *= exp_neg(e.y);
    rv.z *= exp_neg(e.z); rv.w *= exp_neg(e.w);
    kv.x *= exp_neg(tl.x - l.x); kv.y *= exp_neg(tl.y - l.y);
    kv.z *= exp_neg(tl.z - l.z); kv.w *= exp_neg(tl.w - l.w);
    st4(Rs + i * LDA + d, rv);
    st4(Ks + i * LDA + d, kv);
  }
  for (int d = tid; d < HD; d += NT) {
    float tot[NSB];
#pragma unroll
    for (int J = 0; J < NSB; ++J) tot[J] = Ls[(SB * J + SB - 1) * LDA + d];
    float acc = 0.f;
#pragma unroll
    for (int I = 0; I < NSB; ++I) {
      eP[I * HD + d] = exp_neg(acc);
      acc += tot[I];
    }
    dec[d] = exp_neg(acc);
    acc = 0.f;
#pragma unroll
    for (int J = NSB - 1; J >= 0; --J) {
      eQ[J * HD + d] = exp_neg(acc);
      acc += tot[J];
    }
#pragma unroll
    for (int I = 1; I < NSB; ++I) {
      acc = 0.f;
#pragma unroll
      for (int J = I - 1; J >= 0; --J) {
        eM[(I * (I - 1) / 2 + J) * HD + d] = exp_neg(acc);
        acc += tot[J];
      }
    }
  }
  __syncthreads();

  // the off-diagonal score blocks (I > J) on the tensor cores:
  // (r_I o e^(E_I) o e^(M_JI)) (k_J o e^(T_J - L_J))^T
  for (int item = warp; item < NP; item += NW) {
    int I = 1;
    while ((I + 1) * I / 2 <= item) ++I;
    const int J = item - I * (I - 1) / 2;
    const float* ra = Rs + SB * I * LDA;
    const float* kb = Ks + SB * J * LDA;
    const float* em = eM + item * HD;
    float acc[2][4];
    product16(
        acc, HD, [&](int x, int d) { return ra[x * LDA + d] * em[d]; },
        [&](int d, int y) { return kb[y * LDA + d]; }, lane);
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(
            As + (SB * I + g + 8 * hf) * LDS + SB * J + 8 * nb + 2 * t4) =
            make_float2(acc[nb][2 * hf], acc[nb][2 * hf + 1]);
  }
  __syncthreads();

  // what does not need the state, in 16 x 16 tiles a warp keeps in
  // registers: y's intra-chunk part, scores v, for row block I and
  // columns n0; the state's increment (k o e^(s_last - scum))^T v for
  // rows m0 and columns n0
  constexpr int NY = NSB * NC16, NU = NC16 * NC16;
  constexpr int KY = (NY + NW - 1) / NW, KU = (NU + NW - 1) / NW;
  float yin[KY][2][4], inc[KU][2][4];
#pragma unroll
  for (int n = 0; n < KY; ++n) {
    const int item = warp + n * NW;
    if (item < NY) {
      const int I = item / NC16, n0 = (item % NC16) * 16;
      const float* ar = As + SB * I * LDS;
      product16(
          yin[n], SB * (I + 1), [&](int x, int j) { return ar[x * LDS + j]; },
          [&](int j, int col) { return Vs[j * LDV + n0 + col]; }, lane);
    }
  }
#pragma unroll
  for (int n = 0; n < KU; ++n) {
    const int item = warp + n * NW;
    if (item < NU) {
      const int m0 = (item / NC16) * 16, n0 = (item % NC16) * 16;
      product16(
          inc[n], CS,
          [&](int x, int j) {
            return Ks[j * LDA + m0 + x] * eQ[(j / SB) * HD + m0 + x];
          },
          [&](int j, int col) { return Vs[j * LDV + n0 + col]; }, lane);
    }
  }

  // the state step: S_c from the chunk's predecessor (zero at chunk 0),
  // S_{c+1} = S_c o e^(s_last) + increment handed on (the last chunk's
  // is the final state)
  if (c > 0) {
    if (tid == 0) {
      long long polls = 0;
      while (ld_acquire(p.sync + 2 + bh) < c) {
        __nanosleep(64);
        if (++polls > MAX_POLLS) __trap();
      }
    }
    __syncthreads();
    const float* src = p.ring + ((long long)bh * 2 + c % 2) * HD * HD;
    for (int q = tid; q < HD * HD / 4; q += NT) {
      const int d = q / (HD / 4), col = (q % (HD / 4)) * 4;
      st4(St + d * LDV + col,
          __ldcg(reinterpret_cast<const float4*>(src + d * HD + col)));
    }
  } else {
    for (int q = tid; q < HD * HD / 4; q += NT) {
      const int d = q / (HD / 4), col = (q % (HD / 4)) * 4;
      st4(St + d * LDV + col, make_float4(0.f, 0.f, 0.f, 0.f));
    }
  }
  __syncthreads();
  const bool last = c == p.NC - 1;
  float* dst = last ? p.st + (long long)bh * HD * HD
                    : p.ring + ((long long)bh * 2 + (c + 1) % 2) * HD * HD;
#pragma unroll
  for (int n = 0; n < KU; ++n) {
    const int item = warp + n * NW;
    if (item < NU) {
      const int m0 = (item / NC16) * 16, n0 = (item % NC16) * 16;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int d = m0 + g + 8 * hf, col = n0 + 8 * nb + 2 * t4;
          const float* s = St + d * LDV + col;
          __stcg(reinterpret_cast<float2*>(dst + d * HD + col),
                 make_float2(s[0] * dec[d] + inc[n][nb][2 * hf],
                             s[1] * dec[d] + inc[n][nb][2 * hf + 1]));
        }
    }
  }
  if (!last) {
    __threadfence();
    __syncthreads();
    if (tid == 0) st_release(p.sync + 2 + bh, c + 1);
  }

  // y = (scores v + bonus v) + (r o e^(texc)) S_c
  T* yp = static_cast<T*>(p.y) + ((long long)(b * p.S + c0) * p.H + h) * HD;
  const long long ys = (long long)p.H * HD;   // y's row stride
#pragma unroll
  for (int n = 0; n < KY; ++n) {
    const int item = warp + n * NW;
    if (item < NY) {
      const int I = item / NC16, n0 = (item % NC16) * 16;
      const float* ra = Rs + SB * I * LDA;
      const float* ep = eP + I * HD;
      float inter[2][4];
      product16(
          inter, HD, [&](int x, int d) { return ra[x * LDA + d] * ep[d]; },
          [&](int d, int col) { return St[d * LDV + n0 + col]; }, lane);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = SB * I + g + 8 * hf, col = n0 + 8 * nb + 2 * t4;
          const float* vr = Vs + i * LDV + col;
          store_pair(yp + i * ys + col,
                     (yin[n][nb][2 * hf] + dsc[i] * vr[0]) +
                         inter[nb][2 * hf],
                     (yin[n][nb][2 * hf + 1] + dsc[i] * vr[1]) +
                         inter[nb][2 * hf + 1]);
        }
    }
  }

  // the last block to finish leaves the workspace's counters at zero
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(p.sync + 1, 1) == p.BH * p.NC - 1) {
      for (int i = 0; i < p.BH; ++i) p.sync[2 + i] = 0;
      p.sync[0] = 0;
      p.sync[1] = 0;
      __threadfence();
    }
  }
}

template <class T, int CS, int HD>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  auto kern = wkv6_kernel<T, CS, HD>;
  const size_t smem = sizeof(float) * Layout<CS, HD>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<p.BH * p.NC, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <class T, int CS>
cudaError_t launch_hd(int hd, const Params& p, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, CS, 16>(p, s);
    case 32: return launch<T, CS, 32>(p, s);
    case 64: return launch<T, CS, 64>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

template <class T>
cudaError_t launch_cs(int chunk, int hd, const Params& p, cudaStream_t s) {
  switch (chunk) {
    case 16: return launch_hd<T, 16>(hd, p, s);
    case 32: return launch_hd<T, 32>(hd, p, s);
    case 64: return launch_hd<T, 64>(hd, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// r, k, v (B, H, S, hd) bf16 (`bf16` 1) or float32 (0), logw (B, H, S,
// hd) float32, u (H, hd) float32, each read through its strides in
// elements (r, k, v, logw: batch, head, time; u: head), the hd axis of
// unit stride; r, k, v 16-byte aligned with strides of whole 16 bytes.
// y (B, S, H, hd) contiguous in r's dtype and state (B, H, hd, hd) float32
// contiguous, written.  `sync` (2 + B H int32, zero before the first
// launch; each launch leaves it zero) and `ring` (B H x 2 x hd x hd
// float32) are the workspace, one per stream: launches that share one
// must not overlap.  chunk in {16, 32, 64} dividing S; hd in {16, 32,
// 64}.  Launches on `stream`; returns cudaGetLastError().
int wkv6_launch(const void* r, const void* k, const void* v, const void* w,
                const void* u, void* y, void* state, void* sync, void* ring,
                long long rb, long long rh, long long rs, long long kb,
                long long kh, long long ks, long long vb, long long vh,
                long long vs, long long wb, long long wh, long long ws,
                long long uh, int B, int H, int S, int hd, int chunk, int bf16,
                void* stream) {
  if (B < 1 || H < 1 || chunk < 1 || S < chunk || S % chunk != 0)
    return cudaErrorInvalidValue;
  Params p{r, k, v, static_cast<const float*>(w),
           static_cast<const float*>(u), y, static_cast<float*>(state),
           static_cast<int*>(sync), static_cast<float*>(ring),
           {rb, rh, rs}, {kb, kh, ks}, {vb, vh, vs}, {wb, wh, ws}, uh,
           H, S, B * H, S / chunk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_cs<__nv_bfloat16>(chunk, hd, p, s)
              : launch_cs<float>(chunk, hd, p, s);
}

}  // extern "C"
