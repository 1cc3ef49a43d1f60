// The RWKV-6 (WKV6) chunked linear recurrence for Hopper (sm_90a): per
// (batch, head), with data-dependent per-channel decay,
//
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
//   y_t = r_t . S_{t-1} + (r_t . (u * k_t)) v_t,
//
// evaluated chunk by chunk, returning y and the final state.
//
// Replaces the TPU kernel src/repro/kernels/wkv6/kernel.py: wkv6
// (_wkv_kernel).  That kernel walks a sequential chunk axis with the
// (hd, hd) state in VMEM scratch and builds the intra-chunk (cs, cs, hd)
// decay tensor exp(t_i - s_j) in VMEM.  Here one block owns one (batch,
// head) and loops over the chunks itself (blocks run in no order on the
// card): the state stays in shared memory across chunks (16 KB at hd 64)
// with the chunk's r, k, v and cumulative log-decay tiles beside it, and
// the intra-chunk scores sum_d r[i,d] k[j,d] exp(texc[i,d] - scum[j,d])
// (j < i) are computed pair by pair, so the decay tensor is never
// materialised.  Every exponent is <= 0 (the log-decays are negative):
// the same numbers as the reference and overflow-free.  All arithmetic is
// float32, in the reference's order of terms: y = scores v + bonus v +
// (r decayed from the chunk start) state, then state = state decayed over
// the chunk + (k decayed to the chunk end)^T v.
//
// What bounds it on this card: operations.  At the training shape (B 4,
// H 40, S 2048, hd 64, chunk 64) it must do about 1.1e10 FLOP on the CUDA
// cores and 0.67e9 exp on the SFUs (the j < i pairs only) against 210 MB
// of bytes.  What the design does about it: each thread owns a 4 x 4
// micro-tile of every (cs x cs), (cs x hd) and (hd x hd) product, reading
// its operands from shared memory with conflict-free strides, and skips
// the j >= i half of the scores.  The block's 113 KB lets two blocks
// share an SM, so the 160 blocks of the training shape are all resident
// on the 132 SMs.  Tensor-core products and a split of the chunk work over
// warps are a later PR's work.
//
// Inputs: r, k, v, logw (B, H, S, hd) float32 contiguous, u (H, hd)
// float32; S a multiple of the chunk, which the caller guarantees, as in
// the reference.  Built for chunk in {16, 32, 64} and hd in {16, 32, 64}.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;  // threads: a 16 x 16 grid of micro-tiles

//! shared-memory layout, in floats: tiles read by 16 different rows in
//! one warp (k, scum) have padded rows; the others are read a row or two
//! at a time and are not padded
template <int CS, int HD>
struct Layout {
  static constexpr int LDP = HD + 1;
  static constexpr int ST = 0;               // state (HD x HD)
  static constexpr int R = ST + HD * HD;     // r, then r * exp(texc)
  static constexpr int TX = R + CS * HD;     // logw, then texc
  static constexpr int V = TX + CS * HD;     // v
  static constexpr int K = V + CS * HD;      // k, then k * exp(s_last - scum)
  static constexpr int SC = K + CS * LDP;    // scum (inclusive)
  static constexpr int A = SC + CS * LDP;    // scores (CS x CS)
  static constexpr int DSC = A + CS * CS;    // diagonal bonus (CS)
  static constexpr int TOTAL = DSC + CS;
};

template <int CS, int HD>
__global__ void __launch_bounds__(NT)
    wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, float* __restrict__ y,
                float* __restrict__ st_out, int H, int S) {
  using L = Layout<CS, HD>;
  constexpr int LDP = L::LDP;
  constexpr int RI = CS / 16;  // chunk rows per thread
  constexpr int RE = HD / 16;  // channels per thread
  extern __shared__ float sm[];
  float* St = sm + L::ST;
  float* Rs = sm + L::R;
  float* Tx = sm + L::TX;
  float* Vs = sm + L::V;
  float* Ks = sm + L::K;
  float* Sc = sm + L::SC;
  float* As = sm + L::A;
  float* Dsc = sm + L::DSC;

  const int bh = blockIdx.x;
  const float* uh = u + (bh % H) * HD;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const long long base = (long long)bh * S * HD;

  for (int idx = tid; idx < HD * HD; idx += NT) St[idx] = 0.f;

  for (int c0 = 0; c0 < S; c0 += CS) {
    __syncthreads();  // the previous chunk's readers are done
    const long long off = base + (long long)c0 * HD;
    for (int idx = tid; idx < CS * HD; idx += NT) {
      const int t = idx / HD, d = idx % HD;
      Rs[idx] = r[off + idx];
      Tx[idx] = w[off + idx];
      Vs[idx] = v[off + idx];
      Ks[t * LDP + d] = k[off + idx];
    }
    __syncthreads();

    // cumulative log-decays per channel: inclusive scum, exclusive
    // texc = scum - logw (as the reference computes it)
    if (tid < HD) {
      float acc = 0.f;
      for (int t = 0; t < CS; ++t) {
        const float wt = Tx[t * HD + tid];
        acc += wt;
        Sc[t * LDP + tid] = acc;
        Tx[t * HD + tid] = acc - wt;
      }
    }
    __syncthreads();

    // intra-chunk scores[i, j] (j < i; 0 elsewhere), pair by pair
    {
      float acc[RI][RI];
#pragma unroll
      for (int a = 0; a < RI; ++a)
#pragma unroll
        for (int b = 0; b < RI; ++b) acc[a][b] = 0.f;
      for (int d = 0; d < HD; ++d) {
        float rv[RI], tv[RI], kv[RI], sv[RI];
#pragma unroll
        for (int a = 0; a < RI; ++a) {
          rv[a] = Rs[(ty + 16 * a) * HD + d];
          tv[a] = Tx[(ty + 16 * a) * HD + d];
          kv[a] = Ks[(tx + 16 * a) * LDP + d];
          sv[a] = Sc[(tx + 16 * a) * LDP + d];
        }
#pragma unroll
        for (int a = 0; a < RI; ++a)
#pragma unroll
          for (int b = 0; b < RI; ++b)
            if (tx + 16 * b < ty + 16 * a)
              acc[a][b] += rv[a] * kv[b] * expf(tv[a] - sv[b]);
      }
#pragma unroll
      for (int a = 0; a < RI; ++a)
#pragma unroll
        for (int b = 0; b < RI; ++b)
          As[(ty + 16 * a) * CS + tx + 16 * b] = acc[a][b];
    }
    // diagonal bonus: sum_d r[i,d] u[d] k[i,d], one warp per row
    for (int i = warp; i < CS; i += NT / 32) {
      float s = 0.f;
      for (int d = lane; d < HD; d += 32)
        s += Rs[i * HD + d] * uh[d] * Ks[i * LDP + d];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) Dsc[i] = s;
    }
    __syncthreads();

    // r decayed from the chunk start; k decayed to the chunk end
    for (int idx = tid; idx < CS * HD; idx += NT) {
      const int t = idx / HD, d = idx % HD;
      Rs[idx] *= expf(Tx[idx]);
      Ks[t * LDP + d] *= expf(Sc[(CS - 1) * LDP + d] - Sc[t * LDP + d]);
    }
    __syncthreads();

    // y = scores v + bonus v + r_decayed state (the state before update)
    {
      float intra[RI][RE], inter[RI][RE];
#pragma unroll
      for (int a = 0; a < RI; ++a) {
        const int i = ty + 16 * a;
#pragma unroll
        for (int c = 0; c < RE; ++c) intra[a][c] = inter[a][c] = 0.f;
        for (int j = 0; j < i; ++j) {
          const float s = As[i * CS + j];
#pragma unroll
          for (int c = 0; c < RE; ++c)
            intra[a][c] += s * Vs[j * HD + tx + 16 * c];
        }
      }
      for (int d = 0; d < HD; ++d) {
        float rv[RI], sv[RE];
#pragma unroll
        for (int a = 0; a < RI; ++a) rv[a] = Rs[(ty + 16 * a) * HD + d];
#pragma unroll
        for (int c = 0; c < RE; ++c) sv[c] = St[d * HD + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < RI; ++a)
#pragma unroll
          for (int c = 0; c < RE; ++c) inter[a][c] += rv[a] * sv[c];
      }
#pragma unroll
      for (int a = 0; a < RI; ++a) {
        const int i = ty + 16 * a;
#pragma unroll
        for (int c = 0; c < RE; ++c) {
          const int e = tx + 16 * c;
          y[off + i * HD + e] =
              (intra[a][c] + Dsc[i] * Vs[i * HD + e]) + inter[a][c];
        }
      }
    }
    __syncthreads();  // every reader of the old state is done

    // state = state * exp(s_last) + k_decayed^T v
    {
      float acc[RE][RE];
#pragma unroll
      for (int a = 0; a < RE; ++a)
#pragma unroll
        for (int c = 0; c < RE; ++c) acc[a][c] = 0.f;
      for (int j = 0; j < CS; ++j) {
        float kv[RE], vv[RE];
#pragma unroll
        for (int a = 0; a < RE; ++a) kv[a] = Ks[j * LDP + ty + 16 * a];
#pragma unroll
        for (int c = 0; c < RE; ++c) vv[c] = Vs[j * HD + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < RE; ++a)
#pragma unroll
          for (int c = 0; c < RE; ++c) acc[a][c] += kv[a] * vv[c];
      }
#pragma unroll
      for (int a = 0; a < RE; ++a) {
        const int d = ty + 16 * a;
        const float decay = expf(Sc[(CS - 1) * LDP + d]);
#pragma unroll
        for (int c = 0; c < RE; ++c) {
          float* s = St + d * HD + tx + 16 * c;
          *s = *s * decay + acc[a][c];
        }
      }
    }
  }
  __syncthreads();
  float* so = st_out + (long long)bh * HD * HD;
  for (int idx = tid; idx < HD * HD; idx += NT) so[idx] = St[idx];
}

template <int CS, int HD>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, float* y, float* st,
                   int B, int H, int S, cudaStream_t stream) {
  auto kern = wkv6_kernel<CS, HD>;
  const size_t smem = sizeof(float) * Layout<CS, HD>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<B * H, NT, smem, stream>>>(r, k, v, w, u, y, st, H, S);
  return cudaGetLastError();
}

template <int CS>
cudaError_t launch_hd(int hd, const float* r, const float* k, const float* v,
                      const float* w, const float* u, float* y, float* st,
                      int B, int H, int S, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<CS, 16>(r, k, v, w, u, y, st, B, H, S, stream);
    case 32:
      return launch<CS, 32>(r, k, v, w, u, y, st, B, H, S, stream);
    case 64:
      return launch<CS, 64>(r, k, v, w, u, y, st, B, H, S, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// r, k, v, logw (B, H, S, hd) float32 contiguous; u (H, hd) float32;
// y (B, H, S, hd) and state (B, H, hd, hd) float32 contiguous, written.
// chunk in {16, 32, 64} dividing S; hd in {16, 32, 64}.  Launches on
// `stream`; returns cudaGetLastError().
int wkv6_launch(const void* r, const void* k, const void* v, const void* w,
                const void* u, void* y, void* state, int B, int H, int S,
                int hd, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rp = static_cast<const float*>(r);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* wp = static_cast<const float*>(w);
  const float* up = static_cast<const float*>(u);
  float* yp = static_cast<float*>(y);
  float* sp = static_cast<float*>(state);
  if (B < 1 || H < 1 || S < chunk || chunk < 1 || S % chunk != 0)
    return cudaErrorInvalidValue;
  switch (chunk) {
    case 16:
      return launch_hd<16>(hd, rp, kp, vp, wp, up, yp, sp, B, H, S, s);
    case 32:
      return launch_hd<32>(hd, rp, kp, vp, wp, up, yp, sp, B, H, S, s);
    case 64:
      return launch_hd<64>(hd, rp, kp, vp, wp, up, yp, sp, B, H, S, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
