// Helpers shared by the attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu, decode_attention.cu): element conversion to and
// from float32, and the strides of a (B, S, H, hd) tensor whose last
// dimension is contiguous.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

//! masked score, the reference's NEG_INF: exp(NEG_INF - m) is exactly 0
//! for any finite running max m
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);  // round to nearest even, as torch's .to()
}

//! element strides of dims 0, 1 and 2 of a 4-d tensor; dim 3 has stride 1
struct Strides {
  long long b, s, h;
};

inline Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

//! allow `bytes` of dynamic shared memory for `kernel` (above 48 KB it
//! must be asked for), then return the launch's error state
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace attn
