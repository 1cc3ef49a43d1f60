// CUDA kernel for the SMLA cycle engine: the Hopper counterpart of
// repro/core/smla/pallas_engine.py::sim_cell_blocks.  Built by
// core/smla/cuda_engine.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// and loaded with ctypes (plain C interface, no PyTorch headers).
//
// Design: one warp runs one cell's whole chunked simulation
// (smla_cycle.cuh).  A cell's cycles form a serial dependency chain (each
// cycle's scheduler reads the state the previous cycle wrote), while
// cells are independent.  What bounds the kernel is therefore the latency
// of the slowest cell's chain, not device-memory bytes (inputs are a few
// KB per cell, outputs ~100 B) nor peak operation rate.  The warp cuts the
// chain: its lanes take the window slots and the ranks, so each scan over
// them is one warp collective, and the state sits in the warp's slice of
// shared memory.  A block holds a few warps (cells), so a grid's cells
// spread over every SM; each cell carries its own chunk width, so a whole
// shape group of a sweep, whatever its makespan buckets, is one launch.
#include <cuda_runtime.h>

#include "smla_cycle.cuh"

__global__ void smla_sim_kernel(smla::Dims d, smla::Buffers b, int warps) {
  extern __shared__ int32_t smem[];
  const int w = threadIdx.x / smla::LANES;
  const int64_t c = (int64_t)blockIdx.x * warps + w;
  if (c >= d.v[smla::D_N]) return;  // the whole warp leaves
  const smla::DeviceWarp warp{(int)(threadIdx.x % smla::LANES)};
  smla::sim_cell(warp, d, b, c, smem + w * smla::cell_words(d));
}

// 32-bit words of one cell's state (shared memory per warp).
extern "C" long long smla_cell_words(const int32_t* dims) {
  const float fd[2] = {0.0f, 0.0f};
  return smla::cell_words(smla::make_dims(dims, fd));
}

// Launches `warps` cells per block on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int smla_sim_launch(const int32_t* dims, const float* fdims,
                               const int32_t* ctx, const int32_t* rank,
                               const float* inst, const int32_t* tr,
                               int32_t* out_i, int32_t* out_core,
                               float* out_f, int warps, void* stream) {
  const smla::Dims d = smla::make_dims(dims, fdims);
  const smla::Buffers b{ctx, rank, inst, tr, out_i, out_core, out_f};
  const int n = d.v[smla::D_N];
  const int blocks = (n + warps - 1) / warps;
  const size_t smem = sizeof(int32_t) * smla::cell_words(d) * warps;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        smla_sim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return (int)err;
  }
  smla_sim_kernel<<<blocks, warps * smla::LANES, smem,
                    (cudaStream_t)stream>>>(d, b, warps);
  return (int)cudaGetLastError();
}
