// CUDA kernel for the SMLA cycle engine: the Hopper counterpart of
// repro/core/smla/pallas_engine.py::sim_cell_blocks.  Built by
// core/smla/cuda_engine.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC
// and loaded with ctypes (plain C interface, no PyTorch headers).
//
// Design: one thread runs one cell's whole chunked simulation
// (smla_cycle.cuh).  A cell's cycles form a serial dependency chain (each
// cycle's scheduler reads the state the previous cycle wrote), so nothing
// inside a cell is parallel at this level, while cells are independent.
// What bounds the kernel is therefore the latency of the slowest cell's
// chain of dependent loads and branches, not device-memory bytes (inputs
// are a few KB per cell, outputs ~100 B) nor peak operation rate.  The
// state lives in scratch buffers the wrapper allocates (cell-major, so one
// thread's state is contiguous and stays in L1); blocks are small so that
// a few hundred cells spread over many SMs.  A later version can give each
// cell a warp, with lanes over window slots, state in shared memory and
// warp-shuffle argmax/segment reductions.
#include <cuda_runtime.h>

#include "smla_cycle.cuh"

__global__ void smla_sim_kernel(smla::Dims d, smla::Buffers b) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c < d.v[smla::D_N]) smla::sim_cell(d, b, c);
}

extern "C" void smla_scratch_words(const int32_t* dims, int64_t* out) {
  const float fd[2] = {0.0f, 0.0f};
  const smla::Dims d = smla::make_dims(dims, fd);
  out[0] = smla::scratch_i_words(d);
  out[1] = smla::scratch_f_words(d);
}

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int smla_sim_launch(const int32_t* dims, const float* fdims,
                               const int32_t* ctx, const int32_t* rank,
                               const float* inst, const int32_t* tr,
                               int32_t* scratch_i, float* scratch_f,
                               int32_t* out_i, int32_t* out_core,
                               float* out_f, int threads, void* stream) {
  const smla::Dims d = smla::make_dims(dims, fdims);
  const smla::Buffers b{ctx, rank, inst, tr, scratch_i, scratch_f,
                        out_i, out_core, out_f};
  const int n = d.v[smla::D_N];
  const int blocks = (n + threads - 1) / threads;
  smla_sim_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(d, b);
  return (int)cudaGetLastError();
}
