// Host build of the SMLA cycle engine (g++), for the CPU tests only: the
// same smla_cycle.cuh the CUDA kernel runs, looped over cells on the CPU,
// so the kernel's logic is held against the plain PyTorch version where
// there is no card.  The package's entry points never load it.
#include "smla_cycle.cuh"

extern "C" void smla_scratch_words(const int32_t* dims, int64_t* out) {
  const float fd[2] = {0.0f, 0.0f};
  const smla::Dims d = smla::make_dims(dims, fd);
  out[0] = smla::scratch_i_words(d);
  out[1] = smla::scratch_f_words(d);
}

extern "C" int smla_sim_host(const int32_t* dims, const float* fdims,
                             const int32_t* ctx, const int32_t* rank,
                             const float* inst, const int32_t* tr,
                             int32_t* scratch_i, float* scratch_f,
                             int32_t* out_i, int32_t* out_core, float* out_f) {
  const smla::Dims d = smla::make_dims(dims, fdims);
  const smla::Buffers b{ctx, rank, inst, tr, scratch_i, scratch_f,
                        out_i, out_core, out_f};
  for (int64_t c = 0; c < d.v[smla::D_N]; ++c) smla::sim_cell(d, b, c);
  return 0;
}
