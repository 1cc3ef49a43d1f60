// Host build of the SMLA cycle engine (g++), for the CPU tests only: the
// same smla_cycle.cuh the CUDA kernel runs, its warp emulated by 32 lanes
// taken one after another (smla::HostWarp), looped over cells on the CPU,
// so the kernel's logic is held against the plain PyTorch version where
// there is no card.  The package's entry points never load it.
#include <vector>

#include "smla_cycle.cuh"

extern "C" long long smla_cell_words(const int32_t* dims) {
  const float fd[2] = {0.0f, 0.0f};
  return smla::cell_words(smla::make_dims(dims, fd));
}

extern "C" int smla_sim_host(const int32_t* dims, const float* fdims,
                             const int32_t* ctx, const int32_t* rank,
                             const float* inst, const int32_t* tr,
                             int32_t* out_i, int32_t* out_core, float* out_f) {
  const smla::Dims d = smla::make_dims(dims, fdims);
  const smla::Buffers b{ctx, rank, inst, tr, out_i, out_core, out_f};
  std::vector<int32_t> words(smla::cell_words(d));
  const smla::HostWarp warp;
  for (int64_t c = 0; c < d.v[smla::D_N]; ++c)
    smla::sim_cell(warp, d, b, c, words.data());
  return 0;
}
