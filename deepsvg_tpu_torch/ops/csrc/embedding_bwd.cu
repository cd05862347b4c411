// K6: gradients of the embedding tables, a scatter-add of dy rows
// (see ops/embedding.py).
//
//   dcmd[cmd] += dy[row]; darg[i * vocab + arg_i + 1] += dy[row];
//   dgroup[gid] += dy[row]; dpos[row % S] += dy[row]
//
// A few table rows take most of the tokens: the 7 command rows, the S
// position rows, and each slot's PAD row (arg = -1 -> row i * vocab). A block
// owns a run of tokens and one thread a column, so the block first sums those
// hot rows in shared memory without any atomics (a column of a shared row
// belongs to one thread), and adds them to the tables once at its end. The
// other argument rows and the group rows go to the tables with f32 atomicAdd,
// coalesced over the columns of a row. The order of the atomic sums changes
// from run to run. An id outside [0, table rows) adds nothing.
#include "common.cuh"

namespace {

template <class T>
__global__ void __launch_bounds__(256)
    embedding_bwd_kernel(const int* __restrict__ cmd, const int* __restrict__ args,
                         const int* __restrict__ groups, const T* __restrict__ dy,
                         float* __restrict__ dcmd, float* __restrict__ darg,
                         float* __restrict__ dgroup, float* __restrict__ dpos,
                         long long rows, int S, int D, int n_args, int vocab, int n_cmd,
                         int n_group, int use_group, int tokens_per_block) {
  extern __shared__ float hot[];  // [n_cmd + n_args + S][D]
  float* hot_cmd = hot;
  float* hot_pad = hot + (size_t)n_cmd * D;
  float* hot_pos = hot_pad + (size_t)n_args * D;
  const int n_hot = n_cmd + n_args + S;
  const long long t0 = (long long)blockIdx.x * tokens_per_block;
  const long long t1 = min(t0 + tokens_per_block, rows);
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    for (int r = 0; r < n_hot; ++r) hot[(size_t)r * D + c] = 0.f;
    for (long long tok = t0; tok < t1; ++tok) {
      const float v = to_f(dy[tok * D + c]);
      const int id = cmd[tok];
      if (id >= 0 && id < n_cmd) hot_cmd[(size_t)id * D + c] += v;
      const int* a = args + tok * n_args;
      for (int i = 0; i < n_args; ++i) {
        const int row = a[i] + 1;
        if (row == 0)
          hot_pad[(size_t)i * D + c] += v;
        else if (row > 0 && row < vocab)
          atomicAdd(darg + ((size_t)i * vocab + row) * D + c, v);
      }
      if (use_group) {
        const int gid = groups[tok];
        if (gid >= 0 && gid < n_group) atomicAdd(dgroup + (size_t)gid * D + c, v);
      }
      hot_pos[(size_t)(tok % S) * D + c] += v;
    }
    for (int r = 0; r < n_cmd; ++r) atomicAdd(dcmd + (size_t)r * D + c, hot_cmd[(size_t)r * D + c]);
    for (int i = 0; i < n_args; ++i)
      atomicAdd(darg + (size_t)i * vocab * D + c, hot_pad[(size_t)i * D + c]);
    for (int r = 0; r < S; ++r) atomicAdd(dpos + (size_t)r * D + c, hot_pos[(size_t)r * D + c]);
  }
}

}  // namespace

// The four outputs must be zero on entry.
extern "C" int dsvg_embedding_bwd(const void* cmd, const void* args, const void* groups,
                                  const void* dy, void* dcmd, void* darg, void* dgroup,
                                  void* dpos, long long rows, int S, int D, int n_args,
                                  int vocab, int n_cmd, int n_group, int use_group,
                                  int is_f32, void* stream) {
  const int tokens_per_block = 128;
  const size_t smem = (size_t)(n_cmd + n_args + S) * D * sizeof(float);
  const unsigned blocks = (unsigned)((rows + tokens_per_block - 1) / tokens_per_block);
  cudaError_t err;
  if (is_f32) {
    err = cudaFuncSetAttribute(embedding_bwd_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    embedding_bwd_kernel<float><<<blocks, 256, smem, (cudaStream_t)stream>>>(
        (const int*)cmd, (const int*)args, (const int*)groups, (const float*)dy,
        (float*)dcmd, (float*)darg, (float*)dgroup, (float*)dpos, rows, S, D, n_args,
        vocab, n_cmd, n_group, use_group, tokens_per_block);
  } else {
    err = cudaFuncSetAttribute(embedding_bwd_kernel<bf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    embedding_bwd_kernel<bf16><<<blocks, 256, smem, (cudaStream_t)stream>>>(
        (const int*)cmd, (const int*)args, (const int*)groups, (const bf16*)dy,
        (float*)dcmd, (float*)darg, (float*)dgroup, (float*)dpos, rows, S, D, n_args,
        vocab, n_cmd, n_group, use_group, tokens_per_block);
  }
  return (int)cudaGetLastError();
}
