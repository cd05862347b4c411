// K6: gradients of the embedding tables, a scatter-add of dy rows
// (see ops/embedding.py).
//
//   dcmd[cmd] += dy[row]; darg[i * vocab + arg_i + 1] += dy[row];
//   dgroup[gid] += dy[row]; dpos[row % S] += dy[row]
//
// One launch, two kinds of block. The first blocks own a run of tokens each,
// one thread a column. A few table rows take most of the tokens (the 7
// command rows and each slot's PAD row, arg = -1 -> row i * vocab): such a
// block sums them in shared memory without any atomics (a column of a shared
// row belongs to one thread) and adds them to the tables once at its end. The
// other argument rows and the group rows go to the tables with f32
// atomicAdd, coalesced over the columns of a row. The order of the atomic
// sums changes from run to run. An id outside [0, table rows) adds nothing.
// The last S blocks own one position row each: dpos[r] = sum_b dy[b][r],
// each warp over every eighth sequence, eight columns a lane, then the warps'
// sums added in warp order; no atomics, so dpos is the same from run to run.
// The positions' rows are thus outside the shared table, which holds
// (n_cmd + n_args) rows at any S (the S rows there before did not fit at
// S >= 210 with D = 256).
#include "common.cuh"

namespace {

template <class T>
__global__ void __launch_bounds__(256)
    embedding_bwd_kernel(const int* __restrict__ cmd, const int* __restrict__ args,
                         const int* __restrict__ groups, const T* __restrict__ dy,
                         float* __restrict__ dcmd, float* __restrict__ darg,
                         float* __restrict__ dgroup, float* __restrict__ dpos,
                         long long rows, int S, int D, int n_args, int vocab, int n_cmd,
                         int n_group, int use_group, int tokens_per_block, int token_blocks) {
  extern __shared__ float hot[];  // [n_cmd + n_args][D]; [8][D] in a position block
  if ((int)blockIdx.x >= token_blocks) {
    const int r = blockIdx.x - token_blocks;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
    const long long nseq = rows / S;
    for (int c0 = lane * 8; c0 < D; c0 += 32 * 8) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (long long b = warp; b < nseq; b += nwarps) {
        const T* src = dy + (b * S + r) * D + c0;
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          const float2 v = load2(src + j);
          acc[j] += v.x;
          acc[j + 1] += v.y;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) hot[(size_t)warp * D + c0 + j] = acc[j];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      float s = 0.f;
      for (int w = 0; w < nwarps; ++w) s += hot[(size_t)w * D + c];
      dpos[(size_t)r * D + c] = s;
    }
    return;
  }
  float* hot_cmd = hot;
  float* hot_pad = hot + (size_t)n_cmd * D;
  const int n_hot = n_cmd + n_args;
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
    }
    for (int r = 0; r < n_cmd; ++r) atomicAdd(dcmd + (size_t)r * D + c, hot_cmd[(size_t)r * D + c]);
    for (int i = 0; i < n_args; ++i)
      atomicAdd(darg + (size_t)i * vocab * D + c, hot_pad[(size_t)i * D + c]);
  }
}

}  // namespace

// dcmd, darg and dgroup must be zero on entry; dpos is written. D is a
// multiple of 8.
extern "C" int dsvg_embedding_bwd(const void* cmd, const void* args, const void* groups,
                                  const void* dy, void* dcmd, void* darg, void* dgroup,
                                  void* dpos, long long rows, int S, int D, int n_args,
                                  int vocab, int n_cmd, int n_group, int use_group,
                                  int is_f32, void* stream) {
  if (D % 8 || S < 1 || rows % S) return (int)cudaErrorInvalidValue;
  const int tokens_per_block = 128;
  const int n_hot = n_cmd + n_args > 8 ? n_cmd + n_args : 8;
  const size_t smem = (size_t)n_hot * D * sizeof(float);
  const int token_blocks = (int)((rows + tokens_per_block - 1) / tokens_per_block);
  const unsigned blocks = (unsigned)(token_blocks + S);
  cudaError_t err;
  if (is_f32) {
    err = cudaFuncSetAttribute(embedding_bwd_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    embedding_bwd_kernel<float><<<blocks, 256, smem, (cudaStream_t)stream>>>(
        (const int*)cmd, (const int*)args, (const int*)groups, (const float*)dy,
        (float*)dcmd, (float*)darg, (float*)dgroup, (float*)dpos, rows, S, D, n_args,
        vocab, n_cmd, n_group, use_group, tokens_per_block, token_blocks);
  } else {
    err = cudaFuncSetAttribute(embedding_bwd_kernel<bf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    embedding_bwd_kernel<bf16><<<blocks, 256, smem, (cudaStream_t)stream>>>(
        (const int*)cmd, (const int*)args, (const int*)groups, (const bf16*)dy,
        (float*)dcmd, (float*)darg, (float*)dgroup, (float*)dpos, rows, S, D, n_args,
        vocab, n_cmd, n_group, use_group, tokens_per_block, token_blocks);
  }
  return (int)cudaGetLastError();
}
