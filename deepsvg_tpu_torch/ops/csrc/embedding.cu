// K1: fused SVG-token embedding as a gather-sum (see ops/embedding.py).
//
//   out[row] = CmdT[cmd] + sum_i T_i[arg_i + 1] (+ GroupT[gid]) + PosT[row % S]
//
// One thread per pair of output columns (bf16x2); the threads of a row read
// its 13 ids (cached) and the table rows (coalesced, L2-resident). Sums are
// f32, in the order of the one-hot matmuls they replace. An id outside
// [0, table rows) contributes zero.
#include "common.cuh"

__global__ void embedding_kernel(const int* __restrict__ cmd,
                                 const int* __restrict__ args,
                                 const int* __restrict__ groups,
                                 const bf16* __restrict__ cmd_t,
                                 const bf16* __restrict__ arg_t,
                                 const bf16* __restrict__ group_t,
                                 const bf16* __restrict__ pos_t,
                                 bf16* __restrict__ out, long long rows, int S,
                                 int D, int n_args, int vocab, int n_cmd,
                                 int n_group, int use_group) {
  const int half = D / 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * half) return;
  const long long row = t / half;
  const int c = (int)(t % half);

  float2 acc = make_float2(0.f, 0.f);
  auto add = [&](const bf16* table, int n, int id) {
    if (id >= 0 && id < n) {
      const float2 v = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(table)[(long long)id * half + c]);
      acc.x += v.x;
      acc.y += v.y;
    }
  };
  add(cmd_t, n_cmd, cmd[row]);
  const int* a = args + row * n_args;
  for (int i = 0; i < n_args; ++i)
    add(arg_t + (long long)i * vocab * D, vocab, a[i] + 1);
  if (use_group) add(group_t, n_group, groups[row]);
  add(pos_t, S, (int)(row % S));
  reinterpret_cast<__nv_bfloat162*>(out)[row * half + c] =
      __floats2bfloat162_rn(acc.x, acc.y);
}

extern "C" int dsvg_embedding(const void* cmd, const void* args,
                              const void* groups, const void* cmd_t,
                              const void* arg_t, const void* group_t,
                              const void* pos_t, void* out, long long rows,
                              int S, int D, int n_args, int vocab, int n_cmd,
                              int n_group, int use_group, void* stream) {
  const int threads = 256;
  const long long work = rows * (D / 2);
  const unsigned blocks = (unsigned)((work + threads - 1) / threads);
  embedding_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)cmd, (const int*)args, (const int*)groups,
      (const bf16*)cmd_t, (const bf16*)arg_t, (const bf16*)group_t,
      (const bf16*)pos_t, (bf16*)out, rows, S, D, n_args, vocab, n_cmd,
      n_group, use_group);
  return (int)cudaGetLastError();
}
