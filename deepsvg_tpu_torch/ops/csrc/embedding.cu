// K1: fused SVG-token embedding as a gather-sum (see ops/embedding.py).
//
//   out[row] = CmdT[cmd] + sum_i T_i[arg_i + 1] (+ GroupT[gid]) + PosT[row % S]
//
// One thread per pair of output columns (bf16x2 or float2); the threads of a
// row read its 13 ids (cached) and the table rows (coalesced, L2-resident).
// Sums are f32, in the order of the one-hot matmuls they replace; the float
// form is exact (the tables' own values, no product to round), the bf16 form
// rounds once at the store. An id outside [0, table rows) contributes zero.
#include "common.cuh"

template <class T>
__global__ void embedding_kernel(const int* __restrict__ cmd,
                                 const int* __restrict__ args,
                                 const int* __restrict__ groups,
                                 const T* __restrict__ cmd_t,
                                 const T* __restrict__ arg_t,
                                 const T* __restrict__ group_t,
                                 const T* __restrict__ pos_t,
                                 T* __restrict__ out, long long rows, int S,
                                 int D, int n_args, int vocab, int n_cmd,
                                 int n_group, int use_group) {
  const int half = D / 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * half) return;
  const long long row = t / half;
  const int c = 2 * (int)(t % half);

  float2 acc = make_float2(0.f, 0.f);
  auto add = [&](const T* table, int n, int id) {
    if (id >= 0 && id < n) {
      const float2 v = load2(table + (long long)id * D + c);
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
  store2(out + row * D + c, acc.x, acc.y);
}

// is_f32: the tables and the output are float, else bf16
extern "C" int dsvg_embedding(const void* cmd, const void* args,
                              const void* groups, const void* cmd_t,
                              const void* arg_t, const void* group_t,
                              const void* pos_t, void* out, long long rows,
                              int S, int D, int n_args, int vocab, int n_cmd,
                              int n_group, int use_group, int is_f32, void* stream) {
  const int threads = 256;
  const long long work = rows * (D / 2);
  const unsigned blocks = (unsigned)((work + threads - 1) / threads);
  if (is_f32)
    embedding_kernel<float><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)cmd, (const int*)args, (const int*)groups, (const float*)cmd_t,
        (const float*)arg_t, (const float*)group_t, (const float*)pos_t, (float*)out, rows,
        S, D, n_args, vocab, n_cmd, n_group, use_group);
  else
    embedding_kernel<bf16><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)cmd, (const int*)args, (const int*)groups, (const bf16*)cmd_t,
        (const bf16*)arg_t, (const bf16*)group_t, (const bf16*)pos_t, (bf16*)out, rows, S,
        D, n_args, vocab, n_cmd, n_group, use_group);
  return (int)cudaGetLastError();
}
