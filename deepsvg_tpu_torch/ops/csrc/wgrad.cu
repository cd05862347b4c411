// K4 backward, second and third launch: the layer's four weight gradients
// (see ops/layer_vjp.py); K7 computes all 4 L products of its stack in one
// launch of the same kernel (ops/stack_vjp.py).
//
// Each gradient is a product over all rows of the batch,
//   dW[m][n] = sum_r A[r][m] * B[r][n]
// with A the rounded output-side gradient (dqkv, da, dhpre, df) and B the
// matching input (LN1(x), ctx, LN2(x1), dropped FF hidden), both written by
// the first launch. On the TPU the sequential grid accumulated these in one
// VMEM block; here the rows are split over blockIdx.y, each block keeps a
// 64x64 output tile in tensor-core accumulators over its rows and writes it to
// its own slice of `part`, and dsvg_reduce_partials adds the slices in a fixed
// order. No atomics: the result does not depend on the schedule.
#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int MAX_PROBLEMS = 32;   // K4: 4; K7: 4 per layer, up to 8 layers
constexpr int WG_TILE = 64;
constexpr int WG_THREADS = 128;

struct WgradParams {
  const void* a[MAX_PROBLEMS];
  const void* b[MAX_PROBLEMS];
  int M[MAX_PROBLEMS], N[MAX_PROBLEMS];
  int tile0[MAX_PROBLEMS + 1];    // first tile of each problem
  long long out0[MAX_PROBLEMS];   // offset of each dW in a slice
  int nprob, rows_pad, rows_per_split;
  long long total;                // floats per slice
  float* part;                    // [splits][total]
};

template <class T>
__global__ void __launch_bounds__(WG_THREADS) wgrad_kernel(WgradParams p) {
  typedef Mma<T> M;
  int q = 0;
  while (q + 1 < p.nprob && (int)blockIdx.x >= p.tile0[q + 1]) ++q;
  const int t = blockIdx.x - p.tile0[q];
  const int nM = p.M[q], nN = p.N[q];
  const int tn = t % (nN / WG_TILE), tm = t / (nN / WG_TILE);
  const int warp = threadIdx.x >> 5;
  const int m0 = tm * WG_TILE + (warp >> 1) * 32, n0 = tn * WG_TILE + (warp & 1) * 32;
  const T* A = (const T*)p.a[q];
  const T* B = (const T*)p.b[q];
  const int k0 = blockIdx.y * p.rows_per_split;
  const int k1 = min(k0 + p.rows_per_split, p.rows_pad);

  typename M::Acc acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  for (int k = k0; k < k1; k += M::K) {
    typename M::ACol a[2];
    typename M::BRow b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      wmma::load_matrix_sync(a[i], A + (size_t)k * nM + m0 + 16 * i, nM);
      M::fix(a[i]);
      wmma::load_matrix_sync(b[i], B + (size_t)k * nN + n0 + 16 * i, nN);
      M::fix(b[i]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
  }
  float* out = p.part + (size_t)blockIdx.y * p.total + p.out0[q];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(out + (size_t)(m0 + 16 * i) * nN + n0 + 16 * j, acc[i][j],
                              nN, wmma::mem_row_major);
}

__global__ void reduce_partials_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, long long n, int slices) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < slices; ++k) s += part[(size_t)k * n + i];
  out[i] = s;
}

}  // namespace

// nprob products; a[q] is [rows_pad][M[q]], b[q] is [rows_pad][N[q]] (rows
// beyond the batch are zero), M and N multiples of 64. part is
// [splits][sum M*N]; the q-th dW starts at sum_{<q} M*N within a slice.
extern "C" int dsvg_wgrad(void* const* a, void* const* b, const int* M, const int* N,
                          int nprob, int rows_pad, int rows_per_split, int splits,
                          int is_f32, void* part, void* stream) {
  if (nprob < 1 || nprob > MAX_PROBLEMS) return (int)cudaErrorInvalidValue;
  WgradParams p;
  p.nprob = nprob;
  p.rows_pad = rows_pad;
  p.rows_per_split = rows_per_split;
  p.part = (float*)part;
  int tiles = 0;
  long long total = 0;
  for (int q = 0; q < nprob; ++q) {
    p.a[q] = a[q];
    p.b[q] = b[q];
    p.M[q] = M[q];
    p.N[q] = N[q];
    p.tile0[q] = tiles;
    p.out0[q] = total;
    tiles += (M[q] / WG_TILE) * (N[q] / WG_TILE);
    total += (long long)M[q] * N[q];
  }
  p.tile0[nprob] = tiles;
  p.total = total;
  dim3 grid(tiles, splits);
  if (is_f32)
    wgrad_kernel<float><<<grid, WG_THREADS, 0, (cudaStream_t)stream>>>(p);
  else
    wgrad_kernel<bf16><<<grid, WG_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// out[i] = sum_k part[k][i], k in order.
extern "C" int dsvg_reduce_partials(const void* part, void* out, long long n,
                                    int slices, void* stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  reduce_partials_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)part, (float*)out, n, slices);
  return (int)cudaGetLastError();
}
