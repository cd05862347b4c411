// K4 backward, second and third launch: the layer's four weight gradients
// (see ops/layer_vjp.py); K7 computes all 4 L products of its stack in one
// launch (ops/stack_vjp.py): of the wgmma kernel at the end of this file
// where the products are multiples of 128 x 256, else of the older one.
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
//
// K4's bfloat16 short form at D = 256 (layer_train.cuh) takes the wgmma
// launch at the end of this file instead: the same products and split, plus
// the four bias gradients, on Hopper's tensor cores.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------- wgmma form
// dW[m][n] = sum_r A[r][m] B[r][n] and db[m] = sum_r A[r][m] for up to four
// bf16 problems (K4's: dqkv and LN1(x), da and ctx, dhpre and LN2(x1), df
// and the dropped hidden), M a multiple of 128 and N of 256. A work item is
// a 128 x 256 tile of one dW and a split of the rows; its block is a TMA
// producer warp and two wgmma consumer warpgroups (64 rows of the tile
// each). A stage is 64 rows of K: two 64 x 64 boxes of A and four of B, both
// read MN-major by wgmma (rows of K, 128-byte swizzled, as TMA lands them), so
// A^T B needs no transposed copy. The items of N-tile 0 also sum A's columns
// from the stages, in row order: db. Each split's partial sums go to its own
// slice of `part`; dsvg_reduce_partials adds the slices in order.
namespace {

using namespace hopper;

constexpr int HW_THREADS = 384, HW_CONSUMERS = 256, HW_STAGES = 4;
constexpr int HW_MAX = 4;                  // K4's four products
constexpr int HW_MAX_STACK = 32;           // K7's, 4 a layer up to 8 layers
constexpr uint32_t HW_BOX = 8192;          // 64 rows x 64 bf16
constexpr uint32_t HW_STAGE = 6 * HW_BOX;  // A's two boxes, then B's four

// NP problems at most: K4's launch keeps its parameters small (a tensor map
// is 128 bytes), K7's takes 32
template <int NP>
struct HwParams {
  CUtensorMap a[NP], b[NP];          // [rows][M], [rows][N]: boxes {64, 64}
  int N[NP];
  int tile0[NP + 1];                 // each problem's first output tile
  long long out0[NP], bias0[NP];     // its dW and db in a slice
  int nprob, rows, rows_per_split, tiles, items;
  long long total;                   // floats a slice
  float* part;                       // [splits][total]
};

struct HwItem {
  int q, mt, nt, split, k0, k1;
  template <class P>
  __device__ __forceinline__ HwItem(const P& p, int item) {
    split = item / p.tiles;
    const int t = item - split * p.tiles;
    q = 0;
    while (q + 1 < p.nprob && t >= p.tile0[q + 1]) ++q;
    const int local = t - p.tile0[q], nn = p.N[q] / 256;
    mt = local / nn;
    nt = local - mt * nn;
    k0 = split * p.rows_per_split;
    k1 = min(k0 + p.rows_per_split, p.rows);
  }
};

template <int NP>
__global__ void __launch_bounds__(HW_THREADS, 1)
    wgrad_hopper_kernel(const __grid_constant__ HwParams<NP> p) {
  unsigned char* ring = smem_base();
  float* bsum = reinterpret_cast<float*>(ring + HW_STAGES * HW_STAGE);  // [2 wg][2 halves][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + HW_STAGES * HW_STAGE + 1024);
  uint64_t* empty = full + HW_STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < HW_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], HW_CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= HW_CONSUMERS) {
    setmaxnreg_dec<40>();
    if (threadIdx.x != HW_CONSUMERS) return;
    PipeState ps;
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      const HwItem it(p, item);
      for (int r = it.k0; r < it.k1; r += 64) {
        mbar_wait(&empty[ps.stage], ps.phase ^ 1);
        mbar_arrive_expect_tx(&full[ps.stage], HW_STAGE);
        unsigned char* st = ring + ps.stage * HW_STAGE;
        for (int i = 0; i < 2; ++i)
          tma_load_2d(st + i * HW_BOX, &p.a[it.q], &full[ps.stage], 128 * it.mt + 64 * i, r);
        for (int i = 0; i < 4; ++i)
          tma_load_2d(st + (2 + i) * HW_BOX, &p.b[it.q], &full[ps.stage], 256 * it.nt + 64 * i, r);
        ps.advance(HW_STAGES);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bm = tid & 63, bh = (tid >> 6) & 1;  // db: this thread's column and half of a stage
  PipeState ps;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    const HwItem it(p, item);
    float acc[4][32];
    float bs = 0.f;
    int pending = -1;
    for (int r = it.k0; r < it.k1; r += 64) {
      mbar_wait(&full[ps.stage], ps.phase);
      const uint32_t st = smem_u32(ring + ps.stage * HW_STAGE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t a = desc_sw128(st + wg * HW_BOX + 2048 * kk);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wgmma_m64n64k16_bf16<1, 1>(acc[i], a, desc_sw128(st + (2 + i) * HW_BOX + 2048 * kk),
                                     (r > it.k0 || kk > 0) ? 1 : 0);
      }
      wgmma_commit();
      if (it.nt == 0) {
        const unsigned char* ab = ring + ps.stage * HW_STAGE + wg * HW_BOX;
#pragma unroll 8
        for (int i = 0; i < 32; ++i)
          bs += bf2f(*reinterpret_cast<const bf16*>(ab + swizzle128(32 * bh + i, 2 * bm)));
      }
      wgmma_wait<1>();
      if (pending >= 0) mbar_arrive(&empty[pending]);
      pending = ps.stage;
      ps.advance(HW_STAGES);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 4; ++i) fence_acc(acc[i]);
    if (pending >= 0) mbar_arrive(&empty[pending]);
    float* out = p.part + (size_t)it.split * p.total;
    const int N = p.N[it.q];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int m = 128 * it.mt + 64 * wg + 16 * w + g + 8 * rr;
      float* o = out + p.out0[it.q] + (size_t)m * N + 256 * it.nt + 2 * t4;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(o + 64 * i + 8 * j) =
              make_float2(acc[i][4 * j + 2 * rr], acc[i][4 * j + 2 * rr + 1]);
    }
    if (it.nt == 0) {
      bsum[(2 * wg + bh) * 64 + bm] = bs;
      named_barrier(2 + wg, 128);
      if (bh == 0)
        out[p.bias0[it.q] + 128 * it.mt + 64 * wg + bm] = bs + bsum[(2 * wg + 1) * 64 + bm];
      named_barrier(2 + wg, 128);
    }
  }
}

template <int NP>
int wgrad_hopper(void* const* a, void* const* b, const int* M, const int* N, int nprob, int rows,
                 int rows_per_split, int splits, void* part, void* stream) {
  HwParams<NP> p;
  int rc = bind_device_of(a[0]);
  int tiles = 0;
  long long total = 0;
  for (int q = 0; q < nprob && rc == 0; ++q) {
    if (M[q] % 128 || N[q] % 256) return (int)cudaErrorInvalidValue;
    rc = make_tma_2d(&p.a[q], a[q], false, M[q], rows, (uint64_t)M[q] * 2, 64, 64);
    if (rc == 0) rc = make_tma_2d(&p.b[q], b[q], false, N[q], rows, (uint64_t)N[q] * 2, 64, 64);
    p.N[q] = N[q];
    p.tile0[q] = tiles;
    p.out0[q] = total;
    tiles += (M[q] / 128) * (N[q] / 256);
    total += (long long)M[q] * N[q];
  }
  if (rc) return rc;
  for (int q = 0; q < nprob; ++q) {
    p.bias0[q] = total;
    total += M[q];
  }
  p.tile0[nprob] = tiles;
  p.nprob = nprob;
  p.rows = rows;
  p.rows_per_split = rows_per_split;
  p.tiles = tiles;
  p.items = tiles * splits;
  p.total = total;
  p.part = (float*)part;
  const int smem = HW_STAGES * HW_STAGE + 1024 + 64 + 1024;
  if ((rc = (int)cudaFuncSetAttribute(wgrad_hopper_kernel<NP>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
    return rc;
  wgrad_hopper_kernel<NP>
      <<<std::min(p.items, sm_count()), HW_THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// nprob <= 32 bf16 problems (K4's 4, K7's 4 a layer): a[q] [rows][M[q]],
// b[q] [rows][N[q]], M[q] a multiple of 128, N[q] of 256; rows_per_split a
// multiple of 64 and every
// split holding rows. part is [splits][sum M N + sum M]: each slice holds the
// dW in order, then the db in order.
extern "C" int dsvg_wgrad_hopper(void* const* a, void* const* b, const int* M, const int* N,
                                 int nprob, int rows, int rows_per_split, int splits, void* part,
                                 void* stream) {
  if (nprob < 1 || nprob > HW_MAX_STACK || rows_per_split % 64 || rows < 1 ||
      (long long)(splits - 1) * rows_per_split >= rows)
    return (int)cudaErrorInvalidValue;
  if (nprob <= HW_MAX)
    return wgrad_hopper<HW_MAX>(a, b, M, N, nprob, rows, rows_per_split, splits, part, stream);
  return wgrad_hopper<HW_MAX_STACK>(a, b, M, N, nprob, rows, rows_per_split, splits, part,
                                    stream);
}
