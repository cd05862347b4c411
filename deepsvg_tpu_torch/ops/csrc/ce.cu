// K5: softmax cross-entropy of the argument head straight from the decoder
// states, forward and backward; the logits are never stored (see ops/ce.py).
//
// The head arrives packed per slot as in K3: slot i is round16(vocab) rows of
// length D, padded columns masked by index. bf16 operands, f32 accumulation.
//
//   ce_fwd:  a block keeps 128 rows of y in shared memory, stages 64 head
//            columns at a time, multiplies with wmma and folds each chunk into
//            a running (max, sum of exp, target logit) per row and slot. It
//            writes ce = lse - target logit and keeps lse for the backward.
//   ce_bwd_dy: a block keeps 64 rows of y, recomputes each 64-column logits
//            chunk, forms dlg = (exp(lg - lse) - onehot) * g, rounds it to bf16
//            and adds dlg @ W_chunk to the rows' dy, held in accumulators.
//   ce_bwd_dw: dW and db are sums over all rows, and blocks run concurrently:
//            a block owns one 64-column chunk of the head and one split of the
//            rows, walks its row tiles recomputing logits and dlg, keeps
//            dW_chunk = dlg^T @ y in accumulators, and writes them to its
//            split's slice; dsvg_reduce_partials (wgrad.cu) adds the slices in
//            a fixed order. The logits are thus computed twice in the
//            backward; nothing head-sized touches device memory.
#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int CHUNK_TILES = 4;
constexpr int CHUNK = CHUNK_TILES * 16;
constexpr int SCR_LD = CHUNK + 4;
constexpr int DL_LD = CHUNK + 8;
constexpr int FWD_ROWS = 128;
constexpr int BWD_ROWS = 64;

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

// copy `nrows` rows of length D (bf16, 16-byte vectors) into shared memory;
// rows at or beyond `limit` are zero
__device__ __forceinline__ void stage_rows(bf16* dst, int ldx, const bf16* src, int D,
                                           int nrows, long long first, long long limit) {
  const int vecs = D / 8;
  for (int e = threadIdx.x; e < nrows * vecs; e += NTHREADS) {
    const int r = e / vecs, c = e - r * vecs;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (first + r < limit) v = reinterpret_cast<const uint4*>(src + (size_t)(first + r) * D)[c];
    *reinterpret_cast<uint4*>(dst + r * ldx + c * 8) = v;
  }
}

__global__ void __launch_bounds__(NTHREADS)
    ce_fwd_kernel(const bf16* __restrict__ y, const bf16* __restrict__ w,
                  const bf16* __restrict__ bias, const int* __restrict__ tgt,
                  float* __restrict__ ce, float* __restrict__ lse, int R, int D,
                  int n_args, int vocab) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = D + SPAD;
  bf16* ys = reinterpret_cast<bf16*>(smem);
  bf16* ws = ys + FWD_ROWS * ldx;
  float* scr = reinterpret_cast<float*>(ws + CHUNK * ldx);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wscr = scr + warp * 16 * SCR_LD;
  const int row0 = blockIdx.x * FWD_ROWS;
  stage_rows(ys, ldx, y, D, FWD_ROWS, row0, R);

  const int aw = round16(vocab), tiles = aw / 16;
  const int pr = lane >> 1, half = lane & 1;  // two lanes per row
  const int my_row = row0 + warp * 16 + pr;
  for (int slot = 0; slot < n_args; ++slot) {
    const int col0 = slot * aw;
    const int target = my_row < R ? tgt[(size_t)my_row * n_args + slot] : -1;
    float m = -INFINITY, s = 0.f, tl = 0.f;
    for (int t0 = 0; t0 < tiles; t0 += CHUNK_TILES) {
      const int nt = min(CHUNK_TILES, tiles - t0);
      __syncthreads();  // y is loaded / the previous chunk is consumed
      stage_rows(ws, ldx, w, D, nt * 16, col0 + t0 * 16, 1LL << 40);
      __syncthreads();
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[CHUNK_TILES];
#pragma unroll
      for (int t = 0; t < CHUNK_TILES; ++t) wmma::fill_fragment(acc[t], 0.f);
      for (int k = 0; k < D; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, ys + warp * 16 * ldx + k, ldx);
#pragma unroll
        for (int t = 0; t < CHUNK_TILES; ++t) {
          if (t < nt) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
            wmma::load_matrix_sync(b, ws + t * 16 * ldx + k, ldx);
            wmma::mma_sync(acc[t], a, b, acc[t]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < CHUNK_TILES; ++t)
        if (t < nt) wmma::store_matrix_sync(wscr + t * 16, acc[t], SCR_LD, wmma::mem_row_major);
      __syncwarp();
      for (int c = half; c < nt * 16; c += 2) {
        const int col = t0 * 16 + c;  // index within the slot
        if (col < vocab) {
          const float v = wscr[pr * SCR_LD + c] + bf2f(bias[col0 + col]);
          if (col == target) tl = v;
          if (v > m) {
            s = s * expf(m - v) + 1.f;  // exp(-inf) = 0 at the first column
            m = v;
          } else {
            s += expf(v - m);
          }
        }
      }
      __syncwarp();
    }
    const float om = __shfl_xor_sync(FULL_MASK, m, 1);
    const float os = __shfl_xor_sync(FULL_MASK, s, 1);
    tl += __shfl_xor_sync(FULL_MASK, tl, 1);
    const float mm = fmaxf(m, om);
    const float l = mm + logf(s * expf(m - mm) + os * expf(om - mm));
    if (half == 0 && my_row < R) {
      ce[(size_t)my_row * n_args + slot] = l - tl;
      lse[(size_t)my_row * n_args + slot] = l;
    }
  }
}

struct BwdCommon {
  const bf16* y;
  const bf16* w;
  const bf16* bias;
  const int* tgt;
  const float* g;
  const float* lse;
  int R, D, n_args, vocab;
};

// logits of rows [16 wr, +16) x the staged chunk's tiles {2 wc, 2 wc + 1} -> scr
__device__ __forceinline__ void chunk_logits(const bf16* ys, const bf16* ws, int ldx,
                                             int D, int nt, float* scr, int wr, int wc) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int k = 0; k < D; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, ys + wr * 16 * ldx + k, ldx);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = wc * 2 + i;
      if (t < nt) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, ws + t * 16 * ldx + k, ldx);
        wmma::mma_sync(acc[i], a, b, acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = wc * 2 + i;
    if (t < nt)
      wmma::store_matrix_sync(scr + wr * 16 * SCR_LD + t * 16, acc[i], SCR_LD,
                              wmma::mem_row_major);
  }
}

// scr (logits without bias) -> dlg in f32 back into scr, and rounded into dl
__device__ __forceinline__ void chunk_dlg(const BwdCommon& p, float* scr, bf16* dl,
                                          long long row0, int slot, int col0, int c0,
                                          int nt) {
  for (int e = threadIdx.x; e < BWD_ROWS * CHUNK; e += NTHREADS) {
    const int r = e / CHUNK, c = e - r * CHUNK;
    const long long row = row0 + r;
    const int col = c0 + c;  // index within the slot
    float d = 0.f;
    if (row < p.R && c < nt * 16 && col < p.vocab) {
      const size_t rs = (size_t)row * p.n_args + slot;
      const float lg = scr[r * SCR_LD + c] + bf2f(p.bias[col0 + col]);
      d = (expf(lg - p.lse[rs]) - (col == p.tgt[rs] ? 1.f : 0.f)) * p.g[rs];
    }
    scr[r * SCR_LD + c] = d;
    dl[r * DL_LD + c] = f2bf(d);
  }
}

__global__ void __launch_bounds__(NTHREADS) ce_bwd_dy_kernel(BwdCommon p, bf16* __restrict__ dy) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, ldx = D + SPAD;
  bf16* ys = reinterpret_cast<bf16*>(smem);
  bf16* ws = ys + BWD_ROWS * ldx;
  bf16* dl = ws + CHUNK * ldx;
  float* scr = reinterpret_cast<float*>(dl + BWD_ROWS * DL_LD);
  float* wscr = scr + BWD_ROWS * SCR_LD + (threadIdx.x >> 5) * 256;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp & 3, wc = warp >> 2;
  const long long row0 = (long long)blockIdx.x * BWD_ROWS;
  stage_rows(ys, ldx, p.y, D, BWD_ROWS, row0, p.R);

  const int aw = round16(p.vocab), tiles = aw / 16;
  const int nfrag = D / 32;  // this warp's 16 rows x half of D; D <= 256
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
  for (int f = 0; f < 8; ++f) wmma::fill_fragment(acc[f], 0.f);
  for (int slot = 0; slot < p.n_args; ++slot) {
    const int col0 = slot * aw;
    for (int t0 = 0; t0 < tiles; t0 += CHUNK_TILES) {
      const int nt = min(CHUNK_TILES, tiles - t0);
      __syncthreads();
      stage_rows(ws, ldx, p.w, D, nt * 16, col0 + t0 * 16, 1LL << 40);
      __syncthreads();
      chunk_logits(ys, ws, ldx, D, nt, scr, wr, wc);
      __syncthreads();
      chunk_dlg(p, scr, dl, row0, slot, col0, t0 * 16, nt);
      __syncthreads();
      for (int k = 0; k < nt * 16; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, dl + wr * 16 * DL_LD + k, DL_LD);
#pragma unroll
        for (int f = 0; f < 8; ++f) {
          if (f < nfrag) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
            wmma::load_matrix_sync(b, ws + k * ldx + wc * (D / 2) + f * 16, ldx);
            wmma::mma_sync(acc[f], a, b, acc[f]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int f = 0; f < 8; ++f) {
    if (f < nfrag) {
      wmma::store_matrix_sync(wscr, acc[f], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const long long row = row0 + wr * 16 + e / 16;
        if (row < p.R) dy[(size_t)row * D + wc * (D / 2) + f * 16 + e % 16] = f2bf(wscr[e]);
      }
      __syncwarp();
    }
  }
}

// grid: (n_args * chunks per slot, splits)
__global__ void __launch_bounds__(NTHREADS)
    ce_bwd_dw_kernel(BwdCommon p, float* __restrict__ dw_part, float* __restrict__ db_part,
                     int tiles_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, ldx = D + SPAD;
  bf16* ys = reinterpret_cast<bf16*>(smem);
  bf16* ws = ys + BWD_ROWS * ldx;
  bf16* dl = ws + CHUNK * ldx;
  float* scr = reinterpret_cast<float*>(dl + BWD_ROWS * DL_LD);
  const int warp = threadIdx.x >> 5;
  const int wr = warp & 3, wc = warp >> 2;
  const int aw = round16(p.vocab), tiles = aw / 16;
  const int chunks = (tiles + CHUNK_TILES - 1) / CHUNK_TILES;
  const int slot = blockIdx.x / chunks, t0 = (blockIdx.x % chunks) * CHUNK_TILES;
  const int nt = min(CHUNK_TILES, tiles - t0);
  const int col0 = slot * aw;
  stage_rows(ws, ldx, p.w, D, nt * 16, col0 + t0 * 16, 1LL << 40);

  // this warp's part of dW_chunk: all 64 columns x D columns [32 warp, +32)
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[CHUNK_TILES][2];
#pragma unroll
  for (int i = 0; i < CHUNK_TILES; ++i) {
    wmma::fill_fragment(acc[i][0], 0.f);
    wmma::fill_fragment(acc[i][1], 0.f);
  }
  const bool owns = warp * 32 < D;
  float db = 0.f;
  const int ntiles = (p.R + BWD_ROWS - 1) / BWD_ROWS;
  const int first = blockIdx.y * tiles_per_split;
  const int last = min(first + tiles_per_split, ntiles);
  for (int tile = first; tile < last; ++tile) {
    const long long row0 = (long long)tile * BWD_ROWS;
    __syncthreads();
    stage_rows(ys, ldx, p.y, D, BWD_ROWS, row0, p.R);
    __syncthreads();
    chunk_logits(ys, ws, ldx, D, nt, scr, wr, wc);
    __syncthreads();
    chunk_dlg(p, scr, dl, row0, slot, col0, t0 * 16, nt);
    __syncthreads();
    if (threadIdx.x < CHUNK)
      for (int r = 0; r < BWD_ROWS; ++r) db += scr[r * SCR_LD + threadIdx.x];
    if (owns) {
      for (int k = 0; k < BWD_ROWS; k += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
        wmma::load_matrix_sync(b[0], ys + k * ldx + warp * 32, ldx);
        wmma::load_matrix_sync(b[1], ys + k * ldx + warp * 32 + 16, ldx);
#pragma unroll
        for (int i = 0; i < CHUNK_TILES; ++i) {
          if (i < nt) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
            wmma::load_matrix_sync(a, dl + k * DL_LD + i * 16, DL_LD);
            wmma::mma_sync(acc[i][0], a, b[0], acc[i][0]);
            wmma::mma_sync(acc[i][1], a, b[1], acc[i][1]);
          }
        }
      }
    }
  }
  const size_t C = (size_t)p.n_args * aw;
  float* out = dw_part + (size_t)blockIdx.y * C * D + (size_t)(col0 + t0 * 16) * D;
  if (owns) {
#pragma unroll
    for (int i = 0; i < CHUNK_TILES; ++i) {
      if (i < nt) {
        wmma::store_matrix_sync(out + (size_t)i * 16 * D + warp * 32, acc[i][0], D,
                                wmma::mem_row_major);
        wmma::store_matrix_sync(out + (size_t)i * 16 * D + warp * 32 + 16, acc[i][1], D,
                                wmma::mem_row_major);
      }
    }
  }
  if (threadIdx.x < nt * 16)
    db_part[(size_t)blockIdx.y * C + col0 + t0 * 16 + threadIdx.x] = db;
}

size_t bwd_smem(int D) {
  return (size_t)(BWD_ROWS + CHUNK) * (D + SPAD) * sizeof(bf16) +
         (size_t)BWD_ROWS * DL_LD * sizeof(bf16) + (size_t)BWD_ROWS * SCR_LD * sizeof(float) +
         (size_t)NWARPS * 256 * sizeof(float);
}

BwdCommon common(const void* y, const void* w, const void* bias, const void* tgt,
                 const void* g, const void* lse, int R, int D, int n_args, int vocab) {
  BwdCommon p;
  p.y = (const bf16*)y;
  p.w = (const bf16*)w;
  p.bias = (const bf16*)bias;
  p.tgt = (const int*)tgt;
  p.g = (const float*)g;
  p.lse = (const float*)lse;
  p.R = R;
  p.D = D;
  p.n_args = n_args;
  p.vocab = vocab;
  return p;
}

}  // namespace

extern "C" int dsvg_ce_fwd(const void* y, const void* w, const void* bias,
                           const void* tgt, void* ce, void* lse, int R, int D,
                           int n_args, int vocab, void* stream) {
  const size_t smem = (size_t)(FWD_ROWS + CHUNK) * (D + SPAD) * sizeof(bf16) +
                      (size_t)NWARPS * 16 * SCR_LD * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ce_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (R + FWD_ROWS - 1) / FWD_ROWS;
  ce_fwd_kernel<<<blocks, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)y, (const bf16*)w, (const bf16*)bias, (const int*)tgt, (float*)ce,
      (float*)lse, R, D, n_args, vocab);
  return (int)cudaGetLastError();
}

extern "C" int dsvg_ce_bwd_dy(const void* y, const void* w, const void* bias,
                              const void* tgt, const void* g, const void* lse, void* dy,
                              int R, int D, int n_args, int vocab, void* stream) {
  const size_t smem = bwd_smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      ce_bwd_dy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (R + BWD_ROWS - 1) / BWD_ROWS;
  ce_bwd_dy_kernel<<<blocks, NTHREADS, smem, (cudaStream_t)stream>>>(
      common(y, w, bias, tgt, g, lse, R, D, n_args, vocab), (bf16*)dy);
  return (int)cudaGetLastError();
}

// dw_part [splits][n_args * round16(vocab)][D], db_part [splits][n_args * round16(vocab)]
extern "C" int dsvg_ce_bwd_dw(const void* y, const void* w, const void* bias,
                              const void* tgt, const void* g, const void* lse,
                              void* dw_part, void* db_part, int R, int D, int n_args,
                              int vocab, int splits, void* stream) {
  const size_t smem = bwd_smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      ce_bwd_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = round16(vocab) / 16;
  const int chunks = (tiles + CHUNK_TILES - 1) / CHUNK_TILES;
  const int ntiles = (R + BWD_ROWS - 1) / BWD_ROWS;
  const int per_split = (ntiles + splits - 1) / splits;
  dim3 grid(n_args * chunks, splits);
  ce_bwd_dw_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      common(y, w, bias, tgt, g, lse, R, D, n_args, vocab), (float*)dw_part,
      (float*)db_part, per_split);
  return (int)cudaGetLastError();
}
