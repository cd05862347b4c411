// K2: one fused pre-LN transformer layer per launch (see ops/layer.py).
//
// A block of 8 warps owns whole sequences: nseq = 64 / S of them, so a tile
// of at most 64 rows (2x32 for E1, 2x31 for D1 with the ragged rows unused,
// 8x8 for E2/D2). Everything between the input load and the output store
// stays in shared memory:
//   xres  f32  [64][D]          residual stream
//   xn    bf16 [64][D+8]        LN output, later the attention context
//   big   bf16 [64][max(3D,F)+8] QKV, later the FF hidden
//   scratch f32 [8 warps][16x16] accumulator tiles for the epilogues
// The four products run on the tensor cores (wmma bf16 16x16x16, f32
// accumulate); each warp owns a 16-column strip of the output over all 64
// rows, so each weight fragment is read from L2 once per block. Attention
// runs one (sequence, head) per warp: lane j holds key j (S <= 32, head dim
// 32 = one lane per output column), the softmax subtracts the row max, and a
// query whose keys are all masked gets zero probabilities.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int TILE_ROWS = 64;
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int HEAD_DIM = 32;
constexpr int SPAD = 8;  // bf16 row padding in shared memory against bank conflicts
constexpr float LN_EPS = 1e-5f;

struct LayerParams {
  const bf16* x;
  const bf16* seq_bias;  // [B][D] or null
  const bf16* ln1;       // [2][D]: scale, bias
  const bf16* wqkv;      // [3D][D]
  const bf16* bqkv;
  const bf16* wo;        // [D][D]
  const bf16* bo;
  const bf16* ln2;
  const bf16* w1;        // [F][D]
  const bf16* b1;
  const bf16* w2;        // [D][F]
  const bf16* b2;
  const float* mask;     // [B][S] additive
  bf16* out;
  int B, S, D, F, H, causal, nseq;
  float scale;
};

__host__ __device__ inline int big_ld(int D, int F) {
  return (3 * D > F ? 3 * D : F) + SPAD;
}

size_t smem_bytes(int D, int F) {
  return (size_t)TILE_ROWS * D * sizeof(float) +
         (size_t)TILE_ROWS * (D + SPAD) * sizeof(bf16) +
         (size_t)TILE_ROWS * big_ld(D, F) * sizeof(bf16) +
         (size_t)NWARPS * 256 * sizeof(float);
}

// out[64][N] = A[64][K] @ W[N][K]^T, handed element by element to `epi`.
template <class Epi>
__device__ __forceinline__ void tile_gemm(const bf16* A, int lda,
                                          const bf16* __restrict__ W, int N,
                                          int K, float* scratch, int warp,
                                          int lane, Epi epi) {
  for (int nt = warp; nt < N / 16; nt += NWARPS) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TILE_ROWS / 16];
#pragma unroll
    for (int r = 0; r < TILE_ROWS / 16; ++r) wmma::fill_fragment(acc[r], 0.f);
    const bf16* wcol = W + (size_t)nt * 16 * K;
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, wcol + k, K);
#pragma unroll
      for (int r = 0; r < TILE_ROWS / 16; ++r) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, A + (size_t)r * 16 * lda + k, lda);
        wmma::mma_sync(acc[r], a, b, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < TILE_ROWS / 16; ++r) {
      wmma::store_matrix_sync(scratch, acc[r], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32)
        epi(r * 16 + e / 16, nt * 16 + e % 16, scratch[e]);
      __syncwarp();
    }
  }
}

// One warp per row: [xres += seq_bias;] xn = LN(xres) in f32, stored bf16.
__device__ void layer_norm_rows(float* xres, int D, const bf16* __restrict__ ln,
                                bf16* xn, int ldn, const bf16* __restrict__ bias,
                                int S, int nrows, int warp, int lane) {
  for (int r = warp; r < TILE_ROWS; r += NWARPS) {
    float* xr = xres + (size_t)r * D;
    if (bias != nullptr && r < nrows) {
      const bf16* br = bias + (size_t)(r / S) * D;
      for (int c = lane; c < D; c += 32) xr[c] += bf2f(br[c]);
    }
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += xr[c];
    const float mu = warp_sum(s) / D;
    float v = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = xr[c] - mu;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / D + LN_EPS);
    for (int c = lane; c < D; c += 32)
      xn[(size_t)r * ldn + c] = f2bf((xr[c] - mu) * rstd * bf2f(ln[c]) + bf2f(ln[D + c]));
  }
}

// ctx[seq, i, head] = softmax(q_i k^T * scale + mask) v, one warp per
// (sequence, head); probabilities are rounded to bf16 before the PV product.
__device__ void attention(const bf16* qkv, int ldq, bf16* ctx, int ldc,
                          const float* __restrict__ mask, int nvalid, int S,
                          int D, int H, int causal, float scale, int warp,
                          int lane) {
  for (int pair = warp; pair < nvalid * H; pair += NWARPS) {
    const int sq = pair / H, h = pair - sq * H;
    const bf16* base = qkv + (size_t)sq * S * ldq;
    const bool has_key = lane < S;
    const bf16* kr = base + (size_t)(has_key ? lane : 0) * ldq + D + h * HEAD_DIM;
    float kf[HEAD_DIM];
#pragma unroll
    for (int d = 0; d < HEAD_DIM; ++d) kf[d] = has_key ? bf2f(kr[d]) : 0.f;
    const float mval = has_key ? mask[sq * S + lane] : -INFINITY;
    const bf16* vcol = base + 2 * D + h * HEAD_DIM + lane;
    for (int i = 0; i < S; ++i) {
      const bf16* qr = base + (size_t)i * ldq + h * HEAD_DIM;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < HEAD_DIM; ++d) s = fmaf(bf2f(qr[d]), kf[d], s);
      s = s * scale + mval;
      if (!has_key || (causal && lane > i)) s = -INFINITY;
      const float m = warp_max(s);  // the same in every lane
      float pr = 0.f;
      if (m != -INFINITY) {
        const float e = expf(s - m);
        pr = e / warp_sum(e);
      }
      pr = bf2f(f2bf(pr));
      float c = 0.f;
      for (int j = 0; j < S; ++j)
        c = fmaf(__shfl_sync(FULL_MASK, pr, j), bf2f(vcol[(size_t)j * ldq]), c);
      ctx[(size_t)(sq * S + i) * ldc + h * HEAD_DIM + lane] = f2bf(c);
    }
  }
}

__global__ void __launch_bounds__(NTHREADS) layer_kernel(LayerParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, F = p.F, S = p.S;
  const int ldn = D + SPAD, ldb = big_ld(D, F);
  float* xres = reinterpret_cast<float*>(smem);
  bf16* xn = reinterpret_cast<bf16*>(xres + TILE_ROWS * D);
  bf16* big = xn + TILE_ROWS * ldn;
  float* scratch = reinterpret_cast<float*>(big + TILE_ROWS * ldb);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wscr = scratch + warp * 256;
  const int seq0 = blockIdx.x * p.nseq;
  const int nvalid = min(p.nseq, p.B - seq0);
  const int nrows = nvalid * S;
  const size_t row0 = (size_t)seq0 * S;
  const int half = D / 2;

  // 1. input tile -> f32 residual; unused rows are zero
  for (int e = threadIdx.x; e < TILE_ROWS * half; e += NTHREADS) {
    const int r = e / half, c = (e - r * half) * 2;
    float2 v = make_float2(0.f, 0.f);
    if (r < nrows)
      v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p.x + (row0 + r) * D + c));
    xres[r * D + c] = v.x;
    xres[r * D + c + 1] = v.y;
  }
  __syncthreads();

  // 2. LN1
  layer_norm_rows(xres, D, p.ln1, xn, ldn, nullptr, S, nrows, warp, lane);
  __syncthreads();

  // 3. QKV = LN1(x) @ Wqkv^T + b, stored bf16
  tile_gemm(xn, ldn, p.wqkv, 3 * D, D, wscr, warp, lane,
            [&](int r, int n, float v) {
              big[r * ldb + n] = f2bf(v + bf2f(p.bqkv[n]));
            });
  __syncthreads();

  // 4. attention; the context overwrites xn
  attention(big, ldb, xn, ldn, p.mask + (size_t)seq0 * S, nvalid, S, D, p.H,
            p.causal, p.scale, warp, lane);
  __syncthreads();

  // 5. out projection into the residual
  tile_gemm(xn, ldn, p.wo, D, D, wscr, warp, lane, [&](int r, int n, float v) {
    xres[r * D + n] += v + bf2f(p.bo[n]);
  });
  __syncthreads();

  // 6. per-sequence bias, then LN2
  layer_norm_rows(xres, D, p.ln2, xn, ldn,
                  p.seq_bias ? p.seq_bias + (size_t)seq0 * D : nullptr, S,
                  nrows, warp, lane);
  __syncthreads();

  // 7. FF1 + ReLU, stored bf16
  tile_gemm(xn, ldn, p.w1, F, D, wscr, warp, lane, [&](int r, int n, float v) {
    big[r * ldb + n] = f2bf(fmaxf(v + bf2f(p.b1[n]), 0.f));
  });
  __syncthreads();

  // 8. FF2 into the residual
  tile_gemm(big, ldb, p.w2, D, F, wscr, warp, lane, [&](int r, int n, float v) {
    xres[r * D + n] += v + bf2f(p.b2[n]);
  });
  __syncthreads();

  // 9. store the valid rows
  for (int e = threadIdx.x; e < nrows * half; e += NTHREADS) {
    const int r = e / half, c = (e - r * half) * 2;
    *reinterpret_cast<__nv_bfloat162*>(p.out + (row0 + r) * D + c) =
        __floats2bfloat162_rn(xres[r * D + c], xres[r * D + c + 1]);
  }
}

}  // namespace

extern "C" int dsvg_layer(const void* x, const void* seq_bias, const void* ln1,
                          const void* wqkv, const void* bqkv, const void* wo,
                          const void* bo, const void* ln2, const void* w1,
                          const void* b1, const void* w2, const void* b2,
                          const void* mask, void* out, int B, int S, int D,
                          int F, int H, int causal, float scale, void* stream) {
  LayerParams p;
  p.x = (const bf16*)x;
  p.seq_bias = (const bf16*)seq_bias;
  p.ln1 = (const bf16*)ln1;
  p.wqkv = (const bf16*)wqkv;
  p.bqkv = (const bf16*)bqkv;
  p.wo = (const bf16*)wo;
  p.bo = (const bf16*)bo;
  p.ln2 = (const bf16*)ln2;
  p.w1 = (const bf16*)w1;
  p.b1 = (const bf16*)b1;
  p.w2 = (const bf16*)w2;
  p.b2 = (const bf16*)b2;
  p.mask = (const float*)mask;
  p.out = (bf16*)out;
  p.B = B;
  p.S = S;
  p.D = D;
  p.F = F;
  p.H = H;
  p.causal = causal;
  p.nseq = TILE_ROWS / S;
  p.scale = scale;
  const size_t smem = smem_bytes(D, F);
  cudaError_t err = cudaFuncSetAttribute(
      layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + p.nseq - 1) / p.nseq;
  layer_kernel<<<blocks, NTHREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
