// The long form of the fused layer's forward (see ops/layer.py), shared by
// K2's float32 long form (layer_long.cu; its bfloat16 form is
// layer_infer.cuh's) and K4's (layer_long_train.cu): one fused
// pre-LN layer over sequences of up to 256 rows, which a block cannot hold
// whole, in two launches.
//
// 1. qkv_kernel: LN1 + QKV over 64-row tiles (32 for float activations) of
//    all B*S rows, the result rounded to T into a tensor [B*S][3D] (scratch
//    at inference; K4 keeps it for its backward).
// 2. attn_ffn_kernel: one (sequence, query tile) per block. For each head in
//    turn the tile's queries, the sequence's keys (up to the tile's last
//    query when causal) and values come into shared memory; the scores
//    Q K^T on the tensor cores (f32); each row's exact softmax over all its
//    keys in f32, the probabilities rounded to T in place of the scores; the
//    context P V on the tensor cores, rounded to T (attend_tile, which the
//    attention block alone, attention.cu, shares). Then, as the short form:
//    out projection into the f32 residual (reloaded from x), seq_bias, LN2,
//    ReLU FF and residual, and the store of the tile's valid rows.
// The roundings are the short form's and layer_reference's. The products
// use nvcuda::wmma (bf16 16x16x16, or TF32 16x16x8 for float activations,
// whose attention products are then TF32 too), weights read from L2.
//
// TRAIN adds the short form's training switch (layer_fwd.cuh): dropout at
// the four sites, with the masks of common.cuh at the same (row, column)
// coordinates as the short form and the plain version, and what the MODE
// writes: with FWD_SAVE the saved tensors, the probabilities before dropout
// [B][H][S][S] (zero beyond a causal row's last key), the context, the
// residual after the attention block (f32) and the FF hidden before dropout;
// with FWD_OUT nothing but `out` (QKV is the caller's scratch); with
// FWD_WORKSPACE the context, that residual and the f32 hidden, and no FF2
// or `out` (the first launches of K4's recompute backward).
#pragma once

#include "layer_fwd.cuh"

// The kernels are in an anonymous namespace: each source that includes this
// header gets its own instantiations, registered with its own module.
namespace layer_long {
namespace {

using namespace layer_fwd;
using namespace nvcuda;

constexpr int MAX_SEQ_LONG = 256;  // ops/layer.py:MAX_SEQ_LONG
constexpr int HPAD = 8;            // row padding of the per-head Q/K/V slices

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

template <class T, int ROWS>
size_t qkv_smem(int D) {
  return (size_t)ROWS * D * sizeof(float) + (size_t)ROWS * (D + SPAD) * sizeof(T) +
         (size_t)NWARPS * 256 * sizeof(float);
}

// LN1 + QKV of rows [blockIdx.x * ROWS, + ROWS) of x [B*S][D] into qkv.
template <class T, int ROWS>
__global__ void __launch_bounds__(NTHREADS) qkv_kernel(LayerParams<T> p, T* qkv) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, ldn = D + SPAD;
  float* xres = reinterpret_cast<float*>(smem);
  T* xn = reinterpret_cast<T*>(xres + ROWS * D);
  float* scratch = reinterpret_cast<float*>(xn + ROWS * ldn);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row0 = (size_t)blockIdx.x * ROWS;
  const long long left = (long long)p.B * p.S - (long long)row0;
  const int nrows = left < ROWS ? (int)left : ROWS;

  for (int e = threadIdx.x * 2; e < ROWS * D; e += NTHREADS * 2) {
    const float2 v = e / D < nrows ? load2(p.x + row0 * D + e) : make_float2(0.f, 0.f);
    xres[e] = v.x;
    xres[e + 1] = v.y;
  }
  __syncthreads();
  layer_norm_rows<T, ROWS>(xres, D, p.ln1, xn, ldn, nullptr, nullptr, ROWS, nrows, warp, lane);
  __syncthreads();
  tile_gemm<T, ROWS, true>(xn, ldn, p.wqkv, D, 3 * D, D, scratch + warp * 256, warp, lane,
                           nullptr, [&](int r, int n, float v) {
                             if (r < nrows)
                               qkv[(row0 + r) * 3 * D + n] = from_f<T>(v + to_f(p.bqkv[n]));
                             return 0.f;
                           });
}

// Shared memory of attn_ffn_kernel: the context (later LN2's output), then
// one region used first by the attention (Q, K, V of a head of HD columns,
// padded to head_pad(HD); the scores and probabilities) and then by the FF
// (f32 residual, hidden), then the wmma scratch.
template <class T, int QROWS, int HD>
struct LongLayout {
  int ldn, ldh, lds, ldb, spad;
  size_t ctx, q, k, v, sc, xres, big, scratch, total;
  __host__ __device__ LongLayout(int S, int D, int F) {
    spad = round16(S);
    ldn = D + SPAD;
    ldh = head_pad(HD) + HPAD;
    lds = spad + 8;
    ldb = F + SPAD;
    ctx = 0;
    const size_t region = (size_t)QROWS * ldn * sizeof(T);
    q = region;
    k = q + (size_t)QROWS * ldh * sizeof(T);
    v = k + (size_t)spad * ldh * sizeof(T);
    sc = v + (size_t)spad * ldh * sizeof(T);
    const size_t att_end = sc + (size_t)QROWS * lds * sizeof(float);
    xres = region;
    big = xres + (size_t)QROWS * D * sizeof(float);
    const size_t ffn_end = big + (size_t)QROWS * ldb * sizeof(T);
    scratch = att_end > ffn_end ? att_end : ffn_end;
    total = scratch + (size_t)NWARPS * 256 * sizeof(float);
  }
};

// rows [0, nrows) x HD columns at column `col` of the rows `row0 + r` of a
// row-major tensor with `ld` elements a row, into dst [rows][ldh]: zeros
// beyond nrows, and in the columns from HD up to head_pad(HD)
template <int HD, class T>
__device__ void load_head(const T* src, size_t row0, int nrows, int rows, int ld, int col,
                          T* dst, int ldh) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = head_pad(HD) / VEC;
  for (int e = threadIdx.x; e < rows * PER_ROW; e += NTHREADS) {
    const int r = e / PER_ROW, c = (e - r * PER_ROW) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < nrows && c < HD)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * ld + col + c);
    *reinterpret_cast<uint4*>(dst + r * ldh + c) = val;
  }
}

// The attention of one (sequence b, query tile) block, every head in turn:
// the tile's queries [q0, q0 + nq), the sequence's keys (up to the tile's
// last query when causal) and values come into shared memory; the scores
// Q K^T on the tensor cores (f32); each row's exact softmax over all its keys
// in f32, the probabilities rounded to T in place of the scores; the context
// P V on the tensor cores, rounded to T, into ctx [QROWS][ldn]. With `drop`,
// the probabilities are dropped with the mask of SITE_ATTN_PROB at row
// (b * H + h) * S + i, column j; with `p_save` ([B][H][S][S]), they are
// saved before dropout. Heads of HD columns (8, 16 or 32): the products
// run over the head padded with zeros to a whole tensor-core tile, and only
// the HD columns of the context are written. Shared by K2's and K4's long
// forms and by the attention block alone (K10, K11; attention.cu).
template <class T, int QROWS, int HD>
__device__ __forceinline__ void attend_tile(const T* qkv, const float* mask, int b, int q0,
                                            int nq, int S, int D, int H, int causal,
                                            float scale, const LongLayout<T, QROWS, HD>& lay,
                                            unsigned char* smem, T* ctx, float* wscr,
                                            int warp, int lane, bool drop, int seed,
                                            unsigned thr, float kp, T* p_save) {
  typedef Mma<T> M;
  constexpr int KD = (HD + M::K - 1) / M::K * M::K;   // the score products' depth
  constexpr int NC = head_pad(HD) / 16;               // 16-column tiles of the context
  T* qs = reinterpret_cast<T*>(smem + lay.q);
  T* ks = reinterpret_cast<T*>(smem + lay.k);
  T* vs = reinterpret_cast<T*>(smem + lay.v);
  float* sc = reinterpret_cast<float*>(smem + lay.sc);
  T* ps = reinterpret_cast<T*>(sc);                   // probabilities, in place of the scores
  const int ldp = lay.lds * (int)(sizeof(float) / sizeof(T));
  const int ldn = lay.ldn, ldh = lay.ldh, lds = lay.lds;
  const int kmax = causal ? q0 + nq : S;              // keys any query of the tile sees
  const int nk = round16(kmax);
  const size_t seq_row0 = (size_t)b * S;
  const size_t tile_row0 = seq_row0 + q0;

  for (int h = 0; h < H; ++h) {
    load_head<HD>(qkv, tile_row0, nq, QROWS, 3 * D, h * HD, qs, ldh);
    load_head<HD>(qkv, seq_row0, kmax, nk, 3 * D, D + h * HD, ks, ldh);
    load_head<HD>(qkv, seq_row0, kmax, nk, 3 * D, 2 * D + h * HD, vs, ldh);
    __syncthreads();

    // scores [QROWS][nk] = Q K^T (f32)
    const int kt = nk / 16;
    for (int t = warp; t < (QROWS / 16) * kt; t += NWARPS) {
      const int i = t / kt, j = t - i * kt;
      typename M::Acc acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int k = 0; k < KD; k += M::K) {
        typename M::ARow a;
        typename M::BCol bk;
        wmma::load_matrix_sync(a, qs + i * 16 * ldh + k, ldh);
        wmma::load_matrix_sync(bk, ks + j * 16 * ldh + k, ldh);
        M::fix(a);
        M::fix(bk);
        wmma::mma_sync(acc, a, bk, acc);
      }
      wmma::store_matrix_sync(sc + i * 16 * lds + j * 16, acc, lds, wmma::mem_row_major);
    }
    __syncthreads();

    // softmax of each row over its keys; probabilities rounded to T, in place
    // (saved before dropout where asked, then dropped)
    const unsigned key_ap = site_key(seed, SITE_ATTN_PROB);
    for (int r = warp; r < QROWS; r += NWARPS) {
      const int qi = q0 + r;
      const int klim = causal ? min(qi + 1, S) : S;
      float v[MAX_SEQ_LONG / 32];
      float m = -INFINITY;
#pragma unroll
      for (int t = 0; t < MAX_SEQ_LONG / 32; ++t) {
        const int j = lane + 32 * t;
        v[t] = j < klim ? sc[r * lds + j] * scale + mask[j] : -INFINITY;
        m = fmaxf(m, v[t]);
      }
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < MAX_SEQ_LONG / 32; ++t) {
        v[t] = m == -INFINITY ? 0.f : expf(v[t] - m);
        sum += v[t];
      }
      sum = warp_sum(sum);
      __syncwarp();  // every lane has read the row before it is overwritten
      const size_t prow = ((size_t)b * H + h) * S + qi;   // the dropout row of (b, h, qi)
#pragma unroll
      for (int t = 0; t < MAX_SEQ_LONG / 32; ++t) {
        const int j = lane + 32 * t;
        float pr = m == -INFINITY ? 0.f : v[t] / sum;
        if (p_save != nullptr && r < nq && j < S) p_save[prow * S + j] = from_f<T>(pr);
        if (drop) pr = keep_elem(key_ap, (unsigned)prow, (unsigned)j, thr) ? pr * kp : 0.f;
        if (j < nk) ps[r * ldp + j] = from_f<T>(pr);
      }
    }
    __syncthreads();

    // context [QROWS][HD] = P V, rounded to T
    for (int t = warp; t < (QROWS / 16) * NC; t += NWARPS) {
      const int i = t / NC, c = t - i * NC;
      typename M::Acc acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k = 0; k < nk; k += M::K) {
        typename M::ARow a;
        typename M::BRow bv;
        wmma::load_matrix_sync(a, ps + i * 16 * ldp + k, ldp);
        wmma::load_matrix_sync(bv, vs + k * ldh + c * 16, ldh);
        M::fix(a);
        M::fix(bv);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(wscr, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32)
        if (c * 16 + e % 16 < HD)
          ctx[(i * 16 + e / 16) * ldn + h * HD + c * 16 + e % 16] = from_f<T>(wscr[e]);
      __syncwarp();
    }
    __syncthreads();
  }
}

template <class T, int QROWS, int HD, bool TRAIN, int MODE = FWD_SAVE>
__global__ void __launch_bounds__(NTHREADS) attn_ffn_kernel(LayerParams<T> p, const T* qkv) {
  constexpr bool SAVE = TRAIN && MODE == FWD_SAVE;
  constexpr bool WORKSPACE = TRAIN && MODE == FWD_WORKSPACE;
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, F = p.F, S = p.S, H = p.H;
  const LongLayout<T, QROWS, HD> lay(S, D, F);
  T* ctx = reinterpret_cast<T*>(smem + lay.ctx);
  float* xres = reinterpret_cast<float*>(smem + lay.xres);
  T* big = reinterpret_cast<T*>(smem + lay.big);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wscr = reinterpret_cast<float*>(smem + lay.scratch) + warp * 256;
  const int ldn = lay.ldn;
  const bool drop = TRAIN && p.thr != 0u;

  const int ntiles = (S + QROWS - 1) / QROWS;
  const int b = blockIdx.x / ntiles;
  const int q0 = (blockIdx.x - b * ntiles) * QROWS;
  const int nq = min(QROWS, S - q0);
  const size_t tile_row0 = (size_t)b * S + q0;

  attend_tile<T, QROWS, HD>(qkv, p.mask + (size_t)b * S, b, q0, nq, S, D, H, p.causal, p.scale,
                        lay, smem, ctx, wscr, warp, lane, drop, p.seed, p.thr, p.kp,
                        SAVE ? p.p_s : nullptr);
  if constexpr (SAVE || WORKSPACE) {
    for (int e = threadIdx.x; e < nq * D; e += NTHREADS) {
      const int r = e / D, c = e - r * D;
      p.ctx_s[tile_row0 * D + e] = ctx[r * ldn + c];
    }
  }

  // the tile's input rows -> f32 residual (zeros beyond nq)
  const T* xin = p.x + tile_row0 * D;
  for (int e = threadIdx.x * 2; e < QROWS * D; e += NTHREADS * 2) {
    const float2 v = e / D < nq ? load2(xin + e) : make_float2(0.f, 0.f);
    xres[e] = v.x;
    xres[e + 1] = v.y;
  }
  __syncthreads();

  {
    const unsigned key = site_key(p.seed, SITE_ATTN_OUT);
    tile_gemm<T, QROWS, true>(ctx, ldn, p.wo, D, D, D, wscr, warp, lane, nullptr,
                              [&](int r, int n, float v) {
                                float a = v + to_f(p.bo[n]);
                                if (drop)
                                  a = keep_elem(key, (unsigned)(tile_row0 + r), n, p.thr) ? a * p.kp
                                                                                         : 0.f;
                                xres[r * D + n] += a;
                                return 0.f;
                              });
  }
  __syncthreads();
  // seq_bias of sequence b on every row (S = QROWS: r / S = 0), then LN2
  // (the residual after seq_bias saved for the backward, or to the workspace)
  layer_norm_rows<T, QROWS>(xres, D, p.ln2, ctx, ldn,
                            p.seq_bias ? p.seq_bias + (size_t)b * D : nullptr,
                            SAVE || WORKSPACE ? p.x1_s + tile_row0 * D : nullptr, QROWS, nq,
                            warp, lane);
  __syncthreads();
  {
    const unsigned key = site_key(p.seed, SITE_FF_HIDDEN);
    tile_gemm<T, QROWS, true>(ctx, ldn, p.w1, D, F, D, wscr, warp, lane, nullptr,
                              [&](int r, int n, float v) {
                                float h = fmaxf(v + to_f(p.b1[n]), 0.f);
                                if constexpr (SAVE)
                                  if (r < nq) p.h_s[(tile_row0 + r) * F + n] = from_f<T>(h);
                                if constexpr (WORKSPACE)
                                  if (r < nq) p.h32[(tile_row0 + r) * F + n] = h;
                                if (drop)
                                  h = keep_elem(key, (unsigned)(tile_row0 + r), n, p.thr) ? h * p.kp
                                                                                         : 0.f;
                                big[r * lay.ldb + n] = from_f<T>(h);
                                return 0.f;
                              });
  }
  __syncthreads();
  if constexpr (WORKSPACE) return;
  {
    const unsigned key = site_key(p.seed, SITE_FF_OUT);
    tile_gemm<T, QROWS, true>(big, lay.ldb, p.w2, F, D, F, wscr, warp, lane, nullptr,
                              [&](int r, int n, float v) {
                                float f = v + to_f(p.b2[n]);
                                if (drop)
                                  f = keep_elem(key, (unsigned)(tile_row0 + r), n, p.thr) ? f * p.kp
                                                                                         : 0.f;
                                xres[r * D + n] += f;
                                return 0.f;
                              });
  }
  __syncthreads();
  T* out = p.out + tile_row0 * D;
  for (int e = threadIdx.x * 2; e < nq * D; e += NTHREADS * 2) store2(out + e, xres[e], xres[e + 1]);
}

// Both launches on `stream`; qkv [B*S][3D] of the activation type; the
// second at the head dim D / H (8, 16 or 32; any other is refused).
template <class T, int ROWS, int QROWS, bool TRAIN, int MODE = FWD_SAVE>
int launch_forward(LayerParams<T> p, T* qkv, cudaStream_t stream) {
  if (!narrow_head_dim(p.D, p.H)) return (int)cudaErrorInvalidValue;
  const size_t smem1 = qkv_smem<T, ROWS>(p.D);
  cudaError_t err = cudaFuncSetAttribute(qkv_kernel<T, ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)p.B * p.S;
  qkv_kernel<T, ROWS><<<(unsigned)((rows + ROWS - 1) / ROWS), NTHREADS, smem1, stream>>>(p, qkv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)p.B * ((p.S + QROWS - 1) / QROWS);
  return with_head_dim(p.D, p.H, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    const size_t smem2 = LongLayout<T, QROWS, HD>(p.S, p.D, p.F).total;
    cudaError_t e2 = cudaFuncSetAttribute(attn_ffn_kernel<T, QROWS, HD, TRAIN, MODE>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)smem2);
    if (e2 != cudaSuccess) return (int)e2;
    attn_ffn_kernel<T, QROWS, HD, TRAIN, MODE><<<blocks, NTHREADS, smem2, stream>>>(p, qkv);
    return (int)cudaGetLastError();
  });
}

}  // namespace
}  // namespace layer_long
