// K10 and K11: the attention block alone (see ops/attention.py and
// ops/attention_vjp.py): out = softmax(Q K^T / sqrt(hd) + mask) V Wo^T + bo
// with QKV = x Wqkv^T + bqkv, per head, optional causality, no LayerNorm,
// residual or FF. bf16 operands, or float operands multiplied in TF32 (wmma
// 16x16x8); f32 sums, softmax and bias adds.
//
// At D = 256 with 8 heads both directions run the Hopper forms: the forward
// layer_long.cu's (bfloat16: mha_short_kernel for S <= 32, mha_qkv_kernel +
// mha_long_attn_kernel + mha_out_kernel above) and layer_f32.cu's (float32:
// mha_qkv_kernel, K4's train_attn_kernel, mha_out_kernel); the backward
// those forward launches in save mode, K4's saved-mode attention backward
// and the wgmma row and weight products (layer_bwd.cu: dsvg_mha_bwd_bf16;
// layer_f32_bwd.cu: dsvg_mha_bwd_f32). This file keeps the first port's
// forward and backward for the other widths (D <= 256 with head dim 8, 16
// or 32, a template parameter picked from D / H at the entry points; heads
// below 16 columns padded with zero columns to a tensor-core tile in shared
// memory), counted under narrow_launches.
//
// Forward at the other widths (K10, and K11's forward with dropout on the
// probabilities), two launches:
//   mha_qkv_kernel: QKV + bias over row tiles (64 rows, 32 for float) of all
//       B*S rows, rounded to T into a scratch tensor [B*S][3D];
//   mha_attn_kernel: one (sequence, query tile) per block, the long layer's
//       attention (layer_long.cuh: attend_tile; K/V of the sequence in shared
//       memory, exact softmax per row, probabilities rounded to T) into the
//       tile's context, then the output projection of the tile's rows.
// Backward (K11) at the other widths, three launches here, then wgrad.cu and
// the reductions (ops/attention_vjp.py); nothing of the forward is saved but
// its inputs:
//   mha_bwd_rows_kernel: per row tile, the QKV recompute and dctx = g Wo
//       (rounded), and the column sums of g (dbo);
//   mha_attn_bwd_kernel: one (sequence, head) per block, Q, K and V of the
//       head in shared memory; per tile of queries the scores and the
//       probabilities recomputed (expf, summed in this kernel's order), dPe =
//       dctx V^T, the softmax backward with the dropout mask, ds rounded;
//       the context Pe V (for dWo), dQ = ds K written, dK += ds^T Q and dV
//       += Pe^T dctx held in tensor-core accumulators over the query tiles
//       in order;
//   mha_dx_kernel: per row tile, dx = dqkv Wqkv (rounded) and the column sums
//       of dqkv (dbqkv).
// No atomics: reruns are bit-equal.
#include "layer_long.cuh"

using namespace nvcuda;

namespace {

using layer_long::HPAD;
using layer_long::LongLayout;
using layer_long::MAX_SEQ_LONG;
using layer_long::attend_tile;
using layer_long::load_head;
using layer_long::round16;

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) / 128 * 128; }

template <class T>
struct MhaParams {
  const T *x, *wqkv, *bqkv, *wo, *bo;
  const float* mask;  // [B][S] additive
  T* out;
  int B, S, D, H, causal, seed;
  unsigned thr;
  float kp, scale;
};

// the backward's tensors, in the order of the wrapper's pointer array
template <class T>
struct MhaBwdParams {
  const T *x, *g, *wqkv, *bqkv, *wo;
  const float* mask;
  T *qkv, *dctx, *dqkv, *ctx, *dx;
  float* small_part;  // [row blocks of (a), then of (c)][4D]: dbqkv | dbo
  int B, S, D, H, causal, seed;
  unsigned thr;
  float kp, scale;
};

// rows of a row tile: 64 for bf16, 32 for float (twice the bytes a row)
template <class T>
struct Tile {
  static constexpr int ROWS = sizeof(T) == 2 ? 64 : 32;
};

// copy rows [row0, row0 + nrows) of a [*, n] tensor into dst [ROWS][ld]
// (16-byte vectors), zeros below them
template <class T, int ROWS>
__device__ __forceinline__ void stage(const T* src, size_t row0, int nrows, int n, T* dst,
                                      int ld) {
  constexpr int VEC = 16 / sizeof(T);
  const int vecs = n / VEC;
  for (int e = threadIdx.x; e < ROWS * vecs; e += NTHREADS) {
    const int r = e / vecs, c = (e - r * vecs) * VEC;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < nrows) v = *reinterpret_cast<const uint4*>(src + (row0 + r) * n + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

__device__ __forceinline__ int tile_rows(int B, int S, size_t row0, int rows) {
  const long long left = (long long)B * S - (long long)row0;
  return left < rows ? (int)left : rows;
}

// ---- forward
template <class T, int ROWS>
__global__ void __launch_bounds__(NTHREADS) mha_qkv_kernel(MhaParams<T> p, T* qkv) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, ldn = D + SPAD;
  T* xs = reinterpret_cast<T*>(smem);
  float* scratch = reinterpret_cast<float*>(xs + ROWS * ldn);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row0 = (size_t)blockIdx.x * ROWS;
  const int nrows = tile_rows(p.B, p.S, row0, ROWS);
  stage<T, ROWS>(p.x, row0, nrows, D, xs, ldn);
  __syncthreads();
  tile_gemm<T, ROWS, true>(xs, ldn, p.wqkv, D, 3 * D, D, scratch + warp * 256, warp, lane,
                           nullptr, [&](int r, int n, float v) {
                             if (r < nrows)
                               qkv[(row0 + r) * 3 * D + n] = from_f<T>(v + to_f(p.bqkv[n]));
                             return 0.f;
                           });
}

template <class T, int QROWS, int HD>
__global__ void __launch_bounds__(NTHREADS) mha_attn_kernel(MhaParams<T> p, const T* qkv) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, S = p.S;
  const LongLayout<T, QROWS, HD> lay(S, D, 0);
  T* ctx = reinterpret_cast<T*>(smem + lay.ctx);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wscr = reinterpret_cast<float*>(smem + lay.scratch) + warp * 256;
  const int ntiles = (S + QROWS - 1) / QROWS;
  const int b = blockIdx.x / ntiles;
  const int q0 = (blockIdx.x - b * ntiles) * QROWS;
  const int nq = min(QROWS, S - q0);
  const size_t tile_row0 = (size_t)b * S + q0;

  attend_tile<T, QROWS, HD>(qkv, p.mask + (size_t)b * S, b, q0, nq, S, D, p.H, p.causal, p.scale,
                        lay, smem, ctx, wscr, warp, lane, p.thr != 0u, p.seed, p.thr, p.kp,
                        nullptr);
  tile_gemm<T, QROWS, true>(ctx, lay.ldn, p.wo, D, D, D, wscr, warp, lane, nullptr,
                            [&](int r, int n, float v) {
                              if (r < nq)
                                p.out[(tile_row0 + r) * D + n] = from_f<T>(v + to_f(p.bo[n]));
                              return 0.f;
                            });
}

template <class T>
int launch_forward(MhaParams<T> p, T* qkv, cudaStream_t stream) {
  constexpr int ROWS = Tile<T>::ROWS;
  if (!narrow_head_dim(p.D, p.H)) return (int)cudaErrorInvalidValue;
  const size_t smem1 = (size_t)ROWS * (p.D + SPAD) * sizeof(T) + NWARPS * 256 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mha_qkv_kernel<T, ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)p.B * p.S;
  mha_qkv_kernel<T, ROWS><<<(unsigned)((rows + ROWS - 1) / ROWS), NTHREADS, smem1, stream>>>(
      p, qkv);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)p.B * ((p.S + ROWS - 1) / ROWS);
  return with_head_dim(p.D, p.H, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    const size_t smem2 = LongLayout<T, ROWS, HD>(p.S, p.D, 0).total;
    cudaError_t e2 = cudaFuncSetAttribute(mha_attn_kernel<T, ROWS, HD>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)smem2);
    if (e2 != cudaSuccess) return (int)e2;
    mha_attn_kernel<T, ROWS, HD><<<blocks, NTHREADS, smem2, stream>>>(p, qkv);
    return (int)cudaGetLastError();
  });
}

// ---- backward (a): QKV recompute, dctx = g Wo, column sums of g
template <class T, int ROWS>
__global__ void __launch_bounds__(NTHREADS) mha_bwd_rows_kernel(MhaBwdParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, ldn = D + SPAD;
  T* xs = reinterpret_cast<T*>(smem);
  T* gs = xs + ROWS * ldn;
  float* scratch = reinterpret_cast<float*>(gs + ROWS * ldn);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wscr = scratch + warp * 256;
  const size_t row0 = (size_t)blockIdx.x * ROWS;
  const int nrows = tile_rows(p.B, p.S, row0, ROWS);
  stage<T, ROWS>(p.x, row0, nrows, D, xs, ldn);
  stage<T, ROWS>(p.g, row0, nrows, D, gs, ldn);
  __syncthreads();

  float* part = p.small_part + (size_t)blockIdx.x * 4 * D;
  for (int c = threadIdx.x; c < 4 * D; c += NTHREADS) {
    float s = 0.f;
    if (c >= 3 * D)
      for (int r = 0; r < nrows; ++r) s += to_f(gs[r * ldn + c - 3 * D]);
    part[c] = s;
  }
  tile_gemm<T, ROWS, true>(xs, ldn, p.wqkv, D, 3 * D, D, wscr, warp, lane, nullptr,
                           [&](int r, int n, float v) {
                             if (r < nrows)
                               p.qkv[(row0 + r) * 3 * D + n] = from_f<T>(v + to_f(p.bqkv[n]));
                             return 0.f;
                           });
  tile_gemm<T, ROWS, false>(gs, ldn, p.wo, D, D, D, wscr, warp, lane, nullptr,
                            [&](int r, int n, float v) {
                              if (r < nrows) p.dctx[(row0 + r) * D + n] = from_f<T>(v);
                              return 0.f;
                            });
}

// ---- backward (b): the attention of one (sequence, head) of HD columns,
// its slices padded with zeros to head_pad(HD)
template <class T, int QT, int HD>
struct AttnBwdLayout {
  int spad, qpad, ldh, lds, ldp;
  size_t q, k, v, dc, sc, dp, scratch, total;
  __host__ __device__ AttnBwdLayout(int S) {
    spad = round16(S);
    qpad = (S + QT - 1) / QT * QT;
    ldh = head_pad(HD) + HPAD;
    lds = spad + 8;                                  // f32 elements a row of scores / dPe
    ldp = lds * (int)(sizeof(float) / sizeof(T));    // T elements a row of Pe / dS (in place)
    q = 0;
    k = align128(q + (size_t)qpad * ldh * sizeof(T));
    v = align128(k + (size_t)spad * ldh * sizeof(T));
    dc = align128(v + (size_t)spad * ldh * sizeof(T));
    sc = align128(dc + (size_t)QT * ldh * sizeof(T));
    dp = align128(sc + (size_t)QT * lds * sizeof(float));
    scratch = align128(dp + (size_t)QT * lds * sizeof(float));
    total = scratch + (size_t)NWARPS * 256 * sizeof(float);
  }
};

template <class T, int QT, int HD>
__global__ void __launch_bounds__(NTHREADS) mha_attn_bwd_kernel(MhaBwdParams<T> p) {
  typedef Mma<T> M;
  constexpr int KD = (HD + M::K - 1) / M::K * M::K;   // the score products' depth
  constexpr int NC = head_pad(HD) / 16;               // 16-column tiles of a head
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, S = p.S, H = p.H;
  const AttnBwdLayout<T, QT, HD> lay(S);
  T* qs = reinterpret_cast<T*>(smem + lay.q);
  T* ks = reinterpret_cast<T*>(smem + lay.k);
  T* vs = reinterpret_cast<T*>(smem + lay.v);
  T* dcs = reinterpret_cast<T*>(smem + lay.dc);
  float* sc = reinterpret_cast<float*>(smem + lay.sc);
  T* pes = reinterpret_cast<T*>(sc);                 // dropped probabilities, rounded, in place
  float* dP = reinterpret_cast<float*>(smem + lay.dp);
  T* dS = reinterpret_cast<T*>(dP);                  // rounded dS, in place of dPe
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wscr = reinterpret_cast<float*>(smem + lay.scratch) + warp * 256;
  const int ldh = lay.ldh, lds = lay.lds, ldp = lay.ldp;
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const size_t seq_row0 = (size_t)b * S;
  const float* mask = p.mask + seq_row0;
  const bool drop = p.thr != 0u;
  const unsigned key_ap = site_key(p.seed, SITE_ATTN_PROB);
  const size_t ld3 = 3 * (size_t)D;

  load_head<HD>(p.qkv, seq_row0, S, lay.qpad, 3 * D, h * HD, qs, ldh);
  load_head<HD>(p.qkv, seq_row0, S, lay.spad, 3 * D, D + h * HD, ks, ldh);
  load_head<HD>(p.qkv, seq_row0, S, lay.spad, 3 * D, 2 * D + h * HD, vs, ldh);

  // dK and dV of key tiles warp and warp + 8, 16 columns a tile
  typename M::Acc dk[2][NC], dv[2][NC];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      wmma::fill_fragment(dk[a][c], 0.f);
      wmma::fill_fragment(dv[a][c], 0.f);
    }

  for (int q0 = 0; q0 < S; q0 += QT) {
    const int nq = min(QT, S - q0);
    const int kmax = p.causal ? q0 + nq : S;        // keys any query of the tile sees
    const int nk = round16(kmax);
    load_head<HD>(p.dctx, seq_row0 + q0, nq, QT, D, h * HD, dcs, ldh);
    __syncthreads();

    // scores [QT][nk] = Q K^T and dPe [QT][nk] = dctx V^T (f32)
    const int kt = nk / 16, tiles = (QT / 16) * kt;
    for (int t = warp; t < 2 * tiles; t += NWARPS) {
      const bool grad = t >= tiles;
      const int tt = grad ? t - tiles : t;
      const int i = tt / kt, j = tt - i * kt;
      const T* a_src = grad ? dcs + i * 16 * ldh : qs + (q0 + i * 16) * ldh;
      const T* b_src = (grad ? vs : ks) + j * 16 * ldh;
      typename M::Acc acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int k = 0; k < KD; k += M::K) {
        typename M::ARow a;
        typename M::BCol bk;
        wmma::load_matrix_sync(a, a_src + k, ldh);
        wmma::load_matrix_sync(bk, b_src + k, ldh);
        M::fix(a);
        M::fix(bk);
        wmma::mma_sync(acc, a, bk, acc);
      }
      wmma::store_matrix_sync((grad ? dP : sc) + i * 16 * lds + j * 16, acc, lds,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // per row: the forward's probabilities p (f32), the dropout factor km,
    // dp = dPe * km, dS = p (dp - sum_j dp p) and Pe = p * km, both rounded
    // to T, in place of dPe and of the scores
    for (int r = warp; r < QT; r += NWARPS) {
      const int qi = q0 + r;
      const int klim = r < nq ? (p.causal ? qi + 1 : S) : 0;
      const size_t prow = ((size_t)b * H + h) * S + qi;
      float pr[MAX_SEQ_LONG / 32], dp[MAX_SEQ_LONG / 32], km[MAX_SEQ_LONG / 32];
      float m = -INFINITY;
#pragma unroll
      for (int t = 0; t < MAX_SEQ_LONG / 32; ++t) {
        const int j = lane + 32 * t;
        pr[t] = j < klim ? sc[r * lds + j] * p.scale + mask[j] : -INFINITY;
        m = fmaxf(m, pr[t]);
      }
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < MAX_SEQ_LONG / 32; ++t) {
        pr[t] = m == -INFINITY ? 0.f : expf(pr[t] - m);
        sum += pr[t];
      }
      sum = warp_sum(sum);
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < MAX_SEQ_LONG / 32; ++t) {
        const int j = lane + 32 * t;
        pr[t] = m == -INFINITY ? 0.f : pr[t] / sum;
        km[t] = 1.f;
        if (drop && j < klim)
          km[t] = keep_elem(key_ap, (unsigned)prow, (unsigned)j, p.thr) ? p.kp : 0.f;
        dp[t] = j < nk ? dP[r * lds + j] * km[t] : 0.f;
        s += dp[t] * pr[t];
      }
      s = warp_sum(s);
      __syncwarp();  // every lane has read the row before it is overwritten
#pragma unroll
      for (int t = 0; t < MAX_SEQ_LONG / 32; ++t) {
        const int j = lane + 32 * t;
        if (j < nk) {
          dS[r * ldp + j] = from_f<T>(pr[t] * (dp[t] - s));
          pes[r * ldp + j] = from_f<T>(pr[t] * km[t]);
        }
      }
    }
    __syncthreads();

    // the context of the tile's rows, Pe V (rounded; the forward's, for dWo),
    // and dQ = dS K * scale (rounded), both written
    for (int t = warp; t < 2 * (QT / 16) * NC; t += NWARPS) {
      const bool grad = t >= (QT / 16) * NC;
      const int tt = grad ? t - (QT / 16) * NC : t;
      const int i = tt / NC, c = tt - i * NC;
      const T* a_src = (grad ? dS : pes) + i * 16 * ldp;
      const T* b_src = (grad ? ks : vs) + c * 16;
      typename M::Acc acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k = 0; k < nk; k += M::K) {
        typename M::ARow a;
        typename M::BRow bm;
        wmma::load_matrix_sync(a, a_src + k, ldp);
        wmma::load_matrix_sync(bm, b_src + k * ldh, ldh);
        M::fix(a);
        M::fix(bm);
        wmma::mma_sync(acc, a, bm, acc);
      }
      wmma::store_matrix_sync(wscr, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = i * 16 + e / 16;
        if (r < nq && c * 16 + e % 16 < HD) {
          const size_t row = seq_row0 + q0 + r;
          const int col = h * HD + c * 16 + e % 16;
          if (grad)
            p.dqkv[row * ld3 + col] = from_f<T>(wscr[e] * p.scale);
          else
            p.ctx[row * D + col] = from_f<T>(wscr[e]);
        }
      }
      __syncwarp();
    }

    // dV += Pe^T dctx, dK += dS^T Q (this tile's query rows), per key tile
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int kt16 = (warp + NWARPS * a) * 16;
      if (kt16 >= nk) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        for (int k = 0; k < QT; k += M::K) {
          typename M::ACol pa, sa;
          typename M::BRow db, qb;
          wmma::load_matrix_sync(pa, pes + k * ldp + kt16, ldp);
          wmma::load_matrix_sync(db, dcs + k * ldh + c * 16, ldh);
          wmma::load_matrix_sync(sa, dS + k * ldp + kt16, ldp);
          wmma::load_matrix_sync(qb, qs + (q0 + k) * ldh + c * 16, ldh);
          M::fix(pa);
          M::fix(db);
          M::fix(sa);
          M::fix(qb);
          wmma::mma_sync(dv[a][c], pa, db, dv[a][c]);
          wmma::mma_sync(dk[a][c], sa, qb, dk[a][c]);
        }
      }
    }
    __syncthreads();  // before the next tile overwrites dctx, the scores and dPe
  }

  // dK (scaled) and dV of the warp's key tiles, rounded, written
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int kt16 = (warp + NWARPS * a) * 16;
    if (kt16 >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        if (which)
          wmma::store_matrix_sync(wscr, dv[a][c], 16, wmma::mem_row_major);
        else
          wmma::store_matrix_sync(wscr, dk[a][c], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int key = kt16 + e / 16;
          if (key < S && c * 16 + e % 16 < HD)
            p.dqkv[(seq_row0 + key) * ld3 + (which ? 2 : 1) * D + h * HD + c * 16 +
                   e % 16] = from_f<T>(which ? wscr[e] : wscr[e] * p.scale);
        }
        __syncwarp();
      }
    }
  }
}

// ---- backward (c): dx = dqkv Wqkv and the column sums of dqkv
template <class T, int ROWS>
__global__ void __launch_bounds__(NTHREADS) mha_dx_kernel(MhaBwdParams<T> p, float* part) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, ldb = 3 * D + SPAD;
  T* big = reinterpret_cast<T*>(smem);
  float* scratch = reinterpret_cast<float*>(big + ROWS * ldb);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row0 = (size_t)blockIdx.x * ROWS;
  const int nrows = tile_rows(p.B, p.S, row0, ROWS);
  stage<T, ROWS>(p.dqkv, row0, nrows, 3 * D, big, ldb);
  __syncthreads();

  part += (size_t)blockIdx.x * 4 * D;
  for (int c = threadIdx.x; c < 4 * D; c += NTHREADS) {
    float s = 0.f;
    if (c < 3 * D)
      for (int r = 0; r < nrows; ++r) s += to_f(big[r * ldb + c]);
    part[c] = s;
  }
  tile_gemm<T, ROWS, false>(big, ldb, p.wqkv, D, D, 3 * D, scratch + warp * 256, warp, lane,
                            nullptr, [&](int r, int n, float v) {
                              if (r < nrows) p.dx[(row0 + r) * D + n] = from_f<T>(v);
                              return 0.f;
                            });
}

template <class T>
int launch_backward(MhaBwdParams<T> p, cudaStream_t stream) {
  constexpr int ROWS = Tile<T>::ROWS;
  if (!narrow_head_dim(p.D, p.H)) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)p.B * p.S;
  const unsigned row_blocks = (unsigned)((rows + ROWS - 1) / ROWS);
  size_t smem = 2 * (size_t)ROWS * (p.D + SPAD) * sizeof(T) + NWARPS * 256 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mha_bwd_rows_kernel<T, ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mha_bwd_rows_kernel<T, ROWS><<<row_blocks, NTHREADS, smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int rc = with_head_dim(p.D, p.H, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    const size_t smem_b = AttnBwdLayout<T, ROWS, HD>(p.S).total;
    cudaError_t e = cudaFuncSetAttribute(mha_attn_bwd_kernel<T, ROWS, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_b);
    if (e != cudaSuccess) return (int)e;
    mha_attn_bwd_kernel<T, ROWS, HD><<<(unsigned)(p.B * p.H), NTHREADS, smem_b, stream>>>(p);
    return (int)cudaGetLastError();
  });
  if (rc != 0) return rc;

  smem = (size_t)ROWS * (3 * p.D + SPAD) * sizeof(T) + NWARPS * 256 * sizeof(float);
  err = cudaFuncSetAttribute(mha_dx_kernel<T, ROWS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // (c) writes its column sums after (a)'s rows
  mha_dx_kernel<T, ROWS><<<row_blocks, NTHREADS, smem, stream>>>(
      p, p.small_part + (size_t)row_blocks * 4 * p.D);
  return (int)cudaGetLastError();
}

template <class T>
MhaParams<T> forward_params(void* const* t, int B, int S, int D, int H, int causal, int seed,
                            int thr, float kp, float scale) {
  MhaParams<T> p;
  p.x = (const T*)t[0];
  p.wqkv = (const T*)t[1];
  p.bqkv = (const T*)t[2];
  p.wo = (const T*)t[3];
  p.bo = (const T*)t[4];
  p.mask = (const float*)t[5];
  p.out = (T*)t[6];
  p.B = B;
  p.S = S;
  p.D = D;
  p.H = H;
  p.causal = causal;
  p.seed = seed;
  p.thr = (unsigned)thr;
  p.kp = kp;
  p.scale = scale;
  return p;
}

template <class T>
MhaBwdParams<T> backward_params(void* const* t, int B, int S, int D, int H, int causal,
                                int seed, int thr, float kp, float scale) {
  MhaBwdParams<T> p;
  p.x = (const T*)t[0];
  p.g = (const T*)t[1];
  p.wqkv = (const T*)t[2];
  p.bqkv = (const T*)t[3];
  p.wo = (const T*)t[4];
  p.mask = (const float*)t[5];
  p.qkv = (T*)t[6];
  p.dctx = (T*)t[7];
  p.dqkv = (T*)t[8];
  p.ctx = (T*)t[9];
  p.dx = (T*)t[10];
  p.small_part = (float*)t[11];
  p.B = B;
  p.S = S;
  p.D = D;
  p.H = H;
  p.causal = causal;
  p.seed = seed;
  p.thr = (unsigned)thr;
  p.kp = kp;
  p.scale = scale;
  return p;
}

}  // namespace

// Rows of a row tile of the backward's first and third launches (the
// wrapper sizes the per-block column sums with it).
extern "C" int dsvg_mha_rows(int is_f32) { return is_f32 ? Tile<float>::ROWS : Tile<bf16>::ROWS; }

// Forward of K10 (thr 0) and K11 at the widths the Hopper forms do not take.
// `tensors`: x [B*S][D], wqkv [3D][D], bqkv [3D], wo [D][D], bo [D], mask
// [B][S] (f32), out [B*S][D], and the scratch qkv [B*S][3D]; all of the
// activation type (bf16, or float with is_f32) but the mask. 1 <= S <= 256,
// D <= 256 with head dim D / H 8, 16 or 32.
extern "C" int dsvg_mha_fwd(void* const* tensors, int B, int S, int D, int H, int causal,
                            int is_f32, int seed, int thr, float kp, float scale,
                            void* stream) {
  if (S < 1 || S > MAX_SEQ_LONG || !narrow_head_dim(D, H) || D > 256)
    return (int)cudaErrorInvalidValue;
  if (is_f32)
    return launch_forward<float>(
        forward_params<float>(tensors, B, S, D, H, causal, seed, thr, kp, scale),
        (float*)tensors[7], (cudaStream_t)stream);
  return launch_forward<bf16>(
      forward_params<bf16>(tensors, B, S, D, H, causal, seed, thr, kp, scale),
      (bf16*)tensors[7], (cudaStream_t)stream);
}

// Backward of K11, launches (a)-(c). `tensors`: x, g [B*S][D], wqkv, bqkv,
// wo, mask, then the outputs: qkv [B*S][3D] (scratch), dctx [B*S][D]
// (scratch), dqkv [rows][3D], ctx [rows][D] (the recomputed context), dx
// [B*S][D], and the column sums [2 row blocks][4D] (f32).
extern "C" int dsvg_mha_bwd(void* const* tensors, int B, int S, int D, int H, int causal,
                            int is_f32, int seed, int thr, float kp, float scale, void* stream) {
  if (S < 1 || S > MAX_SEQ_LONG || !narrow_head_dim(D, H) || D > 256)
    return (int)cudaErrorInvalidValue;
  if (is_f32)
    return launch_backward<float>(
        backward_params<float>(tensors, B, S, D, H, causal, seed, thr, kp, scale),
        (cudaStream_t)stream);
  return launch_backward<bf16>(
      backward_params<bf16>(tensors, B, S, D, H, causal, seed, thr, kp, scale),
      (cudaStream_t)stream);
}
