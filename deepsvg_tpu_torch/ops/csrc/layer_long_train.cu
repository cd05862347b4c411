// K4, long form (see ops/layer_vjp.py): the training layer over sequences of
// 17 to 256 rows (float activations) or 33 to 256 (bf16), which a block
// cannot hold whole, at the widths its Hopper kernels do not take (those:
// layer_long.cu's and layer_f32.cu's training launches forward,
// layer_bwd.cu's and layer_f32_bwd.cu's backward). The older wmma design:
//
// Forward: the long K2's two launches (layer_long.cuh) with the training
// switch: dropout at the four sites and the saved tensors (QKV, the
// probabilities before dropout [B][H][S][S], the context, the f32 residual
// after the attention block, the FF hidden before dropout).
//
// Backward: the short form's walk (layer_bwd.cuh) split where a row needs
// other rows, in three launches, then the short form's wgrad.cu and
// dsvg_reduce_partials:
//   (a) ffn_bwd_kernel, row tiles of all B*S rows: df -> dhpre -> dxn2 ->
//       LN2 backward -> dx1 (kept in f32 for (b) and (c)) -> da -> dctx;
//   (b) attn_bwd_kernel, one (sequence, head) per block: K, V and Q of the
//       head stay in shared memory; per tile of queries, dP = dctx V^T, the
//       softmax backward with the probabilities' dropout mask, dQ = dS K
//       (written), and dK += dS^T Q, dV += Pe^T dctx kept in tensor-core
//       accumulators over the query tiles in order; the block of head 0 also
//       sums dx1 over the sequence (dseq_bias);
//   (c) qkv_bwd_kernel, row tiles: dxn1 = dqkv Wqkv -> LN1 backward -> dx.
// (a) and (c) write the rounded operands of the four weight products and one
// row each of per-block column sums (bias and LayerNorm gradients), as the
// short form does. No atomics: the gradients are bit-identical from run to
// run. The roundings are the short form's: df, dhpre, da, dctx, ds and dqkv
// are rounded to the activation type before their products.
//
// Recompute mode (RECOMPUTE; the forward wrote `out` alone, its QKV scratch
// freed on return): two launches first fill a workspace of this layer alone,
// the forward's qkv_kernel (QKV) and attn_ffn_kernel with FWD_WORKSPACE (the
// context, x1 and the FF hidden before dropout in f32; no [B][H][S][S]
// buffer). Then (a) takes the f32 hidden for the ReLU gate and the dropped
// hidden, and (b) recomputes each query tile's scores Q K^T and the
// probabilities from Q and K in shared memory, in f32 and bit for bit the
// forward's (as K11's backward does, attention.cu), where the saved mode
// reads them rounded to T.
#include "layer_bwd.cuh"
#include "layer_long.cuh"

using namespace nvcuda;

namespace {

using layer_bwd::BwdParams;
using layer_bwd::SmallOff;
using layer_bwd::reduce_warp_columns;
using layer_long::HPAD;
using layer_long::MAX_SEQ_LONG;
using layer_long::load_head;
using layer_long::round16;

constexpr int BWD_ROWS = 32;   // rows of a tile of (a) and (c)

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// ---- (a): FF, LN2 and out-projection backward on one row tile
template <class T>
size_t ffn_smem(int D, int F) {
  return (size_t)BWD_ROWS * D * sizeof(float) + (size_t)BWD_ROWS * (D + SPAD) * sizeof(T) +
         (size_t)BWD_ROWS * (F + SPAD) * sizeof(T) + (size_t)NWARPS * 256 * sizeof(float) +
         (size_t)(9 * D + F) * sizeof(float);
}

template <class T, bool RECOMPUTE>
__global__ void __launch_bounds__(NTHREADS)
    ffn_bwd_kernel(BwdParams<T> p, T* dctx, float* dx1) {
  constexpr int ROWS = BWD_ROWS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, F = p.F;
  const int ldn = D + SPAD, ldb = F + SPAD;
  const SmallOff off(D, F);
  float* Z = reinterpret_cast<float*>(smem);        // dxn2
  T* S1 = reinterpret_cast<T*>(Z + ROWS * D);       // df, then da
  T* big = S1 + ROWS * ldn;                         // dhpre
  float* scratch = reinterpret_cast<float*>(big + ROWS * ldb);
  float* colsum = scratch + NWARPS * 256;
  float* stage = reinterpret_cast<float*>(big);     // when big is free

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wscr = scratch + warp * 256;
  const size_t row0 = (size_t)blockIdx.x * ROWS;
  const long long left = (long long)p.B * p.S - (long long)row0;
  const int nrows = left < ROWS ? (int)left : ROWS;
  const bool drop = p.thr != 0u;
  const unsigned key_ao = site_key(p.seed, SITE_ATTN_OUT);
  const unsigned key_fh = site_key(p.seed, SITE_FF_HIDDEN);
  const unsigned key_fo = site_key(p.seed, SITE_FF_OUT);
  // the FF hidden before dropout: saved rounded to T, or recomputed in f32
  auto hidden = [&](size_t i) -> float {
    if constexpr (RECOMPUTE) return p.h32[i];
    else return to_f(p.h_s[i]);
  };

  for (int e = threadIdx.x; e < off.total; e += NTHREADS) colsum[e] = 0.f;
  __syncthreads();

  // 1a. xn2 = LN2(x1) for the dW1 product (one warp per row)
  for (int r = warp; r < nrows; r += NWARPS) {
    const size_t row = row0 + r;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = lane + 32 * j;
      v[j] = c < D ? p.x1_s[row * D + c] : 0.f;
    }
    float mu, rstd;
    row_stats(v, D, lane, mu, rstd);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = lane + 32 * j;
      if (c < D)
        p.xn2_o[row * D + c] =
            from_f<T>((v[j] - mu) * rstd * to_f(p.ln2[c]) + to_f(p.ln2[D + c]));
    }
  }
  // 1b. the dropped FF hidden for the dW2 product
  for (int e = threadIdx.x; e < nrows * F; e += NTHREADS) {
    const int r = e / F, n = e - r * F;
    float h = hidden(row0 * F + e);
    if (drop) h = keep_elem(key_fh, (unsigned)(row0 + r), n, p.thr) ? h * p.kp : 0.f;
    p.hd_o[row0 * F + e] = from_f<T>(h);
  }
  // 1c. df = g * mask; db2 = column sums of df (one thread per column)
  for (int c = threadIdx.x; c < D; c += NTHREADS) {
    float s = 0.f;
    for (int r = 0; r < ROWS; ++r) {
      float df = 0.f;
      if (r < nrows) {
        df = to_f(p.g[(row0 + r) * D + c]);
        if (drop) df = keep_elem(key_fo, (unsigned)(row0 + r), c, p.thr) ? df * p.kp : 0.f;
        p.df_o[(row0 + r) * D + c] = from_f<T>(df);
      }
      S1[r * ldn + c] = from_f<T>(df);
      s += df;
    }
    colsum[off.db2 + c] = s;
  }
  __syncthreads();

  // 2. dhd = df @ W2; dhpre = relu'(h) * mask * dhd, rounded; db1
  tile_gemm<T, ROWS, false, true>(S1, ldn, p.w2, F, F, D, wscr, warp, lane, colsum + off.db1,
                                  [&](int r, int n, float v) {
                                    float dh = 0.f;
                                    if (r < nrows) {
                                      const size_t row = row0 + r;
                                      if (hidden(row * F + n) > 0.f) {
                                        dh = v;
                                        if (drop)
                                          dh = keep_elem(key_fh, (unsigned)row, n, p.thr)
                                                   ? dh * p.kp
                                                   : 0.f;
                                      }
                                      p.dhpre_o[row * F + n] = from_f<T>(dh);
                                    }
                                    big[r * ldb + n] = from_f<T>(dh);
                                    return dh;
                                  });
  __syncthreads();

  // 3. dxn2 = dhpre @ W1
  tile_gemm<T, ROWS, false>(big, ldb, p.w1, D, D, F, wscr, warp, lane, nullptr,
                            [&](int r, int n, float v) {
                              Z[r * D + n] = v;
                              return 0.f;
                            });
  __syncthreads();

  // 4. LN2 backward, dx1 = g + ..., da = dx1 * mask (one warp per row)
  {
    float acc[3][8];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[k][j] = 0.f;
    for (int r = warp; r < ROWS; r += NWARPS) {
      if (r >= nrows) {
        for (int c = lane; c < D; c += 32) S1[r * ldn + c] = from_f<T>(0.f);
        continue;
      }
      const size_t row = row0 + r;
      float v[8], dxh[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = lane + 32 * j;
        v[j] = c < D ? p.x1_s[row * D + c] : 0.f;
      }
      float mu, rstd;
      row_stats(v, D, lane, mu, rstd);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = lane + 32 * j;
        if (c < D) {
          const float xh = (v[j] - mu) * rstd, dy = Z[r * D + c];
          v[j] = xh;
          dxh[j] = dy * to_f(p.ln2[c]);
          s1 += dxh[j];
          s2 += dxh[j] * xh;
          acc[0][j] += dy * xh;
          acc[1][j] += dy;
        }
      }
      const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = lane + 32 * j;
        if (c < D) {
          const float d1 = to_f(p.g[row * D + c]) + rstd * (dxh[j] - m1 - v[j] * m2);
          dx1[row * D + c] = d1;
          float da = d1;
          if (drop) da = keep_elem(key_ao, (unsigned)row, c, p.thr) ? da * p.kp : 0.f;
          acc[2][j] += da;
          const T da_t = from_f<T>(da);
          S1[r * ldn + c] = da_t;
          p.da_o[row * D + c] = da_t;
        }
      }
    }
    __syncthreads();  // big (the stage) is no longer read by step 3
    const int dst[3] = {off.dln2_s, off.dln2_b, off.dbo};
    reduce_warp_columns<3>(acc, stage, D, colsum, dst, warp, lane);
  }

  // 5. dctx = da @ Wo, rounded
  tile_gemm<T, ROWS, false>(S1, ldn, p.wo, D, D, D, wscr, warp, lane, nullptr,
                            [&](int r, int n, float v) {
                              if (r < nrows) dctx[(row0 + r) * D + n] = from_f<T>(v);
                              return 0.f;
                            });

  // 6. this block's column sums
  __syncthreads();
  for (int e = threadIdx.x; e < off.total; e += NTHREADS)
    p.small_part[(size_t)blockIdx.x * p.small_stride + e] = colsum[e];
}

// ---- (b): attention backward of one (sequence, head) of HD columns (8, 16
// or 32), its Q, K, V and dctx slices padded with zeros to head_pad(HD)
// RECOMPUTE: `pe` holds the f32 scores, then the rounded dropped
// probabilities in their place (rows of ldp elements)
template <class T, int QT, int HD, bool RECOMPUTE>
struct AttnBwdLayout {
  int spad, qpad, ldh, lds, ldp;
  size_t q, k, v, dc, dp, pe, scratch, total;
  __host__ __device__ AttnBwdLayout(int S) {
    spad = round16(S);
    qpad = (S + QT - 1) / QT * QT;
    ldh = head_pad(HD) + HPAD;
    lds = spad + 8;                                  // f32 elements a row of dP
    ldp = lds * (int)(sizeof(float) / sizeof(T));    // T elements a row of dS (in place)
    q = 0;
    k = align128(q + (size_t)qpad * ldh * sizeof(T));
    v = align128(k + (size_t)spad * ldh * sizeof(T));
    dc = align128(v + (size_t)spad * ldh * sizeof(T));
    dp = align128(dc + (size_t)QT * ldh * sizeof(T));
    pe = align128(dp + (size_t)QT * lds * sizeof(float));
    scratch = align128(pe + (size_t)QT * lds * (RECOMPUTE ? sizeof(float) : sizeof(T)));
    total = scratch + (size_t)NWARPS * 256 * sizeof(float);
  }
};

template <class T, int QT, int HD, bool RECOMPUTE>
__global__ void __launch_bounds__(NTHREADS)
    attn_bwd_kernel(BwdParams<T> p, const T* dctx, const float* dx1, int causal) {
  typedef Mma<T> M;
  constexpr int KD = (HD + M::K - 1) / M::K * M::K;   // the score products' depth
  constexpr int NC = head_pad(HD) / 16;               // 16-column tiles of a head
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, S = p.S, H = p.H;
  const AttnBwdLayout<T, QT, HD, RECOMPUTE> lay(S);
  T* qs = reinterpret_cast<T*>(smem + lay.q);
  T* ks = reinterpret_cast<T*>(smem + lay.k);
  T* vs = reinterpret_cast<T*>(smem + lay.v);
  T* dcs = reinterpret_cast<T*>(smem + lay.dc);
  float* dP = reinterpret_cast<float*>(smem + lay.dp);
  T* dS = reinterpret_cast<T*>(dP);                  // rounded dS, in place of dP
  T* pes = reinterpret_cast<T*>(smem + lay.pe);      // dropped probabilities, rounded
  float* sc = reinterpret_cast<float*>(smem + lay.pe);  // RECOMPUTE: the scores first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wscr = reinterpret_cast<float*>(smem + lay.scratch) + warp * 256;
  const int ldh = lay.ldh, lds = lay.lds, ldp = lay.ldp;
  const int ldpe = RECOMPUTE ? ldp : lds;             // T elements a row of Pe
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const size_t seq_row0 = (size_t)b * S;
  const float* mask = RECOMPUTE ? p.mask + seq_row0 : nullptr;
  const bool drop = p.thr != 0u;
  const unsigned key_ap = site_key(p.seed, SITE_ATTN_PROB);
  const size_t ld3 = 3 * (size_t)D;

  // dseq_bias = dx1 summed over the sequence, in row order
  if (h == 0) {
    for (int c = threadIdx.x; c < D; c += NTHREADS) {
      float s = 0.f;
      for (int i = 0; i < S; ++i) s += dx1[(seq_row0 + i) * D + c];
      p.dbias[(size_t)b * D + c] = s;
    }
  }

  load_head<HD>(p.qkv_s, seq_row0, S, lay.qpad, 3 * D, h * HD, qs, ldh);
  load_head<HD>(p.qkv_s, seq_row0, S, lay.spad, 3 * D, D + h * HD, ks, ldh);
  load_head<HD>(p.qkv_s, seq_row0, S, lay.spad, 3 * D, 2 * D + h * HD, vs, ldh);

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
    const int kmax = causal ? q0 + nq : S;          // keys any query of the tile sees
    const int nk = round16(kmax);
    load_head<HD>(dctx, seq_row0 + q0, nq, QT, D, h * HD, dcs, ldh);
    __syncthreads();

    // dPe [QT][nk] = dctx V^T (f32), the gradient of the dropped
    // probabilities; RECOMPUTE: and the scores [QT][nk] = Q K^T (f32)
    const int kt = nk / 16, tiles = (QT / 16) * kt;
    for (int t = warp; t < (RECOMPUTE ? 2 : 1) * tiles; t += NWARPS) {
      const bool scores = t >= tiles;
      const int tt = scores ? t - tiles : t;
      const int i = tt / kt, j = tt - i * kt;
      const T* a_src = scores ? qs + (q0 + i * 16) * ldh : dcs + i * 16 * ldh;
      const T* b_src = (scores ? ks : vs) + j * 16 * ldh;
      typename M::Acc acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int k = 0; k < KD; k += M::K) {
        typename M::ARow a;
        typename M::BCol bv;
        wmma::load_matrix_sync(a, a_src + k, ldh);
        wmma::load_matrix_sync(bv, b_src + k, ldh);
        M::fix(a);
        M::fix(bv);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync((scores ? sc : dP) + i * 16 * lds + j * 16, acc, lds,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // softmax backward of each row: dp = dPe * km, dS = p (dp - sum_j dp p),
    // Pe = p * km, both rounded to T (dS in place of dPe)
    for (int r = warp; r < QT; r += NWARPS) {
      const int qi = q0 + r;
      const int klim = r < nq ? (causal ? qi + 1 : S) : 0;
      const size_t prow = ((size_t)b * H + h) * S + qi;
      float pr[MAX_SEQ_LONG / 32], dp[MAX_SEQ_LONG / 32], km[MAX_SEQ_LONG / 32];
      if constexpr (RECOMPUTE) {
        // the forward's probabilities in f32, as layer_long::attend_tile
        // forms them from the same scores
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
#pragma unroll
        for (int t = 0; t < MAX_SEQ_LONG / 32; ++t) pr[t] = m == -INFINITY ? 0.f : pr[t] / sum;
      }
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < MAX_SEQ_LONG / 32; ++t) {
        const int j = lane + 32 * t;
        if constexpr (!RECOMPUTE) pr[t] = j < klim ? to_f(p.p_s[prow * S + j]) : 0.f;
        km[t] = 1.f;
        if (drop && j < klim) km[t] = keep_elem(key_ap, (unsigned)prow, (unsigned)j, p.thr) ? p.kp : 0.f;
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
          pes[r * ldpe + j] = from_f<T>(pr[t] * km[t]);
        }
      }
    }
    __syncthreads();

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
          wmma::load_matrix_sync(pa, pes + k * ldpe + kt16, ldpe);
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

    // dQ [QT][HD] = dS K * scale, rounded, written
    for (int t = warp; t < (QT / 16) * NC; t += NWARPS) {
      const int i = t / NC, c = t - i * NC;
      typename M::Acc acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k = 0; k < nk; k += M::K) {
        typename M::ARow a;
        typename M::BRow bk;
        wmma::load_matrix_sync(a, dS + i * 16 * ldp + k, ldp);
        wmma::load_matrix_sync(bk, ks + k * ldh + c * 16, ldh);
        M::fix(a);
        M::fix(bk);
        wmma::mma_sync(acc, a, bk, acc);
      }
      wmma::store_matrix_sync(wscr, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = i * 16 + e / 16;
        if (r < nq && c * 16 + e % 16 < HD)
          p.dqkv_o[(seq_row0 + q0 + r) * ld3 + h * HD + c * 16 + e % 16] =
              from_f<T>(wscr[e] * p.scale);
      }
      __syncwarp();
    }
    __syncthreads();  // before the next tile overwrites dctx, dP and Pe
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
            p.dqkv_o[(seq_row0 + key) * ld3 + (which ? 2 : 1) * D + h * HD + c * 16 +
                     e % 16] = from_f<T>(which ? wscr[e] : wscr[e] * p.scale);
        }
        __syncwarp();
      }
    }
  }
}

// ---- (c): QKV and LN1 backward on one row tile
template <class T>
size_t qkv_bwd_smem(int D, int F) {
  return (size_t)BWD_ROWS * (3 * D + SPAD) * sizeof(T) + (size_t)BWD_ROWS * D * sizeof(float) +
         (size_t)NWARPS * 256 * sizeof(float) + (size_t)(9 * D + F) * sizeof(float);
}

template <class T>
__global__ void __launch_bounds__(NTHREADS) qkv_bwd_kernel(BwdParams<T> p, const float* dx1) {
  constexpr int ROWS = BWD_ROWS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, F = p.F;
  const int ldb = 3 * D + SPAD;
  const SmallOff off(D, F);
  T* big = reinterpret_cast<T*>(smem);              // dqkv
  float* Z = reinterpret_cast<float*>(big + ROWS * ldb);   // dxn1
  float* scratch = Z + ROWS * D;
  float* colsum = scratch + NWARPS * 256;
  float* stage = reinterpret_cast<float*>(big);     // when big is free

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wscr = scratch + warp * 256;
  const size_t row0 = (size_t)blockIdx.x * ROWS;
  const long long left = (long long)p.B * p.S - (long long)row0;
  const int nrows = left < ROWS ? (int)left : ROWS;

  for (int e = threadIdx.x; e < off.total; e += NTHREADS) colsum[e] = 0.f;
  for (int e = threadIdx.x; e < ROWS * 3 * D; e += NTHREADS) {
    const int r = e / (3 * D), n = e - r * 3 * D;
    big[r * ldb + n] = r < nrows ? p.dqkv_o[(row0 + r) * 3 * D + n] : from_f<T>(0.f);
  }
  __syncthreads();

  // dbqkv = column sums of the rounded dqkv; dxn1 = dqkv @ Wqkv
  for (int n = threadIdx.x; n < 3 * D; n += NTHREADS) {
    float s = 0.f;
    for (int r = 0; r < nrows; ++r) s += to_f(big[r * ldb + n]);
    colsum[off.dbqkv + n] = s;
  }
  tile_gemm<T, ROWS, false>(big, ldb, p.wqkv, D, D, 3 * D, wscr, warp, lane, nullptr,
                            [&](int r, int n, float v) {
                              Z[r * D + n] = v;
                              return 0.f;
                            });
  __syncthreads();

  // LN1 backward and dx (one warp per row); xn1 for the dWqkv product
  {
    float acc[2][8];
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[k][j] = 0.f;
    for (int r = warp; r < nrows; r += NWARPS) {
      const size_t row = row0 + r;
      float v[8], dxh[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = lane + 32 * j;
        v[j] = c < D ? to_f(p.x[row * D + c]) : 0.f;
      }
      float mu, rstd;
      row_stats(v, D, lane, mu, rstd);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = lane + 32 * j;
        if (c < D) {
          const float xh = (v[j] - mu) * rstd, dy = Z[r * D + c];
          const float sc = to_f(p.ln1[c]);
          p.xn1_o[row * D + c] = from_f<T>(xh * sc + to_f(p.ln1[D + c]));
          v[j] = xh;
          dxh[j] = dy * sc;
          s1 += dxh[j];
          s2 += dxh[j] * xh;
          acc[0][j] += dy * xh;
          acc[1][j] += dy;
        }
      }
      const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = lane + 32 * j;
        if (c < D)
          p.dx[row * D + c] = from_f<T>(dx1[row * D + c] + rstd * (dxh[j] - m1 - v[j] * m2));
      }
    }
    __syncthreads();  // big (the stage) is no longer read
    const int dst[2] = {off.dln1_s, off.dln1_b};
    reduce_warp_columns<2>(acc, stage, D, colsum, dst, warp, lane);
  }
  for (int e = threadIdx.x; e < off.total; e += NTHREADS)
    p.small_part[(size_t)blockIdx.x * p.small_stride + e] = colsum[e];
}

template <class T, int QT, bool RECOMPUTE = false>
int launch_backward(BwdParams<T> p, T* dctx, float* dx1, int causal, cudaStream_t stream) {
  if (!narrow_head_dim(p.D, p.H)) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)p.B * p.S;
  const unsigned row_blocks = (unsigned)((rows + BWD_ROWS - 1) / BWD_ROWS);
  size_t smem = ffn_smem<T>(p.D, p.F);
  cudaError_t err = cudaFuncSetAttribute(ffn_bwd_kernel<T, RECOMPUTE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ffn_bwd_kernel<T, RECOMPUTE><<<row_blocks, NTHREADS, smem, stream>>>(p, dctx, dx1);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int rc = with_head_dim(p.D, p.H, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    const size_t smem_b = AttnBwdLayout<T, QT, HD, RECOMPUTE>(p.S).total;
    cudaError_t e = cudaFuncSetAttribute(attn_bwd_kernel<T, QT, HD, RECOMPUTE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_b);
    if (e != cudaSuccess) return (int)e;
    attn_bwd_kernel<T, QT, HD, RECOMPUTE><<<(unsigned)(p.B * p.H), NTHREADS, smem_b, stream>>>(
        p, dctx, dx1, causal);
    return (int)cudaGetLastError();
  });
  if (rc != 0) return rc;

  // (c) writes its column sums after (a)'s rows
  BwdParams<T> pc = p;
  pc.small_part = p.small_part + (size_t)row_blocks * p.small_stride;
  smem = qkv_bwd_smem<T>(p.D, p.F);
  err = cudaFuncSetAttribute(qkv_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  qkv_bwd_kernel<T><<<row_blocks, NTHREADS, smem, stream>>>(pc, dx1);
  return (int)cudaGetLastError();
}

// The recompute mode's backward: the workspace launches (QKV; the context,
// x1 and the f32 hidden), then (a), (b) and (c). `t` as for
// dsvg_layer_long_train_bwd_recompute.
template <class T, int ROWS, int QROWS, int QT>
int launch_backward_recompute(void* const* t, int B, int S, int D, int F, int H, int causal,
                              int seed, int thr, float kp, float scale, cudaStream_t stream) {
  layer_fwd::LayerParams<T> f = layer_fwd::make_params<T>(
      t[0], t[26], t[2], t[3], t[27], t[4], t[28], t[5], t[6], t[29], t[7], t[30], t[31],
      nullptr, B, S, D, F, H, causal, scale);
  f.ctx_s = (T*)t[10];
  f.x1_s = (float*)t[11];
  f.h32 = (float*)t[25];
  f.seed = seed;
  f.thr = (unsigned)thr;
  f.kp = kp;
  const int err = layer_long::launch_forward<T, ROWS, QROWS, true, layer_fwd::FWD_WORKSPACE>(
      f, (T*)t[8], stream);
  if (err != 0) return err;
  BwdParams<T> p = layer_bwd::make_params<T>(t, B, S, D, F, H, seed, thr, kp, scale);
  p.h32 = (const float*)t[25];
  p.mask = (const float*)t[31];
  p.causal = causal;
  return launch_backward<T, QT, true>(p, (T*)t[23], (float*)t[24], causal, stream);
}

}  // namespace

// Training forward, long form: as dsvg_layer_train_fwd (layer.cu), for
// S <= MAX_SEQ_LONG; qkv_s [B*S][3D] is written by the first launch.
extern "C" int dsvg_layer_long_train_fwd(
    const void* x, const void* seq_bias, const void* ln1, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* ln2,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* mask, void* out, void* qkv_s, void* p_s, void* ctx_s, void* x1_s,
    void* h_s, int B, int S, int D, int F, int H, int causal, int is_f32, int seed,
    int thr, float kp, float scale, void* stream) {
  if (S < 1 || S > MAX_SEQ_LONG) return (int)cudaErrorInvalidValue;
  if (is_f32) {
    layer_fwd::LayerParams<float> p = layer_fwd::make_params<float>(
        x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask, out, B, S, D, F, H,
        causal, scale);
    p.qkv_s = (float*)qkv_s;
    p.p_s = (float*)p_s;
    p.ctx_s = (float*)ctx_s;
    p.x1_s = (float*)x1_s;
    p.h_s = (float*)h_s;
    p.seed = seed;
    p.thr = (unsigned)thr;
    p.kp = kp;
    return layer_long::launch_forward<float, 32, 32, true>(p, (float*)qkv_s,
                                                           (cudaStream_t)stream);
  }
  layer_fwd::LayerParams<bf16> p = layer_fwd::make_params<bf16>(
      x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask, out, B, S, D, F, H,
      causal, scale);
  p.qkv_s = (bf16*)qkv_s;
  p.p_s = (bf16*)p_s;
  p.ctx_s = (bf16*)ctx_s;
  p.x1_s = (float*)x1_s;
  p.h_s = (bf16*)h_s;
  p.seed = seed;
  p.thr = (unsigned)thr;
  p.kp = kp;
  return layer_long::launch_forward<bf16, 64, 64, true>(p, (bf16*)qkv_s, (cudaStream_t)stream);
}

// Row-tile blocks of launches (a) and (c), so that the wrapper can size the
// per-block column sums: (a)'s rows first, then (c)'s.
extern "C" int dsvg_layer_long_bwd_rows() { return BWD_ROWS; }

// `tensors`: the 23 device pointers of BwdParams (layer_bwd.cuh), in its
// order, then dctx [B*S][D] (activation type) and dx1 [B*S][D] (f32), both
// scratch written here.
extern "C" int dsvg_layer_long_train_bwd(void* const* tensors, int B, int S, int D, int F,
                                         int H, int causal, int is_f32, int seed, int thr,
                                         float kp, float scale, void* stream) {
  if (S < 1 || S > MAX_SEQ_LONG) return (int)cudaErrorInvalidValue;
  if (is_f32) {
    BwdParams<float> p =
        layer_bwd::make_params<float>(tensors, B, S, D, F, H, seed, thr, kp, scale);
    return launch_backward<float, 32>(p, (float*)tensors[23], (float*)tensors[24], causal,
                                      (cudaStream_t)stream);
  }
  BwdParams<bf16> p = layer_bwd::make_params<bf16>(tensors, B, S, D, F, H, seed, thr, kp, scale);
  return launch_backward<bf16, 64>(p, (bf16*)tensors[23], (float*)tensors[24], causal,
                                   (cudaStream_t)stream);
}

// Training forward of the recompute mode, long form: the arguments of
// dsvg_layer_long_train_fwd, of which only qkv_s is used (the scratch
// [B*S][3D] between the two launches); `out` alone is written, to the bit
// the saved mode's.
extern "C" int dsvg_layer_long_train_fwd_recompute(
    const void* x, const void* seq_bias, const void* ln1, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* ln2,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* mask, void* out, void* qkv, void*, void*, void*, void*, int B, int S, int D,
    int F, int H, int causal, int is_f32, int seed, int thr, float kp, float scale,
    void* stream) {
  if (S < 1 || S > MAX_SEQ_LONG) return (int)cudaErrorInvalidValue;
  if (is_f32) {
    layer_fwd::LayerParams<float> p = layer_fwd::make_params<float>(
        x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask, out, B, S, D, F, H,
        causal, scale);
    p.seed = seed;
    p.thr = (unsigned)thr;
    p.kp = kp;
    return layer_long::launch_forward<float, 32, 32, true, layer_fwd::FWD_OUT>(
        p, (float*)qkv, (cudaStream_t)stream);
  }
  layer_fwd::LayerParams<bf16> p = layer_fwd::make_params<bf16>(
      x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask, out, B, S, D, F, H,
      causal, scale);
  p.seed = seed;
  p.thr = (unsigned)thr;
  p.kp = kp;
  return layer_long::launch_forward<bf16, 64, 64, true, layer_fwd::FWD_OUT>(
      p, (bf16*)qkv, (cudaStream_t)stream);
}

// The recompute mode's backward, long form. `tensors`: the 23 pointers of
// BwdParams, where QKV, the context (16-row padded) and x1 are this layer's
// workspace, written here, and the saved probabilities and hidden are not
// read; dctx and dx1 (scratch, as dsvg_layer_long_train_bwd); then the f32
// hidden [B*S][F] (workspace), seq_bias (or null), bqkv, bo, b1, b2 and the
// mask [B][S].
extern "C" int dsvg_layer_long_train_bwd_recompute(void* const* tensors, int B, int S, int D,
                                                   int F, int H, int causal, int is_f32,
                                                   int seed, int thr, float kp, float scale,
                                                   void* stream) {
  if (S < 1 || S > MAX_SEQ_LONG) return (int)cudaErrorInvalidValue;
  if (is_f32)
    return launch_backward_recompute<float, 32, 32, 32>(tensors, B, S, D, F, H, causal, seed,
                                                         thr, kp, scale, (cudaStream_t)stream);
  return launch_backward_recompute<bf16, 64, 64, 64>(tensors, B, S, D, F, H, causal, seed, thr,
                                                      kp, scale, (cudaStream_t)stream);
}
