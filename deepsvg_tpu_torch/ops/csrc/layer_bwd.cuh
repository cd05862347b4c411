// The fused layer's backward, everything local to a row or a sequence, on one
// block's rows: shared by K4's first backward launch (layer_bwd.cu) and K7's
// stack backward (stack.cu).
//
// A block of 8 warps owns whole sequences, ROWS rows (32 for bf16, 16 for
// float activations). It reads the layer input, the incoming gradient and
// what the forward saved (QKV, probabilities, context, x1, FF hidden),
// regenerates the dropout masks from the hash, and walks the layer backwards:
//   df -> dhpre -> dxn2 -> LN2 backward -> dx1 (-> dseq_bias) -> da -> dctx
//   -> attention backward (dq, dk, dv) -> dxn1 -> LN1 backward -> dx.
// The residual gradient, LayerNorm and softmax arithmetic are f32; df, dhpre,
// da, dctx, ds and dqkv are rounded to the activation type before their
// products, which run on the tensor cores.
//
// RECOMPUTE (K4's recompute mode; K7 does not instantiate it): the forward
// saved nothing. A launch before this one (layer_fwd.cuh, FWD_WORKSPACE)
// wrote QKV, the context, x1 and the FF hidden before dropout in f32 into a
// workspace of this layer alone; the probabilities are recomputed here per
// (sequence, head) from Q and K, in f32 and bit for bit that workspace
// launch's attention, and enter the softmax backward in f32, as the f32
// hidden enters the ReLU gate and the dropped hidden: the Pallas kernel's
// recompute backward. In bfloat16 at D = 256 the forward that made `out` is
// layer_train.cuh's wgmma kernel, whose sums run in another order: what is
// recomputed here differs from that forward's intermediates in their last
// bits (the gradients are held to the plain version's limits).
//
// The weight gradients are sums over all rows of the batch, and blocks run
// concurrently, so this code does not form them. It writes the operands of
// the four products (dqkv and LN1(x), da and ctx, dhpre and LN2(x1), df and
// the dropped FF hidden) for the split-K kernel in wgrad.cu, and one vector of
// per-block column sums (the bias and LayerNorm gradients), which
// dsvg_reduce_partials adds up in a fixed order.
#pragma once

#include "common.cuh"

namespace layer_bwd {

template <class T>
struct BwdParams {
  const T* x;
  const T* g;
  const T* ln1;
  const T* wqkv;
  const T* wo;
  const T* ln2;
  const T* w1;
  const T* w2;
  const T* qkv_s;
  const T* p_s;
  const T* ctx_s;
  const float* x1_s;
  const T* h_s;
  const float* h32;   // RECOMPUTE: the FF hidden before dropout, f32 [rows][F]
  const float* mask;  // RECOMPUTE: [B][S] additive
  int causal;         // RECOMPUTE
  T* dx;
  float* dbias;  // [B][D]
  T* xn1_o;      // [rows][D]
  T* dqkv_o;     // [rows][3D]
  T* da_o;       // [rows][D]
  T* xn2_o;      // [rows][D]
  T* dhpre_o;    // [rows][F]
  T* hd_o;       // [rows][F]
  T* df_o;       // [rows][D]
  float* small_part;  // [blocks][small_stride], this layer's 9D + F first
  long long small_stride;
  int B, S, D, F, H, nseq;
  float scale, kp;
  unsigned thr;
  int seed;
};

__host__ __device__ inline int big_ld(int D, int F) {
  return (3 * D > F ? 3 * D : F) + SPAD;
}

// offsets into the per-block column sums
struct SmallOff {
  int dln1_s, dln1_b, dbqkv, dbo, dln2_s, dln2_b, db1, db2, total;
  __host__ __device__ SmallOff(int D, int F) {
    dln1_s = 0;
    dln1_b = D;
    dbqkv = 2 * D;
    dbo = 5 * D;
    dln2_s = 6 * D;
    dln2_b = 7 * D;
    db1 = 8 * D;
    db2 = 8 * D + F;
    total = 9 * D + F;
  }
};

template <class T, int ROWS>
size_t smem_bytes(int D, int F) {
  return (size_t)2 * ROWS * D * sizeof(float) + (size_t)2 * ROWS * (D + SPAD) * sizeof(T) +
         (size_t)ROWS * big_ld(D, F) * sizeof(T) + (size_t)NWARPS * 256 * sizeof(float) +
         (size_t)(9 * D + F) * sizeof(float);
}

// Sum the warps' per-lane column accumulators (`n` arrays of 8 columns per
// lane) through `stage` [NWARPS][n][D], in warp order, into `dst_k[c]`.
template <int N>
__device__ void reduce_warp_columns(const float (&acc)[N][8], float* stage, int D,
                                    float* colsum, const int (&dst)[N], int warp,
                                    int lane) {
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (lane + 32 * j < D) stage[((size_t)warp * N + k) * D + lane + 32 * j] = acc[k][j];
  __syncthreads();
  for (int e = threadIdx.x; e < N * D; e += NTHREADS) {
    const int k = e / D, c = e - k * D;
    float s = 0.f;
    for (int w = 0; w < NWARPS; ++w) s += stage[((size_t)w * N + k) * D + c];
    colsum[dst[k] + c] += s;
  }
  __syncthreads();
}

// One layer's backward on the sequences of block blockIdx.x, heads of HD
// columns (8, 16 or 32). `smem` holds smem_bytes<T, ROWS>(D, F) bytes.
template <class T, int ROWS, int HD, bool RECOMPUTE = false>
__device__ __forceinline__ void layer_bwd_tile(const BwdParams<T>& p, unsigned char* smem) {
  const int D = p.D, F = p.F, S = p.S, H = p.H;
  const int ldn = D + SPAD, ldb = big_ld(D, F);
  const SmallOff off(D, F);
  float* Y = reinterpret_cast<float*>(smem);        // dx1, the residual gradient
  float* Z = Y + ROWS * D;                          // f32 product outputs
  T* S1 = reinterpret_cast<T*>(Z + ROWS * D);
  T* S2 = S1 + ROWS * ldn;
  T* big = S2 + ROWS * ldn;
  float* scratch = reinterpret_cast<float*>(big + ROWS * ldb);
  float* colsum = scratch + NWARPS * 256;
  float* stage = reinterpret_cast<float*>(big);     // when big is free

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wscr = scratch + warp * 256;
  const int seq0 = blockIdx.x * p.nseq;
  const int nvalid = min(p.nseq, p.B - seq0);
  const int nrows = nvalid * S;
  const size_t row0 = (size_t)seq0 * S;
  const bool drop = p.thr != 0u;
  const unsigned key_ao = site_key(p.seed, SITE_ATTN_OUT);
  const unsigned key_fh = site_key(p.seed, SITE_FF_HIDDEN);
  const unsigned key_fo = site_key(p.seed, SITE_FF_OUT);
  const unsigned key_ap = site_key(p.seed, SITE_ATTN_PROB);
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
                                    dh = keep_elem(key_fh, (unsigned)row, n, p.thr) ? dh * p.kp : 0.f;
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
        for (int c = lane; c < D; c += 32) {
          Y[r * D + c] = 0.f;
          S1[r * ldn + c] = from_f<T>(0.f);
        }
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
          const float dx1 = to_f(p.g[row * D + c]) + rstd * (dxh[j] - m1 - v[j] * m2);
          Y[r * D + c] = dx1;
          float da = dx1;
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

  // 5. dseq_bias = dx1 summed over each sequence; QKV tile into big
  for (int e = threadIdx.x; e < nvalid * D; e += NTHREADS) {
    const int sq = e / D, c = e - sq * D;
    float s = 0.f;
    for (int i = 0; i < S; ++i) s += Y[(sq * S + i) * D + c];
    p.dbias[(size_t)(seq0 + sq) * D + c] = s;
  }
  for (int e = threadIdx.x; e < ROWS * 3 * D; e += NTHREADS) {
    const int r = e / (3 * D), n = e - r * 3 * D;
    big[r * ldb + n] = r < nrows ? p.qkv_s[(row0 + r) * 3 * D + n] : from_f<T>(0.f);
  }

  // 6. dctx = da @ Wo, rounded
  tile_gemm<T, ROWS, false>(S1, ldn, p.wo, D, D, D, wscr, warp, lane, nullptr,
                            [&](int r, int n, float v) {
                              S2[r * ldn + n] = from_f<T>(v);
                              return 0.f;
                            });
  __syncthreads();

  // 7. attention backward, one warp per (sequence, head); lane j owns key j,
  // and lane c < HD sums column c of dq. dq, dk, dv overwrite q, k, v in big
  // (each block of it belongs to one warp).
  for (int pair = warp; pair < nvalid * H; pair += NWARPS) {
    const int sq = pair / H, h = pair - sq * H;
    T* base = big + (size_t)sq * S * ldb;
    const bool has_key = lane < S;
    const int jr = has_key ? lane : 0;
    // RECOMPUTE: this lane's key (read before any of it is overwritten) and
    // mask, as the forward's attention holds them
    const T* krow = base + (size_t)jr * ldb + D + h * HD;
    const bool has_col = lane < HD;
    const int col = has_col ? lane : 0;
    const float mval =
        RECOMPUTE && has_key ? p.mask[(size_t)(seq0 + sq) * S + lane] : -INFINITY;
    float vf[HD], dk[HD], dv[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      vf[d] = has_key ? to_f(base[(size_t)jr * ldb + 2 * D + h * HD + d]) : 0.f;
      dk[d] = 0.f;
      dv[d] = 0.f;
    }
    const size_t prow0 = ((size_t)(seq0 + sq) * H + h) * S;
    for (int i = 0; i < S; ++i) {
      const T* dc = S2 + (size_t)(sq * S + i) * ldn + h * HD;
      T* qr = base + (size_t)i * ldb + h * HD;
      float pr;
      if constexpr (RECOMPUTE) {
        // the forward's probability, f32: the same products and sums in the
        // same order as layer_fwd::attention
        float sc = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d)
          sc = fmaf(to_f(qr[d]), has_key ? to_f(krow[d]) : 0.f, sc);
        sc = sc * p.scale + mval;
        if (!has_key || (p.causal && lane > i)) sc = -INFINITY;
        const float m = warp_max(sc);
        pr = 0.f;
        if (m != -INFINITY) {
          const float e = expf(sc - m);
          pr = e / warp_sum(e);
        }
      } else {
        pr = has_key ? to_f(p.p_s[(prow0 + i) * S + lane]) : 0.f;
      }
      float km = 1.f;  // the dropout factor of this probability
      if (drop) km = keep_elem(key_ap, (unsigned)(prow0 + i), (unsigned)lane, p.thr) ? p.kp : 0.f;
      const float pe = round_to<T>(pr * km);
      float dp = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        const float dcd = to_f(dc[d]);
        dp = fmaf(dcd, vf[d], dp);
        dv[d] = fmaf(pe, dcd, dv[d]);
      }
      dp *= km;
      const float ds = round_to<T>(pr * (dp - warp_sum(dp * pr)));
      float dq = 0.f;
      for (int j = 0; j < S; ++j)
        dq = fmaf(__shfl_sync(FULL_MASK, ds, j),
                  to_f(base[(size_t)j * ldb + D + h * HD + col]), dq);
#pragma unroll
      for (int d = 0; d < HD; ++d) dk[d] = fmaf(ds, to_f(qr[d]), dk[d]);
      __syncwarp();  // every lane has read q_i
      if (has_col) qr[lane] = from_f<T>(dq * p.scale);
    }
    __syncwarp();  // every lane has read the keys
    if (has_key) {
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        base[(size_t)lane * ldb + D + h * HD + d] = from_f<T>(dk[d] * p.scale);
        base[(size_t)lane * ldb + 2 * D + h * HD + d] = from_f<T>(dv[d]);
      }
    }
  }
  __syncthreads();

  // 8. dqkv out; dbqkv = column sums of the rounded dqkv
  for (int n = threadIdx.x; n < 3 * D; n += NTHREADS) {
    float s = 0.f;
    for (int r = 0; r < nrows; ++r) {
      const T v = big[r * ldb + n];
      p.dqkv_o[(row0 + r) * 3 * D + n] = v;
      s += to_f(v);
    }
    colsum[off.dbqkv + n] = s;
  }
  // dxn1 = dqkv @ Wqkv
  tile_gemm<T, ROWS, false>(big, ldb, p.wqkv, D, D, 3 * D, wscr, warp, lane, nullptr,
                            [&](int r, int n, float v) {
                              Z[r * D + n] = v;
                              return 0.f;
                            });
  __syncthreads();

  // 9. LN1 backward and dx (one warp per row); xn1 for the dWqkv product
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
          p.dx[row * D + c] =
              from_f<T>(Y[r * D + c] + rstd * (dxh[j] - m1 - v[j] * m2));
      }
    }
    __syncthreads();  // big (the stage) is no longer read by step 8
    const int dst[2] = {off.dln1_s, off.dln1_b};
    reduce_warp_columns<2>(acc, stage, D, colsum, dst, warp, lane);
  }

  // 10. this block's column sums
  for (int e = threadIdx.x; e < off.total; e += NTHREADS)
    p.small_part[(size_t)blockIdx.x * p.small_stride + e] = colsum[e];
}

template <class T>
BwdParams<T> make_params(void* const* t, int B, int S, int D, int F, int H, int seed,
                         int thr, float kp, float scale) {
  BwdParams<T> p;
  p.x = (const T*)t[0];
  p.g = (const T*)t[1];
  p.ln1 = (const T*)t[2];
  p.wqkv = (const T*)t[3];
  p.wo = (const T*)t[4];
  p.ln2 = (const T*)t[5];
  p.w1 = (const T*)t[6];
  p.w2 = (const T*)t[7];
  p.qkv_s = (const T*)t[8];
  p.p_s = (const T*)t[9];
  p.ctx_s = (const T*)t[10];
  p.x1_s = (const float*)t[11];
  p.h_s = (const T*)t[12];
  p.h32 = nullptr;
  p.mask = nullptr;
  p.causal = 0;
  p.dx = (T*)t[13];
  p.dbias = (float*)t[14];
  p.xn1_o = (T*)t[15];
  p.dqkv_o = (T*)t[16];
  p.da_o = (T*)t[17];
  p.xn2_o = (T*)t[18];
  p.dhpre_o = (T*)t[19];
  p.hd_o = (T*)t[20];
  p.df_o = (T*)t[21];
  p.small_part = (float*)t[22];
  p.small_stride = 9 * D + F;
  p.B = B;
  p.S = S;
  p.D = D;
  p.F = F;
  p.H = H;
  p.seed = seed;
  p.thr = (unsigned)thr;
  p.kp = kp;
  p.scale = scale;
  return p;
}

}  // namespace layer_bwd
