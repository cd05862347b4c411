// K4's bfloat16 short form for Hopper (see ops/layer_vjp.py): the fused
// pre-LN layer's training forward with dropout at four sites, in both modes,
// and its saved-mode backward, at D = 256 (8 heads of 32), F a multiple of
// 64 up to 1024, S <= 32.
//
// Replaces deepsvg_tpu/ops/layer_vjp.py:_fwd_kernel and _bwd_kernel_saved
// (wrapper fused_layer_train) in bfloat16. What bounds the layer on the H100
// is the tensor cores: its products are 2 (4 D^2 + 2 D F) = 1.05 MFLOP a row
// forward and twice that backward; at E1 with B=128 (32,768 rows) 0.036 ms
// and 0.072 ms at 989 TFLOP/s, against about 0.05 ms for the ~4.6 KB a row
// the saved mode writes. The old form (layer_fwd.cuh / layer_bwd.cuh, still
// K7's, the recompute backward's and the narrower widths') ran wmma 16x16
// tiles in blocks of 64 (forward) and 32 (backward) rows that each read all
// of the layer's weights from L2 with nothing in flight. This form is K2's
// design (layer_infer.cuh): persistent blocks, one TMA producer warp
// streaming the weights through an mbarrier ring, two wgmma consumer
// warpgroups of 64 rows each on 128-row tiles of whole sequences, so the
// weights come from L2 once per 128 rows.
//
// * Forward (train_short_kernel in layer.cu): K2's walk, plus
//   - dropout at the four sites, the hash of common.cuh evaluated at each
//     element's (row, column): the masks the plain version and the backward
//     draw;
//   - the saved mode's writes: QKV and the probabilities before dropout from
//     registers (attend_rows' hook), the context from shared memory, x1 and
//     the FF hidden before dropout;
//   - a residual that leaves the registers: with dropout the out projection
//     and FF2 need their products alone (out = x1 + m (h W2^T + b2)), and a
//     product and the residual together are 256 registers a thread against
//     the 240 a consumer has. So the attention block's output goes to x1's
//     tensor (x1_s in the saved mode, a scratch tensor in the recompute
//     mode), a row-per-warp pass adds the residual there and takes LN2, and
//     each thread reads its own elements of x1 back for the output. The two
//     modes run the same arithmetic: the same `out` to the bit.
// * Backward: three row-local launches and the weight products.
//   - bwd_ff_kernel (K2's block shape): df = g m staged in shared memory;
//     per 64-column chunk of the hidden, dh = df W2 on wgmma, dhpre = the
//     ReLU and dropout gates of the saved hidden times dh, staged by
//     stmatrix as the A operand of dxn2 += dhpre W1, which runs on while the
//     next chunk is issued; then LN2's backward a row a warp (dxn2 parked in
//     the dx1 scratch): dx1 (summed per sequence into dseq_bias) and da,
//     staged again, and dctx = da Wo. The weights are read as they lie,
//     [K][N] rows: bf16 wgmma reads its B operand MN-major, so no transposed
//     copy.
//   - bwd_attn_kernel: per 128-row tile and head, Q, K, V and dctx of the
//     head in shared memory (the next head's loading by cp.async meanwhile);
//     each warp owns 16 query rows: dP = dctx V^T and dQ = dS K on mma.sync,
//     the saved probabilities read from device memory, the softmax backward
//     in registers; dS and the dropped probabilities go to shared memory
//     transposed (stmatrix), and each warp then owns 16 key rows: dK = dS^T
//     Q, dV = P^T dctx. No atomics.
//   - bwd_qkv_kernel: dxn1 = dqkv Wqkv with both operands from TMA (48 KB
//     stages), LN1's backward a row a warp, dx = dx1 + its input gradient.
//   - The four weight products dW = A^T B over all rows and the four bias
//     gradients (column sums of A) are wgrad.cu's wgmma launch, split over
//     the rows and added in a fixed order by dsvg_reduce_partials, as are the
//     LayerNorm gradients' per-block partial sums of the row-local launches.
//     No atomics: the gradients are equal to the bit from run to run.
//
// What the H100 showed (PERF.md): a spilled register costs a round trip to
// L2, since these blocks leave L1 about 28 KB, so each epilogue that ran
// with the 128 accumulator registers live and spilled (the residual, the
// LayerNorms in the accumulator layout) was moved to a row-per-warp pass
// over device memory, which L2 holds.
//
// The roundings are the old form's and the Pallas kernel's: LN outputs, QKV,
// the probabilities, the context, the FF hidden, df, dhpre, da, dctx, ds and
// dqkv in bf16; residuals, sums, LayerNorm and softmax in f32.
#pragma once

#include "layer_infer.cuh"

namespace layer_train {
namespace {

using namespace hopper;
using namespace layer_infer;

constexpr int QKV_W = 3 * DM;  // a row of QKV
constexpr int WBOX = 8192;     // bytes of a 64 x 64 weight box

// What a training forward writes beside `out`, and its dropout.
struct Train {
  bf16* qkv;     // [rows][3D], or null: the recompute mode
  bf16* p;       // [B][H][S][S], before dropout
  bf16* ctx;     // [rows][D]
  float* x1;     // [rows][D]: the residual after the attention block (the
                 // recompute mode's scratch)
  bf16* h;       // [rows][F], before dropout
  int seed;
  unsigned thr;  // floor(rate 2^24); 0: no dropout
  float kp;      // 1 / (1 - rate)
  float* p32;    // [B][H][S][S] before dropout, float32 (K11's backward, which
                 // takes them unrounded as the JAX rule does), or null
};

// the shapes this form takes (the wrapper routes the others to the old one):
// F a multiple of 256, the widths its weight-product launch takes
// (dsvg_wgrad_hopper: M a multiple of 128, N of 256; dW2 has N = F)
inline bool hopper_form(int D, int F, int H, int S) {
  return D == DM && H == NH && F % 256 == 0 && F <= MAX_F && S >= 1 && S <= 32;
}

// v kept (times kp) or dropped at (row, col) of the site `key`
__device__ __forceinline__ float drop_at(float v, unsigned key, size_t row, int col, unsigned thr,
                                         float kp) {
  return thr == 0u ? v : (keep_elem(key, (unsigned)row, (unsigned)col, thr) ? v * kp : 0.f);
}

// the saved probabilities at `at` and at + 1 (in0, in1: which are the
// row's), in their type: one store of the pair where it is aligned
__device__ __forceinline__ void store_p_pair(bf16* at, float p0, float p1, bool in0, bool in1) {
  if (in0 && in1 && !(reinterpret_cast<uintptr_t>(at) & 3)) {
    *reinterpret_cast<uint32_t*>(at) = pack_bf16(p0, p1);
  } else {
    if (in0) at[0] = __float2bfloat16(p0);
    if (in1) at[1] = __float2bfloat16(p1);
  }
}
__device__ __forceinline__ void store_p_pair(float* at, float p0, float p1, bool in0, bool in1) {
  if (in0 && in1 && !(reinterpret_cast<uintptr_t>(at) & 7)) {
    *reinterpret_cast<float2*>(at) = make_float2(p0, p1);
  } else {
    if (in0) at[0] = p0;
    if (in1) at[1] = p1;
  }
}

// a saved probability as float
__device__ __forceinline__ float p_value(bf16 v) { return bf2f(v); }
__device__ __forceinline__ float p_value(float v) { return v; }

// attend_rows' hook in the training forward: saves the probabilities of the
// thread's row rr (tile rows i0 and i0 + 8) at key rows j and j + 1 (its
// sequence's keys only, in PT: K4's bf16, K11's backward float32) and
// returns them with dropout, packed. The rows' sequence start, probability
// row and its hash are reckoned once a head.
template <class PT>
struct AttnDropT {
  PT* p;  // the saved probabilities, or null
  unsigned key, thr;
  float kp;
  int S, lo[2];  // lo: the row's first key, or -S - 1 past the tile's rows
  unsigned prow[2], rh[2];  // the probability row and its hash
  __device__ __forceinline__ AttnDropT(PT* p_, unsigned key_, unsigned thr_, float kp_, int seq0,
                                       int S_, int h, int nrows, int i0)
      : p(p_), key(key_), thr(thr_), kp(kp_), S(S_) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = i0 + 8 * rr, sq = i / S;
      lo[rr] = i < nrows ? sq * S : -S - 1;
      prow[rr] = (unsigned)(((seq0 + sq) * NH + h) * S + (i - sq * S));
      rh[rr] = row_hash(key, prow[rr]);
    }
  }
  // pr with dropout at key k of row rr (another sequence's key, pr = 0, or
  // no row: as it is)
  __device__ __forceinline__ float dropped(float pr, int rr, int k) const {
    if (k < 0 || k >= S || thr == 0u) return pr;
    return keep_col(rh[rr], (unsigned)k, thr) ? pr * kp : 0.f;
  }
  __device__ __forceinline__ uint32_t pair(float p0, float p1, int rr, int j) const {
    const int k = j - lo[rr];
    if (p != nullptr)
      store_p_pair(p + (size_t)prow[rr] * S + k, p0, p1, k >= 0 && k < S, k + 1 >= 0 && k + 1 < S);
    return pack_bf16(dropped(p0, rr, k), dropped(p1, rr, k + 1));
  }
};
using AttnDrop = AttnDropT<bf16>;

// the warpgroup's context rows (shared memory, as store_ctx wrote them) to
// the saved context [rows][D]
__device__ __forceinline__ void save_ctx(bf16* dst, const unsigned char* ctx, const Lane& ln,
                                         const Rows& R) {
  for (int idx = ln.tid & 127; idx < 64 * KSL * 8; idx += 128) {
    const int tr = R.rb + (idx >> 5), k = (idx >> 3) & 3, c = idx & 7;
    if (tr >= R.nrows) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(ctx + k * TR * 128 + swizzle128(tr, c * 16));
    *reinterpret_cast<uint4*>(dst + (R.row0 + tr) * DM + k * 64 + c * 8) = v;
  }
}

// after the out projection (acc = ctx Wo^T): a = m (acc + bo), the
// attention block's output, to t.x1 (the valid rows); residual_ln2 adds the
// residual there. Adding it here, with the 128 accumulator registers live,
// spilled, and a spill is a round trip to L2 in these blocks.
__device__ __forceinline__ void attn_out_train(const Train& t, const float* prm, const Lane& ln,
                                               const Rows& R, const float (&acc)[2][64]) {
  const unsigned key = site_key(t.seed, SITE_ATTN_OUT);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = R.rb + ln.r0 + 8 * rr;
    if (r >= R.nrows) continue;
    const size_t row = R.row0 + r;
    float* a = t.x1 + row * DM;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 128 * n + 8 * j + 2 * ln.t4, i = 4 * j + 2 * rr;
        const float2 bo = lds2(prm + P_BO + col);
        *reinterpret_cast<float2*>(a + col) =
            make_float2(drop_at(acc[n][i] + bo.x, key, row, col, t.thr, t.kp),
                        drop_at(acc[n][i + 1] + bo.y, key, row, col + 1, t.thr, t.kp));
      }
  }
}

// a quarter of a warpgroup's 64 x 64 bf16 chunk to shared memory by
// stmatrix (K-major, row r at r * 128 bytes, swizzled): v[e] is the packed
// pair m = 4 q + e of the m64n64 accumulator order (rows r0 + 8 (m & 1),
// columns 8 (m >> 1) + 2 t4 and + 1). Staged a quarter at a time, a chunk
// holds four packed registers, not sixteen.
__device__ __forceinline__ void stage_quarter(uint32_t dst, const Lane& ln, int q,
                                              const uint32_t (&v)[4]) {
  const int mi = ln.lane >> 3;
  stmatrix_x4<false>(dst + swizzle128(16 * ln.w + 8 * (mi & 1) + (ln.lane & 7),
                                      16 * (2 * q + (mi >> 1))),
                     v[0], v[1], v[2], v[3]);
}

// The FF of the training forward over the warpgroup's LN2 rows, as K2's
// ff_store: per 64-column chunk FF1, ReLU (saved before dropout in the saved
// mode), dropout, bf16 staged into the hidden buffers, FF2 into acc; then
// out = x1 + m (acc + b2), x1 read back from t.x1
template <bool SAVE>
__device__ __forceinline__ void ff_train(const Params& p, const Train& t, const float* prm,
                                         const Lane& ln, const Rows& R, Ring& r, uint32_t xn_a,
                                         uint32_t slice, uint32_t hbuf, uint32_t hstride,
                                         float (&acc)[2][64]) {
  const unsigned key_h = site_key(t.seed, SITE_FF_HIDDEN), key_o = site_key(t.seed, SITE_FF_OUT);
  const int ra = R.rb + ln.r0;  // the thread's tile rows ra and ra + 8
#pragma unroll 1
  for (int c = 0; c < p.F / FC; ++c) {
    float hacc[32];
#pragma unroll
    for (int kp = 0; kp < KSL / 2; ++kp) {
      const uint32_t st = r.acquire();
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_bf16(hacc, desc_sw128(xn_a + (2 * kp + j) * slice + 32 * kk),
                               desc_sw128(st + j * 8192 + 32 * kk), (kp | j | kk) ? 1 : 0);
      wgmma_commit();
      r.keep1();
    }
    r.drain();  // this chunk's FF1, and the last chunk's FF2, are done
    fence_acc(hacc);
    const uint32_t hb = hbuf + (c & 1) * hstride;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 4 * q + e, rr = m & 1, col = FC * c + 8 * (m >> 1) + 2 * ln.t4;
        const size_t row = R.row0 + ra + 8 * rr;
        const float2 b = lds2(prm + P_B1 + col);
        const float h0 = fmaxf(hacc[2 * m] + b.x, 0.f), h1 = fmaxf(hacc[2 * m + 1] + b.y, 0.f);
        if constexpr (SAVE)
          if (ra + 8 * rr < R.nrows)
            *reinterpret_cast<uint32_t*>(t.h + row * p.F + col) = pack_bf16(h0, h1);
        v[e] = pack_bf16(drop_at(h0, key_h, row, col, t.thr, t.kp),
                         drop_at(h1, key_h, row, col + 1, t.thr, t.kp));
      }
      stage_quarter(hb, ln, q, v);
    }
    fence_proxy_async();
    named_barrier(2 + ln.wg, 128);
#pragma unroll
    for (int n = 0; n < DM / 128; ++n) {
      const uint32_t st = r.acquire();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128k16_bf16(acc[n], desc_sw128(hb + 32 * kk), desc_sw128(st + 32 * kk),
                              (c | kk) ? 1 : 0);
      wgmma_commit();
      r.keep1();
    }
  }
  r.drain();
  fence_acc(acc[0]);
  fence_acc(acc[1]);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (ra + 8 * rr >= R.nrows) continue;
    const size_t row = R.row0 + ra + 8 * rr;
    // x1 as residual_ln2 left it: other lanes of this warp wrote these
    // elements, visible here through the warpgroup barrier after
    // residual_ln2 (named_barrier(2 + wg) in train_short_kernel)
    const float* x1 = t.x1 + row * DM;
    bf16* o = p.out + row * DM;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 128 * n + 8 * j + 2 * ln.t4, i = 4 * j + 2 * rr;
        const float2 xv = *reinterpret_cast<const float2*>(x1 + col);
        const float2 b2 = lds2(prm + P_B2 + col);
        *reinterpret_cast<uint32_t*>(o + col) =
            pack_bf16(xv.x + drop_at(acc[n][i] + b2.x, key_o, row, col, t.thr, t.kp),
                      xv.y + drop_at(acc[n][i + 1] + b2.y, key_o, row, col + 1, t.thr, t.kp));
      }
  }
}

// ==================================================================== backward
struct Bwd {
  const bf16* x;      // [rows][D]
  const bf16* g;      // [rows][D]
  const bf16* ln1;    // [2][D]
  const bf16* ln2;
  const bf16* qkv;    // saved: [rows][3D]
  const bf16* p;      // saved: [B][H][S][S]
  const float* x1;    // saved: [rows][D]
  const bf16* h;      // saved: [rows][F]
  bf16* dx;           // [rows][D]
  float* dbias;       // [B][D]
  bf16* xn1;          // the weight products' operands, [rows][..]
  bf16* dqkv;
  bf16* da;
  bf16* xn2;
  bf16* dhpre;
  bf16* hd;
  bf16* df;
  float* small;       // [blocks][4 D]: dln1 (scale, bias), dln2 (scale, bias)
  float* dx1;         // scratch [rows][D]
  bf16* dctx;         // scratch [rows][D]
  float* dy;          // scratch [rows][D]: dxn1 before LN1's backward
  int B, S, F, nseq, ntiles, seed;
  unsigned thr;
  float kp, scale;
  const float* p32;   // K11's backward: the probabilities in float32 (p unused)
};

constexpr int SMALL_W = 4 * DM;  // a block's LayerNorm partial sums

struct FfBwdMaps {
  CUtensorMap g, w2, w1, wo;  // g: boxes {64, 128}; the weights, [K][N] rows: {64, 64}
};

// producer of bwd_ff_kernel, per tile: g (KSL stages of 128 rows); per
// 64-column chunk c of the hidden, W2's columns of the chunk (two stages of
// two 64-row boxes) and W1's rows of the chunk (two stages of two
// 64-column quarters); Wo (per 64-row slice of K, two stages of two quarters)
__device__ __forceinline__ void produce_ff_bwd(Ring& r, const FfBwdMaps& m, int row0, int F) {
  for (int k = 0; k < KSL; ++k) {
    unsigned char* st = r.produce(STAGE);
    tma_load_2d(st, &m.g, r.bar(), 64 * k, row0);
    r.advance();
  }
  for (int c = 0; c < F / FC; ++c) {
    for (int s = 0; s < 2; ++s) {
      unsigned char* st = r.produce(STAGE);
      for (int b = 0; b < 2; ++b) tma_load_2d(st + b * WBOX, &m.w2, r.bar(), FC * c, 64 * (2 * s + b));
      r.advance();
    }
    for (int s = 0; s < 2; ++s) {
      unsigned char* st = r.produce(STAGE);
      for (int b = 0; b < 2; ++b) tma_load_2d(st + b * WBOX, &m.w1, r.bar(), 64 * (2 * s + b), FC * c);
      r.advance();
    }
  }
  for (int s = 0; s < KSL; ++s)
    for (int hf = 0; hf < 2; ++hf) {
      unsigned char* st = r.produce(STAGE);
      for (int b = 0; b < 2; ++b) tma_load_2d(st + b * WBOX, &m.wo, r.bar(), 64 * (2 * hf + b), 64 * s);
      r.advance();
    }
}

// df = g m (bf16) of the 16 tile rows [rb, rb + 16) (rows >= nrows zero), one
// row a warp at a time, 8 columns a lane, from g's stages into `as` (the A
// operand, [KSL][128 rows][128 bytes] swizzled) and to b.df
__device__ __forceinline__ void df_rows(const Bwd& b, const unsigned char* (&gs)[KSL], int nrows,
                                        size_t row0, int rb, int lane, unsigned char* as) {
  const unsigned key = site_key(b.seed, SITE_FF_OUT);
  const unsigned char* src = gs[lane >> 3];
  unsigned char* dst = as + (lane >> 3) * TR * 128;
  const int col0 = 8 * lane;  // (lane >> 3) * 64 + (lane & 7) * 8
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int r = rb + i;
    const uint32_t at = r * 128 + (((lane & 7) ^ (r & 7)) << 4);
    uint4 o = make_uint4(0, 0, 0, 0);
    if (r < nrows) {
      o = *reinterpret_cast<const uint4*>(src + at);
      if (b.thr != 0u) {
        bf16* e = reinterpret_cast<bf16*>(&o);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = f2bf(drop_at(bf2f(e[j]), key, row0 + r, col0 + j, b.thr, b.kp));
      }
      *reinterpret_cast<uint4*>(b.df + (row0 + r) * DM + col0) = o;
    }
    *reinterpret_cast<uint4*>(dst + at) = o;
  }
}

// 8 consecutive values at p as floats (16-byte aligned): f32 or bf16
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = bf2f(e[j]);
}
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                    pack_bf16(v[6], v[7]));
}

// the warpgroup's m64n64 accumulators (acc[q][4 j + 2 rr + e]: row R.rb +
// r0 + 8 rr, column 64 q + 8 j + 2 t4 + e) to dst [rows][D] in f32, the
// valid rows
__device__ __forceinline__ void spill_rows(float* dst, const float (&acc)[4][32], const Lane& ln,
                                           const Rows& R) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int tr = R.rb + ln.r0 + 8 * rr;
    if (tr >= R.nrows) continue;
    float* o = dst + (R.row0 + tr) * DM + 2 * ln.t4;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(o + 64 * q + 8 * j) =
            make_float2(acc[q][4 * j + 2 * rr], acc[q][4 * j + 2 * rr + 1]);
  }
}

// The LayerNorm backward of the warp's 16 rows, one row at a time, 8
// columns a lane (c0 = 8 lane): dy, the gradient of the LayerNorm's output,
// and xin, its input, [rows][D] in device memory (f32, or xin bf16); w, bsh
// its scale and bias (shared memory, f32). The column sums of dy xhat and dy
// over the rows are added to sums[0..D) and sums[D..2D), the warp's own.
// epi(tile row, global row, c0, xn, dxin) takes each valid row: the
// LayerNorm's output (xhat w + b) and its input gradient. (Loading rows
// ahead, or the epilogue's own row with these, spilled and ran slower on
// the H100.)
template <class XT, class Epi>
__device__ __forceinline__ void ln_bwd_rows(const XT* xin, const float* dy_in, const float* w,
                                            const float* bsh, const Lane& ln, const Rows& R,
                                            float* sums, Epi epi) {
  const int c0 = 8 * ln.lane;
  float cs[8], cb[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) cs[e] = cb[e] = 0.f;
#pragma unroll 1
  for (int i = 0; i < 16; ++i) {
    const int tr = R.rb + 16 * ln.w + i;
    if (tr >= R.nrows) break;
    const size_t row = R.row0 + tr;
    float x[8], dy[8];
    load8(xin + row * DM + c0, x);
    load8(dy_in + row * DM + c0, dy);
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) s += x[e];
    const float mu = warp_sum(s) / DM;
    float q = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      x[e] -= mu;
      q += x[e] * x[e];
    }
    const float rstd = rsqrtf(warp_sum(q) / DM + LN_EPS);
    float s1 = 0.f, s2 = 0.f, xn[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float xh = x[e] * rstd, d = dy[e] * w[c0 + e];
      cs[e] += dy[e] * xh;
      cb[e] += dy[e];
      s1 += d;
      s2 += d * xh;
      x[e] = xh;
      xn[e] = xh * w[c0 + e] + bsh[c0 + e];
      dy[e] = d;
    }
    const float m1 = warp_sum(s1) / DM, m2 = warp_sum(s2) / DM;
#pragma unroll
    for (int e = 0; e < 8; ++e) dy[e] = rstd * (dy[e] - m1 - x[e] * m2);
    epi(tr, row, c0, xn, dy);
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    sums[c0 + e] += cs[e];
    sums[DM + c0 + e] += cb[e];
  }
}

// the residual and LN2 of the training forward, one row of the warp's 16
// a time, 8 columns a lane: x1 = x + a (+ seq_bias), a the attention
// block's output in t.x1 (written by this warp), x1 back to t.x1, and its
// LayerNorm rounded to bf16 into xn ([KSL][128 rows][128 bytes], swizzled;
// rows >= nrows zero)
__device__ __forceinline__ void residual_ln2(const Params& p, const Train& t, const float* prm,
                                             const Lane& ln, const Rows& R, unsigned char* xn) {
  const int c0 = 8 * ln.lane;
  float w[8], b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    w[j] = prm[P_LN2W + c0 + j];
    b[j] = prm[P_LN2B + c0 + j];
  }
  unsigned char* dst = xn + (ln.lane >> 3) * TR * 128;
#pragma unroll 2
  for (int i = 0; i < 16; ++i) {
    const int r = R.rb + 16 * ln.w + i;
    const uint32_t at = r * 128 + (((ln.lane & 7) ^ (r & 7)) << 4);
    uint4 o = make_uint4(0, 0, 0, 0);
    if (r < R.nrows) {
      const size_t row = R.row0 + r;
      float v[8], xv[8];
      load8(t.x1 + row * DM + c0, v);
      load8(p.x + row * DM + c0, xv);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] += xv[j];
      if (p.seq_bias != nullptr) {
        load8(p.seq_bias + (row / R.S) * DM + c0, xv);  // tiles may cut sequences
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] += xv[j];
      }
      *reinterpret_cast<float4*>(t.x1 + row * DM + c0) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(t.x1 + row * DM + c0 + 4) = make_float4(v[4], v[5], v[6], v[7]);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) s += v[j];
      const float mu = warp_sum(s) / DM;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] -= mu;
        q += v[j] * v[j];
      }
      const float rstd = rsqrtf(warp_sum(q) / DM + LN_EPS);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = v[j] * rstd * w[j] + b[j];
      o = pack8(v);
    }
    *reinterpret_cast<uint4*>(dst + at) = o;
  }
}

// a warpgroup's m64n64 accumulators (4 quarters of 64 columns) rounded to
// bf16 into dst [rows][D], the valid rows
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[4][32], const Lane& ln,
                                           const Rows& R) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int tr = R.rb + ln.r0 + 8 * rr;
    if (tr >= R.nrows) continue;
    bf16* o = dst + (R.row0 + tr) * DM + 2 * ln.t4;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(o + 64 * q + 8 * j) =
            pack_bf16(acc[q][4 * j + 2 * rr], acc[q][4 * j + 2 * rr + 1]);
  }
}

// acc[64 x 256] (+)= A (the warpgroup's rows, K-major at a_wg, KSL slices
// `slice` bytes apart; slice k of K) x B (two 64 x 64 quarters of a [K][N]
// weight per stage, read MN-major): 2 stages a slice of K. (One m64n128
// product a stage, its B two column blocks apart, ran slower on the H100
// than these two m64n64.)
__device__ __forceinline__ void rows_by_weight(Ring& r, uint32_t a_wg, uint32_t slice,
                                               float (&acc)[4][32]) {
#pragma unroll 1
  for (int s = 0; s < KSL; ++s)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const uint32_t st = r.acquire();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t a = desc_sw128(a_wg + s * slice + 32 * kk);
#pragma unroll
        for (int b = 0; b < 2; ++b)
          wgmma_m64n64k16_bf16<0, 1>(acc[2 * hf + b], a, desc_sw128(st + b * WBOX + 2048 * kk),
                                     (s | kk) ? 1 : 0);
      }
      wgmma_commit();
      r.keep1();
    }
  r.drain();
#pragma unroll
  for (int q = 0; q < 4; ++q) fence_acc(acc[q]);
}

// the block's LayerNorm partial sums: the 8 warps' [2][D] in order, to
// small[block][off ..)
__device__ __forceinline__ void write_sums(const float* sums, float* small, int off) {
  named_barrier(1, CONSUMERS);
  for (int e = threadIdx.x; e < 2 * DM; e += CONSUMERS) {
    float s = 0.f;
    for (int w = 0; w < CONSUMERS / 32; ++w) s += sums[w * 2 * DM + e];
    small[(size_t)blockIdx.x * SMALL_W + off + e] = s;
  }
}

// ---------------------------------------------------------------- attention backward
constexpr int LDT = 152;        // bf16 a row of the transposed dS and P (304 bytes)
constexpr int T_ROWS = TR + 16;  // key rows of dS^T: a warp's key blocks run to 15 past the tile

// mma.sync A fragment (16 x 16) of rows [r0, r0 + 16) of a row-major bf16
// matrix at shared address m (`ld` bf16 a row), columns [c0, c0 + 16)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t m, int ld, int r0, int c0,
                                       int lane) {
  ldmatrix_x4<false>(a, m + ((r0 + (lane & 15)) * ld + c0 + 8 * (lane >> 4)) * 2);
}


constexpr uint32_t HEAD_MAT = TR * LDH * 2;  // a head's Q, K, V or dctx rows in shared memory

struct AttnBwdLayout {
  uint32_t buf[2], ds, pe, total;  // two head buffers (Q, K, V, dctx), then dS^T and pe^T
  __host__ __device__ AttnBwdLayout() {
    Carve cv;
    buf[0] = cv.take(4 * HEAD_MAT, 128);
    buf[1] = cv.take(4 * HEAD_MAT, 128);
    ds = cv.take(T_ROWS * LDT * 2, 128);
    pe = cv.take(T_ROWS * LDT * 2, 128);
    total = cv.off + 1024;
  }
};

// 16 bytes global -> shared, asynchronously (zeros where !valid)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Q, K, V and dctx of head h for the tile's rows (>= nrows zero) into the
// head buffer at dst, asynchronously (one commit group)
__device__ __forceinline__ void load_head(const Bwd& b, size_t row0, int nrows, int h,
                                          uint32_t dst) {
  for (int idx = threadIdx.x; idx < 4 * TR * 4; idx += CONSUMERS) {
    const int m = idx / (TR * 4), r = (idx >> 2) % TR, c = idx & 3;
    const size_t row = row0 + (r < nrows ? r : 0);
    const bf16* src = m < 3 ? b.qkv + row * QKV_W + m * DM + h * HEAD_DIM
                            : b.dctx + row * DM + h * HEAD_DIM;
    cp_async16(dst + m * HEAD_MAT + r * LDH * 2 + 16 * c, src + 8 * c, r < nrows);
  }
  cp_async_commit();
}

// The attention backward of one 128-row tile (whole sequences, tile rows
// [0, nrows)), head by head, by the 8 warps of the block, the saved
// probabilities P of type PT (K4's bf16, K11's float32; every key of a
// row's sequence read: past its own, 0 when causal). Each warp first
// owns the 16 query rows q0 = 16 w: dP = dctx V^T over the keys of its
// rows' sequences (as attend_rows' scores), the saved probabilities p, the
// dropout factor km, dp = dP km, ds = p (dp - sum_j dp p) and pe = p km in
// bf16; dQ = dS K (as attend_rows' P V). dS and pe go to shared memory
// transposed ([key][query]). Then it owns the 16 key rows j0 = 16 w:
// dK = dS^T Q and dV = pe^T dctx over the query rows of its keys'
// sequences, the entries of another sequence masked out.
template <class PT>
__device__ __forceinline__ void attn_bwd_tile(const Bwd& b, const PT* P, int tile,
                                              unsigned char* base) {
  const AttnBwdLayout L;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int S = b.S, seq0 = tile * b.nseq;
  const int nrows = min(b.nseq, b.B - seq0) * S;
  const size_t row0 = (size_t)seq0 * S;
  const uint32_t dss = smem_u32(base + L.ds), pes = smem_u32(base + L.pe);
  const unsigned key_ap = site_key(b.seed, SITE_ATTN_PROB);
  const float sl = b.scale;
  load_head(b, row0, nrows, 0, smem_u32(base + L.buf[0]));
#pragma unroll 1
  for (int h = 0; h < NH; ++h) {
    // the next head's rows load while this one is worked on
    if (h + 1 < NH)
      load_head(b, row0, nrows, h + 1, smem_u32(base + L.buf[(h + 1) & 1]));
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t qs = smem_u32(base + L.buf[h & 1]), ks = qs + HEAD_MAT, vs = qs + 2 * HEAD_MAT,
                   cs = qs + 3 * HEAD_MAT;

    // ---- the warp's 16 query rows
    const int q0 = 16 * w;
    if (q0 < nrows) {
      const int qlast = min(q0 + 15, nrows - 1);
      // every key of the rows' sequences (when causal, the probabilities
      // saved for later keys are 0)
      const int kstart = (q0 / S) * S;
      const int kend = (qlast / S + 1) * S;
      const int nkt = (kend - kstart + 15) >> 4;
      int lo[2], hi[2];
      size_t prow[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = q0 + g + 8 * rr;
        lo[rr] = hi[rr] = 0;
        prow[rr] = 0;
        if (i < nrows) {
          lo[rr] = (i / S) * S;
          hi[rr] = lo[rr] + S;
          prow[rr] = ((size_t)(seq0 + i / S) * NH + h) * S + (i - lo[rr]);
        }
      }
      uint32_t cf[2][4];
      load_a(cf[0], cs, LDH, q0, 0, lane);
      load_a(cf[1], cs, LDH, q0, 16, lane);
      float dp[8][4], pv[8][4], pe[8][4];
      float dsum[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < 8; ++t) {
#pragma unroll
        for (int i = 0; i < 4; ++i) dp[t][i] = pv[t][i] = pe[t][i] = 0.f;
        if (t < 2 * nkt) {
          const int kr = min(kstart + 8 * t + (lane & 7), TR - 1);
          uint32_t bb[4];
          ldmatrix_x4<false>(bb, vs + kr * (LDH * 2) + (lane >> 3) * 16);
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_m16n8k16_bf16(d, cf[0], bb[0], bb[1]);
          mma_m16n8k16_bf16(d, cf[1], bb[2], bb[3]);
          const int j0 = kstart + 8 * t + 2 * t4;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int rr = i >> 1, j = j0 + (i & 1);
            if (j >= lo[rr] && j < hi[rr]) {
              const float p = p_value(P[prow[rr] * S + (j - lo[rr])]);
              const float km = drop_at(1.f, key_ap, prow[rr], j - lo[rr], b.thr, b.kp);
              pv[t][i] = p;
              pe[t][i] = p * km;
              dp[t][i] = d[i] * km;
              dsum[rr] += dp[t][i] * p;
            }
          }
        }
      }
      dsum[0] = quad_sum(dsum[0]);
      dsum[1] = quad_sum(dsum[1]);
      float oq[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) oq[j][0] = oq[j][1] = oq[j][2] = oq[j][3] = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u < nkt) {
          uint32_t a[4], ap[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int t = 2 * u + (q >> 1), rr = q & 1;
            a[q] = pack_bf16(pv[t][2 * rr] * (dp[t][2 * rr] - dsum[rr]),
                             pv[t][2 * rr + 1] * (dp[t][2 * rr + 1] - dsum[rr]));
            ap[q] = pack_bf16(pe[t][2 * rr], pe[t][2 * rr + 1]);
          }
          const int kr = min(kstart + 16 * u + (lane & 7) + ((lane >> 3) & 1) * 8, TR - 1);
#pragma unroll
          for (int dd = 0; dd < 2; ++dd) {
            uint32_t bb[4];
            ldmatrix_x4<true>(bb, ks + kr * (LDH * 2) + (16 * dd + 8 * (lane >> 4)) * 2);
            mma_m16n8k16_bf16(oq[2 * dd], a, bb[0], bb[1]);
            mma_m16n8k16_bf16(oq[2 * dd + 1], a, bb[2], bb[3]);
          }
          // dS and pe transposed: matrix m of the fragment (queries 8 (m & 1),
          // keys 8 (m >> 1) of the step) lands at key rows, query columns
          const int m = lane >> 3;
          const uint32_t at = ((kstart + 16 * u + (lane & 7) + 8 * (m >> 1)) * LDT + q0 + 8 * (m & 1)) * 2;
          stmatrix_x4<true>(dss + at, a[0], a[1], a[2], a[3]);
          stmatrix_x4<true>(pes + at, ap[0], ap[1], ap[2], ap[3]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = q0 + g + 8 * rr;
        if (i >= nrows) continue;
        bf16* o = b.dqkv + (row0 + i) * QKV_W + h * HEAD_DIM + 2 * t4;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint32_t*>(o + 8 * j) =
              pack_bf16(oq[j][2 * rr] * sl, oq[j][2 * rr + 1] * sl);
      }
    }
    __syncthreads();

    // ---- the warp's 16 key rows
    const int j0 = 16 * w;
    if (j0 < nrows) {
      const int jl = min(j0 + 15, nrows - 1);
      const int qa = ((j0 / S) * S) & ~15;  // 16-aligned start of the keys' queries
      const int qend = (jl / S + 1) * S;
      const int nqt = (qend - qa + 15) >> 4;
      int kseq[2];  // each key row's sequence
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int j = j0 + g + 8 * rr;
        kseq[rr] = j < nrows ? j / S : -1;
      }
      float ok[4][4], ov[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ok[j][e] = ov[j][e] = 0.f;
#pragma unroll
      for (int v = 0; v < 6; ++v) {
        if (v < nqt) {
          const int c0 = qa + 16 * v;
          uint32_t ad[4], ap[4];
          load_a(ad, dss, LDT, j0, c0, lane);
          load_a(ap, pes, LDT, j0, c0, lane);
          // keep the entries whose query is of the key's sequence: the query
          // warps wrote no others
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int i = c0 + 8 * (m >> 1) + 2 * t4, ksq = kseq[m & 1];
            uint32_t keep = 0u;
            if (ksq >= 0 && i < nrows && i / S == ksq) keep |= 0xFFFFu;
            if (ksq >= 0 && i + 1 < nrows && (i + 1) / S == ksq) keep |= 0xFFFF0000u;
            ad[m] &= keep;
            ap[m] &= keep;
          }
          const int qr = min(c0 + (lane & 7) + ((lane >> 3) & 1) * 8, TR - 1);
#pragma unroll
          for (int dd = 0; dd < 2; ++dd) {
            uint32_t bq[4], bc[4];
            ldmatrix_x4<true>(bq, qs + qr * (LDH * 2) + (16 * dd + 8 * (lane >> 4)) * 2);
            ldmatrix_x4<true>(bc, cs + qr * (LDH * 2) + (16 * dd + 8 * (lane >> 4)) * 2);
            mma_m16n8k16_bf16(ok[2 * dd], ad, bq[0], bq[1]);
            mma_m16n8k16_bf16(ok[2 * dd + 1], ad, bq[2], bq[3]);
            mma_m16n8k16_bf16(ov[2 * dd], ap, bc[0], bc[1]);
            mma_m16n8k16_bf16(ov[2 * dd + 1], ap, bc[2], bc[3]);
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int j = j0 + g + 8 * rr;
        if (j >= nrows) continue;
        bf16* o = b.dqkv + (row0 + j) * QKV_W + h * HEAD_DIM + 2 * t4;
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          *reinterpret_cast<uint32_t*>(o + DM + 8 * d) =
              pack_bf16(ok[d][2 * rr] * sl, ok[d][2 * rr + 1] * sl);
          *reinterpret_cast<uint32_t*>(o + 2 * DM + 8 * d) = pack_bf16(ov[d][2 * rr], ov[d][2 * rr + 1]);
        }
      }
    }
    __syncthreads();  // the head's buffers are free
  }
}
}  // namespace
}  // namespace layer_train
