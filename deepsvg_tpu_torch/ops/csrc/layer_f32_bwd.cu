// K4's float32 long form for Hopper, backward (see ops/layer_vjp.py): the
// saved-mode backward of the fused pre-LN training layer at D = 256 (8 heads
// of 32), F a multiple of 256 up to 1024, 17 <= S <= 256, its forward being
// layer_f32.cu's training launches (QKV saved head-major [H][B*S][96], the
// probabilities before dropout [B][H][S][S], the context, x1 and the FF
// hidden before dropout, all float32).
//
// Replaces deepsvg_tpu/ops/layer_vjp.py:_bwd_kernel_saved (wrapper
// fused_layer_train) for float32 activations. What bounds it on the H100 is
// the tensor cores: its products are 2 x 1.05 MFLOP a row (the four input
// gradients and the four weight gradients), 0.065 ms at 495 TFLOP/s TF32
// for the float32 flagship's E1 at B=60 (15,360 rows), against about 0.03
// ms for the bytes it must move. Every product runs on TF32 tensor cores,
// every operand rounded to TF32 (to nearest) where it is written; LayerNorm,
// softmax and every sum in float32. TF32 wgmma reads K-major operands only,
// so the weights come transposed (the wrapper's copies) and the weight
// products transpose their row tiles on the way into shared memory. The
// layer splits where a row needs other rows:
//
//   bwd_ff_kernel (128-row tiles of all rows; a TMA producer warp and two
//     wgmma consumer warpgroups): df = g m into shared memory; per 64-column
//     chunk of the hidden, dh = df W2 (W2^T streamed), dhpre = the saved
//     hidden's ReLU and dropout gates on dh, staged as the A operand of
//     dxn2 += dhpre W1 (W1^T streamed); dxn2 parked in the dx1 scratch, LN2's
//     backward a row a warp: dx1 = g + its input gradient, da = dx1 m staged
//     over df, xn2; dctx = da Wo (Wo^T streamed).
//   bwd_attn_kernel (a tile of whole sequences and one head a block; 8 warps
//     on mma.sync m16n8k8 TF32): the head's Q, K, V and dctx in shared
//     memory. Each warp owns 16 query rows: dP = dctx V^T key step by key
//     step, the saved probabilities and the dropout factors, dsum = sum_j dp
//     p in a first pass, ds = p (dp - dsum) and dQ = dS K in a second
//     (dS straight from the accumulators, the key order 0, 2, 4, 6, 1, 3, 5,
//     7 of layer_f32.cu's attention); then 16 key rows: dP^T = V dctx^T,
//     dS^T and Pe^T from it, dK = dS^T Q and dV = Pe^T dctx in registers
//     over the query steps in order.
//     The head-0 block also sums dx1 over each sequence: dseq_bias.
//   bwd_qkv_kernel (128-row tiles): dxn1 = dqkv Wqkv (dqkv and Wqkv^T by
//     TMA, 48 KB stages), LN1's backward a row a warp, dx = dx1 + its input
//     gradient, xn1.
//   wgrad_tf32_kernel: dW = A^T B and db = the column sums of A for the four
//     weights (dqkv and xn1, da and the context, dhpre and xn2, df and the
//     dropped hidden), a 128 x 256 tile of a dW and a split of the rows an
//     item: each 32-row step of A and B is read row-major and written
//     transposed into the 128-byte swizzled K-major layout (double buffered,
//     the next step's loads in flight under the current step's wgmma);
//     dsvg_reduce_partials adds the splits in order, as it adds the row
//     launches' LayerNorm partial sums (a row a warp in device memory, no
//     register held for them across the products, folded a block by
//     fold_sums_kernel).
//
// No atomics anywhere: the gradients are equal to the bit from run to run.
#include "layer_infer.cuh"

namespace layer_f32_bwd {
namespace {

using namespace hopper;
using layer_infer::init_ring_bars;
using layer_infer::Lane;
using layer_infer::quad_sum;

constexpr int DM = 256;                // the model width this form takes
constexpr int NH = DM / HEAD_DIM;      // heads
constexpr int QKV_W = 3 * DM;
constexpr int KS = 32;                 // floats in a 128-byte slice
constexpr int NSL = DM / KS;           // slices of a row of D
constexpr int THREADS = 384;           // two consumer warpgroups, then the producer's
constexpr int CONSUMERS = 256;
constexpr int TR = 128;                // rows of a product tile
constexpr int FC = 64;                 // FF hidden columns a chunk
constexpr int LDA = 36;                // floats a row of a head's Q, K, V, dctx in the attention
constexpr uint32_t STAGE = 16384;
constexpr int SMALL_W = 4 * DM;        // a warp's LayerNorm partial sums: dln1, then dln2

struct Bwd {
  const float* x;      // [rows][D]
  const float* g;      // [rows][D]
  const float* ln1;    // [2][D]
  const float* ln2;
  const float* qkv;    // saved: [H][rows][96], head h's q | k | v
  const float* p;      // saved: [B][H][S][S]
  const float* x1;     // saved: [rows][D]
  const float* h;      // saved: [rows][F]
  float* dx;           // [rows][D]
  float* dbias;        // [B][D]
  float* xn1;          // the weight products' operands, [rows][..]
  float* dqkv;         // [rows][3D]
  float* da;
  float* xn2;
  float* dhpre;
  float* hd;
  float* df;
  float* small;        // [blocks][8 warps][SMALL_W]
  float* dx1;          // scratch [rows][D]
  float* dctx;         // scratch [rows][D]
  float* dy;           // scratch [rows][D]: dxn1 before LN1's backward
  long long rows;
  int B, S, F, causal, seed, nseq;
  unsigned thr;
  float kp, scale;
};

struct Maps {
  CUtensorMap w2t, w1t, wot;   // [F][D] box {32, 64}; [D][F] and [D][D], box {32, 128}
  CUtensorMap dqkv, wqkvt;     // [rows][3D] box {32, 128}; [D][3D] box {32, 256}
};

__device__ __forceinline__ float drop_at(float v, unsigned key, size_t row, int col, unsigned thr,
                                         float kp) {
  return thr == 0u ? v : (keep_elem(key, (unsigned)row, (unsigned)col, thr) ? v * kp : 0.f);
}

// into L2 ahead of use: the 32 bytes at `p`
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// 8 floats of row r (a lane's columns 8 lane ..) into a [NSL][128 rows][128 B]
// swizzled operand at `a`
__device__ __forceinline__ void stage8(unsigned char* a, int r, int lane, const float (&v)[8]) {
  unsigned char* dst = a + (lane >> 2) * TR * 128 + r * 128;
#pragma unroll
  for (int pc = 0; pc < 2; ++pc) {
    const uint32_t piece = (lane & 3) * 2 + pc;
    *reinterpret_cast<float4*>(dst + ((piece ^ (r & 7)) << 4)) =
        make_float4(v[4 * pc], v[4 * pc + 1], v[4 * pc + 2], v[4 * pc + 3]);
  }
}

// the warpgroup's m64n128 accumulators (acc[n][4 j + 2 rr + e]: row rb + r0 +
// 8 rr, column 128 n + 8 j + 2 t4 + e) to dst [rows][D], the valid rows;
// rounded to TF32 if ROUND
template <bool ROUND>
__device__ __forceinline__ void store_acc(float* dst, const float (&acc)[2][64], const Lane& ln,
                                          size_t row0, int rb, int nrows) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int tr = rb + ln.r0 + 8 * rr;
    if (tr >= nrows) continue;
    float* o = dst + (row0 + tr) * DM + 2 * ln.t4;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float a = acc[n][4 * j + 2 * rr], b = acc[n][4 * j + 2 * rr + 1];
        *reinterpret_cast<float2*>(o + 128 * n + 8 * j) =
            ROUND ? make_float2(to_tf32(a), to_tf32(b)) : make_float2(a, b);
      }
  }
}

// The LayerNorm backward of one row, 8 columns a lane (c0 = 8 lane): x the
// LayerNorm's input, dy the gradient of its output, w and b its scale and
// bias. Returns the input gradient in dy and the output (x^ w + b) in xn;
// adds dy x^ and dy to the lane's column sums cs, cb.
__device__ __forceinline__ void ln_bwd_row(float (&x)[8], float (&dy)[8], const float (&w)[8],
                                           const float (&b)[8], float (&xn)[8], float (&cs)[8],
                                           float (&cb)[8]) {
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
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float xh = x[e] * rstd, d = dy[e] * w[e];
    cs[e] += dy[e] * xh;
    cb[e] += dy[e];
    s1 += d;
    s2 += d * xh;
    x[e] = xh;
    xn[e] = xh * w[e] + b[e];
    dy[e] = d;
  }
  const float m1 = warp_sum(s1) / DM, m2 = warp_sum(s2) / DM;
#pragma unroll
  for (int e = 0; e < 8; ++e) dy[e] = rstd * (dy[e] - m1 - x[e] * m2);
}

// a warp's LayerNorm column sums of one tile (cs, cb: a lane's 8 columns c0
// ..) into its row of the partial sums, small[block * 8 + warp][off ..): set
// on the block's first tile, added to after; dsvg_reduce_partials adds the
// rows in order
__device__ __forceinline__ void add_sums(const float (&cs)[8], const float (&cb)[8], float* small,
                                         int off, int c0, bool first) {
  float* row = small + ((size_t)blockIdx.x * (CONSUMERS / 32) + (threadIdx.x >> 5)) * SMALL_W + off;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    row[c0 + e] = first ? cs[e] : row[c0 + e] + cs[e];
    row[DM + c0 + e] = first ? cb[e] : row[DM + c0 + e] + cb[e];
  }
}

// ---------------------------------------------------------------- (a) FF, LN2, out projection
constexpr int FF_STAGES = 3;

struct FfLayout {
  uint32_t a, hid, ring, prm, bars, total;
  __host__ __device__ FfLayout() {
    Carve c;
    a = c.take(NSL * TR * 128);          // df, then da: the A operand (128 KB)
    hid = c.take(2 * 2 * 64 * 128);      // a warpgroup's dhpre chunk: two slices of 64 rows
    ring = c.take(FF_STAGES * STAGE);
    prm = c.take(2 * DM * 4, 16);        // LN2's scale and bias
    bars = c.take(2 * FF_STAGES * 8, 8);
    total = c.off + 1024;
  }
};

__global__ void __launch_bounds__(THREADS, 1)
    bwd_ff_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Bwd b) {
  const FfLayout L;
  unsigned char* base = smem_base();
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bars);
  layer_infer::Ring ring;
  ring.init(base + L.ring, bars, FF_STAGES);
  if (threadIdx.x == 0) {
    init_ring_bars(bars, FF_STAGES);
    fence_barrier_init();
  }
  __syncthreads();
  const int ntiles = (int)((b.rows + TR - 1) / TR);

  if (threadIdx.x >= CONSUMERS) {  // the producer
    setmaxnreg_dec<24>();
    if (threadIdx.x != CONSUMERS) return;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      for (int c = 0; c < b.F / FC; ++c) {
        for (int kp = 0; kp < NSL / 2; ++kp) {  // W2^T rows of the chunk, two slices of D
          unsigned char* st = ring.produce(STAGE);
          tma_load_2d(st, &maps.w2t, ring.bar(), KS * (2 * kp), FC * c);
          tma_load_2d(st + 8192, &maps.w2t, ring.bar(), KS * (2 * kp + 1), FC * c);
          ring.advance();
        }
        for (int ks = 0; ks < FC / KS; ++ks)    // W1^T: a slice of the chunk, half of D
          for (int n = 0; n < DM / 128; ++n) {
            unsigned char* st = ring.produce(STAGE);
            tma_load_2d(st, &maps.w1t, ring.bar(), FC * c + KS * ks, 128 * n);
            ring.advance();
          }
      }
      for (int k = 0; k < NSL; ++k)             // Wo^T
        for (int n = 0; n < DM / 128; ++n) {
          unsigned char* st = ring.produce(STAGE);
          tma_load_2d(st, &maps.wot, ring.bar(), KS * k, 128 * n);
          ring.advance();
        }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const Lane ln;
  float* prm = reinterpret_cast<float*>(base + L.prm);
  for (int i = ln.tid; i < 2 * DM; i += CONSUMERS) prm[i] = b.ln2[i];
  named_barrier(1, CONSUMERS);
  unsigned char* as = base + L.a;
  const int rb = 64 * ln.wg;
  const uint32_t a_wg = smem_u32(as) + rb * 128;
  unsigned char* hb = base + L.hid + ln.wg * 2 * 64 * 128;
  const uint32_t hid_a = smem_u32(hb);
  const int c0 = 8 * ln.lane;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const unsigned key_fo = site_key(b.seed, SITE_FF_OUT);
    const size_t row0 = (size_t)tile * TR;
    const int nrows = (int)min((long long)TR, b.rows - (long long)row0);
    // df = g m, rounded to TF32, into the A operand (rows >= nrows zero) and
    // to b.df; a row of the warp's 16 at a time
#pragma unroll 1
    for (int i = 0; i < 16; ++i) {
      const int r = rb + 16 * ln.w + i;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
      if (r < nrows) {
        const size_t row = row0 + r;
        load8(b.g + row * DM + c0, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = to_tf32(drop_at(v[e], key_fo, row, c0 + e, b.thr, b.kp));
        store8(b.df + row * DM + c0, v);
      }
      stage8(as, r, ln.lane, v);
    }
    fence_proxy_async();
    named_barrier(2 + ln.wg, 128);
    // per chunk of the hidden: dh = df W2, dhpre, dxn2 += dhpre W1
    float acc[2][64];
#pragma unroll 1
    for (int c = 0; c < b.F / FC; ++c) {
      // the chunk's saved hidden, which the epilogue reads, into L2 under
      // the products: the thread's two rows, its quarter of the 256 bytes
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        if (rb + ln.r0 + 8 * rr < nrows)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            prefetch_l2(b.h + (row0 + rb + ln.r0 + 8 * rr) * b.F + FC * c + 16 * ln.t4 + 8 * e);
      float hacc[32];
#pragma unroll 1
      for (int kp = 0; kp < NSL / 2; ++kp) {
        const uint32_t st = ring.acquire();
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n64k8_tf32(hacc, desc_sw128(a_wg + (2 * kp + j) * (TR * 128) + 32 * kk),
                                desc_sw128(st + j * 8192 + 32 * kk), (kp | j | kk) ? 1 : 0);
        wgmma_commit();
        ring.keep1();
      }
      ring.drain();  // this chunk's dh, and the last chunk's dxn2 product, are done
      fence_acc(hacc);
      // dhpre: the saved hidden's ReLU gate and the dropout mask on dh; the
      // dropped hidden for dW2; dhpre staged as the next product's A
      const unsigned key_fh = site_key(b.seed, SITE_FF_HIDDEN);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int col = 8 * (i >> 2) + 2 * ln.t4, r = ln.r0 + 8 * ((i >> 1) & 1);
        const int gcol = FC * c + col;
        const size_t row = row0 + rb + r;
        float dh0 = 0.f, dh1 = 0.f;
        if (rb + r < nrows) {
          const float2 hv = *reinterpret_cast<const float2*>(b.h + row * b.F + gcol);
          dh0 = hv.x > 0.f ? to_tf32(drop_at(hacc[i], key_fh, row, gcol, b.thr, b.kp)) : 0.f;
          dh1 = hv.y > 0.f ? to_tf32(drop_at(hacc[i + 1], key_fh, row, gcol + 1, b.thr, b.kp)) : 0.f;
          store2(b.dhpre + row * b.F + gcol, dh0, dh1);
          store2(b.hd + row * b.F + gcol, to_tf32(drop_at(hv.x, key_fh, row, gcol, b.thr, b.kp)),
                 to_tf32(drop_at(hv.y, key_fh, row, gcol + 1, b.thr, b.kp)));
        }
        *reinterpret_cast<float2*>(hb + (col >> 5) * 64 * 128 + swizzle128(r, (col & 31) * 4)) =
            make_float2(dh0, dh1);
      }
      fence_proxy_async();
      named_barrier(2 + ln.wg, 128);
#pragma unroll
      for (int ks = 0; ks < FC / KS; ++ks)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const uint32_t st = ring.acquire();
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n128k8_tf32(acc[n], desc_sw128(hid_a + ks * 64 * 128 + 32 * kk),
                                 desc_sw128(st + 32 * kk), (c | ks | kk) ? 1 : 0);
          wgmma_commit();
          ring.keep1();
        }
    }
    ring.drain();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    // LN2's backward a row a warp, from dxn2 parked in the dx1 scratch rows
    // (the warp's accumulator rows are its 16 rows): dx1 = g + its input
    // gradient; da = dx1 m staged over df for dctx; xn2 for dW1
    store_acc<false>(b.dx1, acc, ln, row0, rb, nrows);
    __syncwarp();
    const unsigned key_ao = site_key(b.seed, SITE_ATTN_OUT);
    float w2n[8], b2n[8], cs[8], cb[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      w2n[e] = prm[c0 + e];
      b2n[e] = prm[DM + c0 + e];
      cs[e] = cb[e] = 0.f;
    }
#pragma unroll 1
    for (int i = 0; i < 16; ++i) {
      const int r = rb + 16 * ln.w + i;
      float da[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) da[e] = 0.f;
      if (r < nrows) {
        const size_t row = row0 + r;
        float x[8], dy[8], xn[8], gv[8];
        load8(b.x1 + row * DM + c0, x);
        load8(b.dx1 + row * DM + c0, dy);
        ln_bwd_row(x, dy, w2n, b2n, xn, cs, cb);
        load8(b.g + row * DM + c0, gv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          gv[e] += dy[e];
          da[e] = to_tf32(drop_at(gv[e], key_ao, row, c0 + e, b.thr, b.kp));
          xn[e] = to_tf32(xn[e]);
        }
        store8(b.dx1 + row * DM + c0, gv);
        store8(b.da + row * DM + c0, da);
        store8(b.xn2 + row * DM + c0, xn);
      }
      stage8(as, r, ln.lane, da);
    }
    add_sums(cs, cb, b.small, 2 * DM, c0, tile == (int)blockIdx.x);
    fence_proxy_async();  // da, as wgmma's A operand
    named_barrier(2 + ln.wg, 128);
    // dctx = da Wo
#pragma unroll 1
    for (int k = 0; k < NSL; ++k)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const uint32_t st = ring.acquire();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k8_tf32(acc[n], desc_sw128(a_wg + k * (TR * 128) + 32 * kk),
                               desc_sw128(st + 32 * kk), (k | kk) ? 1 : 0);
        wgmma_commit();
        ring.keep1();
      }
    ring.drain();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    store_acc<true>(b.dctx, acc, ln, row0, rb, nrows);
    named_barrier(2 + ln.wg, 128);  // the warpgroup's reads of da are done before the next df
  }
}

// ---------------------------------------------------------------- (b) attention
template <int TRB>
struct AttnCfg {
  static constexpr uint32_t SMEM = (4 * TRB * LDA + TRB) * 4;
};

// the dropout factor of the probability at key k of the row whose hash is rh
// (row_hash of the probability row)
__device__ __forceinline__ float keep_factor(unsigned rh, int k, unsigned thr, float kp) {
  return thr == 0u ? 1.f : (keep_col(rh, (unsigned)k, thr) ? kp : 0.f);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

template <int TRB>
__global__ void __launch_bounds__(256, 1) bwd_attn_kernel(const __grid_constant__ Bwd b) {
  extern __shared__ float4 attn_smem[];
  float* qs = reinterpret_cast<float*>(attn_smem);
  float* ks = qs + TRB * LDA;
  float* vs = ks + TRB * LDA;
  float* cs = vs + TRB * LDA;   // dctx of the head
  float* dsum_s = cs + TRB * LDA;
  const int tile = blockIdx.x, h = blockIdx.y, S = b.S;
  const int seq0 = tile * b.nseq;
  const int nvalid = min(b.nseq, b.B - seq0);
  const int nrows = nvalid * S;
  const size_t row0 = (size_t)seq0 * S;
  const float* src = b.qkv + ((size_t)h * b.rows + row0) * 96;
  for (int e = threadIdx.x; e < TRB * 32; e += blockDim.x) {
    const int r = e >> 5, c4 = e & 31;
    const size_t rs = r < nrows ? r : 0;
    if (c4 < 24)
      cp_async16((c4 < 8 ? qs : c4 < 16 ? ks : vs) + r * LDA + 4 * (c4 & 7), src + rs * 96 + 4 * c4,
                 r < nrows);
    else
      cp_async16(cs + r * LDA + 4 * (c4 - 24), b.dctx + (row0 + rs) * DM + h * HEAD_DIM + 4 * (c4 - 24),
                 r < nrows);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  // dseq_bias: dx1 summed over each sequence, in row order
  if (h == 0 && b.dbias != nullptr)
    for (int e = threadIdx.x; e < nvalid * DM; e += blockDim.x) {
      const int sq = e / DM, col = e - sq * DM;
      const float* d1 = b.dx1 + (row0 + (size_t)sq * S) * DM + col;
      float s = 0.f;
      for (int i = 0; i < S; ++i) s += d1[(size_t)i * DM];
      b.dbias[(size_t)(seq0 + sq) * DM + col] = s;
    }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const unsigned key_ap = site_key(b.seed, SITE_ATTN_PROB);
  const float* P = b.p;

  // ---- the warp's 16 query rows: dsum, then dQ
#pragma unroll 1
  for (int blk = warp; blk < TRB / 16; blk += 8) {
    const int q0 = 16 * blk;
    if (q0 >= nrows) break;
    const int qlast = min(q0 + 15, nrows - 1);
    const int kstart = (q0 / S) * S;
    const int kend = b.causal ? qlast + 1 : (qlast / S + 1) * S;
    const int nk8 = (kend - kstart + 7) >> 3;
    int lo[2], hi[2];
    unsigned prow[2], rh[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = q0 + g + 8 * rr;
      lo[rr] = hi[rr] = 0;
      prow[rr] = 0u;
      if (i < nrows) {
        const int sq = i / S;
        lo[rr] = sq * S;
        hi[rr] = b.causal ? i + 1 : lo[rr] + S;
        prow[rr] = (unsigned)(((seq0 + sq) * NH + h) * S + (i - lo[rr]));
      }
      rh[rr] = row_hash(key_ap, prow[rr]);
    }
    uint32_t cf[4][4];  // dctx of the rows as the A fragments of the four 8-dim steps
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* c = cs + (q0 + g) * LDA + 8 * kk + t4;
      cf[kk][0] = __float_as_uint(c[0]);
      cf[kk][1] = __float_as_uint(c[8 * LDA]);
      cf[kk][2] = __float_as_uint(c[4]);
      cf[kk][3] = __float_as_uint(c[8 * LDA + 4]);
    }
    float dsum[2] = {0.f, 0.f};
    float oq[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) oq[j][0] = oq[j][1] = oq[j][2] = oq[j][3] = 0.f;
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll 1
      for (int t = 0; t < nk8; ++t) {
        // dPe of keys kstart + 8 t + [0, 8): d[i] at row g + 8 (i >> 1), key
        // 2 t4 + (i & 1) of the step
        const float* vr = vs + min(kstart + 8 * t + g, TRB - 1) * LDA + t4;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_m16n8k8_tf32(d, cf[kk], __float_as_uint(vr[8 * kk]), __float_as_uint(vr[8 * kk + 4]));
        const int j0 = kstart + 8 * t + 2 * t4;
        float ds[4];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          // the saved probabilities at keys j0 and j0 + 1 of the row, one
          // 8-byte load where both are the row's and aligned
          const int k0 = j0 - lo[rr];
          const bool in[2] = {j0 >= lo[rr] && j0 < hi[rr], j0 + 1 >= lo[rr] && j0 + 1 < hi[rr]};
          const float* at = P + (size_t)prow[rr] * S + k0;
          float pp[2] = {0.f, 0.f};
          if (in[0] && in[1] && !(reinterpret_cast<uintptr_t>(at) & 7)) {
            const float2 v = *reinterpret_cast<const float2*>(at);
            pp[0] = v.x;
            pp[1] = v.y;
          } else {
            if (in[0]) pp[0] = at[0];
            if (in[1]) pp[1] = at[1];
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * rr + e;
            ds[i] = 0.f;
            if (in[e]) {
              const float dp = d[i] * keep_factor(rh[rr], k0 + e, b.thr, b.kp);
              if (pass == 0) dsum[rr] += dp * pp[e];
              else ds[i] = pp[e] * (dp - dsum[rr]);
            }
          }
        }
        if (pass == 1) {
          // dQ += dS K over these keys, taken in the order (0, 2, 4, 6, 1, 3,
          // 5, 7): the A fragment's column t4 is key 2 t4, t4 + 4 key 2 t4 + 1
          const uint32_t a[4] = {__float_as_uint(to_tf32(ds[0])), __float_as_uint(to_tf32(ds[2])),
                                 __float_as_uint(to_tf32(ds[1])), __float_as_uint(to_tf32(ds[3]))};
          const float* k0 = ks + min(j0, TRB - 1) * LDA + g;
          const float* k1 = ks + min(j0 + 1, TRB - 1) * LDA + g;
#pragma unroll
          for (int jn = 0; jn < 4; ++jn)
            mma_m16n8k8_tf32(oq[jn], a, __float_as_uint(k0[8 * jn]), __float_as_uint(k1[8 * jn]));
        }
      }
      if (pass == 0) {
        dsum[0] = quad_sum(dsum[0]);
        dsum[1] = quad_sum(dsum[1]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = q0 + g + 8 * rr;
      if (r >= nrows) continue;
      if (t4 == 0) dsum_s[r] = dsum[rr];
      float* o = b.dqkv + (row0 + r) * QKV_W + h * HEAD_DIM + 2 * t4;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
        store2(o + 8 * jn, to_tf32(oq[jn][2 * rr] * b.scale), to_tf32(oq[jn][2 * rr + 1] * b.scale));
    }
  }
  __syncthreads();  // every row's dsum is in

  // ---- the warp's 16 key rows: dK = dS^T Q, dV = Pe^T dctx over the query
  // steps of their sequences, in order
#pragma unroll 1
  for (int blk = warp; blk < TRB / 16; blk += 8) {
    const int j0 = 16 * blk;
    if (j0 >= nrows) break;
    const int jl = min(j0 + 15, nrows - 1);
    const int qa = b.causal ? j0 : (j0 / S) * S;
    const int qend = (jl / S + 1) * S;
    const int nq8 = (qend - qa + 7) >> 3;
    int jj[2], kseq[2], klo[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      jj[rr] = j0 + g + 8 * rr;
      kseq[rr] = jj[rr] < nrows ? jj[rr] / S : -1;
      klo[rr] = kseq[rr] * S;
    }
    uint32_t vf[4][4];  // V of the key rows as the A fragments of the 8-dim steps
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* v = vs + (j0 + g) * LDA + 8 * kk + t4;
      vf[kk][0] = __float_as_uint(v[0]);
      vf[kk][1] = __float_as_uint(v[8 * LDA]);
      vf[kk][2] = __float_as_uint(v[4]);
      vf[kk][3] = __float_as_uint(v[8 * LDA + 4]);
    }
    float dk[4][4], dv[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
#pragma unroll 1
    for (int t = 0; t < nq8; ++t) {
      const int qb = qa + 8 * t;
      // dPe^T of queries qb + [0, 8): d[i] at key row g + 8 (i >> 1), query
      // 2 t4 + (i & 1) of the step
      const float* cr = cs + min(qb + g, TRB - 1) * LDA + t4;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_m16n8k8_tf32(d, vf[kk], __float_as_uint(cr[8 * kk]), __float_as_uint(cr[8 * kk + 4]));
      float ds[4], pe[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = i >> 1, j = jj[rr], q = qb + 2 * t4 + (i & 1);
        ds[i] = pe[i] = 0.f;
        // the key's sequence's queries (up to the key when causal)
        if (kseq[rr] >= 0 && q >= (b.causal ? j : klo[rr]) && q < klo[rr] + S) {
          const unsigned pr = (unsigned)(((seq0 + kseq[rr]) * NH + h) * S + (q - klo[rr]));
          const int k = j - klo[rr];
          const float p = P[(size_t)pr * S + k];
          const float km = keep_factor(row_hash(key_ap, pr), k, b.thr, b.kp);
          pe[i] = p * km;
          ds[i] = p * (d[i] * km - dsum_s[q]);
        }
      }
      // the queries in the order (0, 2, 4, 6, 1, 3, 5, 7), as dQ's keys
      const uint32_t as_[4] = {__float_as_uint(to_tf32(ds[0])), __float_as_uint(to_tf32(ds[2])),
                               __float_as_uint(to_tf32(ds[1])), __float_as_uint(to_tf32(ds[3]))};
      const uint32_t ap[4] = {__float_as_uint(to_tf32(pe[0])), __float_as_uint(to_tf32(pe[2])),
                              __float_as_uint(to_tf32(pe[1])), __float_as_uint(to_tf32(pe[3]))};
      const int qr0 = min(qb + 2 * t4, TRB - 1) * LDA + g, qr1 = min(qb + 2 * t4 + 1, TRB - 1) * LDA + g;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        mma_m16n8k8_tf32(dk[jn], as_, __float_as_uint(qs[qr0 + 8 * jn]),
                         __float_as_uint(qs[qr1 + 8 * jn]));
        mma_m16n8k8_tf32(dv[jn], ap, __float_as_uint(cs[qr0 + 8 * jn]),
                         __float_as_uint(cs[qr1 + 8 * jn]));
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (jj[rr] >= nrows) continue;
      float* o = b.dqkv + (row0 + jj[rr]) * QKV_W + h * HEAD_DIM + 2 * t4;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        store2(o + DM + 8 * jn, to_tf32(dk[jn][2 * rr] * b.scale),
               to_tf32(dk[jn][2 * rr + 1] * b.scale));
        store2(o + 2 * DM + 8 * jn, to_tf32(dv[jn][2 * rr]), to_tf32(dv[jn][2 * rr + 1]));
      }
    }
  }
}

// ---------------------------------------------------------------- (c) QKV, LN1
constexpr uint32_t QKV_STAGE = TR * 128 + DM * 128;  // a slice of dqkv's K, then of Wqkv^T's
constexpr int QKV_STAGES = 4;

struct QkvLayout {
  uint32_t ring, prm, bars, total;
  __host__ __device__ QkvLayout() {
    Carve c;
    ring = c.take(QKV_STAGES * QKV_STAGE);
    prm = c.take(2 * DM * 4, 16);
    bars = c.take(2 * QKV_STAGES * 8, 8);
    total = c.off + 1024;
  }
};

__global__ void __launch_bounds__(THREADS, 1)
    bwd_qkv_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Bwd b) {
  const QkvLayout L;
  unsigned char* base = smem_base();
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bars);
  layer_infer::RingT<QKV_STAGE> ring;
  ring.init(base + L.ring, bars, QKV_STAGES);
  if (threadIdx.x == 0) {
    init_ring_bars(bars, QKV_STAGES);
    fence_barrier_init();
  }
  __syncthreads();
  const int ntiles = (int)((b.rows + TR - 1) / TR);

  if (threadIdx.x >= CONSUMERS) {
    setmaxnreg_dec<24>();
    if (threadIdx.x != CONSUMERS) return;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x)
      for (int s = 0; s < QKV_W / KS; ++s) {
        unsigned char* st = ring.produce(QKV_STAGE);
        tma_load_2d(st, &maps.dqkv, ring.bar(), KS * s, tile * TR);
        tma_load_2d(st + TR * 128, &maps.wqkvt, ring.bar(), KS * s, 0);
        ring.advance();
      }
    return;
  }

  setmaxnreg_inc<240>();
  const Lane ln;
  float* prm = reinterpret_cast<float*>(base + L.prm);
  for (int i = ln.tid; i < 2 * DM; i += CONSUMERS) prm[i] = b.ln1[i];
  named_barrier(1, CONSUMERS);
  const int rb = 64 * ln.wg, c0 = 8 * ln.lane;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * TR;
    const int nrows = (int)min((long long)TR, b.rows - (long long)row0);
    float acc[2][64];
#pragma unroll 1
    for (int s = 0; s < QKV_W / KS; ++s) {
      const uint32_t st = ring.acquire();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t a = desc_sw128(st + rb * 128 + 32 * kk);
#pragma unroll
        for (int n = 0; n < 2; ++n)
          wgmma_m64n128k8_tf32(acc[n], a, desc_sw128(st + TR * 128 + n * 128 * 128 + 32 * kk),
                               (s | kk) ? 1 : 0);
      }
      wgmma_commit();
      ring.keep1();
    }
    ring.drain();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    // LN1's backward a row a warp, from dxn1 parked in the dy scratch rows
    store_acc<false>(b.dy, acc, ln, row0, rb, nrows);
    __syncwarp();
    float w1n[8], b1n[8], cs[8], cb[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      w1n[e] = prm[c0 + e];
      b1n[e] = prm[DM + c0 + e];
      cs[e] = cb[e] = 0.f;
    }
#pragma unroll 1
    for (int i = 0; i < 16; ++i) {
      const int r = rb + 16 * ln.w + i;
      if (r >= nrows) break;
      const size_t row = row0 + r;
      float x[8], dy[8], xn[8], d1[8];
      load8(b.x + row * DM + c0, x);
      load8(b.dy + row * DM + c0, dy);
      ln_bwd_row(x, dy, w1n, b1n, xn, cs, cb);
      load8(b.dx1 + row * DM + c0, d1);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        d1[e] += dy[e];
        xn[e] = to_tf32(xn[e]);
      }
      store8(b.dx + row * DM + c0, d1);
      store8(b.xn1 + row * DM + c0, xn);
    }
    add_sums(cs, cb, b.small, 0, c0, tile == (int)blockIdx.x);
  }
}

// each row block's 8 warp rows of LayerNorm partial sums (bwd_qkv_kernel's
// dln1, bwd_ff_kernel's dln2) added in order into the block's row after
// the [grid][8] warp rows: a block a row block (folding them in the row
// launches themselves made them spill)
__global__ void __launch_bounds__(256) fold_sums_kernel(float* small) {
  const float* rows8 = small + (size_t)blockIdx.x * (CONSUMERS / 32) * SMALL_W;
  float* fold = small + ((size_t)gridDim.x * (CONSUMERS / 32) + blockIdx.x) * SMALL_W;
  for (int e = threadIdx.x; e < SMALL_W; e += blockDim.x) {
    float sum = 0.f;
    for (int w = 0; w < CONSUMERS / 32; ++w) sum += rows8[(size_t)w * SMALL_W + e];
    fold[e] = sum;
  }
}

// ---------------------------------------------------------------- weight products
constexpr int WT_MAX = 32;        // K4: 4 products; K7: 4 a layer up to 8 layers
constexpr int WT_THREADS = 256;
constexpr uint32_t WT_A = 128 * 128, WT_B = 256 * 128, WT_BUF = WT_A + WT_B;

struct WtParams {
  const float* a[WT_MAX];  // [rows][M]
  const float* b[WT_MAX];  // [rows][N]
  int M[WT_MAX], N[WT_MAX];
  int tile0[WT_MAX + 1];
  long long out0[WT_MAX], bias0[WT_MAX];
  int nprob, rows, rows_per_split, tiles, items;
  long long total;
  float* part;             // [splits][total]
};

// A = dW's output-side operand, B its input: dW[m][n] = sum_r A[r][m] B[r][n]
// over the rows [k0, k1) of the item's split, for m in [128 mt, + 128), n in
// [256 nt, + 256); a warp's threads take a 32-row step's rows lane by lane
// (a lane reads 16 and 32 consecutive floats of its row) and write them
// transposed: every store of the warp lands in one 128-byte row of the
// swizzled K-major layout, free of bank conflicts
__global__ void __launch_bounds__(WT_THREADS, 1)
    wgrad_tf32_kernel(const __grid_constant__ WtParams p) {
  unsigned char* base = smem_base();
  float* bsum = reinterpret_cast<float*>(base + 2 * WT_BUF);
  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int w = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int bm = tid >> 1, bh = tid & 1;  // db: this thread's row of A^T and half of a step
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    const int split = item / p.tiles, t = item - split * p.tiles;
    int q = 0;
    while (q + 1 < p.nprob && t >= p.tile0[q + 1]) ++q;
    const int local = t - p.tile0[q], nn = p.N[q] / 256;
    const int mt = local / nn, nt = local - mt * nn;
    const int k0 = split * p.rows_per_split, k1 = min(k0 + p.rows_per_split, p.rows);
    const int M = p.M[q], N = p.N[q];
    const float* A = p.a[q] + 128 * mt + 16 * warp;
    const float* B = p.b[q] + 256 * nt + 32 * warp;
    const int nsteps = (k1 - k0 + 31) / 32;
    float4 ra[4], rbv[8];
    auto load = [&](int r0) {
      const int r = r0 + lane;
      const bool ok = r < k1;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ra[i] = ok ? __ldg(reinterpret_cast<const float4*>(A + (size_t)r * M + 4 * i)) : z;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        rbv[i] = ok ? __ldg(reinterpret_cast<const float4*>(B + (size_t)r * N + 4 * i)) : z;
    };
    auto store = [&](unsigned char* buf) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = 16 * warp + 4 * i;
        const float v[4] = {ra[i].x, ra[i].y, ra[i].z, ra[i].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          *reinterpret_cast<float*>(buf + swizzle128(m + e, 4 * lane)) = v[e];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int n = 32 * warp + 4 * i;
        const float v[4] = {rbv[i].x, rbv[i].y, rbv[i].z, rbv[i].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          *reinterpret_cast<float*>(buf + WT_A + swizzle128(n + e, 4 * lane)) = v[e];
      }
    };
    float acc[2][64];
    float bs = 0.f;
    load(k0);
    store(base);
#pragma unroll 1
    for (int s = 0; s < nsteps; ++s) {
      unsigned char* cur = base + (s & 1) * WT_BUF;
      fence_proxy_async();
      __syncthreads();
      const uint32_t a_s = smem_u32(cur) + wg * 64 * 128, b_s = smem_u32(cur) + WT_A;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int n = 0; n < 2; ++n)
          wgmma_m64n128k8_tf32(acc[n], desc_sw128(a_s + 32 * kk),
                               desc_sw128(b_s + n * 128 * 128 + 32 * kk), (s | kk) ? 1 : 0);
      wgmma_commit();
      if (nt == 0) {
#pragma unroll
        for (int k = 0; k < 16; ++k)
          bs += *reinterpret_cast<const float*>(cur + swizzle128(bm, 4 * (16 * bh + k)));
      }
      if (s + 1 < nsteps) {
        load(k0 + 32 * (s + 1));
        store(base + ((s + 1) & 1) * WT_BUF);
      }
      wgmma_wait<0>();
    }
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    float* out = p.part + (size_t)split * p.total;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int m = 128 * mt + 64 * wg + 16 * w + g + 8 * rr;
      float* o = out + p.out0[q] + (size_t)m * N + 256 * nt + 2 * t4;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<float2*>(o + 128 * n + 8 * j) =
              make_float2(acc[n][4 * j + 2 * rr], acc[n][4 * j + 2 * rr + 1]);
    }
    if (nt == 0) bsum[tid] = bs;
    __syncthreads();  // bsum, and every thread's reads of the buffers, are done
    if (nt == 0 && bh == 0) out[p.bias0[q] + 128 * mt + bm] = bs + bsum[tid + 1];
  }
}

template <class K>
int prepare(K kernel, uint32_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

int row_grid(long long rows) {
  return std::min((int)((rows + TR - 1) / TR), sm_count());
}

template <int TRB>
int launch_attn(Bwd b, cudaStream_t stream) {
  b.nseq = TRB / b.S;
  const int ntiles = (b.B + b.nseq - 1) / b.nseq;
  const int rc = prepare(bwd_attn_kernel<TRB>, AttnCfg<TRB>::SMEM);
  if (rc) return rc;
  bwd_attn_kernel<TRB><<<dim3(ntiles, NH), 256, AttnCfg<TRB>::SMEM, stream>>>(b);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace layer_f32_bwd

// The row launches' persistent grid: their LayerNorm partial sums are
// [grid][8 warps][4 D] (the third launch's dln1, then the first's dln2),
// then each block's sum of its 8 rows, [grid][4 D].
extern "C" int dsvg_layer_f32_bwd_grid(int B, int S) {
  return layer_f32_bwd::row_grid((long long)B * S);
}

// K4's float32 long form, saved-mode backward: the three row launches. `t`:
// x, g, ln1, ln2, qkv_s, p_s, x1_s, h_s (the forward's, dsvg_layer_f32_train);
// wqkv^T [D][3D], wo^T [D][D], w1^T [D][F], w2^T [F][D] (float32 rounded to
// TF32); then dx, dbias [B][D], xn1, dqkv, da, xn2, dhpre, hd, df (the weight
// products' operands, [B*S][..]), small [grid * 9][4 D], and the scratch dx1,
// dctx, dy ([B*S][D]). The weight products follow in dsvg_wgrad_tf32.
extern "C" int dsvg_layer_f32_train_bwd(void* const* t, int B, int S, int F, int causal, int seed,
                                        int thr, float kp, float scale, void* stream) {
  using namespace layer_f32_bwd;
  if (B < 1 || S < 1 || S > 256 || F % 256 || F > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Bwd b;
  b.x = (const float*)t[0];
  b.g = (const float*)t[1];
  b.ln1 = (const float*)t[2];
  b.ln2 = (const float*)t[3];
  b.qkv = (const float*)t[4];
  b.p = (const float*)t[5];
  b.x1 = (const float*)t[6];
  b.h = (const float*)t[7];
  b.dx = (float*)t[12];
  b.dbias = (float*)t[13];
  b.xn1 = (float*)t[14];
  b.dqkv = (float*)t[15];
  b.da = (float*)t[16];
  b.xn2 = (float*)t[17];
  b.dhpre = (float*)t[18];
  b.hd = (float*)t[19];
  b.df = (float*)t[20];
  b.small = (float*)t[21];
  b.dx1 = (float*)t[22];
  b.dctx = (float*)t[23];
  b.dy = (float*)t[24];
  b.rows = (long long)B * S;
  b.B = B;
  b.S = S;
  b.F = F;
  b.causal = causal;
  b.seed = seed;
  b.nseq = 0;
  b.thr = (unsigned)thr;
  b.kp = kp;
  b.scale = scale;
  Maps m;
  int rc = bind_device_of(t[0]);
  if (rc == 0) rc = make_tma_2d(&m.w2t, t[11], true, DM, F, DM * 4, KS, 64);
  if (rc == 0) rc = make_tma_2d(&m.w1t, t[10], true, F, DM, (uint64_t)F * 4, KS, 128);
  if (rc == 0) rc = make_tma_2d(&m.wot, t[9], true, DM, DM, DM * 4, KS, 128);
  if (rc == 0) rc = make_tma_2d(&m.dqkv, t[15], true, QKV_W, (uint64_t)b.rows, QKV_W * 4, KS, TR);
  if (rc == 0) rc = make_tma_2d(&m.wqkvt, t[8], true, QKV_W, DM, QKV_W * 4, KS, DM);
  if (rc) return rc;
  const int grid = row_grid(b.rows);
  const uint32_t ff_smem = FfLayout().total, qkv_smem = QkvLayout().total;
  if ((rc = prepare(bwd_ff_kernel, ff_smem)) || (rc = prepare(bwd_qkv_kernel, qkv_smem))) return rc;
  bwd_ff_kernel<<<grid, THREADS, ff_smem, st>>>(m, b);
  if ((rc = (int)cudaGetLastError())) return rc;
  rc = S <= 32 ? launch_attn<128>(b, st) : launch_attn<256>(b, st);
  if (rc) return rc;
  bwd_qkv_kernel<<<grid, THREADS, qkv_smem, st>>>(m, b);
  if ((rc = (int)cudaGetLastError())) return rc;
  fold_sums_kernel<<<grid, 256, 0, st>>>(b.small);
  return (int)cudaGetLastError();
}

// nprob <= 32 float32 problems (K4's 4, K7's 4 a layer): a[q] [rows][M[q]],
// b[q] [rows][N[q]], M[q] a multiple of 128, N[q] of 256; rows_per_split a
// multiple of 32 and every
// split holding rows. part is [splits][sum M N + sum M]: each slice holds the
// dW in order, then the db (the column sums of each a[q]) in order.
extern "C" int dsvg_wgrad_tf32(void* const* a, void* const* b, const int* M, const int* N,
                               int nprob, int rows, int rows_per_split, int splits, void* part,
                               void* stream) {
  using namespace layer_f32_bwd;
  if (nprob < 1 || nprob > WT_MAX || rows_per_split % 32 || rows < 1 ||
      (long long)(splits - 1) * rows_per_split >= rows)
    return (int)cudaErrorInvalidValue;
  WtParams p;
  int tiles = 0;
  long long total = 0;
  for (int q = 0; q < nprob; ++q) {
    if (M[q] % 128 || N[q] % 256) return (int)cudaErrorInvalidValue;
    p.a[q] = (const float*)a[q];
    p.b[q] = (const float*)b[q];
    p.M[q] = M[q];
    p.N[q] = N[q];
    p.tile0[q] = tiles;
    p.out0[q] = total;
    tiles += (M[q] / 128) * (N[q] / 256);
    total += (long long)M[q] * N[q];
  }
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
  const uint32_t smem = 2 * WT_BUF + WT_THREADS * 4 + 1024;
  int rc = prepare(wgrad_tf32_kernel, smem);
  if (rc) return rc;
  wgrad_tf32_kernel<<<std::min(p.items, sm_count()), WT_THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
