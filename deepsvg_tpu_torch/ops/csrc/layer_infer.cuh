// K2's bfloat16 inference forms for Hopper (see ops/layer.py): the fused
// pre-LN layer LN1 -> QKV -> masked softmax(Q K^T / sqrt(32)) V -> out
// projection -> residual -> + seq_bias -> LN2 -> ReLU FF -> residual, at
// D = 256 (8 heads of 32), F a multiple of 64 up to 1024.
//
// Replaces deepsvg_tpu/ops/layer.py:_layer_kernel (wrapper fused_layer) in
// bfloat16. What bounds the layer on the H100 is the tensor cores: the four
// products are 2 (4 D^2 + 2 D F) = 1.05 MFLOP a row, against 1 KB a row of
// input and output (E1 at N=1024: 0.28 ms at 989 TFLOP/s bf16, the bytes
// 0.08 ms). The design keeps every intermediate on chip and feeds the tensor
// cores from shared memory:
//
// * Persistent blocks (one per SM) of three warpgroups: one producer warp
//   streams the tile's x and the layer's weights with TMA, in 16 KB stages
//   (one 128-byte slice of K), through an mbarrier ring; two consumer
//   warpgroups (240 registers a thread against the producer's 24, by
//   setmaxnreg) run the four products on wgmma (bf16 m64nNk16, f32
//   accumulators), each on 64 rows of a 128-row tile, both reading the same
//   weight stages: the weights come from L2 once per 128 rows. The small
//   parameters (biases, LayerNorm weights) and the tile's mask sit in shared
//   memory as float.
// * The short form (S <= 32, infer_short_kernel) takes tiles of 128 / S
//   whole sequences (E1 4 x 32, D1 4 x 31, D2 16 x 8, S=17 7 x 17). LN1 reads
//   x from the ring and writes its output to shared memory (64 KB, the
//   128-byte swizzle wgmma reads). Head by head, a 64 x 96 product gives the
//   head's Q, K and V: Q stays in registers as the A fragments of Q K^T, K
//   and V go to shared memory. Each warp then attends its 16 query rows
//   against the keys of the sequences they lie in (at most 64) with mma.sync
//   m16n8k16: the scores, the exact softmax in registers (max-subtracted,
//   the probabilities rounded to bf16 and reused as the A fragments of P V),
//   the context rounded to bf16 into shared memory (64 KB). The out
//   projection accumulates onto x + bo + seq_bias, loaded into its
//   accumulators (128 a thread): they hold the residual from there on. LN2
//   writes its output over LN1's; the FF runs in 64-column chunks of the
//   hidden, each chunk's ReLU output staged by stmatrix in the context's
//   (now idle) shared memory as the A operand of FF2, which accumulates into
//   the residual (b2 added first) while the next chunk's FF1 is issued.
// * The long form (33 <= S <= 256) is two launches. infer_qkv_kernel runs
//   LN1 and the QKV product as above over 128-row tiles of all B*S rows and
//   writes QKV (bf16) to a scratch tensor, head-major ([H][B*S][96]) so that
//   the second launch reads a head's rows contiguously. infer_attn_ffn_kernel
//   takes tiles of 256 / S whole sequences (at most 256 rows; one sequence at
//   S=242): head by head, the tile's K and V come into shared memory once,
//   and each warp attends two 16-row query blocks against all their keys
//   (up to 256, every score in registers: the softmax stays exact and
//   two-pass); the context goes to shared memory (128 KB) as the out
//   projection's A operand. Then per 128-row half: the out projection, LN2
//   (over the context rows it has read), the FF (its hidden staged in the
//   idle K/V buffer) and the store, as the short form.
//
// The roundings are layer_reference's: LN outputs, QKV, the normalized
// probabilities, the context and the FF hidden in bf16; residual, sums and
// softmax in f32. A query whose keys are all masked gets zero probabilities.
// Nothing is summed across threads in a data-dependent order: the same
// inputs give the same output to the bit.
#pragma once

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

// The device code is in an anonymous namespace: layer.cu, which holds the
// short form's kernel, and layer_long.cu, which holds the long form's two,
// each compile their own copy.
namespace layer_infer {
namespace {

using namespace hopper;

constexpr int DM = 256;              // the model width these forms take
constexpr int NH = DM / HEAD_DIM;    // heads
constexpr int KSL = DM / 64;         // 128-byte slices of a row of D
constexpr int MAX_F = 1024;          // the widest FF hidden these forms take
constexpr int THREADS = 384;         // two consumer warpgroups, then the producer's
constexpr int CONSUMERS = 256;
constexpr int TR = 128;              // rows of a product tile
constexpr int LONG_TR = 256;         // rows of the long form's attention tile
constexpr int LONG_S = 256;          // the long form's largest S (ops/layer.py:MAX_SEQ_LONG)
constexpr uint32_t STAGE = 16384;    // bytes of a weight stage
constexpr int FC = 64;               // FF hidden columns a chunk
constexpr int LDH = 40;              // bf16 a row of the per-head K and V (80 bytes)
constexpr int LDQ = 104;             // bf16 a row of a head's staged QKV (208 bytes)
constexpr float L2E = 1.4426950408889634f;

// the small parameters as float in shared memory, in this order: those the
// layer needs after the attention (bo, LN2, b2, b1: all that the long form's
// second launch loads), then LN1's and the QKV bias
constexpr int P_BO = 0, P_LN2W = 256, P_LN2B = 512, P_B2 = 768, P_B1 = 1024;
__host__ __device__ constexpr int p_ln1w(int F) { return P_B1 + F; }
__host__ __device__ constexpr int p_ln1b(int F) { return P_B1 + F + DM; }
__host__ __device__ constexpr int p_bqkv(int F) { return P_B1 + F + 2 * DM; }
__host__ __device__ constexpr int params_all(int F) { return P_B1 + F + 5 * DM; }
__host__ __device__ constexpr int params_after(int F) { return P_B1 + F; }

struct Params {
  const bf16* x;         // [B*S][D]
  const bf16* seq_bias;  // [B][D] or null
  const bf16* ln1;       // [2][D]
  const bf16* bqkv;      // [3D]
  const bf16* bo;
  const bf16* ln2;
  const bf16* b1;        // [F]
  const bf16* b2;
  const float* mask;     // [B][S] additive
  bf16* out;             // [B*S][D]
  bf16* qkv;             // long form: [H][B*S][96], head h's q | k | v
  int B, S, F, causal;
  int nseq, ntiles;      // whole sequences a tile, tiles
  float scale;
};

// a consumer thread's place: warpgroup wg, warp w in it, lane, the rows r0
// and r0 + 8 (of the warpgroup's 64) it holds in a wgmma accumulator or an
// mma.sync fragment, and its column pair 2 t4 in every group of 8 columns
struct Lane {
  int tid, wg, w, lane, g, t4, r0;
  __device__ __forceinline__ Lane() {
    tid = threadIdx.x;
    wg = tid >> 7;
    w = (tid >> 5) & 3;
    lane = tid & 31;
    g = lane >> 2;
    t4 = lane & 3;
    r0 = 16 * w + g;
  }
};

__device__ __forceinline__ float2 ldg2(const bf16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// the first `n` of the small parameters (in the P_ order) into prm, by the
// consumer threads
__device__ __forceinline__ void load_params(const Params& p, float* prm, int n) {
  for (int i = threadIdx.x; i < n; i += CONSUMERS) {
    const bf16* src;
    if (i < P_LN2W) src = p.bo + i;
    else if (i < P_B2) src = p.ln2 + (i - P_LN2W);
    else if (i < P_B1) src = p.b2 + (i - P_B2);
    else if (i < p_ln1w(p.F)) src = p.b1 + (i - P_B1);
    else if (i < p_bqkv(p.F)) src = p.ln1 + (i - p_ln1w(p.F));
    else src = p.bqkv + (i - p_bqkv(p.F));
    prm[i] = bf2f(*src);
  }
}

// ---------------------------------------------------------------- the weight ring
// SB: bytes a stage (the training backward's row products stage 48 KB)
template <uint32_t SB = STAGE>
struct RingT {
  unsigned char* buf;
  uint64_t* full;
  uint64_t* empty;
  int n;
  PipeState ps;
  int pending = -1;  // consumer: the stage whose last wgmma group may still run

  __device__ __forceinline__ void init(unsigned char* b, uint64_t* bars, int stages) {
    buf = b;
    full = bars;
    empty = bars + stages;
    n = stages;
  }
  // producer: a free stage that expects `bytes`; load into it, then advance()
  __device__ __forceinline__ unsigned char* produce(uint32_t bytes) {
    mbar_wait(&empty[ps.stage], ps.phase ^ 1);
    mbar_arrive_expect_tx(&full[ps.stage], bytes);
    return buf + ps.stage * SB;
  }
  __device__ __forceinline__ uint64_t* bar() { return &full[ps.stage]; }
  __device__ __forceinline__ void advance() { ps.advance(n); }
  // consumer: the shared address of the next full stage
  __device__ __forceinline__ uint32_t acquire() {
    mbar_wait(&full[ps.stage], ps.phase);
    return smem_u32(buf + ps.stage * SB);
  }
  // consumer, after committing the wgmma group that reads the acquired
  // stage: release the stage before it once its group is done
  __device__ __forceinline__ void keep1() {
    wgmma_wait<1>();
    if (pending >= 0) mbar_arrive(&empty[pending]);
    pending = ps.stage;
    ps.advance(n);
  }
  // consumer: every group done, every stage released
  __device__ __forceinline__ void drain() {
    wgmma_wait<0>();
    if (pending >= 0) mbar_arrive(&empty[pending]);
    pending = -1;
  }
  // consumer: the next KSL stages (a tile of x, read by plain loads; every
  // group drained before), waited for; release them with release_x()
  __device__ __forceinline__ void acquire_x(const unsigned char* (&st)[KSL]) {
    PipeState t = ps;
#pragma unroll
    for (int k = 0; k < KSL; ++k) {
      mbar_wait(&full[t.stage], t.phase);
      st[k] = buf + t.stage * SB;
      t.advance(n);
    }
  }
  __device__ __forceinline__ void release_x() {
#pragma unroll
    for (int k = 0; k < KSL; ++k) {
      mbar_arrive(&empty[ps.stage]);
      ps.advance(n);
    }
  }
};
using Ring = RingT<>;

__device__ __forceinline__ void init_ring_bars(uint64_t* bars, int n) {
  for (int i = 0; i < n; ++i) {
    mbar_init(&bars[i], 1);
    mbar_init(&bars[n + i], CONSUMERS);
  }
}

struct Maps {
  CUtensorMap qkv, o, w1, w2, x;  // boxes {64, 32}, {64, 128}, {64, 64}, {64, 128}, {64, 128}
};

// producer: a tile of x (KSL stages of 128 rows from `row0`), the stages of one
// head's Q, K and V weights (three 32-row boxes per slice of K), of the out
// projection (slice k, 128-row half n) and of the FF (per 64-column chunk:
// W1's two stages of two slices, W2's two halves)
__device__ __forceinline__ void produce_x(Ring& r, const Maps& m, int row0) {
  for (int k = 0; k < KSL; ++k) {
    unsigned char* st = r.produce(STAGE);
    tma_load_2d(st, &m.x, r.bar(), 64 * k, row0);
    r.advance();
  }
}

__device__ __forceinline__ void produce_qkv_head(Ring& r, const Maps& m, int h) {
  for (int k = 0; k < KSL; ++k) {
    unsigned char* st = r.produce(3 * 32 * 128);
    for (int part = 0; part < 3; ++part)
      tma_load_2d(st + part * 4096, &m.qkv, r.bar(), 64 * k, part * DM + h * HEAD_DIM);
    r.advance();
  }
}

__device__ __forceinline__ void produce_out_ff(Ring& r, const Maps& m, int F) {
  for (int k = 0; k < KSL; ++k)
    for (int n = 0; n < DM / 128; ++n) {
      unsigned char* st = r.produce(STAGE);
      tma_load_2d(st, &m.o, r.bar(), 64 * k, 128 * n);
      r.advance();
    }
  for (int c = 0; c < F / FC; ++c) {
    for (int kp = 0; kp < KSL / 2; ++kp) {
      unsigned char* st = r.produce(STAGE);
      tma_load_2d(st, &m.w1, r.bar(), 64 * (2 * kp), FC * c);
      tma_load_2d(st + 8192, &m.w1, r.bar(), 64 * (2 * kp + 1), FC * c);
      r.advance();
    }
    for (int n = 0; n < DM / 128; ++n) {
      unsigned char* st = r.produce(STAGE);
      tma_load_2d(st, &m.w2, r.bar(), FC * c, 128 * n);
      r.advance();
    }
  }
}

// ---------------------------------------------------------------- LayerNorm 1
// LN1 of the 16 tile rows [rb, rb + 16) (rows >= nrows zero), one row a warp
// at a time, 8 columns a lane, from the tile of x in the ring's stages into
// xn: both [KSL slices][128 rows][128 bytes], 128-byte swizzled
__device__ __forceinline__ void ln1_rows(const float* prm, int F, const unsigned char* (&xs)[KSL],
                                         int nrows, int rb, int lane, unsigned char* xn) {
  float w[8], b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    w[j] = prm[p_ln1w(F) + 8 * lane + j];
    b[j] = prm[p_ln1b(F) + 8 * lane + j];
  }
  const unsigned char* src = xs[lane >> 3];
  unsigned char* dst = xn + (lane >> 3) * TR * 128;
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int r = rb + i;
    const uint32_t at = r * 128 + (((lane & 7) ^ (r & 7)) << 4);
    uint4 o = make_uint4(0, 0, 0, 0);
    if (r < nrows) {
      const uint4 u = *reinterpret_cast<const uint4*>(src + at);
      const bf16* e = reinterpret_cast<const bf16*>(&u);
      float v[8];
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = bf2f(e[j]);
        s += v[j];
      }
      const float mu = warp_sum(s) / DM;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] -= mu;
        q += v[j] * v[j];
      }
      const float rstd = rsqrtf(warp_sum(q) / DM + LN_EPS);
      o.x = pack_bf16(v[0] * rstd * w[0] + b[0], v[1] * rstd * w[1] + b[1]);
      o.y = pack_bf16(v[2] * rstd * w[2] + b[2], v[3] * rstd * w[3] + b[3]);
      o.z = pack_bf16(v[4] * rstd * w[4] + b[4], v[5] * rstd * w[5] + b[5]);
      o.w = pack_bf16(v[6] * rstd * w[6] + b[6], v[7] * rstd * w[7] + b[7]);
    }
    *reinterpret_cast<uint4*>(dst + at) = o;
  }
}

// the consumers' LN1 of a tile: wait for x's stages, LN1 the warp's 16 rows
// into xn, release the stages, make xn visible to wgmma (the warpgroup reads
// only its own rows)
__device__ __forceinline__ void ln1_tile(Ring& ring, const float* prm, int F, int nrows,
                                         const Lane& ln, unsigned char* xn) {
  const unsigned char* xs[KSL];
  ring.acquire_x(xs);
  ln1_rows(prm, F, xs, nrows, 64 * ln.wg + 16 * ln.w, ln.lane, xn);
  ring.release_x();
  fence_proxy_async();
  named_barrier(2 + ln.wg, 128);
}

// ---------------------------------------------------------------- QKV of one head
// acc[64 x 96] = the warpgroup's LN1 rows (xn_a: their first row in slice 0;
// slices `slice` bytes apart) x (Wq | Wk | Wv of the head)^T, from KSL stages
__device__ __forceinline__ void qkv_head_product(Ring& r, uint32_t xn_a, uint32_t slice,
                                                 float (&acc)[48]) {
#pragma unroll 1
  for (int k = 0; k < KSL; ++k) {
    const uint32_t st = r.acquire();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n96k16_bf16(acc, desc_sw128(xn_a + k * slice + 32 * kk), desc_sw128(st + 32 * kk),
                           (k | kk) ? 1 : 0);
    wgmma_commit();
    r.keep1();
  }
  r.drain();
  fence_acc(acc);
}

// ---------------------------------------------------------------- attention
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL_MASK, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL_MASK, v, 1);
  return v + __shfl_xor_sync(FULL_MASK, v, 2);
}

// The context of the 16 query rows [q0, q0 + 16) of a tile of `nrows` valid
// rows (whole sequences of S) for one head: each row attends to the keys of
// its sequence (up to itself when causal) with the additive mask mask[j] of
// tile row j (shared memory). qf: the rows' Q as mma A fragments (head dims
// 0-15, 16-31); ks, vs: the tile's K and V rows, LDH bf16 apart, `krows` of
// them. o: the context in the mma accumulator layout, o[j] holding head dims
// 8 j + [0, 8). MAXT: the most 16-key steps a warp's share of the rows' keys
// spans (4 in the short form, 16 in the long): every score stays in
// registers, so the softmax is exact and two-pass, each probability 2^(s -
// max) / sum rounded to bf16 before P V, as the plain version's.
// `drop.pair(p0, p1, rr, j)` gives the probabilities of the thread's row rr
// (tile row q0 + lane / 4 + 8 rr) at key rows j and j + 1 as P V takes them,
// packed (the training forward's dropout and save, layer_train.cuh); K2 takes
// them as they are.
//
// NSPLIT > 1 splits the rows' key steps over NSPLIT warps (part 0..NSPLIT-1,
// each calling with the same rows; fewer score registers a thread, so that
// more blocks share an SM): they exchange their row maxima, then their row
// sums (added in part order), through x behind the named barrier `bar` of
// their 32 NSPLIT threads, and part 0 adds the others' partial contexts to
// its own in part order; its o is the rows' context.
struct NoDrop {
  __device__ __forceinline__ uint32_t pair(float p0, float p1, int, int) const {
    return pack_bf16(p0, p1);
  }
};

template <int NSPLIT>
struct SplitXch {
  float m[NSPLIT][16];
  float l[NSPLIT][16];
  float o[NSPLIT - 1][16][HEAD_DIM + 1];  // the partial contexts of parts 1.., padded
};
template <>
struct SplitXch<1> {};

template <int MAXT, class Drop = NoDrop, int NSPLIT = 1>
__device__ __forceinline__ void attend_rows(const uint32_t (&qf)[2][4], uint32_t ks, uint32_t vs,
                                            int krows, int q0, int nrows, int S, int causal,
                                            const float* mask, float scale, int lane,
                                            float (&o)[4][4], const Drop& drop = Drop(),
                                            int part = 0, SplitXch<NSPLIT>* x = nullptr,
                                            int bar = 0) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  if (q0 >= nrows) return;
  const int qlast = min(q0 + 15, nrows - 1);
  const int kstart = (q0 / S) * S;
  const int kend = causal ? qlast + 1 : (qlast / S + 1) * S;
  const int nkt = (kend - kstart + 15) >> 4;
  // this warp's key steps [u0, u0 + nu)
  const int per = (nkt + NSPLIT - 1) / NSPLIT;
  const int u0 = NSPLIT == 1 ? 0 : part * per;
  const int nu = NSPLIT == 1 ? nkt : max(0, min(nkt, u0 + per) - u0);
  int lo[2], hi[2];  // the key range of rows g and g + 8
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = q0 + g + 8 * rr;
    lo[rr] = hi[rr] = 0;
    if (i < nrows) {
      lo[rr] = (i / S) * S;
      hi[rr] = causal ? i + 1 : lo[rr] + S;
    }
  }
  // the scores of key tile t (keys kstart + 8 (2 u0 + t) + [0, 8)) in log2
  // units, q k scale + mask[key], -inf where the key is not the row's
  const float sl = scale * L2E;
  float s[2 * MAXT][4];
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int t = 0; t < 2 * MAXT; ++t) {
    s[t][0] = s[t][1] = s[t][2] = s[t][3] = -INFINITY;
    if (t < 2 * nu) {
      const int kt = 2 * u0 + t;
      const int kr = min(kstart + 8 * kt + (lane & 7), krows - 1);
      uint32_t b[4];
      ldmatrix_x4<false>(b, ks + kr * (LDH * 2) + (lane >> 3) * 16);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_m16n8k16_bf16(d, qf[0], b[0], b[1]);
      mma_m16n8k16_bf16(d, qf[1], b[2], b[3]);
      const int j0 = kstart + 8 * kt + 2 * t4;
      const float mv[2] = {j0 < kend ? mask[j0] * L2E : 0.f,
                           j0 + 1 < kend ? mask[j0 + 1] * L2E : 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = j0 + (i & 1), rr = i >> 1;
        if (j >= lo[rr] && j < hi[rr]) s[t][i] = fmaf(d[i], sl, mv[i & 1]);
        m[rr] = fmaxf(m[rr], s[t][i]);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) m[rr] = quad_max(m[rr]);
  if constexpr (NSPLIT > 1) {  // the rows' maxima over every part
    if (t4 == 0) {
      x->m[part][g] = m[0];
      x->m[part][g + 8] = m[1];
    }
    named_barrier(bar, 32 * NSPLIT);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      m[rr] = x->m[0][g + 8 * rr];
#pragma unroll
      for (int q = 1; q < NSPLIT; ++q) m[rr] = fmaxf(m[rr], x->m[q][g + 8 * rr]);
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    if (m[rr] == -INFINITY) m[rr] = 0.f;  // no key: every exponential is 0
  float sum[2] = {0.f, 0.f}, inv[2];
#pragma unroll
  for (int t = 0; t < 2 * MAXT; ++t)
    if (t < 2 * nu)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[t][i] = ex2(s[t][i] - m[i >> 1]);
        sum[i >> 1] += s[t][i];
      }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) sum[rr] = quad_sum(sum[rr]);
  if constexpr (NSPLIT > 1) {  // the rows' sums, in part order
    if (t4 == 0) {
      x->l[part][g] = sum[0];
      x->l[part][g + 8] = sum[1];
    }
    named_barrier(bar, 32 * NSPLIT);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      sum[rr] = x->l[0][g + 8 * rr];
#pragma unroll
      for (int q = 1; q < NSPLIT; ++q) sum[rr] += x->l[q][g + 8 * rr];
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) inv[rr] = sum[rr] > 0.f ? 1.f / sum[rr] : 0.f;
  // o += P V, 16 keys a step; P's accumulator tiles 2 uu and 2 uu + 1 are
  // the A fragment of step u0 + uu
#pragma unroll
  for (int uu = 0; uu < MAXT; ++uu) {
    if (uu < nu) {
      const int u = u0 + uu;
      uint32_t a[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* sv = s[2 * uu + (q >> 1)];
        const int rr = q & 1, j = kstart + 16 * u + 8 * (q >> 1) + 2 * t4;
        a[q] = drop.pair(sv[2 * rr] * inv[rr], sv[2 * rr + 1] * inv[rr], rr, j);
      }
      const int kr = min(kstart + 16 * u + (lane & 7) + ((lane >> 3) & 1) * 8, krows - 1);
#pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        uint32_t b[4];
        ldmatrix_x4<true>(b, vs + kr * (LDH * 2) + (16 * dp + 8 * (lane >> 4)) * 2);
        mma_m16n8k16_bf16(o[2 * dp], a, b[0], b[1]);
        mma_m16n8k16_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }
  if constexpr (NSPLIT > 1) {  // part 0 adds the others' contexts, in part order
    if (part > 0)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x->o[part - 1][g + 8 * (e >> 1)][8 * j + 2 * t4 + (e & 1)] = o[j][e];
    named_barrier(bar, 32 * NSPLIT);
    if (part == 0)
#pragma unroll
      for (int q = 1; q < NSPLIT; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[j][e] += x->o[q - 1][g + 8 * (e >> 1)][8 * j + 2 * t4 + (e & 1)];
  }
}

// the context of a warp's 16 rows for head h (attend_rows' o), rounded to
// bf16, into ctx: [KSL][rows][128 bytes], 128-byte swizzled
__device__ __forceinline__ void store_ctx(unsigned char* ctx, int rows, int q0, int h,
                                          const float (&o)[4][4], int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = h * HEAD_DIM + 8 * j + 2 * (lane & 3);
    unsigned char* dst = ctx + (col >> 6) * rows * 128;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      *reinterpret_cast<uint32_t*>(dst + swizzle128(q0 + (lane >> 2) + 8 * rr, (col & 63) * 2)) =
          pack_bf16(o[j][2 * rr], o[j][2 * rr + 1]);
  }
}

// ---------------------------------------------------------------- after the attention
// The warpgroup's 64 rows, tile rows [rb, rb + 64) of a tile whose first
// row is global row `row0` and first sequence `seq0`.
struct Rows {
  size_t row0;
  int seq0, nrows, rb, S;
};

// acc = x + bo (+ seq_bias) of the warpgroup's rows: the out projection
// accumulates onto it
__device__ __forceinline__ void residual_init(const Params& p, const float* prm, const Lane& ln,
                                              const Rows& R, float (&acc)[2][64]) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = R.rb + ln.r0 + 8 * rr;
    const bool valid = r < R.nrows;
    const bf16* xr = p.x + (R.row0 + (valid ? r : 0)) * DM;
    const bf16* sb = p.seq_bias != nullptr ? p.seq_bias + (size_t)(R.seq0 + (valid ? r : 0) / R.S) * DM
                                           : nullptr;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 128 * n + 8 * j + 2 * ln.t4, i = 4 * j + 2 * rr;
        const float2 xv = ldg2(xr + col), bo = lds2(prm + P_BO + col);
        float v0 = xv.x + bo.x, v1 = xv.y + bo.y;
        if (sb != nullptr) {
          const float2 bv = ldg2(sb + col);
          v0 += bv.x;
          v1 += bv.y;
        }
        acc[n][i] = v0;
        acc[n][i + 1] = v1;
      }
  }
}

// LN2 of the residual in acc, rounded to bf16, into `xn` ([KSL][rows][128],
// swizzled, at the warpgroup's rows rb..); then acc += b2, so that FF2
// accumulates into the residual
__device__ __forceinline__ void ln2_rows(const float* prm, const Lane& ln, const Rows& R,
                                         float (&acc)[2][64], unsigned char* xn, int rows) {
  float mu[2], rstd[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float s = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 16; ++j) s += acc[n][4 * j + 2 * rr] + acc[n][4 * j + 2 * rr + 1];
    s += __shfl_xor_sync(FULL_MASK, s, 1);
    s += __shfl_xor_sync(FULL_MASK, s, 2);
    mu[rr] = s / DM;
    float q = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = acc[n][4 * j + 2 * rr + e] - mu[rr];
          q += d * d;
        }
    q += __shfl_xor_sync(FULL_MASK, q, 1);
    q += __shfl_xor_sync(FULL_MASK, q, 2);
    rstd[rr] = rsqrtf(q / DM + LN_EPS);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 128 * n + 8 * j + 2 * ln.t4;
      const float2 w = lds2(prm + P_LN2W + col), b = lds2(prm + P_LN2B + col),
                   b2 = lds2(prm + P_B2 + col);
      unsigned char* dst = xn + (col >> 6) * rows * 128;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = 4 * j + 2 * rr, r = R.rb + ln.r0 + 8 * rr;
        const float y0 = (acc[n][i] - mu[rr]) * rstd[rr] * w.x + b.x;
        const float y1 = (acc[n][i + 1] - mu[rr]) * rstd[rr] * w.y + b.y;
        *reinterpret_cast<uint32_t*>(dst + swizzle128(r, (col & 63) * 2)) = pack_bf16(y0, y1);
        acc[n][i] += b2.x;
        acc[n][i + 1] += b2.y;
      }
    }
}

// relu(hacc + b1) of a 64 x 64 chunk of the hidden (b1: the chunk's first
// column's bias), rounded to bf16, to shared memory at dst by stmatrix:
// K-major, row r at r * 128 bytes, 128-byte swizzled. The 8x8 block (j, rr)
// holds rows 16 w + 8 rr + [0, 8) and columns 8 j + [0, 8); one stmatrix
// stores four of them.
__device__ __forceinline__ void stage_hidden(uint32_t dst, const float (&hacc)[32],
                                             const float* b1, const Lane& ln) {
  const int mi = ln.lane >> 3, k = ln.lane & 7;
  uint32_t v[16];
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const float2 b = lds2(b1 + 8 * (i >> 2) + 2 * ln.t4);
    v[i >> 1] = pack_bf16(fmaxf(hacc[i] + b.x, 0.f), fmaxf(hacc[i + 1] + b.y, 0.f));
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = 2 * q + (mi >> 1), rr = mi & 1;
    // block (2 q + b, rr) is matrix 2 b + rr: elements 8 q + 4 b + 2 rr and + 1
    stmatrix_x4<false>(dst + swizzle128(16 * ln.w + 8 * rr + k, 16 * j), v[4 * q], v[4 * q + 1],
                       v[4 * q + 2], v[4 * q + 3]);
  }
}

// FF over the warpgroup's LN2 rows (xn_a: their first row in slice 0, slices
// `slice` bytes apart): per 64-column chunk of the hidden, FF1 on wgmma, ReLU
// and bf16 into one of the warpgroup's two hidden buffers (hbuf, hbuf +
// hstride: 8 KB each, idle shared memory), FF2 from there into acc, running
// on while the next chunk's FF1 is issued; then the store of the valid rows
__device__ __forceinline__ void ff_store(const Params& p, const float* prm, const Lane& ln,
                                         const Rows& R, Ring& r, uint32_t xn_a, uint32_t slice,
                                         uint32_t hbuf, uint32_t hstride, float (&acc)[2][64]) {
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
    stage_hidden(hb, hacc, prm + P_B1 + FC * c, ln);
    fence_proxy_async();
    named_barrier(2 + ln.wg, 128);
#pragma unroll
    for (int n = 0; n < DM / 128; ++n) {
      const uint32_t st = r.acquire();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128k16_bf16(acc[n], desc_sw128(hb + 32 * kk), desc_sw128(st + 32 * kk), 1);
      wgmma_commit();
      r.keep1();
    }
  }
  r.drain();
  fence_acc(acc[0]);
  fence_acc(acc[1]);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = R.rb + ln.r0 + 8 * rr;
    if (row >= R.nrows) continue;
    bf16* o = p.out + (R.row0 + row) * DM;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int i = 4 * j + 2 * rr;
        *reinterpret_cast<uint32_t*>(o + 128 * n + 8 * j + 2 * ln.t4) =
            pack_bf16(acc[n][i], acc[n][i + 1]);
      }
  }
}

// ---------------------------------------------------------------- launchers
// the tensor maps of the four weights and of x; wqkv [3D][D], wo [D][D],
// w1 [F][D], w2 [D][F], x [rows][D]
inline int make_maps(Maps* m, const void* wqkv, const void* wo, const void* w1, const void* w2,
                     const void* x, long long rows, int F) {
  int rc = bind_device_of(wqkv);
  if (rc == 0) rc = make_tma_2d(&m->qkv, wqkv, false, DM, 3 * DM, DM * 2, 64, 32);
  if (rc == 0) rc = make_tma_2d(&m->o, wo, false, DM, DM, DM * 2, 64, 128);
  if (rc == 0) rc = make_tma_2d(&m->w1, w1, false, DM, F, DM * 2, 64, FC);
  if (rc == 0) rc = make_tma_2d(&m->w2, w2, false, F, DM, (uint64_t)F * 2, 64, 128);
  if (rc == 0) rc = make_tma_2d(&m->x, x, false, DM, (uint64_t)rows, DM * 2, 64, TR);
  return rc;
}

template <class K>
int prepare(K kernel, uint32_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

inline Params make_params(const void* x, const void* seq_bias, const void* ln1, const void* bqkv,
                          const void* bo, const void* ln2, const void* b1, const void* b2,
                          const void* mask, void* out, int B, int S, int F, int causal,
                          float scale) {
  Params p;
  p.x = (const bf16*)x;
  p.seq_bias = (const bf16*)seq_bias;
  p.ln1 = (const bf16*)ln1;
  p.bqkv = (const bf16*)bqkv;
  p.bo = (const bf16*)bo;
  p.ln2 = (const bf16*)ln2;
  p.b1 = (const bf16*)b1;
  p.b2 = (const bf16*)b2;
  p.mask = (const float*)mask;
  p.out = (bf16*)out;
  p.qkv = nullptr;
  p.B = B;
  p.S = S;
  p.F = F;
  p.causal = causal;
  p.nseq = p.ntiles = 0;
  p.scale = scale;
  return p;
}

}  // namespace
}  // namespace layer_infer
