// K2's float32 forms for Hopper (see ops/layer.py): the fused pre-LN layer
// LN1 -> QKV -> masked softmax(Q K^T / sqrt(32)) V -> out projection ->
// residual -> + seq_bias -> LN2 -> ReLU FF -> residual in float32, the
// products on the tensor cores in TF32, at D = 256 (8 heads of 32), F a
// multiple of 64 up to 1024, any S up to 256 (the short form's S <= 32 and
// the long form's 33..256 alike).
//
// Replaces deepsvg_tpu/ops/layer.py:_layer_kernel (wrapper fused_layer) for
// float32 activations. What bounds the layer on the H100 is the tensor
// cores: the four products are 2 (4 D^2 + 2 D F) = 1.05 MFLOP a row, at 495
// TFLOP/s TF32 (an E1 layer of the float32 flagship, 8,192 x 32 rows: 0.56
// ms), against 2 KB a row of input and output.
//
// bfloat16's design (layer_infer.cuh) keeps a 128-row tile's LN1 output and
// its context in shared memory together (64 KB each). In float32 they take
// 128 KB each, more than a block has (227 KB), and a long sequence's context
// (S = 242: 242 KB) does not fit at all. So two tensors pass through device
// memory, QKV and the context, and the layer is three launches:
//
//   qkv_kernel: LN1 of 128-row tiles of all B*S rows (a row a warp, read from
//     device memory) into shared memory, rounded to TF32; head by head a
//     64 x 96 wgmma product a warpgroup (m64n96k8 TF32, the head's Q, K, V
//     weights streamed by a TMA producer warp through an mbarrier ring,
//     both warpgroups reading each stage); + bias, rounded to TF32, to a
//     scratch tensor, head-major ([H][B*S][96]).
//   attn_kernel: a block a (tile of whole sequences, head): the tile's Q, K
//     and V of the head come into shared memory, each warp attends 16-row
//     query blocks on mma.sync m16n8k8 TF32, every score of a row in
//     registers: the exact max-subtracted softmax in float32, each
//     probability rounded to TF32. The P V product takes the probabilities
//     straight from the score accumulators: the keys of each 8-key step are
//     taken in the order (0, 2, 4, 6, 1, 3, 5, 7), which makes a thread's
//     two score columns (2 t4, 2 t4 + 1) the A fragment's (t4, t4 + 4), and
//     V's B fragment is read from shared memory in the same order, by scalar
//     loads (ldmatrix does not transpose 32-bit values). The context,
//     rounded to TF32, goes to a second scratch tensor ([B*S][D]).
//   out_ffn_kernel: 128-row tiles of all rows: the tile's context comes in
//     by TMA (128 KB); the out projection accumulates onto x + bo +
//     seq_bias in the wgmma accumulators (128 a thread), which hold the
//     residual from there on; LN2 writes its output, rounded to TF32, over
//     the context; the FF runs in 64-column chunks of the hidden, FF1 on
//     wgmma, ReLU + b1 rounded to TF32 into a warpgroup's 16 KB buffer, FF2
//     into the residual; then the store.
//
// TF32: wgmma and mma.sync read float32 bits as TF32 by dropping the low 13.
// Every activation operand is rounded to nearest where it is written (LN
// outputs, QKV, probabilities, context, hidden: cvt.rna.tf32), the weights
// once by the wrapper (ops/layer.py). LN, the residual, the softmax and every
// sum are float32, as layer_reference computes them. Nothing is summed across
// threads in a data-dependent order: the same inputs give the same output to
// the bit.
//
// K10 and K11's forward in float32 at D = 256 (ops/attention.py) run the
// three launches without LN1, the residual, LN2 and the FF (mha_qkv_kernel,
// K4's train_attn_kernel, mha_out_kernel; dsvg_mha_f32); K11's backward
// reruns the first two in save mode (dsvg_mha_recompute_f32, ahead of
// layer_f32_bwd.cu's dsvg_mha_bwd_f32).
#include "layer_infer.cuh"

namespace layer_f32 {
namespace {

using namespace hopper;
using layer_infer::init_ring_bars;
using layer_infer::Lane;
using layer_infer::lds2;
using layer_infer::quad_max;
using layer_infer::quad_sum;
using layer_infer::P_B1;
using layer_infer::P_B2;
using layer_infer::P_BO;
using layer_infer::P_LN2B;
using layer_infer::P_LN2W;

constexpr int DM = 256;                // the model width these forms take
constexpr int NH = DM / HEAD_DIM;      // heads
constexpr int KS = 32;                 // floats in a 128-byte slice
constexpr int NSL = DM / KS;           // slices of a row of D
constexpr int THREADS = 384;           // two consumer warpgroups, then the producer's
constexpr int CONSUMERS = 256;
constexpr int TR = 128;                // rows of a product tile
constexpr int FC = 64;                 // FF hidden columns a chunk
constexpr int MAX_F = 1024;
constexpr int LONG_S = 256;
constexpr int LDA = 36;                // floats a row of a head's Q, K, V in the attention
constexpr float L2E = 1.4426950408889634f;
constexpr int QKV_STAGES = 6, OUT_STAGES = 3;
constexpr uint32_t QKV_STAGE = 3 * 32 * 128;  // a head's Q, K and V weights, one slice of K

struct Params {
  const float* x;         // [B*S][D]
  const float* seq_bias;  // [B][D] or null
  const float* ln1;       // [2][D]
  const float* bqkv;      // [3D]
  const float* bo;
  const float* ln2;
  const float* b1;        // [F]
  const float* b2;
  const float* mask;      // [B][S] additive
  float* out;             // [B*S][D]
  float* qkv;             // scratch [H][B*S][96], head h's q | k | v
  float* ctx;             // scratch [B*S][D]
  float* qkv_rows;        // the attention block alone: a row-major copy [B*S][3D], or null
  long long rows;         // B*S
  int B, S, F, causal;
  int nseq;               // whole sequences of an attention tile
  float scale;
};

struct Maps {
  CUtensorMap qkv, o, w1, w2, ctx;  // boxes {32, 32}, {32, 128}, {32, 64}, {32, 128}, {32, 128}
};

// ---------------------------------------------------------------- qkv_kernel
// small parameters: LN1's weight and bias, then the QKV bias
constexpr int Q_LN1W = 0, Q_LN1B = DM, Q_BQKV = 2 * DM, Q_ALL = 5 * DM;

struct QkvLayout {
  uint32_t xn, ring, prm, bars, total;
  __host__ __device__ QkvLayout() {
    Carve c;
    xn = c.take(NSL * TR * 128);
    ring = c.take(QKV_STAGES * QKV_STAGE);
    prm = c.take(Q_ALL * 4, 16);
    bars = c.take(2 * QKV_STAGES * 8, 8);
    total = c.off + 1024;
  }
};

// LN1 of the 16 tile rows [rb, rb + 16) (zero from nrows on), a row a warp at
// a time, 8 columns a lane, read from x four rows at a time; into xn
// ([NSL][128 rows][128 B], 128-byte swizzled), rounded to TF32
__device__ __forceinline__ void ln1_rows(const float* x, const float* prm, int nrows, int rb,
                                         int lane, unsigned char* xn) {
  float w[8], b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    w[j] = prm[Q_LN1W + 8 * lane + j];
    b[j] = prm[Q_LN1B + 8 * lane + j];
  }
  unsigned char* dst = xn + (lane >> 2) * TR * 128;
#pragma unroll 1
  for (int i0 = 0; i0 < 16; i0 += 4) {
    float4 u[4][2];  // four rows' loads in flight (a row past nrows reads row 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rb + i0 + i;
      const float4* src =
          reinterpret_cast<const float4*>(x + (size_t)(r < nrows ? r : 0) * DM + 8 * lane);
      u[i][0] = __ldg(src);
      u[i][1] = __ldg(src + 1);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rb + i0 + i;
      float v[8] = {u[i][0].x, u[i][0].y, u[i][0].z, u[i][0].w,
                    u[i][1].x, u[i][1].y, u[i][1].z, u[i][1].w};
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
      for (int j = 0; j < 8; ++j) v[j] = r < nrows ? to_tf32(v[j] * rstd * w[j] + b[j]) : 0.f;
#pragma unroll
      for (int pc = 0; pc < 2; ++pc) {
        const uint32_t piece = (lane & 3) * 2 + pc;
        *reinterpret_cast<float4*>(dst + r * 128 + ((piece ^ (r & 7)) << 4)) =
            make_float4(v[4 * pc], v[4 * pc + 1], v[4 * pc + 2], v[4 * pc + 3]);
      }
    }
  }
}

// rows [rb, rb + 16) of x (zero from nrows on) rounded to TF32 into xn, as
// ln1_rows lays its output out: the QKV product of the attention block
// alone, which has no LN1
__device__ __forceinline__ void tf32_rows(const float* x, int nrows, int rb, int lane,
                                          unsigned char* xn) {
  unsigned char* dst = xn + (lane >> 2) * TR * 128;
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int r = rb + i;
    float4 u[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
    if (r < nrows) {
      const float4* src = reinterpret_cast<const float4*>(x + (size_t)r * DM + 8 * lane);
      u[0] = __ldg(src);
      u[1] = __ldg(src + 1);
    }
#pragma unroll
    for (int pc = 0; pc < 2; ++pc) {
      const uint32_t piece = (lane & 3) * 2 + pc;
      *reinterpret_cast<float4*>(dst + r * 128 + ((piece ^ (r & 7)) << 4)) =
          make_float4(to_tf32(u[pc].x), to_tf32(u[pc].y), to_tf32(u[pc].z), to_tf32(u[pc].w));
    }
  }
}

// into L2 ahead of use: the 32 bytes at `p` (a lane's part of a row)
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// the QKV launch's body: K2's qkv_kernel and K4's train_qkv_kernel (LN1),
// and the attention block's mha_qkv_kernel (x as it is, rounded to TF32;
// QKV into p.qkv head-major and/or p.qkv_rows row-major, either may be null)
template <bool LN1>
__device__ __forceinline__ void qkv_tiles(const Maps& maps, const Params& p) {
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
  const int ntiles = (int)((p.rows + TR - 1) / TR);

  if (threadIdx.x >= CONSUMERS) {  // the producer
    setmaxnreg_dec<24>();
    if (threadIdx.x != CONSUMERS) return;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x)
      for (int h = 0; h < NH; ++h)
        for (int k = 0; k < NSL; ++k) {
          unsigned char* st = ring.produce(QKV_STAGE);
          for (int part = 0; part < 3; ++part)
            tma_load_2d(st + part * 4096, &maps.qkv, ring.bar(), KS * k, part * DM + h * HEAD_DIM);
          ring.advance();
        }
    return;
  }

  setmaxnreg_inc<240>();
  const Lane ln;
  float* prm = reinterpret_cast<float*>(base + L.prm);
  for (int i = ln.tid + (LN1 ? 0 : Q_BQKV); i < Q_ALL; i += CONSUMERS)
    prm[i] = i < Q_LN1B ? p.ln1[i] : i < Q_BQKV ? p.ln1[DM + i - Q_LN1B] : p.bqkv[i - Q_BQKV];
  named_barrier(1, CONSUMERS);
  unsigned char* xn = base + L.xn;
  const uint32_t xn_a = smem_u32(xn) + ln.wg * 64 * 128;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * TR;
    const int nrows = (int)min((long long)TR, p.rows - (long long)row0);
    if constexpr (LN1)
      ln1_rows(p.x + row0 * DM, prm, nrows, 64 * ln.wg + 16 * ln.w, ln.lane, xn);
    else
      tf32_rows(p.x + row0 * DM, nrows, 64 * ln.wg + 16 * ln.w, ln.lane, xn);
    fence_proxy_async();
    named_barrier(2 + ln.wg, 128);  // the warpgroup reads only its own rows
    // the next tile's rows of x into L2 while this tile's heads run
    const long long next = (long long)(tile + gridDim.x) * TR + 64 * ln.wg + 16 * ln.w;
    for (int i = 0; i < 16; ++i)
      if (next + i < p.rows) prefetch_l2(p.x + (next + i) * DM + 8 * ln.lane);
#pragma unroll 1
    for (int h = 0; h < NH; ++h) {
      float acc[48];
#pragma unroll 1
      for (int k = 0; k < NSL; ++k) {
        const uint32_t st = ring.acquire();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n96k8_tf32(acc, desc_sw128(xn_a + k * (TR * 128) + 32 * kk),
                              desc_sw128(st + 32 * kk), (k | kk) ? 1 : 0);
        wgmma_commit();
        ring.keep1();
      }
      ring.drain();
      fence_acc(acc);
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int c = 8 * j + 2 * ln.t4;  // column of the head's q | k | v
        const float2 b = lds2(prm + Q_BQKV + (j >> 2) * DM + h * HEAD_DIM + (c & 31));
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int r = 64 * ln.wg + ln.r0 + 8 * rr;
          if (r >= nrows) continue;
          const float v0 = to_tf32(acc[4 * j + 2 * rr] + b.x);
          const float v1 = to_tf32(acc[4 * j + 2 * rr + 1] + b.y);
          if (LN1 || p.qkv != nullptr)
            store2(p.qkv + ((size_t)h * p.rows + row0 + r) * 96 + c, v0, v1);
          if (!LN1 && p.qkv_rows != nullptr)
            store2(p.qkv_rows + (row0 + r) * 3 * DM + (j >> 2) * DM + h * HEAD_DIM + (c & 31), v0,
                   v1);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    qkv_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Params p) {
  qkv_tiles<true>(maps, p);
}

// ---------------------------------------------------------------- attn_kernel
// The context of the 16 query rows [q0, q0 + 16) of a tile of `nrows` valid
// rows (whole sequences of S) for one head: each row attends to the keys of
// its sequence (up to itself when causal) with the additive mask mask[j] of
// tile row j. qs, ks, vs: the tile's Q, K and V rows (LDA floats apart, zero
// from nrows on, `krows` rows). o: the context in the mma accumulator
// layout, o[j] holding head dims 8 j + [0, 8). MAXT: the most 16-key steps a
// query block's keys span; every score stays in registers. drop.pair(p0,
// p1, rr, j): the probabilities of the thread's row rr (tile row q0 + lane /
// 4 + 8 rr) at key rows j and j + 1 as P V takes them (K4's dropout and
// save, TrainDrop); K2 takes them as they are (NoDrop).
struct NoDrop {
  __device__ __forceinline__ float2 pair(float p0, float p1, int, int) const {
    return make_float2(p0, p1);
  }
};

template <int MAXT, class Drop = NoDrop>
__device__ __forceinline__ void attend_rows(const float* qs, const float* ks, const float* vs,
                                            int krows, int q0, int nrows, int S, int causal,
                                            const float* mask, float scale, int lane,
                                            float (&o)[4][4], const Drop& drop = Drop()) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  if (q0 >= nrows) return;
  const int qlast = min(q0 + 15, nrows - 1);
  const int kstart = (q0 / S) * S;
  const int kend = causal ? qlast + 1 : (qlast / S + 1) * S;
  const int nkt = (kend - kstart + 15) >> 4;
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
  // Q as the A fragments of the four 8-dim steps
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float* q = qs + (q0 + g) * LDA + 8 * kk + t4;
    qf[kk][0] = __float_as_uint(q[0]);
    qf[kk][1] = __float_as_uint(q[8 * LDA]);
    qf[kk][2] = __float_as_uint(q[4]);
    qf[kk][3] = __float_as_uint(q[8 * LDA + 4]);
  }
  // the scores of key tile t (keys kstart + 8 t + [0, 8)) in log2 units
  const float sl = scale * L2E;
  float s[2 * MAXT][4];
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int t = 0; t < 2 * MAXT; ++t) {
    s[t][0] = s[t][1] = s[t][2] = s[t][3] = -INFINITY;
    if (t < 2 * nkt) {
      const float* kr = ks + min(kstart + 8 * t + g, krows - 1) * LDA + t4;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_m16n8k8_tf32(d, qf[kk], __float_as_uint(kr[8 * kk]), __float_as_uint(kr[8 * kk + 4]));
      const int j0 = kstart + 8 * t + 2 * t4;
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
  float sum[2] = {0.f, 0.f}, inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    m[rr] = quad_max(m[rr]);
    if (m[rr] == -INFINITY) m[rr] = 0.f;  // no key: every exponential is 0
  }
#pragma unroll
  for (int t = 0; t < 2 * MAXT; ++t)
    if (t < 2 * nkt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[t][i] = ex2(s[t][i] - m[i >> 1]);
        sum[i >> 1] += s[t][i];
      }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    sum[rr] = quad_sum(sum[rr]);
    inv[rr] = sum[rr] > 0.f ? 1.f / sum[rr] : 0.f;
  }
  // o += P V, 8 keys a step in the order (0, 2, 4, 6, 1, 3, 5, 7): the A
  // fragment's column t4 is key 2 t4 and its column t4 + 4 key 2 t4 + 1,
  // which the thread holds as s[t][0..3]
#pragma unroll
  for (int t = 0; t < 2 * MAXT; ++t) {
    if (t < 2 * nkt) {
      const int kb = kstart + 8 * t + 2 * t4;
      const float2 r0 = drop.pair(s[t][0] * inv[0], s[t][1] * inv[0], 0, kb);
      const float2 r1 = drop.pair(s[t][2] * inv[1], s[t][3] * inv[1], 1, kb);
      const uint32_t a[4] = {__float_as_uint(to_tf32(r0.x)), __float_as_uint(to_tf32(r1.x)),
                             __float_as_uint(to_tf32(r0.y)), __float_as_uint(to_tf32(r1.y))};
      const float* v0 = vs + min(kb, krows - 1) * LDA + g;
      const float* v1 = vs + min(kb + 1, krows - 1) * LDA + g;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
        mma_m16n8k8_tf32(o[jn], a, __float_as_uint(v0[8 * jn]), __float_as_uint(v1[8 * jn]));
    }
  }
}

// 16 bytes from global to shared memory, asynchronously (zeros if !valid)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// tiles of TRB rows: 128 for S <= 32 (MAXT 4), 256 for the long form (MAXT 16)
template <int MAXT>
struct AttnCfg {
  static constexpr int TRB = MAXT == 4 ? 128 : 256;
  static constexpr uint32_t SMEM = (3 * TRB * LDA + TRB) * 4;
};

template <int MAXT>
__global__ void __launch_bounds__(256, MAXT == 4 ? 2 : 1)
    attn_kernel(const __grid_constant__ Params p) {
  constexpr int TRB = AttnCfg<MAXT>::TRB;
  extern __shared__ float4 attn_smem[];
  float* qs = reinterpret_cast<float*>(attn_smem);
  float* ks = qs + TRB * LDA;
  float* vs = ks + TRB * LDA;
  float* mask = vs + TRB * LDA;
  const int tile = blockIdx.x, h = blockIdx.y;
  const int seq0 = tile * p.nseq;
  const int nrows = min(p.nseq, p.B - seq0) * p.S;
  const size_t row0 = (size_t)seq0 * p.S;
  // the tile's Q, K and V rows of head h, zero from nrows on: every copy in
  // flight at once (cp.async), then one wait
  const float* src = p.qkv + ((size_t)h * p.rows + row0) * 96;
  for (int e = threadIdx.x; e < TRB * 24; e += blockDim.x) {
    const int r = e / 24, c4 = e - r * 24, part = c4 >> 3;
    cp_async16((part == 0 ? qs : part == 1 ? ks : vs) + r * LDA + 4 * (c4 & 7),
               src + (size_t)(r < nrows ? r : 0) * 96 + 4 * c4, r < nrows);
  }
  for (int r = threadIdx.x; r < TRB; r += blockDim.x) mask[r] = r < nrows ? p.mask[row0 + r] : 0.f;
  cp_async_wait_all();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 1
  for (int blk = warp; blk < TRB / 16; blk += 8) {
    const int q0 = 16 * blk;
    float o[4][4];
    attend_rows<MAXT>(qs, ks, vs, TRB, q0, nrows, p.S, p.causal, mask, p.scale, lane, o);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = h * HEAD_DIM + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = q0 + (lane >> 2) + 8 * rr;
        if (r < nrows)
          store2(p.ctx + (row0 + r) * DM + col, to_tf32(o[j][2 * rr]), to_tf32(o[j][2 * rr + 1]));
      }
    }
  }
}

// ---------------------------------------------------------------- out_ffn_kernel
struct OutLayout {
  uint32_t ctx, hid, ring, prm, bars, total;
  __host__ __device__ explicit OutLayout(int F) {
    Carve c;
    ctx = c.take(NSL * TR * 128);
    hid = c.take(2 * 2 * 64 * 128);  // a warpgroup's hidden chunk: two slices of 64 rows
    ring = c.take(OUT_STAGES * layer_infer::STAGE);
    prm = c.take((P_B1 + F) * 4, 16);
    bars = c.take((2 * OUT_STAGES + NSL + 1) * 8, 8);
    total = c.off + 1024;
  }
};

// the producer of out_ffn_kernel and train_out_ffn_kernel, per tile: the
// tile's context (NSL slices, each on its barrier of cfull, once the
// consumers released the last tile's through cempty), Wo (slice k, half n),
// then per 64-column chunk of the hidden W1's two stages of two slices and
// W2's two slices of two halves
__device__ __forceinline__ void produce_out_ffn(const Maps& maps, const Params& p,
                                                layer_infer::Ring& ring, unsigned char* ctxs,
                                                uint64_t* cfull, uint64_t* cempty, int ntiles) {
  PipeState cs;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    mbar_wait(cempty, cs.phase ^ 1);
    for (int k = 0; k < NSL; ++k) {
      mbar_arrive_expect_tx(&cfull[k], TR * 128);
      tma_load_2d(ctxs + k * TR * 128, &maps.ctx, &cfull[k], KS * k, tile * TR);
    }
    cs.advance(1);
    for (int k = 0; k < NSL; ++k)
      for (int n = 0; n < DM / 128; ++n) {
        unsigned char* st = ring.produce(layer_infer::STAGE);
        tma_load_2d(st, &maps.o, ring.bar(), KS * k, 128 * n);
        ring.advance();
      }
    for (int c = 0; c < p.F / FC; ++c) {
      for (int kp = 0; kp < NSL / 2; ++kp) {
        unsigned char* st = ring.produce(layer_infer::STAGE);
        tma_load_2d(st, &maps.w1, ring.bar(), KS * (2 * kp), FC * c);
        tma_load_2d(st + 8192, &maps.w1, ring.bar(), KS * (2 * kp + 1), FC * c);
        ring.advance();
      }
      for (int ks = 0; ks < FC / KS; ++ks)
        for (int n = 0; n < DM / 128; ++n) {
          unsigned char* st = ring.produce(layer_infer::STAGE);
          tma_load_2d(st, &maps.w2, ring.bar(), FC * c + KS * ks, 128 * n);
          ring.advance();
        }
    }
  }
}

// acc = x + bo (+ seq_bias) of the warpgroup's 64 rows [rb, rb + 64) of the
// tile at global row row0
__device__ __forceinline__ void residual_init(const Params& p, const float* prm, const Lane& ln,
                                              size_t row0, int nrows, int rb,
                                              float (&acc)[2][64]) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = rb + ln.r0 + 8 * rr;
    const size_t row = row0 + (r < nrows ? r : 0);
    const float* xr = p.x + row * DM;
    const float* sb = p.seq_bias != nullptr ? p.seq_bias + (row / p.S) * DM : nullptr;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 128 * n + 8 * j + 2 * ln.t4, i = 4 * j + 2 * rr;
        const float2 xv = __ldg(reinterpret_cast<const float2*>(xr + col));
        const float2 bo = lds2(prm + P_BO + col);
        float v0 = xv.x + bo.x, v1 = xv.y + bo.y;
        if (sb != nullptr) {
          const float2 bv = __ldg(reinterpret_cast<const float2*>(sb + col));
          v0 += bv.x;
          v1 += bv.y;
        }
        acc[n][i] = v0;
        acc[n][i + 1] = v1;
      }
  }
}

// LN2 of the residual in acc, rounded to TF32, into xn ([NSL][128 rows][128
// B], swizzled) at the warpgroup's rows; then acc += b2, so that FF2
// accumulates into the residual
__device__ __forceinline__ void ln2_rows(const float* prm, const Lane& ln, int rb,
                                         float (&acc)[2][64], unsigned char* xn) {
  float mu[2], rstd[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float s = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 16; ++j) s += acc[n][4 * j + 2 * rr] + acc[n][4 * j + 2 * rr + 1];
    mu[rr] = quad_sum(s) / DM;
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
    rstd[rr] = rsqrtf(quad_sum(q) / DM + LN_EPS);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 128 * n + 8 * j + 2 * ln.t4;
      const float2 w = lds2(prm + P_LN2W + col), b = lds2(prm + P_LN2B + col),
                   b2 = lds2(prm + P_B2 + col);
      unsigned char* dst = xn + (col >> 5) * TR * 128;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = 4 * j + 2 * rr, r = rb + ln.r0 + 8 * rr;
        const float y0 = to_tf32((acc[n][i] - mu[rr]) * rstd[rr] * w.x + b.x);
        const float y1 = to_tf32((acc[n][i + 1] - mu[rr]) * rstd[rr] * w.y + b.y);
        *reinterpret_cast<float2*>(dst + swizzle128(r, (col & 31) * 4)) = make_float2(y0, y1);
        acc[n][i] += b2.x;
        acc[n][i + 1] += b2.y;
      }
    }
}

__global__ void __launch_bounds__(THREADS, 1)
    out_ffn_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Params p) {
  const OutLayout L(p.F);
  unsigned char* base = smem_base();
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* cfull = bars + 2 * OUT_STAGES;  // a barrier a slice of the context
  uint64_t* cempty = cfull + NSL;
  layer_infer::Ring ring;
  ring.init(base + L.ring, bars, OUT_STAGES);
  if (threadIdx.x == 0) {
    init_ring_bars(bars, OUT_STAGES);
    for (int k = 0; k < NSL; ++k) mbar_init(&cfull[k], 1);
    mbar_init(cempty, CONSUMERS);
    fence_barrier_init();
  }
  __syncthreads();
  const int ntiles = (int)((p.rows + TR - 1) / TR);
  unsigned char* ctxs = base + L.ctx;

  if (threadIdx.x >= CONSUMERS) {  // the producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS) produce_out_ffn(maps, p, ring, ctxs, cfull, cempty, ntiles);
    return;
  }

  setmaxnreg_inc<240>();
  const Lane ln;
  float* prm = reinterpret_cast<float*>(base + L.prm);
  for (int i = ln.tid; i < P_B1 + p.F; i += CONSUMERS) {
    const float* src = i < P_LN2W ? p.bo + i
                     : i < P_B2   ? p.ln2 + (i - P_LN2W)
                     : i < P_B1   ? p.b2 + (i - P_B2)
                                  : p.b1 + (i - P_B1);
    prm[i] = *src;
  }
  named_barrier(1, CONSUMERS);
  const int rb = 64 * ln.wg;
  const uint32_t ctx_a = smem_u32(ctxs) + rb * 128;
  const uint32_t hid_a = smem_u32(base + L.hid) + ln.wg * 2 * 64 * 128;
  PipeState cs;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * TR;
    const int nrows = (int)min((long long)TR, p.rows - (long long)row0);
    float acc[2][64];
    residual_init(p, prm, ln, row0, nrows, rb, acc);
    // out projection onto the residual, a slice of the context as it lands
#pragma unroll 1
    for (int k = 0; k < NSL; ++k) {
      mbar_wait(&cfull[k], cs.phase);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const uint32_t st = ring.acquire();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k8_tf32(acc[n], desc_sw128(ctx_a + k * (TR * 128) + 32 * kk),
                               desc_sw128(st + 32 * kk), 1);
        wgmma_commit();
        ring.keep1();
      }
    }
    ring.drain();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    ln2_rows(prm, ln, rb, acc, ctxs);  // over the context rows just read
    fence_proxy_async();
    named_barrier(2 + ln.wg, 128);
    // the FF, a 64-column chunk of the hidden at a time
#pragma unroll 1
    for (int c = 0; c < p.F / FC; ++c) {
      float hacc[32];
#pragma unroll 1
      for (int kp = 0; kp < NSL / 2; ++kp) {
        const uint32_t st = ring.acquire();
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n64k8_tf32(hacc, desc_sw128(ctx_a + (2 * kp + j) * (TR * 128) + 32 * kk),
                                desc_sw128(st + j * 8192 + 32 * kk), (kp | j | kk) ? 1 : 0);
        wgmma_commit();
        ring.keep1();
      }
      ring.drain();  // this chunk's FF1, and the last chunk's FF2, are done
      fence_acc(hacc);
      // relu(. + b1), rounded to TF32, into the warpgroup's hidden buffer:
      // [2 slices][64 rows][128 B], swizzled
      unsigned char* hb = base + L.hid + ln.wg * 2 * 64 * 128;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int col = 8 * (i >> 2) + 2 * ln.t4, r = ln.r0 + 8 * ((i >> 1) & 1);
        const float2 b = lds2(prm + P_B1 + FC * c + col);
        *reinterpret_cast<float2*>(hb + (col >> 5) * 64 * 128 + swizzle128(r, (col & 31) * 4)) =
            make_float2(to_tf32(fmaxf(hacc[i] + b.x, 0.f)), to_tf32(fmaxf(hacc[i + 1] + b.y, 0.f)));
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
                                 desc_sw128(st + 32 * kk), 1);
          wgmma_commit();
          ring.keep1();
        }
    }
    ring.drain();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    mbar_arrive(cempty);  // this warpgroup is done with the tile's shared rows
    cs.advance(1);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = rb + ln.r0 + 8 * rr;
      if (r >= nrows) continue;
      float* o = p.out + (row0 + r) * DM;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int i = 4 * j + 2 * rr;
          store2(o + 128 * n + 8 * j + 2 * ln.t4, acc[n][i], acc[n][i + 1]);
        }
    }
  }
}

// ================================================================ K4's forward
// The training forward of K4's float32 long form: K2's three launches with
// the training switch. train_qkv_kernel is qkv_kernel's body (its QKV
// scratch is the saved QKV in the saved mode); train_attn_kernel adds the
// dropout of the probabilities and, saved, writes them before dropout;
// train_out_ffn_kernel runs the out projection alone, the attention block's
// output m (acc + bo) goes to x1's tensor, a row-per-warp pass adds the
// residual there and takes LN2 (the residual held beside a product's
// accumulators spills), the FF drops its hidden (saved before dropout) and
// out = x1 + m (FF2 + b2) reads x1 back. Both modes run the same arithmetic:
// the same `out` to the bit.
struct Train {
  float* p;      // [B][H][S][S], before dropout, or null: the recompute mode
  float* x1;     // [rows][D]: the residual after the attention block
  float* h;      // [rows][F], before dropout (saved mode)
  int seed;
  unsigned thr;  // floor(rate 2^24); 0: no dropout
  float kp;      // 1 / (1 - rate)
};

// v kept (times kp) or dropped at (row, col) of the site `key`
__device__ __forceinline__ float drop_at(float v, unsigned key, size_t row, int col, unsigned thr,
                                         float kp) {
  return thr == 0u ? v : (keep_elem(key, (unsigned)row, (unsigned)col, thr) ? v * kp : 0.f);
}

__global__ void __launch_bounds__(THREADS, 1)
    train_qkv_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Params p) {
  qkv_tiles<true>(maps, p);
}

// attend_rows' hook in the training forward: saves the probabilities of the
// thread's row rr at key rows j and j + 1 (its sequence's keys only; one
// 8-byte store where the pair is aligned) and returns them with dropout, as
// layer_train.cuh's AttnDrop does in bfloat16
struct TrainDrop {
  float* p;
  unsigned key, thr;
  float kp;
  int S, lo[2];  // lo: the row's first key, or -S - 1 past the tile's rows
  unsigned prow[2], rh[2];  // the probability row and its hash
  __device__ __forceinline__ TrainDrop(float* p_, unsigned key_, unsigned thr_, float kp_,
                                       int seq0, int S_, int h, int nrows, int i0)
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
  __device__ __forceinline__ float2 pair(float p0, float p1, int rr, int j) const {
    const int k = j - lo[rr];
    if (p != nullptr) {
      float* at = p + (size_t)prow[rr] * S + k;
      if (k >= 0 && k + 1 < S && !(reinterpret_cast<uintptr_t>(at) & 7)) {
        *reinterpret_cast<float2*>(at) = make_float2(p0, p1);
      } else {
        if (k >= 0 && k < S) at[0] = p0;
        if (k + 1 >= 0 && k + 1 < S) at[1] = p1;
      }
    }
    return make_float2(dropped(p0, rr, k), dropped(p1, rr, k + 1));
  }
};

template <int MAXT, bool SAVE>
__global__ void __launch_bounds__(256, MAXT == 4 ? 2 : 1)
    train_attn_kernel(const __grid_constant__ Params p, const __grid_constant__ Train t) {
  constexpr int TRB = AttnCfg<MAXT>::TRB;
  extern __shared__ float4 attn_smem[];
  float* qs = reinterpret_cast<float*>(attn_smem);
  float* ks = qs + TRB * LDA;
  float* vs = ks + TRB * LDA;
  float* mask = vs + TRB * LDA;
  const int tile = blockIdx.x, h = blockIdx.y;
  const int seq0 = tile * p.nseq;
  const int nrows = min(p.nseq, p.B - seq0) * p.S;
  const size_t row0 = (size_t)seq0 * p.S;
  const float* src = p.qkv + ((size_t)h * p.rows + row0) * 96;
  for (int e = threadIdx.x; e < TRB * 24; e += blockDim.x) {
    const int r = e / 24, c4 = e - r * 24, part = c4 >> 3;
    cp_async16((part == 0 ? qs : part == 1 ? ks : vs) + r * LDA + 4 * (c4 & 7),
               src + (size_t)(r < nrows ? r : 0) * 96 + 4 * c4, r < nrows);
  }
  for (int r = threadIdx.x; r < TRB; r += blockDim.x) mask[r] = r < nrows ? p.mask[row0 + r] : 0.f;
  cp_async_wait_all();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned key_ap = site_key(t.seed, SITE_ATTN_PROB);
#pragma unroll 1
  for (int blk = warp; blk < TRB / 16; blk += 8) {
    const int q0 = 16 * blk;
    const TrainDrop drop(SAVE ? t.p : nullptr, key_ap, t.thr, t.kp, seq0, p.S, h, nrows,
                         q0 + (lane >> 2));
    float o[4][4];
    attend_rows<MAXT>(qs, ks, vs, TRB, q0, nrows, p.S, p.causal, mask, p.scale, lane, o, drop);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = h * HEAD_DIM + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = q0 + (lane >> 2) + 8 * rr;
        if (r < nrows)
          store2(p.ctx + (row0 + r) * DM + col, to_tf32(o[j][2 * rr]), to_tf32(o[j][2 * rr + 1]));
      }
    }
  }
}

// x1 = a + x (+ seq_bias) of the warp's 16 tile rows [rb, rb + 16), a the
// attention block's output in t.x1 (written by this warp), back to t.x1, and
// its LN2 rounded to TF32 into xn ([NSL][128 rows][128 B], swizzled; rows >=
// nrows zero); a row at a time, 8 columns a lane
__device__ __forceinline__ void residual_ln2_rows(const Params& p, const Train& t,
                                                  const float* prm, size_t row0, int nrows,
                                                  int rb, int lane, unsigned char* xn) {
  const int c0 = 8 * lane;
  float w[8], b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    w[j] = prm[P_LN2W + c0 + j];
    b[j] = prm[P_LN2B + c0 + j];
  }
  unsigned char* dst = xn + (lane >> 2) * TR * 128;
#pragma unroll 1
  for (int i = 0; i < 16; ++i) {
    const int r = rb + i;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.f;
    if (r < nrows) {
      const size_t row = row0 + r;
      float* x1 = t.x1 + row * DM + c0;
      const float4 a0 = *reinterpret_cast<const float4*>(x1);
      const float4 a1 = *reinterpret_cast<const float4*>(x1 + 4);
      const float4* xr = reinterpret_cast<const float4*>(p.x + row * DM + c0);
      const float4 x0 = __ldg(xr), x1v = __ldg(xr + 1);
      v[0] = a0.x + x0.x, v[1] = a0.y + x0.y, v[2] = a0.z + x0.z, v[3] = a0.w + x0.w;
      v[4] = a1.x + x1v.x, v[5] = a1.y + x1v.y, v[6] = a1.z + x1v.z, v[7] = a1.w + x1v.w;
      if (p.seq_bias != nullptr) {
        const float4* sb = reinterpret_cast<const float4*>(p.seq_bias + (row / p.S) * DM + c0);
        const float4 s0 = __ldg(sb), s1 = __ldg(sb + 1);
        v[0] += s0.x, v[1] += s0.y, v[2] += s0.z, v[3] += s0.w;
        v[4] += s1.x, v[5] += s1.y, v[6] += s1.z, v[7] += s1.w;
      }
      *reinterpret_cast<float4*>(x1) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(x1 + 4) = make_float4(v[4], v[5], v[6], v[7]);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += v[j];
      const float mu = warp_sum(sum) / DM;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] -= mu;
        q += v[j] * v[j];
      }
      const float rstd = rsqrtf(warp_sum(q) / DM + LN_EPS);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = to_tf32(v[j] * rstd * w[j] + b[j]);
    }
#pragma unroll
    for (int pc = 0; pc < 2; ++pc) {
      const uint32_t piece = (lane & 3) * 2 + pc;
      *reinterpret_cast<float4*>(dst + r * 128 + ((piece ^ (r & 7)) << 4)) =
          make_float4(v[4 * pc], v[4 * pc + 1], v[4 * pc + 2], v[4 * pc + 3]);
    }
  }
}

template <bool SAVE>
__global__ void __launch_bounds__(THREADS, 1)
    train_out_ffn_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Params p,
                         const __grid_constant__ Train t) {
  const OutLayout L(p.F);
  unsigned char* base = smem_base();
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* cfull = bars + 2 * OUT_STAGES;
  uint64_t* cempty = cfull + NSL;
  layer_infer::Ring ring;
  ring.init(base + L.ring, bars, OUT_STAGES);
  if (threadIdx.x == 0) {
    init_ring_bars(bars, OUT_STAGES);
    for (int k = 0; k < NSL; ++k) mbar_init(&cfull[k], 1);
    mbar_init(cempty, CONSUMERS);
    fence_barrier_init();
  }
  __syncthreads();
  const int ntiles = (int)((p.rows + TR - 1) / TR);
  unsigned char* ctxs = base + L.ctx;

  if (threadIdx.x >= CONSUMERS) {  // the producer: out_ffn_kernel's stages
    setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS) produce_out_ffn(maps, p, ring, ctxs, cfull, cempty, ntiles);
    return;
  }

  setmaxnreg_inc<240>();
  const Lane ln;
  float* prm = reinterpret_cast<float*>(base + L.prm);
  for (int i = ln.tid; i < P_B1 + p.F; i += CONSUMERS) {
    const float* src = i < P_LN2W ? p.bo + i
                     : i < P_B2   ? p.ln2 + (i - P_LN2W)
                     : i < P_B1   ? p.b2 + (i - P_B2)
                                  : p.b1 + (i - P_B1);
    prm[i] = *src;
  }
  named_barrier(1, CONSUMERS);
  const int rb = 64 * ln.wg;
  const uint32_t ctx_a = smem_u32(ctxs) + rb * 128;
  const uint32_t hid_a = smem_u32(base + L.hid) + ln.wg * 2 * 64 * 128;
  unsigned char* hb = base + L.hid + ln.wg * 2 * 64 * 128;
  const unsigned key_ao = site_key(t.seed, SITE_ATTN_OUT), key_fh = site_key(t.seed, SITE_FF_HIDDEN),
                 key_fo = site_key(t.seed, SITE_FF_OUT);
  PipeState cs;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * TR;
    const int nrows = (int)min((long long)TR, p.rows - (long long)row0);
    float acc[2][64];
    // the out projection alone, a slice of the context as it lands
#pragma unroll 1
    for (int k = 0; k < NSL; ++k) {
      mbar_wait(&cfull[k], cs.phase);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const uint32_t st = ring.acquire();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k8_tf32(acc[n], desc_sw128(ctx_a + k * (TR * 128) + 32 * kk),
                               desc_sw128(st + 32 * kk), (k | kk) ? 1 : 0);
        wgmma_commit();
        ring.keep1();
      }
    }
    ring.drain();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    // a = m (acc + bo) to x1's tensor; the warp's accumulator rows are the
    // 16 rows its residual pass takes
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = rb + ln.r0 + 8 * rr;
      if (r >= nrows) continue;
      const size_t row = row0 + r;
      float* a = t.x1 + row * DM;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 128 * n + 8 * j + 2 * ln.t4, i = 4 * j + 2 * rr;
          const float2 bo = lds2(prm + P_BO + col);
          store2(a + col, drop_at(acc[n][i] + bo.x, key_ao, row, col, t.thr, t.kp),
                 drop_at(acc[n][i + 1] + bo.y, key_ao, row, col + 1, t.thr, t.kp));
        }
    }
    __syncwarp();
    residual_ln2_rows(p, t, prm, row0, nrows, rb + 16 * ln.w, ln.lane, ctxs);  // over the context
    fence_proxy_async();
    named_barrier(2 + ln.wg, 128);
    // the FF, a 64-column chunk of the hidden at a time
#pragma unroll 1
    for (int c = 0; c < p.F / FC; ++c) {
      float hacc[32];
#pragma unroll 1
      for (int kp = 0; kp < NSL / 2; ++kp) {
        const uint32_t st = ring.acquire();
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n64k8_tf32(hacc, desc_sw128(ctx_a + (2 * kp + j) * (TR * 128) + 32 * kk),
                                desc_sw128(st + j * 8192 + 32 * kk), (kp | j | kk) ? 1 : 0);
        wgmma_commit();
        ring.keep1();
      }
      ring.drain();  // this chunk's FF1, and the last chunk's FF2, are done
      fence_acc(hacc);
      // relu(. + b1) (saved before dropout), dropped, rounded to TF32, into
      // the warpgroup's hidden buffer: [2 slices][64 rows][128 B], swizzled
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int col = 8 * (i >> 2) + 2 * ln.t4, r = ln.r0 + 8 * ((i >> 1) & 1);
        const int gcol = FC * c + col;
        const size_t row = row0 + rb + r;
        const float2 b = lds2(prm + P_B1 + gcol);
        const float h0 = fmaxf(hacc[i] + b.x, 0.f), h1 = fmaxf(hacc[i + 1] + b.y, 0.f);
        if constexpr (SAVE)
          if (rb + r < nrows) store2(t.h + row * p.F + gcol, h0, h1);
        *reinterpret_cast<float2*>(hb + (col >> 5) * 64 * 128 + swizzle128(r, (col & 31) * 4)) =
            make_float2(to_tf32(drop_at(h0, key_fh, row, gcol, t.thr, t.kp)),
                        to_tf32(drop_at(h1, key_fh, row, gcol + 1, t.thr, t.kp)));
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
    mbar_arrive(cempty);  // this warpgroup is done with the tile's shared rows
    cs.advance(1);
    // out = x1 + m (acc + b2); x1 as the residual pass left it (other lanes
    // of this warp wrote it, visible through the warpgroup barrier after it)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = rb + ln.r0 + 8 * rr;
      if (r >= nrows) continue;
      const size_t row = row0 + r;
      const float* x1 = t.x1 + row * DM;
      float* o = p.out + row * DM;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 128 * n + 8 * j + 2 * ln.t4, i = 4 * j + 2 * rr;
          const float2 xv = *reinterpret_cast<const float2*>(x1 + col);
          const float2 b2 = lds2(prm + P_B2 + col);
          store2(o + col, xv.x + drop_at(acc[n][i] + b2.x, key_fo, row, col, t.thr, t.kp),
                 xv.y + drop_at(acc[n][i + 1] + b2.y, key_fo, row, col + 1, t.thr, t.kp));
        }
    }
  }
}

template <class K>
int prepare(K kernel, uint32_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <int MAXT>
int launch_attn(const Params& p, cudaStream_t stream) {
  constexpr int TRB = AttnCfg<MAXT>::TRB;
  Params q = p;
  q.nseq = TRB / p.S;
  const int ntiles = (p.B + q.nseq - 1) / q.nseq;
  int rc = prepare(attn_kernel<MAXT>, AttnCfg<MAXT>::SMEM);
  if (rc) return rc;
  attn_kernel<MAXT><<<dim3(ntiles, NH), 256, AttnCfg<MAXT>::SMEM, stream>>>(q);
  return (int)cudaGetLastError();
}

template <int MAXT, bool SAVE>
int launch_train_attn(const Params& p, const Train& t, cudaStream_t stream) {
  constexpr int TRB = AttnCfg<MAXT>::TRB;
  Params q = p;
  q.nseq = TRB / p.S;
  const int ntiles = (p.B + q.nseq - 1) / q.nseq;
  int rc = prepare(train_attn_kernel<MAXT, SAVE>, AttnCfg<MAXT>::SMEM);
  if (rc) return rc;
  train_attn_kernel<MAXT, SAVE><<<dim3(ntiles, NH), 256, AttnCfg<MAXT>::SMEM, stream>>>(q, t);
  return (int)cudaGetLastError();
}

template <bool SAVE>
int launch_train(const Maps& maps, const Params& p, const Train& t, cudaStream_t st) {
  const int tiles = (int)((p.rows + TR - 1) / TR);
  const uint32_t smem1 = QkvLayout().total;
  int rc = prepare(train_qkv_kernel, smem1);
  if (rc) return rc;
  train_qkv_kernel<<<std::min(tiles, sm_count()), THREADS, smem1, st>>>(maps, p);
  if ((rc = (int)cudaGetLastError())) return rc;
  rc = p.S <= 32 ? launch_train_attn<4, SAVE>(p, t, st) : launch_train_attn<LONG_S / 16, SAVE>(p, t, st);
  if (rc) return rc;
  const uint32_t smem3 = OutLayout(p.F).total;
  if ((rc = prepare(train_out_ffn_kernel<SAVE>, smem3))) return rc;
  train_out_ffn_kernel<SAVE><<<std::min(tiles, sm_count()), THREADS, smem3, st>>>(maps, p, t);
  return (int)cudaGetLastError();
}

// ================================================================ K10 and K11's forward
// The attention block alone at D = 256 in float32, any S up to 256
// (ops/attention.py): K2's three launches without LN1, the residual, LN2 and
// the FF. mha_qkv_kernel is qkv_tiles without LN1 (x rounded to TF32 as it
// is staged); the attention is K4's train_attn_kernel without its save (K11's
// dropout where t.thr > 0, K10 none); mha_out_kernel runs the out projection
// onto bo over 128-row tiles of the context, which lands by TMA, as
// out_ffn_kernel's first product.
constexpr int MHA_OUT_STAGES = 4;

__global__ void __launch_bounds__(THREADS, 1)
    mha_qkv_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Params p) {
  qkv_tiles<false>(maps, p);
}

struct MhaOutLayout {
  uint32_t ctx, ring, prm, bars, total;
  __host__ __device__ MhaOutLayout() {
    Carve c;
    ctx = c.take(NSL * TR * 128);
    ring = c.take(MHA_OUT_STAGES * layer_infer::STAGE);
    prm = c.take(DM * 4, 16);
    bars = c.take((2 * MHA_OUT_STAGES + NSL + 1) * 8, 8);
    total = c.off + 1024;
  }
};

// p.F = 0: the producer's produce_out_ffn streams the context and Wo alone
__global__ void __launch_bounds__(THREADS, 1)
    mha_out_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Params p) {
  const MhaOutLayout L;
  unsigned char* base = smem_base();
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* cfull = bars + 2 * MHA_OUT_STAGES;  // a barrier a slice of the context
  uint64_t* cempty = cfull + NSL;
  layer_infer::Ring ring;
  ring.init(base + L.ring, bars, MHA_OUT_STAGES);
  if (threadIdx.x == 0) {
    init_ring_bars(bars, MHA_OUT_STAGES);
    for (int k = 0; k < NSL; ++k) mbar_init(&cfull[k], 1);
    mbar_init(cempty, CONSUMERS);
    fence_barrier_init();
  }
  __syncthreads();
  const int ntiles = (int)((p.rows + TR - 1) / TR);
  unsigned char* ctxs = base + L.ctx;

  if (threadIdx.x >= CONSUMERS) {  // the producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS) produce_out_ffn(maps, p, ring, ctxs, cfull, cempty, ntiles);
    return;
  }

  setmaxnreg_inc<240>();
  const Lane ln;
  float* prm = reinterpret_cast<float*>(base + L.prm);
  for (int i = ln.tid; i < DM; i += CONSUMERS) prm[i] = p.bo[i];
  named_barrier(1, CONSUMERS);
  const int rb = 64 * ln.wg;
  const uint32_t ctx_a = smem_u32(ctxs) + rb * 128;
  PipeState cs;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * TR;
    const int nrows = (int)min((long long)TR, p.rows - (long long)row0);
    float acc[2][64];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 bo = lds2(prm + 128 * n + 8 * j + 2 * ln.t4);
        acc[n][4 * j] = acc[n][4 * j + 2] = bo.x;
        acc[n][4 * j + 1] = acc[n][4 * j + 3] = bo.y;
      }
#pragma unroll 1
    for (int k = 0; k < NSL; ++k) {
      mbar_wait(&cfull[k], cs.phase);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const uint32_t st = ring.acquire();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k8_tf32(acc[n], desc_sw128(ctx_a + k * (TR * 128) + 32 * kk),
                               desc_sw128(st + 32 * kk), 1);
        wgmma_commit();
        ring.keep1();
      }
    }
    ring.drain();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    mbar_arrive(cempty);  // this warpgroup is done with the tile's context rows
    cs.advance(1);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = rb + ln.r0 + 8 * rr;
      if (r >= nrows) continue;
      float* o = p.out + (row0 + r) * DM;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          store2(o + 128 * n + 8 * j + 2 * ln.t4, acc[n][4 * j + 2 * rr],
                 acc[n][4 * j + 2 * rr + 1]);
    }
  }
}

// the attention block's parameters and tensor maps (Wqkv, Wo, the context;
// F = 0, no LayerNorm, FF or seq_bias), the maps encoded once for each set
// of addresses
int mha_setup(Params* p, Maps* maps, const void* x, const void* wqkv, const void* bqkv,
              const void* wo, const void* bo, const void* mask, void* qkv, void* ctx, void* out,
              int B, int S, int causal, float scale) {
  *p = Params{};
  *maps = Maps{};
  p->x = (const float*)x;
  p->bqkv = (const float*)bqkv;
  p->bo = (const float*)bo;
  p->mask = (const float*)mask;
  p->out = (float*)out;
  p->qkv = (float*)qkv;
  p->ctx = (float*)ctx;
  p->rows = (long long)B * S;
  p->B = B;
  p->S = S;
  p->causal = causal;
  p->scale = scale;
  int rc = make_tma_2d_cached(&maps->qkv, wqkv, true, DM, 3 * DM, DM * 4, KS, 32);
  if (rc == 0 && wo != nullptr)
    rc = make_tma_2d_cached(&maps->o, wo, true, DM, DM, DM * 4, KS, 128);
  if (rc == 0 && ctx != nullptr)
    rc = make_tma_2d_cached(&maps->ctx, ctx, true, DM, (uint64_t)p->rows, DM * 4, KS, TR);
  return rc;
}

int launch_mha_qkv(const Maps& maps, const Params& p, cudaStream_t st) {
  const int tiles = (int)((p.rows + TR - 1) / TR);
  const uint32_t smem = QkvLayout().total;
  int rc = prepare(mha_qkv_kernel, smem);
  if (rc) return rc;
  mha_qkv_kernel<<<std::min(tiles, sm_count()), THREADS, smem, st>>>(maps, p);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace layer_f32

// K10 and K11's forward in float32 at D = 256, 8 heads, 1 <= S <= 256
// (ops/attention.py): three launches through qkv [H][B*S][96] and ctx
// [B*S][D] (float32 scratch; ctx holds the context). x [B*S][D], wqkv
// [3D][D] and wo [D][D] rounded to TF32, bqkv [3D], bo [D], mask [B][S],
// out [B*S][D]; thr = floor(rate 2^24) (0: no dropout), kp = 1 / (1 - rate).
// qkv_rows [B*S][3D] and p_save [B][H][S][S], if not null, receive the
// forward's QKV row-major and its probabilities before dropout (each row's
// keys up to its warp's last row's when causal).
extern "C" int dsvg_mha_f32(const void* x, const void* wqkv, const void* bqkv, const void* wo,
                            const void* bo, const void* mask, void* out, void* qkv, void* ctx,
                            void* qkv_rows, void* p_save, int B, int S, int causal, int seed,
                            int thr, float kp, float scale, void* stream) {
  using namespace layer_f32;
  if (B < 1 || S < 1 || S > LONG_S || qkv == nullptr || ctx == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Params p;
  Maps maps;
  int rc = mha_setup(&p, &maps, x, wqkv, bqkv, wo, bo, mask, qkv, ctx, out, B, S, causal, scale);
  if (rc) return rc;
  p.qkv_rows = (float*)qkv_rows;
  if ((rc = launch_mha_qkv(maps, p, st))) return rc;
  const Train t = {(float*)p_save, nullptr, nullptr, seed, (unsigned)thr, kp};
  if (p_save != nullptr)
    rc = S <= 32 ? launch_train_attn<4, true>(p, t, st)
                 : launch_train_attn<LONG_S / 16, true>(p, t, st);
  else
    rc = S <= 32 ? launch_train_attn<4, false>(p, t, st)
                 : launch_train_attn<LONG_S / 16, false>(p, t, st);
  if (rc) return rc;
  const uint32_t smem = MhaOutLayout().total;
  if ((rc = prepare(mha_out_kernel, smem))) return rc;
  mha_out_kernel<<<std::min((int)((p.rows + TR - 1) / TR), sm_count()), THREADS, smem, st>>>(maps,
                                                                                           p);
  return (int)cudaGetLastError();
}

// K11's backward in float32 at D = 256, 8 heads, 1 <= S <= 256, its first
// launches (layer_f32_bwd.cu's dsvg_mha_bwd_f32 runs them first): the first
// two of dsvg_mha_f32 in save mode on its operands x, wqkv (rounded to TF32),
// bqkv and mask: QKV head-major into qkv [H][B*S][96] (and row-major into
// qkv_rows [B*S][3D] if not null), the probabilities before dropout into p
// [B][H][S][S] (each row's keys up to its warp's last row's when causal) and
// the context into ctx [B*S][D], equal to the bit to the forward's.
extern "C" int dsvg_mha_recompute_f32(const void* x, const void* wqkv, const void* bqkv,
                                      const void* mask, void* qkv, void* qkv_rows, void* p_save,
                                      void* ctx, int B, int S, int causal, int seed, int thr,
                                      float kp, float scale, void* stream) {
  using namespace layer_f32;
  if (B < 1 || S < 1 || S > LONG_S || qkv == nullptr || p_save == nullptr || ctx == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Params p;
  Maps maps;
  int rc = mha_setup(&p, &maps, x, wqkv, bqkv, nullptr, nullptr, mask, qkv, nullptr, nullptr, B, S,
                     causal, scale);
  if (rc) return rc;
  p.ctx = (float*)ctx;
  p.qkv_rows = (float*)qkv_rows;
  if ((rc = launch_mha_qkv(maps, p, st))) return rc;
  const Train t = {(float*)p_save, nullptr, nullptr, seed, (unsigned)thr, kp};
  return S <= 32 ? launch_train_attn<4, true>(p, t, st)
                 : launch_train_attn<LONG_S / 16, true>(p, t, st);
}

// Whether the float32 wgmma forms take these widths (else the older wmma
// code of layer_fwd.cuh / layer_long.cuh runs): D = 256 with 8 heads, F a
// multiple of 64 up to 1024, 1 <= S <= 256.
extern "C" int dsvg_layer_f32_hopper(int D, int F, int H, int S) {
  using namespace layer_f32;
  return D == DM && H == NH && F % FC == 0 && F > 0 && F <= MAX_F && S >= 1 && S <= LONG_S;
}

namespace layer_f32 {
namespace {

// the launches' parameters and tensor maps
int setup(Params* p, Maps* maps, const void* x, const void* seq_bias, const void* ln1,
          const void* wqkv, const void* bqkv, const void* wo, const void* bo, const void* ln2,
          const void* w1, const void* b1, const void* w2, const void* b2, const void* mask,
          void* qkv, void* ctx, void* out, int B, int S, int F, int causal, float scale) {
  p->x = (const float*)x;
  p->seq_bias = (const float*)seq_bias;
  p->ln1 = (const float*)ln1;
  p->bqkv = (const float*)bqkv;
  p->bo = (const float*)bo;
  p->ln2 = (const float*)ln2;
  p->b1 = (const float*)b1;
  p->b2 = (const float*)b2;
  p->mask = (const float*)mask;
  p->out = (float*)out;
  p->qkv = (float*)qkv;
  p->ctx = (float*)ctx;
  p->rows = (long long)B * S;
  p->B = B;
  p->S = S;
  p->F = F;
  p->causal = causal;
  p->nseq = 0;
  p->scale = scale;
  p->qkv_rows = nullptr;
  int rc = bind_device_of(wqkv);
  if (rc == 0) rc = make_tma_2d(&maps->qkv, wqkv, true, DM, 3 * DM, DM * 4, KS, 32);
  if (rc == 0) rc = make_tma_2d(&maps->o, wo, true, DM, DM, DM * 4, KS, 128);
  if (rc == 0) rc = make_tma_2d(&maps->w1, w1, true, DM, F, DM * 4, KS, FC);
  if (rc == 0) rc = make_tma_2d(&maps->w2, w2, true, F, DM, (uint64_t)F * 4, KS, 128);
  if (rc == 0) rc = make_tma_2d(&maps->ctx, ctx, true, DM, (uint64_t)p->rows, DM * 4, KS, TR);
  return rc;
}

}  // namespace
}  // namespace layer_f32

// K2 in float32 at the widths dsvg_layer_f32_hopper takes: three launches,
// QKV through qkv [H][B*S][96] and the context through ctx [B*S][D], float32
// scratch. The weights are float32 rounded to TF32.
extern "C" int dsvg_layer_f32(const void* x, const void* seq_bias, const void* ln1,
                              const void* wqkv, const void* bqkv, const void* wo, const void* bo,
                              const void* ln2, const void* w1, const void* b1, const void* w2,
                              const void* b2, const void* mask, void* qkv, void* ctx, void* out,
                              int B, int S, int F, int causal, float scale, void* stream) {
  using namespace layer_f32;
  if (!dsvg_layer_f32_hopper(DM, F, NH, S) || B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Params p;
  Maps maps;
  int rc = setup(&p, &maps, x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask, qkv,
                 ctx, out, B, S, F, causal, scale);
  if (rc) return rc;
  const int tiles = (int)((p.rows + TR - 1) / TR);
  const uint32_t smem1 = QkvLayout().total;
  if ((rc = prepare(qkv_kernel, smem1))) return rc;
  qkv_kernel<<<std::min(tiles, sm_count()), THREADS, smem1, st>>>(maps, p);
  if ((rc = (int)cudaGetLastError())) return rc;
  rc = S <= 32 ? launch_attn<4>(p, st) : launch_attn<LONG_S / 16>(p, st);
  if (rc) return rc;
  const uint32_t smem3 = OutLayout(F).total;
  if ((rc = prepare(out_ffn_kernel, smem3))) return rc;
  out_ffn_kernel<<<std::min(tiles, sm_count()), THREADS, smem3, st>>>(maps, p);
  return (int)cudaGetLastError();
}

// K4's float32 long form, forward, at the widths dsvg_layer_f32_hopper takes
// with F a multiple of 256 (its backward's weight products take 128 x 256
// tiles): three launches. qkv [H][B*S][96] and ctx [B*S][D] pass QKV and the
// context between them, x1 [B*S][D] the residual after the attention block;
// in the saved mode (p_s not null) these are saved with the probabilities
// before dropout p_s [B][H][S][S] and the FF hidden before dropout h_s
// [B*S][F]; in the recompute mode (p_s and h_s null) they are scratch and
// `out` alone is the result, to the bit the saved mode's. The weights are
// float32 rounded to TF32; thr = floor(rate 2^24), kp = 1 / (1 - rate).
extern "C" int dsvg_layer_f32_train(const void* x, const void* seq_bias, const void* ln1,
                                    const void* wqkv, const void* bqkv, const void* wo,
                                    const void* bo, const void* ln2, const void* w1,
                                    const void* b1, const void* w2, const void* b2,
                                    const void* mask, void* out, void* qkv, void* p_s, void* ctx,
                                    void* x1, void* h_s, int B, int S, int F, int causal, int seed,
                                    int thr, float kp, float scale, void* stream) {
  using namespace layer_f32;
  if (!dsvg_layer_f32_hopper(DM, F, NH, S) || F % 256 || B < 1 || (p_s == nullptr) != (h_s == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  Maps maps;
  const int rc = setup(&p, &maps, x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                       qkv, ctx, out, B, S, F, causal, scale);
  if (rc) return rc;
  const Train t = {(float*)p_s, (float*)x1, (float*)h_s, seed, (unsigned)thr, kp};
  return p_s != nullptr ? launch_train<true>(maps, p, t, (cudaStream_t)stream)
                        : launch_train<false>(maps, p, t, (cudaStream_t)stream);
}
