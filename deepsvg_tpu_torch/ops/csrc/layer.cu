// K2 and the forward of K4, saved and recompute mode: one fused pre-LN
// transformer layer per launch (see ops/layer.py and ops/layer_vjp.py). K2's
// bfloat16 form at D = 256 with 8 heads is the wgmma kernel below, on
// layer_infer.cuh's device code; K4's bfloat16 short form at D = 256 is the
// wgmma kernel after it, with layer_train.cuh's additions. The float32
// forms, and both types at the other widths (head dim 8, 16 or 32: a
// template parameter, picked from D / H at the entry points), run the
// device code of layer_fwd.cuh, which K7's stack forward (stack.cu) and K4's
// recompute backward (layer_bwd.cu) run too.
#include "layer_fwd.cuh"
#include "layer_train.cuh"

using namespace layer_fwd;

// ---- K2's bfloat16 form (device code in layer_infer.cuh)
namespace layer_infer {
namespace {

constexpr int SHORT_STAGES = 4;  // weight stages of the ring (the rest of shared memory is full)

struct ShortLayout {
  uint32_t xn, ctx, kv, ring, prm, mask, bars, total;
  __host__ __device__ explicit ShortLayout(int F) {
    Carve c;
    xn = c.take(KSL * TR * 128);
    ctx = c.take(KSL * TR * 128);
    kv = c.take(2 * TR * LDH * 2);
    ring = c.take(SHORT_STAGES * STAGE);
    prm = c.take(params_all(F) * 4, 16);
    mask = c.take(TR * 4, 16);
    bars = c.take(2 * SHORT_STAGES * 8, 8);
    total = c.off + 1024;
  }
};

__global__ void __launch_bounds__(THREADS, 1)
    infer_short_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Params p) {
  const ShortLayout L(p.F);
  unsigned char* base = smem_base();
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bars);
  Ring ring;
  ring.init(base + L.ring, bars, SHORT_STAGES);
  if (threadIdx.x == 0) {
    init_ring_bars(bars, SHORT_STAGES);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer
    setmaxnreg_dec<24>();
    if (threadIdx.x != CONSUMERS) return;
    for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
      produce_x(ring, maps, tile * p.nseq * p.S);
      for (int h = 0; h < NH; ++h) produce_qkv_head(ring, maps, h);
      produce_out_ff(ring, maps, p.F);
    }
    return;
  }

  setmaxnreg_inc<240>();
  const Lane ln;
  float* prm = reinterpret_cast<float*>(base + L.prm);
  load_params(p, prm, params_all(p.F));
  float* mask = reinterpret_cast<float*>(base + L.mask);
  unsigned char* xn = base + L.xn;
  unsigned char* ctxs = base + L.ctx;
  const uint32_t xn_a = smem_u32(xn) + ln.wg * 64 * 128;
  const uint32_t ctx_a = smem_u32(ctxs) + ln.wg * 64 * 128;
  bf16* kb = reinterpret_cast<bf16*>(base + L.kv);
  bf16* vb = kb + TR * LDH;
  const uint32_t ks = smem_u32(kb), vs = smem_u32(vb);
  const int q0 = 64 * ln.wg + 16 * ln.w;  // the warp's query rows in the tile
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const int seq0 = tile * p.nseq;
    const int nrows = min(p.nseq, p.B - seq0) * p.S;
    const size_t row0 = (size_t)seq0 * p.S;
    const Rows R = {row0, seq0, nrows, 64 * ln.wg, p.S};
    named_barrier(1, CONSUMERS);  // the last tile's readers of the mask are done
    if (ln.tid < TR) mask[ln.tid] = ln.tid < nrows ? p.mask[row0 + ln.tid] : 0.f;
    ln1_tile(ring, prm, p.F, nrows, ln, xn);

#pragma unroll 1
    for (int h = 0; h < NH; ++h) {
      float acc[48];
      qkv_head_product(ring, xn_a, TR * 128, acc);
      // Q to A fragments; K and V (+ bias, bf16) to shared memory
      uint32_t qf[2][4];
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int part = j >> 2, c = 8 * (j & 3) + 2 * ln.t4;  // column within the part
        const float2 b = lds2(prm + p_bqkv(p.F) + part * DM + h * HEAD_DIM + c);
        const uint32_t lo = pack_bf16(acc[4 * j] + b.x, acc[4 * j + 1] + b.y);
        const uint32_t hi = pack_bf16(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
        if (part == 0) {
          qf[j >> 1][(j & 1) * 2] = lo;
          qf[j >> 1][(j & 1) * 2 + 1] = hi;
        } else {
          bf16* dst = (part == 1 ? kb : vb) + (64 * ln.wg + ln.r0) * LDH + c;
          *reinterpret_cast<uint32_t*>(dst) = lo;
          *reinterpret_cast<uint32_t*>(dst + 8 * LDH) = hi;
        }
      }
      named_barrier(1, CONSUMERS);  // every row's K and V are in
      float o[4][4];
      attend_rows<4>(qf, ks, vs, TR, q0, nrows, p.S, p.causal, mask, p.scale, ln.lane, o);
      store_ctx(ctxs, TR, q0, h, o, ln.lane);
      named_barrier(1, CONSUMERS);  // every warp is done with K and V
    }
    fence_proxy_async();  // the context, as wgmma's A operand (the warpgroup's own rows)
    named_barrier(2 + ln.wg, 128);

    // out projection onto the residual
    float acc[2][64];
    residual_init(p, prm, ln, R, acc);
#pragma unroll
    for (int k = 0; k < KSL; ++k)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const uint32_t st = ring.acquire();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k16_bf16(acc[n], desc_sw128(ctx_a + k * (TR * 128) + 32 * kk),
                                desc_sw128(st + 32 * kk), 1);
        wgmma_commit();
        ring.keep1();
      }
    ring.drain();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    ln2_rows(prm, ln, R, acc, xn, TR);
    fence_proxy_async();
    named_barrier(2 + ln.wg, 128);
    // the hidden chunks go to this warpgroup's context rows of slices 0 and 1
    ff_store(p, prm, ln, R, ring, xn_a, TR * 128, ctx_a, TR * 128, acc);
  }
}

// the short form: 1 <= S <= 32, D = DM, F a multiple of FC up to MAX_F
int launch_short(Params p, const void* wqkv, const void* wo, const void* w1, const void* w2,
                 cudaStream_t stream) {
  if (p.S < 1 || p.S > 32 || p.F % FC || p.F > MAX_F) return (int)cudaErrorInvalidValue;
  p.nseq = TR / p.S;
  p.ntiles = (p.B + p.nseq - 1) / p.nseq;
  Maps maps;
  int rc = make_maps(&maps, wqkv, wo, w1, w2, p.x, (long long)p.B * p.S, p.F);
  if (rc) return rc;
  const uint32_t smem = ShortLayout(p.F).total;
  if ((rc = prepare(infer_short_kernel, smem))) return rc;
  infer_short_kernel<<<std::min(p.ntiles, sm_count()), THREADS, smem, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

// ---- K4's bfloat16 short form (device code in layer_train.cuh): K2's
// walk with dropout, the saves (SAVE) and x1 through device memory
template <bool SAVE>
__global__ void __launch_bounds__(THREADS, 1)
    train_short_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Params p,
                       const __grid_constant__ layer_train::Train t) {
  const ShortLayout L(p.F);
  unsigned char* base = smem_base();
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bars);
  Ring ring;
  ring.init(base + L.ring, bars, SHORT_STAGES);
  if (threadIdx.x == 0) {
    init_ring_bars(bars, SHORT_STAGES);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer: K2's stages
    setmaxnreg_dec<24>();
    if (threadIdx.x != CONSUMERS) return;
    for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
      produce_x(ring, maps, tile * p.nseq * p.S);
      for (int h = 0; h < NH; ++h) produce_qkv_head(ring, maps, h);
      produce_out_ff(ring, maps, p.F);
    }
    return;
  }

  setmaxnreg_inc<240>();
  const Lane ln;
  float* prm = reinterpret_cast<float*>(base + L.prm);
  load_params(p, prm, params_all(p.F));
  float* mask = reinterpret_cast<float*>(base + L.mask);
  unsigned char* xn = base + L.xn;
  unsigned char* ctxs = base + L.ctx;
  const uint32_t xn_a = smem_u32(xn) + ln.wg * 64 * 128;
  const uint32_t ctx_a = smem_u32(ctxs) + ln.wg * 64 * 128;
  bf16* kb = reinterpret_cast<bf16*>(base + L.kv);
  bf16* vb = kb + TR * LDH;
  const uint32_t ks = smem_u32(kb), vs = smem_u32(vb);
  const int q0 = 64 * ln.wg + 16 * ln.w;  // the warp's query rows in the tile
  const unsigned key_ap = site_key(t.seed, SITE_ATTN_PROB);
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const int seq0 = tile * p.nseq;
    const int nrows = min(p.nseq, p.B - seq0) * p.S;
    const size_t row0 = (size_t)seq0 * p.S;
    const Rows R = {row0, seq0, nrows, 64 * ln.wg, p.S};
    named_barrier(1, CONSUMERS);  // the last tile's readers of the mask are done
    if (ln.tid < TR) mask[ln.tid] = ln.tid < nrows ? p.mask[row0 + ln.tid] : 0.f;
    ln1_tile(ring, prm, p.F, nrows, ln, xn);

#pragma unroll 1
    for (int h = 0; h < NH; ++h) {
      float acc[48];
      qkv_head_product(ring, xn_a, TR * 128, acc);
      uint32_t qf[2][4];
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int part = j >> 2, c = 8 * (j & 3) + 2 * ln.t4;
        const float2 b = lds2(prm + p_bqkv(p.F) + part * DM + h * HEAD_DIM + c);
        const uint32_t lo = pack_bf16(acc[4 * j] + b.x, acc[4 * j + 1] + b.y);
        const uint32_t hi = pack_bf16(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
        if constexpr (SAVE) {
          const int r = 64 * ln.wg + ln.r0;
          bf16* dst = t.qkv + (row0 + r) * layer_train::QKV_W + part * DM + h * HEAD_DIM + c;
          if (r < nrows) *reinterpret_cast<uint32_t*>(dst) = lo;
          if (r + 8 < nrows) *reinterpret_cast<uint32_t*>(dst + 8 * layer_train::QKV_W) = hi;
        }
        if (part == 0) {
          qf[j >> 1][(j & 1) * 2] = lo;
          qf[j >> 1][(j & 1) * 2 + 1] = hi;
        } else {
          bf16* dst = (part == 1 ? kb : vb) + (64 * ln.wg + ln.r0) * LDH + c;
          *reinterpret_cast<uint32_t*>(dst) = lo;
          *reinterpret_cast<uint32_t*>(dst + 8 * LDH) = hi;
        }
      }
      named_barrier(1, CONSUMERS);  // every row's K and V are in
      const layer_train::AttnDrop drop(SAVE ? t.p : nullptr, key_ap, t.thr, t.kp, seq0, p.S, h,
                                       nrows, q0 + ln.g);
      float o[4][4];
      attend_rows<4>(qf, ks, vs, TR, q0, nrows, p.S, p.causal, mask, p.scale, ln.lane, o, drop);
      store_ctx(ctxs, TR, q0, h, o, ln.lane);
      named_barrier(1, CONSUMERS);  // every warp is done with K and V
    }
    fence_proxy_async();  // the context, as wgmma's A operand (the warpgroup's own rows)
    named_barrier(2 + ln.wg, 128);
    if constexpr (SAVE) layer_train::save_ctx(t.ctx, ctxs, ln, R);

    // the out projection alone; x1 = x + dropout(. + bo) (+ seq_bias) and
    // LN2 a row a warp
    float acc[2][64];
#pragma unroll
    for (int k = 0; k < KSL; ++k)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const uint32_t st = ring.acquire();
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k16_bf16(acc[n], desc_sw128(ctx_a + k * (TR * 128) + 32 * kk),
                                desc_sw128(st + 32 * kk), (k | kk) ? 1 : 0);
        wgmma_commit();
        ring.keep1();
      }
    ring.drain();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    layer_train::attn_out_train(t, prm, ln, R, acc);
    __syncwarp();  // the warp's rows of the attention output are written
    layer_train::residual_ln2(p, t, prm, ln, R, xn);
    fence_proxy_async();
    named_barrier(2 + ln.wg, 128);
    layer_train::ff_train<SAVE>(p, t, prm, ln, R, ring, xn_a, TR * 128, ctx_a, TR * 128, acc);
  }
}

// K4's bfloat16 short form: D = DM, 1 <= S <= 32, F a multiple of FC up to
// MAX_F; SAVE: the saved mode, else the recompute mode (t.x1 a scratch)
template <bool SAVE>
int launch_train(Params p, const layer_train::Train& t, const void* wqkv, const void* wo,
                 const void* w1, const void* w2, cudaStream_t stream) {
  if (p.S < 1 || p.S > 32 || p.F % FC || p.F > MAX_F) return (int)cudaErrorInvalidValue;
  p.nseq = TR / p.S;
  p.ntiles = (p.B + p.nseq - 1) / p.nseq;
  Maps maps;
  int rc = make_maps(&maps, wqkv, wo, w1, w2, p.x, (long long)p.B * p.S, p.F);
  if (rc) return rc;
  const uint32_t smem = ShortLayout(p.F).total;
  if ((rc = prepare(train_short_kernel<SAVE>, smem))) return rc;
  train_short_kernel<SAVE><<<std::min(p.ntiles, sm_count()), THREADS, smem, stream>>>(maps, p, t);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace layer_infer

namespace {

template <class T, int ROWS, int HD, bool TRAIN, int MODE>
__global__ void __launch_bounds__(NTHREADS) layer_kernel(LayerParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  layer_tile<T, ROWS, HD, TRAIN, MODE>(p, smem);
}

// the layer_fwd.cuh kernel at the head dim D / H (8, 16 or 32; any other is
// refused)
template <class T, int ROWS, bool TRAIN, int MODE = FWD_SAVE>
int launch(LayerParams<T> p, cudaStream_t stream) {
  p.nseq = ROWS / p.S;
  const size_t smem = smem_bytes<T, ROWS>(p.D, p.F);
  return with_head_dim(p.D, p.H, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    cudaError_t err = cudaFuncSetAttribute(layer_kernel<T, ROWS, HD, TRAIN, MODE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (p.B + p.nseq - 1) / p.nseq;
    layer_kernel<T, ROWS, HD, TRAIN, MODE><<<blocks, NTHREADS, smem, stream>>>(p);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// Inference layer. is_f32: activations and weights are float (TF32 products),
// else bf16: at D = 256 with 8 heads (F a multiple of 64 up to 1024) the
// wgmma kernel of layer_infer.cuh, at other widths (head dim 8, 16 or 32)
// layer_fwd.cuh's on 64-row blocks.
extern "C" int dsvg_layer(const void* x, const void* seq_bias, const void* ln1,
                          const void* wqkv, const void* bqkv, const void* wo,
                          const void* bo, const void* ln2, const void* w1,
                          const void* b1, const void* w2, const void* b2,
                          const void* mask, void* out, int B, int S, int D,
                          int F, int H, int causal, int is_f32, float scale,
                          void* stream) {
  if (is_f32)
    return launch<float, 32, false>(
        make_params<float>(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2,
                           mask, out, B, S, D, F, H, causal, scale),
        (cudaStream_t)stream);
  if (D != layer_infer::DM || H != layer_infer::NH)
    return launch<bf16, 64, false>(
        make_params<bf16>(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask, out,
                          B, S, D, F, H, causal, scale),
        (cudaStream_t)stream);
  return layer_infer::launch_short(
      layer_infer::make_params(x, seq_bias, ln1, bqkv, bo, ln2, b1, b2, mask, out, B, S, F,
                               causal, scale),
      wqkv, wo, w1, w2, (cudaStream_t)stream);
}

// Whether K4's bfloat16 short form runs its wgmma kernels at these widths
// (else the older wmma kernels): forward and backward dispatch by it.
extern "C" int dsvg_layer_train_hopper(int D, int F, int H, int S) {
  return layer_train::hopper_form(D, F, H, S) ? 1 : 0;
}

// Training forward: dropout (thr = floor(rate * 2^24), kp = 1 / (1 - rate))
// and the saved tensors.
extern "C" int dsvg_layer_train_fwd(
    const void* x, const void* seq_bias, const void* ln1, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* ln2,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* mask, void* out, void* qkv_s, void* p_s, void* ctx_s, void* x1_s,
    void* h_s, int B, int S, int D, int F, int H, int causal, int is_f32, int seed,
    int thr, float kp, float scale, void* stream) {
  if (is_f32) {
    LayerParams<float> p = make_params<float>(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2,
                                              w1, b1, w2, b2, mask, out, B, S, D, F, H,
                                              causal, scale);
    p.qkv_s = (float*)qkv_s;
    p.p_s = (float*)p_s;
    p.ctx_s = (float*)ctx_s;
    p.x1_s = (float*)x1_s;
    p.h_s = (float*)h_s;
    p.seed = seed;
    p.thr = (unsigned)thr;
    p.kp = kp;
    return launch<float, 32, true>(p, (cudaStream_t)stream);
  }
  if (layer_train::hopper_form(D, F, H, S)) {
    const layer_train::Train t = {(bf16*)qkv_s, (bf16*)p_s, (bf16*)ctx_s, (float*)x1_s,
                                  (bf16*)h_s, seed, (unsigned)thr, kp};
    return layer_infer::launch_train<true>(
        layer_infer::make_params(x, seq_bias, ln1, bqkv, bo, ln2, b1, b2, mask, out, B, S, F,
                                 causal, scale),
        t, wqkv, wo, w1, w2, (cudaStream_t)stream);
  }
  LayerParams<bf16> p = make_params<bf16>(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1,
                                          b1, w2, b2, mask, out, B, S, D, F, H, causal,
                                          scale);
  p.qkv_s = (bf16*)qkv_s;
  p.p_s = (bf16*)p_s;
  p.ctx_s = (bf16*)ctx_s;
  p.x1_s = (float*)x1_s;
  p.h_s = (bf16*)h_s;
  p.seed = seed;
  p.thr = (unsigned)thr;
  p.kp = kp;
  return launch<bf16, 64, true>(p, (cudaStream_t)stream);
}

// Training forward of the recompute mode: dropout as dsvg_layer_train_fwd,
// `out` alone written (to the bit the saved mode's). The arguments are
// dsvg_layer_train_fwd's; of the five saved-tensor pointers only x1_s is
// read, by the bfloat16 wgmma form: a float32 [B*S][D] scratch for x1.
extern "C" int dsvg_layer_train_fwd_recompute(
    const void* x, const void* seq_bias, const void* ln1, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* ln2,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* mask, void* out, void*, void*, void*, void* x1_s, void*, int B, int S, int D,
    int F, int H, int causal, int is_f32, int seed, int thr, float kp, float scale,
    void* stream) {
  if (is_f32) {
    LayerParams<float> p = make_params<float>(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2,
                                              w1, b1, w2, b2, mask, out, B, S, D, F, H,
                                              causal, scale);
    p.seed = seed;
    p.thr = (unsigned)thr;
    p.kp = kp;
    return launch<float, 32, true, FWD_OUT>(p, (cudaStream_t)stream);
  }
  if (layer_train::hopper_form(D, F, H, S)) {
    const layer_train::Train t = {nullptr, nullptr, nullptr, (float*)x1_s, nullptr, seed,
                                  (unsigned)thr, kp};
    return layer_infer::launch_train<false>(
        layer_infer::make_params(x, seq_bias, ln1, bqkv, bo, ln2, b1, b2, mask, out, B, S, F,
                                 causal, scale),
        t, wqkv, wo, w1, w2, (cudaStream_t)stream);
  }
  LayerParams<bf16> p = make_params<bf16>(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1,
                                          b1, w2, b2, mask, out, B, S, D, F, H, causal,
                                          scale);
  p.seed = seed;
  p.thr = (unsigned)thr;
  p.kp = kp;
  return launch<bf16, 64, true, FWD_OUT>(p, (cudaStream_t)stream);
}
