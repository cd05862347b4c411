// K2, long form (see ops/layer.py): one fused pre-LN layer over sequences of
// up to 256 rows in two launches. The bfloat16 form is the two wgmma kernels
// below, on layer_infer.cuh's device code; the float32 form runs the device
// code of layer_long.cuh, which K4's long form (layer_long_train.cu) compiles
// with its training switch.
#include "layer_infer.cuh"
#include "layer_long.cuh"

using namespace layer_long;

// ---- K2's bfloat16 long form (device code in layer_infer.cuh)
namespace layer_infer {
namespace {

constexpr int QKV_STAGES = 6;   // weight stages of the first launch's ring
constexpr int LONG_STAGES = 3;  // and of the second's (the context takes 128 KB)

// ---------------------------------------------------------------- long form, launch 1
struct QkvLayout {
  uint32_t xn, stage_out, ring, prm, bars, total;
  __host__ __device__ explicit QkvLayout(int F) {
    Carve c;
    xn = c.take(KSL * TR * 128);
    stage_out = c.take(TR * LDQ * 2);
    ring = c.take(QKV_STAGES * STAGE);
    prm = c.take(params_all(F) * 4, 16);
    bars = c.take(2 * QKV_STAGES * 8, 8);
    total = c.off + 1024;
  }
};

// LN1 and QKV (+ bias, bf16) of 128-row tiles of all B*S rows into p.qkv,
// head-major: head h's rows [h][B*S][96] (q | k | v), so that the second
// launch reads a head's rows contiguously
__global__ void __launch_bounds__(THREADS, 1)
    infer_qkv_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Params p) {
  const QkvLayout L(p.F);
  unsigned char* base = smem_base();
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bars);
  Ring ring;
  ring.init(base + L.ring, bars, QKV_STAGES);
  if (threadIdx.x == 0) {
    init_ring_bars(bars, QKV_STAGES);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    setmaxnreg_dec<24>();
    if (threadIdx.x != CONSUMERS) return;
    for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
      produce_x(ring, maps, tile * TR);
      for (int h = 0; h < NH; ++h) produce_qkv_head(ring, maps, h);
    }
    return;
  }

  setmaxnreg_inc<240>();
  const Lane ln;
  float* prm = reinterpret_cast<float*>(base + L.prm);
  load_params(p, prm, params_all(p.F));
  named_barrier(1, CONSUMERS);
  unsigned char* xn = base + L.xn;
  const uint32_t xn_a = smem_u32(xn) + ln.wg * 64 * 128;
  bf16* so = reinterpret_cast<bf16*>(base + L.stage_out) + ln.wg * 64 * LDQ;  // this warpgroup's rows
  const long long total = (long long)p.B * p.S;
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * TR;
    const int nrows = (int)min((long long)TR, total - (long long)row0);
    ln1_tile(ring, prm, p.F, nrows, ln, xn);
    const int r_lo = 64 * ln.wg, nmine = max(0, min(64, nrows - r_lo));  // this warpgroup's valid rows
    for (int h = 0; h < NH; ++h) {
      float acc[48];
      qkv_head_product(ring, xn_a, TR * 128, acc);
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int c = 8 * j + 2 * ln.t4;
        const float2 b = lds2(prm + p_bqkv(p.F) + (j >> 2) * DM + h * HEAD_DIM + (c & 31));
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          *reinterpret_cast<uint32_t*>(so + (ln.r0 + 8 * rr) * LDQ + c) =
              pack_bf16(acc[4 * j + 2 * rr] + b.x, acc[4 * j + 2 * rr + 1] + b.y);
      }
      named_barrier(2 + ln.wg, 128);
      // the warpgroup's rows of head h, 192 bytes each, contiguous in p.qkv
      bf16* dst = p.qkv + ((size_t)h * total + row0 + r_lo) * 96;
      for (int e = ln.tid & 127; e < nmine * 12; e += 128) {
        const int r = e / 12, c = e - r * 12;
        *reinterpret_cast<uint4*>(dst + r * 96 + 8 * c) =
            *reinterpret_cast<const uint4*>(so + r * LDQ + 8 * c);
      }
      named_barrier(2 + ln.wg, 128);
    }
  }
}

// ---------------------------------------------------------------- long form, launch 2
struct LongLayout {
  uint32_t ctx, kv, ring, prm, mask, bars, total;
  __host__ __device__ explicit LongLayout(int F) {
    Carve c;
    ctx = c.take(KSL * LONG_TR * 128);
    kv = c.take(2 * LONG_TR * LDH * 2);
    ring = c.take(LONG_STAGES * STAGE);
    prm = c.take(params_after(F) * 4, 16);
    mask = c.take(LONG_TR * 4, 16);
    bars = c.take(2 * LONG_STAGES * 8, 8);
    total = c.off + 1024;
  }
};

__global__ void __launch_bounds__(THREADS, 1)
    infer_attn_ffn_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Params p) {
  const LongLayout L(p.F);
  unsigned char* base = smem_base();
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bars);
  Ring ring;
  ring.init(base + L.ring, bars, LONG_STAGES);
  if (threadIdx.x == 0) {
    init_ring_bars(bars, LONG_STAGES);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    setmaxnreg_dec<24>();
    if (threadIdx.x != CONSUMERS) return;
    for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
      const int nrows = min(p.nseq, p.B - tile * p.nseq) * p.S;
      for (int sub = 0; sub * TR < nrows; ++sub) produce_out_ff(ring, maps, p.F);
    }
    return;
  }

  setmaxnreg_inc<240>();
  const Lane ln;
  float* prm = reinterpret_cast<float*>(base + L.prm);
  load_params(p, prm, params_after(p.F));
  float* mask = reinterpret_cast<float*>(base + L.mask);
  unsigned char* ctxs = base + L.ctx;
  const uint32_t ctx_a = smem_u32(ctxs);
  bf16* kb = reinterpret_cast<bf16*>(base + L.kv);
  bf16* vb = kb + LONG_TR * LDH;
  const uint32_t ks = smem_u32(kb), vs = smem_u32(vb);
  const int warp = ln.tid >> 5;  // 0..7
  const size_t total = (size_t)p.B * p.S;
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const int seq0 = tile * p.nseq;
    const int nrows = min(p.nseq, p.B - seq0) * p.S;
    const size_t row0 = (size_t)seq0 * p.S;
    named_barrier(1, CONSUMERS);  // the last tile's readers of mask, K and V are done
    mask[ln.tid] = ln.tid < nrows ? p.mask[row0 + ln.tid] : 0.f;
    for (int h = 0; h < NH; ++h) {
      // the tile's K and V of head h (zero beyond nrows)
      const bf16* qkv = p.qkv + ((size_t)h * total + row0) * 96;
      for (int e = ln.tid; e < 2 * LONG_TR * 4; e += CONSUMERS) {
        const int mtx = e / (LONG_TR * 4), r = (e >> 2) % LONG_TR, c = e & 3;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (r < nrows)
          v = *reinterpret_cast<const uint4*>(qkv + (size_t)r * 96 + (1 + mtx) * HEAD_DIM + 8 * c);
        *reinterpret_cast<uint4*>((mtx ? vb : kb) + r * LDH + 8 * c) = v;
      }
      named_barrier(1, CONSUMERS);
#pragma unroll 1
      for (int blk = warp; blk < LONG_TR / 16; blk += 8) {
        const int q0 = 16 * blk;
        uint32_t qf[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = q0 + ln.g + 8 * (q & 1);
            if (r < nrows)
              qf[kk][q] = *reinterpret_cast<const uint32_t*>(qkv + (size_t)r * 96 + 16 * kk +
                                                             8 * (q >> 1) + 2 * ln.t4);
          }
        float o[4][4];
        attend_rows<LONG_S / 16>(qf, ks, vs, LONG_TR, q0, nrows, p.S, p.causal, mask, p.scale,
                                 ln.lane, o);
        store_ctx(ctxs, LONG_TR, q0, h, o, ln.lane);
      }
      named_barrier(1, CONSUMERS);  // before the next head's K and V
    }
    fence_proxy_async();
    named_barrier(1, CONSUMERS);

    for (int sub = 0; sub * TR < nrows; ++sub) {
      const Rows R = {row0, seq0, nrows, sub * TR + 64 * ln.wg, p.S};
      const uint32_t a = ctx_a + R.rb * 128;
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
            wgmma_m64n128k16_bf16(acc[n], desc_sw128(a + k * (LONG_TR * 128) + 32 * kk),
                                  desc_sw128(st + 32 * kk), 1);
          wgmma_commit();
          ring.keep1();
        }
      ring.drain();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      ln2_rows(prm, ln, R, acc, ctxs, LONG_TR);  // over the context rows just read
      fence_proxy_async();
      named_barrier(2 + ln.wg, 128);
      ff_store(p, prm, ln, R, ring, a, LONG_TR * 128, smem_u32(base + L.kv) + ln.wg * 16384, 8192,
               acc);  // the hidden chunks go to the K/V buffer
    }
  }
}

// the long form: 1 <= S <= 256; qkv scratch of B*S*3D bf16
int launch_long(Params p, const void* wqkv, const void* wo, const void* w1, const void* w2,
                void* qkv, cudaStream_t stream) {
  if (p.S < 1 || p.S > LONG_S || p.F % FC || p.F > MAX_F) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)p.B * p.S;
  Maps maps;
  int rc = make_maps(&maps, wqkv, wo, w1, w2, p.x, rows, p.F);
  if (rc) return rc;
  p.qkv = (bf16*)qkv;
  Params p1 = p;
  p1.ntiles = (int)((rows + TR - 1) / TR);
  const uint32_t smem1 = QkvLayout(p.F).total;
  if ((rc = prepare(infer_qkv_kernel, smem1))) return rc;
  infer_qkv_kernel<<<std::min(p1.ntiles, sm_count()), THREADS, smem1, stream>>>(maps, p1);
  if ((rc = (int)cudaGetLastError())) return rc;
  p.nseq = LONG_TR / p.S;
  p.ntiles = (p.B + p.nseq - 1) / p.nseq;
  const uint32_t smem2 = LongLayout(p.F).total;
  if ((rc = prepare(infer_attn_ffn_kernel, smem2))) return rc;
  infer_attn_ffn_kernel<<<std::min(p.ntiles, sm_count()), THREADS, smem2, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace layer_infer

// S <= MAX_SEQ_LONG, head dim HEAD_DIM; qkv: scratch of B*S*3D elements of
// the activation type. is_f32: activations and weights are float (TF32
// products), else bf16 (D = 256, F a multiple of 64 up to 1024).
extern "C" int dsvg_layer_long(const void* x, const void* seq_bias, const void* ln1,
                               const void* wqkv, const void* bqkv, const void* wo,
                               const void* bo, const void* ln2, const void* w1,
                               const void* b1, const void* w2, const void* b2,
                               const void* mask, void* qkv, void* out, int B, int S, int D,
                               int F, int H, int causal, int is_f32, float scale,
                               void* stream) {
  if (S < 1 || S > MAX_SEQ_LONG) return (int)cudaErrorInvalidValue;
  if (is_f32)
    return launch_forward<float, 32, 32, false>(
        make_params<float>(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                           out, B, S, D, F, H, causal, scale),
        (float*)qkv, (cudaStream_t)stream);
  if (D != layer_infer::DM || H != layer_infer::NH) return (int)cudaErrorInvalidValue;
  return layer_infer::launch_long(
      layer_infer::make_params(x, seq_bias, ln1, bqkv, bo, ln2, b1, b2, mask, out, B, S, F,
                               causal, scale),
      wqkv, wo, w1, w2, qkv, (cudaStream_t)stream);
}
