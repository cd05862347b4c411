// K2, long form (see ops/layer.py): one fused pre-LN layer over sequences of
// up to 256 rows in two launches. The bfloat16 form is the two wgmma kernels
// below, on layer_infer.cuh's device code; the float32 form at other widths
// runs the device code of layer_long.cuh. K4's bfloat16 long form at D = 256
// (ops/layer_vjp.py) is three launches on the same device code with
// layer_train.cuh's training switch (train_long_qkv_kernel,
// train_long_attn_kernel, train_long_out_ffn_kernel): dropout at the four
// sites, x1 through its tensor, and in the saved mode QKV (row-major
// [B*S][3D]), the probabilities before dropout, the context, x1 and the FF
// hidden before dropout, the layout K4's long backward (layer_bwd.cu) reads.
#include "layer_infer.cuh"
#include "layer_long.cuh"
#include "layer_train.cuh"

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
// launch reads a head's rows contiguously; and, if `save` is not null, into
// save [B*S][3D] row-major too (K4's saved QKV)
__device__ __forceinline__ void qkv_long_tiles(const Maps& maps, const Params& p, bf16* save) {
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
        const uint4 v = *reinterpret_cast<const uint4*>(so + r * LDQ + 8 * c);
        *reinterpret_cast<uint4*>(dst + r * 96 + 8 * c) = v;
        if (save != nullptr)
          *reinterpret_cast<uint4*>(save + (row0 + r_lo + r) * layer_train::QKV_W +
                                    (c >> 2) * DM + h * HEAD_DIM + 8 * (c & 3)) = v;
      }
      named_barrier(2 + ln.wg, 128);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    infer_qkv_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Params p) {
  qkv_long_tiles(maps, p, nullptr);
}

__global__ void __launch_bounds__(THREADS, 1)
    train_long_qkv_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Params p,
                          bf16* save) {
  qkv_long_tiles(maps, p, save);
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

// ---------------------------------------------------------------- K4's long form
// K4's bfloat16 long form, forward: the long K2's QKV launch (saving QKV
// row-major too in the saved mode), then, so that the card fills at the
// recipe's B=60 (60 sequences, one 256-row attention tile each), the
// attention and the rest split: train_long_attn_kernel takes a tile of
// whole sequences and one head a block (480 blocks at B=60), each warp's
// 16-row query blocks in registers as K2's (attend_rows with AttnDrop: the
// probabilities' dropout and save), the context to device memory;
// train_long_out_ffn_kernel takes 128-row tiles of all rows (the context
// by TMA): the out projection alone, x1 = x + m (acc + bo) (+ seq_bias)
// through x1's tensor with LN2 a row a warp, the FF with dropout (its
// hidden saved before dropout) and out = x1 + m (FF2 + b2), as the short
// form's train_short_kernel.
template <bool SAVE>
__global__ void __launch_bounds__(CONSUMERS, 1)
    train_long_attn_kernel(const __grid_constant__ Params p, const __grid_constant__ layer_train::Train t) {
  unsigned char* base = smem_base();
  bf16* kb = reinterpret_cast<bf16*>(base);
  bf16* vb = kb + LONG_TR * LDH;
  float* mask = reinterpret_cast<float*>(vb + LONG_TR * LDH);
  const uint32_t ks = smem_u32(kb), vs = smem_u32(vb);
  const int tile = blockIdx.x, h = blockIdx.y;
  const int seq0 = tile * p.nseq;
  const int nrows = min(p.nseq, p.B - seq0) * p.S;
  const size_t row0 = (size_t)seq0 * p.S;
  const size_t total = (size_t)p.B * p.S;
  const bf16* qkv = p.qkv + ((size_t)h * total + row0) * 96;
  // the tile's K and V of head h (zero beyond nrows) and its mask
  for (int e = threadIdx.x; e < 2 * LONG_TR * 4; e += CONSUMERS) {
    const int mtx = e / (LONG_TR * 4), r = (e >> 2) % LONG_TR, c = e & 3;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < nrows)
      v = *reinterpret_cast<const uint4*>(qkv + (size_t)r * 96 + (1 + mtx) * HEAD_DIM + 8 * c);
    *reinterpret_cast<uint4*>((mtx ? vb : kb) + r * LDH + 8 * c) = v;
  }
  for (int r = threadIdx.x; r < LONG_TR; r += CONSUMERS)
    mask[r] = r < nrows ? p.mask[row0 + r] : 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const unsigned key_ap = site_key(t.seed, SITE_ATTN_PROB);
#pragma unroll 1
  for (int blk = warp; blk < LONG_TR / 16; blk += 8) {
    const int q0 = 16 * blk;
    if (q0 >= nrows) break;
    uint32_t qf[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = q0 + g + 8 * (q & 1);
        if (r < nrows)
          qf[kk][q] = *reinterpret_cast<const uint32_t*>(qkv + (size_t)r * 96 + 16 * kk +
                                                         8 * (q >> 1) + 2 * t4);
      }
    const layer_train::AttnDrop drop(SAVE ? t.p : nullptr, key_ap, t.thr, t.kp, seq0, p.S, h,
                                     nrows, q0 + g);
    float o[4][4];
    attend_rows<LONG_S / 16>(qf, ks, vs, LONG_TR, q0, nrows, p.S, p.causal, mask, p.scale, lane,
                             o, drop);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = q0 + g + 8 * rr;
      if (r >= nrows) continue;
      bf16* dst = t.ctx + (row0 + r) * DM + h * HEAD_DIM + 2 * t4;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(o[j][2 * rr], o[j][2 * rr + 1]);
    }
  }
}

constexpr int OUT_STAGES = 4;

struct OutLayout {
  uint32_t ctx, hid, ring, prm, bars, total;
  __host__ __device__ explicit OutLayout(int F) {
    Carve c;
    ctx = c.take(KSL * TR * 128);        // the context, then LN2's output: the A operand
    hid = c.take(2 * 2 * 64 * 128);      // two hidden buffers a warpgroup
    ring = c.take(OUT_STAGES * STAGE);
    prm = c.take(params_after(F) * 4, 16);
    bars = c.take((2 * OUT_STAGES + KSL + 1) * 8, 8);
    total = c.off + 1024;
  }
};

template <bool SAVE>
__global__ void __launch_bounds__(THREADS, 1)
    train_long_out_ffn_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Params p,
                              const __grid_constant__ layer_train::Train t) {
  const OutLayout L(p.F);
  unsigned char* base = smem_base();
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* cfull = bars + 2 * OUT_STAGES;  // a barrier a slice of the context
  uint64_t* cempty = cfull + KSL;
  Ring ring;
  ring.init(base + L.ring, bars, OUT_STAGES);
  if (threadIdx.x == 0) {
    init_ring_bars(bars, OUT_STAGES);
    for (int k = 0; k < KSL; ++k) mbar_init(&cfull[k], 1);
    mbar_init(cempty, CONSUMERS);
    fence_barrier_init();
  }
  __syncthreads();
  const long long rows = (long long)p.B * p.S;
  unsigned char* ctxs = base + L.ctx;

  if (threadIdx.x >= CONSUMERS) {  // the producer: the context (maps.x), then the weights
    setmaxnreg_dec<24>();
    if (threadIdx.x != CONSUMERS) return;
    PipeState cs;
    for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
      mbar_wait(cempty, cs.phase ^ 1);
      for (int k = 0; k < KSL; ++k) {
        mbar_arrive_expect_tx(&cfull[k], TR * 128);
        tma_load_2d(ctxs + k * TR * 128, &maps.x, &cfull[k], 64 * k, tile * TR);
      }
      cs.advance(1);
      produce_out_ff(ring, maps, p.F);
    }
    return;
  }

  setmaxnreg_inc<240>();
  const Lane ln;
  float* prm = reinterpret_cast<float*>(base + L.prm);
  load_params(p, prm, params_after(p.F));
  named_barrier(1, CONSUMERS);
  const uint32_t ctx_a = smem_u32(ctxs) + ln.wg * 64 * 128;
  const uint32_t hbuf = smem_u32(base + L.hid) + ln.wg * 2 * 64 * 128;
  PipeState cs;
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * TR;
    const int nrows = (int)min((long long)TR, rows - (long long)row0);
    const Rows R = {row0, 0, nrows, 64 * ln.wg, p.S};
    float acc[2][64];
#pragma unroll 1
    for (int k = 0; k < KSL; ++k) {
      mbar_wait(&cfull[k], cs.phase);
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
    }
    ring.drain();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    layer_train::attn_out_train(t, prm, ln, R, acc);
    __syncwarp();  // the warp's rows of the attention output are written
    layer_train::residual_ln2(p, t, prm, ln, R, ctxs);  // over the context rows just read
    fence_proxy_async();
    named_barrier(2 + ln.wg, 128);
    layer_train::ff_train<SAVE>(p, t, prm, ln, R, ring, ctx_a, TR * 128, hbuf, 64 * 128, acc);
    mbar_arrive(cempty);  // this warpgroup is done with the tile's shared rows
    cs.advance(1);
  }
}

// K4's bfloat16 long form, forward: 1 <= S <= 256, D = DM, F a multiple of FC
// up to MAX_F; qkv: a scratch of B*S*3D bf16 between the launches; SAVE: the
// saved mode (t.qkv, t.p, t.ctx, t.x1, t.h written), else the recompute mode
// (t.x1 a scratch)
template <bool SAVE>
int launch_long_train(Params p, const layer_train::Train& t, const void* wqkv, const void* wo,
                      const void* w1, const void* w2, void* qkv, cudaStream_t stream) {
  if (p.S < 1 || p.S > LONG_S || p.F % FC || p.F > MAX_F) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)p.B * p.S;
  Maps maps, out_maps;
  int rc = make_maps(&maps, wqkv, wo, w1, w2, p.x, rows, p.F);
  // the third launch reads the context where the others read x
  if (rc == 0) rc = make_maps(&out_maps, wqkv, wo, w1, w2, t.ctx, rows, p.F);
  if (rc) return rc;
  p.qkv = (bf16*)qkv;
  p.ntiles = (int)((rows + TR - 1) / TR);
  const uint32_t smem1 = QkvLayout(p.F).total, smem3 = OutLayout(p.F).total;
  const uint32_t smem2 = 2 * LONG_TR * LDH * 2 + LONG_TR * 4 + 1024;
  if ((rc = prepare(train_long_qkv_kernel, smem1)) ||
      (rc = prepare(train_long_attn_kernel<SAVE>, smem2)) ||
      (rc = prepare(train_long_out_ffn_kernel<SAVE>, smem3)))
    return rc;
  const int grid = std::min(p.ntiles, sm_count());
  train_long_qkv_kernel<<<grid, THREADS, smem1, stream>>>(maps, p, SAVE ? t.qkv : nullptr);
  if ((rc = (int)cudaGetLastError())) return rc;
  Params pa = p;
  pa.nseq = LONG_TR / p.S;
  const int atiles = (p.B + pa.nseq - 1) / pa.nseq;
  train_long_attn_kernel<SAVE><<<dim3(atiles, NH), CONSUMERS, smem2, stream>>>(pa, t);
  if ((rc = (int)cudaGetLastError())) return rc;
  train_long_out_ffn_kernel<SAVE><<<grid, THREADS, smem3, stream>>>(out_maps, p, t);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace layer_infer

// Whether K4's long form runs its Hopper kernels at these widths: D = 256
// with 8 heads and F a multiple of 256 up to 1024 in both types (the weight
// products, dsvg_wgrad_hopper and dsvg_wgrad_tf32, take N multiples of 256,
// and dW2 has N = F); 1 <= S <= 256.
extern "C" int dsvg_layer_long_train_hopper(int D, int F, int H, int S) {
  using namespace layer_infer;
  return D == DM && H == NH && F % 256 == 0 && F > 0 && F <= MAX_F && S >= 1 && S <= LONG_S;
}

// K4's bfloat16 long form, forward, at the widths dsvg_layer_long_train_hopper
// takes: qkv [B*S][3D] a scratch (QKV head-major) between the launches; the
// context ctx_s [B*S][D] and x1_s [B*S][D] (float32) always written. Saved
// mode (p_s not null): qkv_s, p_s and h_s written too, all in the layout the
// backward reads (QKV row-major); recompute mode (p_s, qkv_s, h_s null):
// `out` is the result, to the bit the saved mode's.
extern "C" int dsvg_layer_long_train_bf16(
    const void* x, const void* seq_bias, const void* ln1, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* ln2,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* mask, void* out, void* qkv, void* qkv_s, void* p_s, void* ctx_s, void* x1_s,
    void* h_s, int B, int S, int F, int causal, int seed, int thr, float kp, float scale,
    void* stream) {
  if (!dsvg_layer_long_train_hopper(layer_infer::DM, F, layer_infer::NH, S) || B < 1)
    return (int)cudaErrorInvalidValue;
  const layer_train::Train t = {(bf16*)qkv_s, (bf16*)p_s, (bf16*)ctx_s, (float*)x1_s,
                                (bf16*)h_s, seed, (unsigned)thr, kp};
  const layer_infer::Params p = layer_infer::make_params(x, seq_bias, ln1, bqkv, bo, ln2, b1, b2,
                                                         mask, out, B, S, F, causal, scale);
  return p_s != nullptr
             ? layer_infer::launch_long_train<true>(p, t, wqkv, wo, w1, w2, qkv, (cudaStream_t)stream)
             : layer_infer::launch_long_train<false>(p, t, wqkv, wo, w1, w2, qkv,
                                                     (cudaStream_t)stream);
}

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
