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
// K10 and K11's forward in bfloat16 at D = 256 (ops/attention.py) run the
// same device code without LN1 and the FF: mha_short_kernel (S <= 32, one
// launch), and mha_qkv_kernel, mha_long_attn_kernel and mha_out_kernel
// (33 <= S <= 256); K11's backward reruns them in save mode without the out
// projection (dsvg_mha_recompute_bf16); see the section at the end.
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

// head h's Q, K and V of the warpgroup's rows (acc + bias bq, the head's
// columns of bqkv at bq + part * DM + h * HEAD_DIM, as float; bf16) through
// its staging rows `so` to device memory, 16 bytes a thread: head-major into
// qkv ([H][total][96], if not null) and row-major into save ([total][3D], if
// not null). The warpgroup's rows are tile rows r_lo.., nmine of them valid.
__device__ __forceinline__ void store_head_qkv(const float (&acc)[48], const float* bq,
                                               const Lane& ln, bf16* so, int h, size_t row0,
                                               int r_lo, int nmine, size_t total, bf16* qkv,
                                               bf16* save) {
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const int c = 8 * j + 2 * ln.t4;
    const float2 b = lds2(bq + (j >> 2) * DM + h * HEAD_DIM + (c & 31));
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      *reinterpret_cast<uint32_t*>(so + (ln.r0 + 8 * rr) * LDQ + c) =
          pack_bf16(acc[4 * j + 2 * rr] + b.x, acc[4 * j + 2 * rr + 1] + b.y);
  }
  named_barrier(2 + ln.wg, 128);
  // the warpgroup's rows of head h, 192 bytes each, contiguous in qkv
  bf16* dst = qkv == nullptr ? nullptr : qkv + ((size_t)h * total + row0 + r_lo) * 96;
  for (int e = ln.tid & 127; e < nmine * 12; e += 128) {
    const int r = e / 12, c = e - r * 12;
    const uint4 v = *reinterpret_cast<const uint4*>(so + r * LDQ + 8 * c);
    if (dst != nullptr) *reinterpret_cast<uint4*>(dst + r * 96 + 8 * c) = v;
    if (save != nullptr)
      *reinterpret_cast<uint4*>(save + (row0 + r_lo + r) * layer_train::QKV_W + (c >> 2) * DM +
                                h * HEAD_DIM + 8 * (c & 3)) = v;
  }
  named_barrier(2 + ln.wg, 128);
}

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
      store_head_qkv(acc, prm + p_bqkv(p.F), ln, so, h, row0, r_lo, nmine, (size_t)total, p.qkv,
                     save);
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

// ================================================================ K10 and K11's forward
// The attention block alone at D = 256 in bfloat16 (ops/attention.py): out
// = softmax(Q K^T scale + mask) V Wo^T + bo with QKV = x Wqkv^T + bqkv, K11's
// dropout on the probabilities where t.thr > 0. K2's and K4's walks without
// LN1, the residual, LN2 and the FF: x itself is the QKV product's A
// operand, landed by TMA in a buffer of its own (a tile's eight heads read
// it while the weight ring turns over), released once the last head's
// product is done. The probabilities go through AttnDrop at K4's hash
// coordinates (row (b H + h) S + i, column j); nothing is saved but what a
// caller asks for (t.qkv, t.p32, t.ctx).
//
// K11's backward (BWD, dsvg_mha_recompute_bf16) reruns these launches in save
// mode, so that QKV, the probabilities before dropout (float32: the JAX rule
// takes them unrounded in the softmax backward) and the context it reads are
// the forward's to the bit. The short form's one launch skips its out
// projection; the long form's QKV launch then takes the tiles of g and
// computes dctx = g Wo (rounded to bf16): g lands by TMA in the x buffers,
// the wgmma A operand, and Wo streams through the ring as it lies, read
// MN-major (K4's dctx = da Wo, layer_train.cuh: rows_by_weight).

// the small parameters as float: bo, then bqkv
constexpr int M_BO = 0, M_BQKV = DM, M_ALL = 4 * DM;

__device__ __forceinline__ void load_mha_params(const Params& p, float* prm, bool with_bo) {
  for (int i = with_bo ? threadIdx.x : M_BQKV + threadIdx.x; i < M_ALL; i += CONSUMERS)
    prm[i] = bf2f(i < M_BQKV ? p.bo[i] : p.bqkv[i - M_BQKV]);
}

// NB buffers of a 128-row tile (KSL slices of [128 rows][128 bytes],
// swizzled: a wgmma A operand), each filled by one TMA box a slice on its
// `full` barrier and handed back by the consumers on its `empty` one
template <int NB>
struct TileBufs {
  static constexpr uint32_t BYTES = KSL * TR * 128;
  unsigned char* buf;
  uint64_t* full;
  uint64_t* empty;
  PipeState ps;

  __device__ __forceinline__ void init(unsigned char* b, uint64_t* bars) {
    buf = b;
    full = bars;
    empty = bars + NB;
  }
  __device__ __forceinline__ void init_bars() {
    for (int i = 0; i < NB; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS);
    }
  }
  // producer: rows [row0, row0 + 128) of the map's tensor into the next buffer
  __device__ __forceinline__ void produce(const CUtensorMap* map, int row0) {
    mbar_wait(&empty[ps.stage], ps.phase ^ 1);
    mbar_arrive_expect_tx(&full[ps.stage], BYTES);
    unsigned char* dst = buf + ps.stage * BYTES;
    for (int k = 0; k < KSL; ++k)
      tma_load_2d(dst + k * TR * 128, map, &full[ps.stage], 64 * k, row0);
    ps.advance(NB);
  }
  // consumer: the shared address of the next buffer, once it has landed
  __device__ __forceinline__ uint32_t acquire() {
    mbar_wait(&full[ps.stage], ps.phase);
    return smem_u32(buf + ps.stage * BYTES);
  }
  // consumer: every wgmma of this thread's warpgroup that reads it is done
  __device__ __forceinline__ void release() {
    mbar_arrive(&empty[ps.stage]);
    ps.advance(NB);
  }
};

// out = ctx Wo^T + bo of the warpgroup's 64 rows (a: their first row in
// slice 0 of the context, slices `slice` bytes apart): the accumulators
// start at bo, the product runs over 2 KSL weight stages; then the rows
// below nrows (tile rows rb..) are stored at out + (row0 + row) D
__device__ __forceinline__ void mha_out_rows(Ring& ring, const float* prm, const Lane& ln,
                                             uint32_t a, uint32_t slice, bf16* out, size_t row0,
                                             int rb, int nrows) {
  float acc[2][64];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 bo = lds2(prm + M_BO + 128 * n + 8 * j + 2 * ln.t4);
      acc[n][4 * j] = acc[n][4 * j + 2] = bo.x;
      acc[n][4 * j + 1] = acc[n][4 * j + 3] = bo.y;
    }
#pragma unroll
  for (int k = 0; k < KSL; ++k)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const uint32_t st = ring.acquire();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128k16_bf16(acc[n], desc_sw128(a + k * slice + 32 * kk),
                              desc_sw128(st + 32 * kk), 1);
      wgmma_commit();
      ring.keep1();
    }
  ring.drain();
  fence_acc(acc[0]);
  fence_acc(acc[1]);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = rb + ln.r0 + 8 * rr;
    if (row >= nrows) continue;
    bf16* o = out + (row0 + row) * DM;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<uint32_t*>(o + 128 * n + 8 * j + 2 * ln.t4) =
            pack_bf16(acc[n][4 * j + 2 * rr], acc[n][4 * j + 2 * rr + 1]);
  }
}

// K11's backward, the long form: g [rows][D] (boxes {64, 128}, a tile buffer)
// and Wo [D][D] as it lies (boxes {64, 64}: 64 rows of K, 64 columns of N)
struct MhaBwdMaps {
  CUtensorMap g, wo;
};

// producer: Wo for dctx = g Wo, per 64-row slice of K two stages of two
// 64-column quarters (rows_by_weight's order)
__device__ __forceinline__ void produce_wo_rows(Ring& r, const MhaBwdMaps& m) {
  for (int s = 0; s < KSL; ++s)
    for (int hf = 0; hf < 2; ++hf) {
      unsigned char* st = r.produce(STAGE);
      for (int b = 0; b < 2; ++b)
        tma_load_2d(st + b * layer_train::WBOX, &m.wo, r.bar(), 64 * (2 * hf + b), 64 * s);
      r.advance();
    }
}

// consumers: dctx = g Wo of the warpgroup's rows (a: their first row in slice
// 0 of the g buffer), rounded to bf16, to dctx [rows][D] (R's valid rows)
__device__ __forceinline__ void dctx_rows(Ring& ring, uint32_t a, const Lane& ln, const Rows& R,
                                          bf16* dctx) {
  float acc[4][32];
  layer_train::rows_by_weight(ring, a, TR * 128, acc);
  layer_train::store_rows(dctx, acc, ln, R);
}

// ---- S <= 32: one persistent launch over 128-row tiles of 128 / S whole
// sequences (train_short_kernel's walk): head by head the 64 x 96 QKV
// product from the x buffer, Q into mma A fragments, K and V into shared
// memory, the attention on mma.sync with the probabilities in registers, the
// context into shared memory; then the out projection onto bo (BWD: none;
// and, causal, the probabilities after each row's own key written 0, which
// attend_rows leaves unwritten past its rows' last key and the backward
// reads). SAVE_P: the probabilities saved to t.p32 (a compile-time choice:
// the forward without the save keeps no store in its softmax loop).
constexpr int MHA_SHORT_STAGES = 4;

struct MhaShortLayout {
  uint32_t xs, ctx, kv, ring, prm, mask, bars, total;
  __host__ __device__ MhaShortLayout() {
    Carve c;
    xs = c.take(TileBufs<1>::BYTES);
    ctx = c.take(KSL * TR * 128);
    kv = c.take(2 * TR * LDH * 2);
    ring = c.take(MHA_SHORT_STAGES * STAGE);
    prm = c.take(M_ALL * 4, 16);
    mask = c.take(TR * 4, 16);
    bars = c.take((2 * MHA_SHORT_STAGES + 2) * 8, 8);
    total = c.off + 1024;
  }
};

template <bool BWD, bool SAVE_P>
__global__ void __launch_bounds__(THREADS, 1)
    mha_short_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Params p,
                     const __grid_constant__ layer_train::Train t) {
  static_assert(SAVE_P || !BWD, "the backward's recompute saves the probabilities");
  const MhaShortLayout L;
  unsigned char* base = smem_base();
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bars);
  Ring ring;
  ring.init(base + L.ring, bars, MHA_SHORT_STAGES);
  TileBufs<1> xb;
  xb.init(base + L.xs, bars + 2 * MHA_SHORT_STAGES);
  if (threadIdx.x == 0) {
    init_ring_bars(bars, MHA_SHORT_STAGES);
    xb.init_bars();
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer: x, each head's QKV weights, Wo
    setmaxnreg_dec<24>();
    if (threadIdx.x != CONSUMERS) return;
    for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
      xb.produce(&maps.x, tile * p.nseq * p.S);
      for (int h = 0; h < NH; ++h) produce_qkv_head(ring, maps, h);
      if constexpr (!BWD) produce_out_ff(ring, maps, 0);  // F = 0: Wo alone
    }
    return;
  }

  setmaxnreg_inc<240>();
  const Lane ln;
  float* prm = reinterpret_cast<float*>(base + L.prm);
  load_mha_params(p, prm, !BWD);
  float* mask = reinterpret_cast<float*>(base + L.mask);
  unsigned char* ctxs = base + L.ctx;
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
    named_barrier(1, CONSUMERS);  // the last tile's readers of the mask are done
    if (ln.tid < TR) mask[ln.tid] = ln.tid < nrows ? p.mask[row0 + ln.tid] : 0.f;
    const uint32_t xs_a = xb.acquire() + ln.wg * 64 * 128;

#pragma unroll 1
    for (int h = 0; h < NH; ++h) {
      float acc[48];
      qkv_head_product(ring, xs_a, TR * 128, acc);
      if (h == NH - 1) xb.release();  // the tile's last product from x is done
      // Q to A fragments; K and V (+ bias, bf16) to shared memory
      uint32_t qf[2][4];
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int part = j >> 2, c = 8 * (j & 3) + 2 * ln.t4;  // column within the part
        const float2 b = lds2(prm + M_BQKV + part * DM + h * HEAD_DIM + c);
        const uint32_t lo = pack_bf16(acc[4 * j] + b.x, acc[4 * j + 1] + b.y);
        const uint32_t hi = pack_bf16(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
        if (t.qkv != nullptr) {  // a caller's copy of QKV, row-major
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
      if constexpr (BWD)
        if (p.causal)
#pragma unroll 1
          for (int i = q0; i < min(q0 + 16, nrows); ++i) {  // the warp's rows, a lane a key
            const int sq = i / p.S, qi = i - sq * p.S;
            if (qi + 1 + ln.lane < p.S)
              t.p32[(((size_t)(seq0 + sq) * NH + h) * p.S + qi) * p.S + qi + 1 + ln.lane] = 0.f;
          }
      const layer_train::AttnDropT<float> drop(SAVE_P ? t.p32 : nullptr, key_ap, t.thr, t.kp,
                                               seq0, p.S, h, nrows, q0 + ln.g);
      float o[4][4];
      attend_rows<4>(qf, ks, vs, TR, q0, nrows, p.S, p.causal, mask, p.scale, ln.lane, o, drop);
      store_ctx(ctxs, TR, q0, h, o, ln.lane);
      named_barrier(1, CONSUMERS);  // every warp is done with K and V
    }
    fence_proxy_async();  // the context, as wgmma's A operand (the warpgroup's own rows)
    named_barrier(2 + ln.wg, 128);
    if (t.ctx != nullptr)
      layer_train::save_ctx(t.ctx, ctxs, ln, Rows{row0, seq0, nrows, 64 * ln.wg, p.S});
    if constexpr (!BWD)
      mha_out_rows(ring, prm, ln, ctx_a, TR * 128, p.out, row0, 64 * ln.wg, nrows);
  }
}

// the long forms' attention: a block a (tile of 256 / S whole sequences,
// head), as train_long_attn_kernel, its Q, K and V in shared memory, each
// 16-row query block's keys split over MHA_SPLIT warps (attend_rows: half
// the score registers a thread, so two blocks share an SM where that
// launch's one block holds it; a split over four warps read no faster at
// 1,024 x 242); the context of the tile's rows for the head to t.ctx
constexpr int MHA_SPLIT = 2;

// SAVE_P: the probabilities saved to t.p32 (compile-time, as mha_short_kernel's)
template <bool SAVE_P>
__global__ void __launch_bounds__(CONSUMERS, 2)
    mha_long_attn_kernel(const __grid_constant__ Params p,
                         const __grid_constant__ layer_train::Train t) {
  constexpr int GROUPS = CONSUMERS / 32 / MHA_SPLIT;
  unsigned char* base = smem_base();
  bf16* qb = reinterpret_cast<bf16*>(base);
  bf16* kb = qb + LONG_TR * LDH;
  bf16* vb = kb + LONG_TR * LDH;
  float* mask = reinterpret_cast<float*>(vb + LONG_TR * LDH);
  SplitXch<MHA_SPLIT>* xch = reinterpret_cast<SplitXch<MHA_SPLIT>*>(mask + LONG_TR);
  const uint32_t qs = smem_u32(qb), ks = smem_u32(kb), vs = smem_u32(vb);
  const int tile = blockIdx.x, h = blockIdx.y;
  const int seq0 = tile * p.nseq;
  const int nrows = min(p.nseq, p.B - seq0) * p.S;
  const size_t row0 = (size_t)seq0 * p.S;
  const size_t total = (size_t)p.B * p.S;
  const bf16* qkv = p.qkv + ((size_t)h * total + row0) * 96;
  // the tile's Q, K and V of head h (zero beyond nrows) and its mask
  for (int e = threadIdx.x; e < 3 * LONG_TR * 4; e += CONSUMERS) {
    const int mtx = e / (LONG_TR * 4), r = (e >> 2) % LONG_TR, c = e & 3;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < nrows)
      v = *reinterpret_cast<const uint4*>(qkv + (size_t)r * 96 + mtx * HEAD_DIM + 8 * c);
    *reinterpret_cast<uint4*>(qb + mtx * LONG_TR * LDH + r * LDH + 8 * c) = v;
  }
  for (int r = threadIdx.x; r < LONG_TR; r += CONSUMERS)
    mask[r] = r < nrows ? p.mask[row0 + r] : 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int group = warp / MHA_SPLIT, part = warp - group * MHA_SPLIT;
  const unsigned key_ap = site_key(t.seed, SITE_ATTN_PROB);
#pragma unroll 1
  for (int blk = group; blk < LONG_TR / 16; blk += GROUPS) {
    const int q0 = 16 * blk;
    if (q0 >= nrows) break;  // the group's warps alike
    // Q as the A fragments of head dims 0-15 and 16-31
    uint32_t qf[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      ldmatrix_x4<false>(qf[kk], qs + (q0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * (LDH * 2) +
                                     (16 * kk + 8 * (lane >> 4)) * 2);
    // each part saves the probabilities of its own keys: attend_rows hands
    // them over normalized by the rows' sums over every part
    const layer_train::AttnDropT<float> drop(SAVE_P ? t.p32 : nullptr, key_ap, t.thr, t.kp,
                                             seq0, p.S, h, nrows, q0 + g);
    float o[4][4];
    attend_rows<LONG_S / 16 / MHA_SPLIT, layer_train::AttnDropT<float>, MHA_SPLIT>(
        qf, ks, vs, LONG_TR, q0, nrows, p.S, p.causal, mask, p.scale, lane, o, drop, part,
        xch + group, 1 + group);
    if (part != 0) continue;
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

// ---- 33 <= S <= 256: three launches. mha_qkv_kernel: the QKV product over
// 128-row tiles of all B*S rows (x double-buffered), into p.qkv head-major
// (the attention launch's layout) and/or `save` row-major (BWD: then dctx =
// g Wo over the tiles of g into p.out, g in the same buffers); then
// mha_long_attn_kernel (a tile of whole sequences and a head a block, the
// context to t.ctx); then mha_out_kernel: the out projection onto bo over
// 128-row tiles, the context double-buffered by TMA.
constexpr int MHA_QKV_STAGES = 4, MHA_OUT_STAGES = 4;

struct MhaQkvLayout {
  uint32_t xs, stage_out, ring, prm, bars, total;
  __host__ __device__ MhaQkvLayout() {
    Carve c;
    xs = c.take(2 * TileBufs<2>::BYTES);
    stage_out = c.take(TR * LDQ * 2);
    ring = c.take(MHA_QKV_STAGES * STAGE);
    prm = c.take(M_ALL * 4, 16);
    bars = c.take((2 * MHA_QKV_STAGES + 4) * 8, 8);
    total = c.off + 1024;
  }
};

template <bool BWD>
__global__ void __launch_bounds__(THREADS, 1)
    mha_qkv_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Params p,
                   bf16* save, const __grid_constant__ MhaBwdMaps bm) {
  const MhaQkvLayout L;
  unsigned char* base = smem_base();
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bars);
  Ring ring;
  ring.init(base + L.ring, bars, MHA_QKV_STAGES);
  TileBufs<2> xb;
  xb.init(base + L.xs, bars + 2 * MHA_QKV_STAGES);
  if (threadIdx.x == 0) {
    init_ring_bars(bars, MHA_QKV_STAGES);
    xb.init_bars();
    fence_barrier_init();
  }
  __syncthreads();

  // the items: the tiles of x, then (BWD) those of g
  const int items = BWD ? 2 * p.ntiles : p.ntiles;
  if (threadIdx.x >= CONSUMERS) {
    setmaxnreg_dec<24>();
    if (threadIdx.x != CONSUMERS) return;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      if (item < p.ntiles) {
        xb.produce(&maps.x, item * TR);
        for (int h = 0; h < NH; ++h) produce_qkv_head(ring, maps, h);
      } else {
        xb.produce(&bm.g, (item - p.ntiles) * TR);
        produce_wo_rows(ring, bm);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const Lane ln;
  float* prm = reinterpret_cast<float*>(base + L.prm);
  load_mha_params(p, prm, false);
  named_barrier(1, CONSUMERS);
  bf16* so = reinterpret_cast<bf16*>(base + L.stage_out) + ln.wg * 64 * LDQ;
  const size_t total = (size_t)p.B * p.S;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int tile = item < p.ntiles ? item : item - p.ntiles;
    const size_t row0 = (size_t)tile * TR;
    const int nrows = (int)min((long long)TR, (long long)(total - row0));
    if (BWD && item >= p.ntiles) {
      const uint32_t gs_a = xb.acquire() + ln.wg * 64 * 128;
      dctx_rows(ring, gs_a, ln, Rows{row0, 0, nrows, 64 * ln.wg, 1}, p.out);
      xb.release();
      continue;
    }
    const int r_lo = 64 * ln.wg, nmine = max(0, min(64, nrows - r_lo));
    const uint32_t xs_a = xb.acquire() + ln.wg * 64 * 128;
#pragma unroll 1
    for (int h = 0; h < NH; ++h) {
      float acc[48];
      qkv_head_product(ring, xs_a, TR * 128, acc);
      if (h == NH - 1) xb.release();
      store_head_qkv(acc, prm + M_BQKV, ln, so, h, row0, r_lo, nmine, total, p.qkv, save);
    }
  }
}

struct MhaOutLayout {
  uint32_t ctx, ring, prm, bars, total;
  __host__ __device__ MhaOutLayout() {
    Carve c;
    ctx = c.take(2 * TileBufs<2>::BYTES);
    ring = c.take(MHA_OUT_STAGES * STAGE);
    prm = c.take(M_ALL * 4, 16);
    bars = c.take((2 * MHA_OUT_STAGES + 4) * 8, 8);
    total = c.off + 1024;
  }
};

// maps.x: the context [B*S][D]
__global__ void __launch_bounds__(THREADS, 1)
    mha_out_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Params p) {
  const MhaOutLayout L;
  unsigned char* base = smem_base();
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bars);
  Ring ring;
  ring.init(base + L.ring, bars, MHA_OUT_STAGES);
  TileBufs<2> cb;
  cb.init(base + L.ctx, bars + 2 * MHA_OUT_STAGES);
  if (threadIdx.x == 0) {
    init_ring_bars(bars, MHA_OUT_STAGES);
    cb.init_bars();
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    setmaxnreg_dec<24>();
    if (threadIdx.x != CONSUMERS) return;
    for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
      cb.produce(&maps.x, tile * TR);
      produce_out_ff(ring, maps, 0);  // Wo alone
    }
    return;
  }

  setmaxnreg_inc<240>();
  const Lane ln;
  float* prm = reinterpret_cast<float*>(base + L.prm);
  load_mha_params(p, prm, true);
  named_barrier(1, CONSUMERS);
  const size_t total = (size_t)p.B * p.S;
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * TR;
    const int nrows = (int)min((long long)TR, (long long)(total - row0));
    const uint32_t a = cb.acquire() + ln.wg * 64 * 128;
    mha_out_rows(ring, prm, ln, a, TR * 128, p.out, row0, 64 * ln.wg, nrows);
    cb.release();
  }
}

// the tensor maps of Wqkv (boxes {64, 32}), Wo ({64, 128}) and of the rows
// the first product reads, x or the context ({64, 128}); w1 and w2 unused.
// Encoded once for each set of addresses (the calls are short: the encoder's
// host time is what they wait on)
inline int make_mha_maps(Maps* m, const void* wqkv, const void* wo, const void* rows_src,
                         long long rows) {
  *m = Maps{};
  int rc = make_tma_2d_cached(&m->qkv, wqkv, false, DM, 3 * DM, DM * 2, 64, 32);
  if (rc == 0) rc = make_tma_2d_cached(&m->o, wo, false, DM, DM, DM * 2, 64, 128);
  if (rc == 0)
    rc = make_tma_2d_cached(&m->x, rows_src, false, DM, (uint64_t)rows, DM * 2, 64, TR);
  return rc;
}

// the QKV launch alone: into qkv head-major ([H][B*S][96]) and/or save
// row-major ([B*S][3D]), either may be null; BWD: then dctx = g Wo into
// p.out (bm: the maps of g and Wo)
template <bool BWD>
int launch_mha_qkv(Params p, const void* wqkv, const void* wo, bf16* save, cudaStream_t stream,
                   const MhaBwdMaps& bm = MhaBwdMaps{}) {
  const long long rows = (long long)p.B * p.S;
  Maps maps;
  int rc = make_mha_maps(&maps, wqkv, wo, p.x, rows);
  if (rc) return rc;
  p.ntiles = (int)((rows + TR - 1) / TR);
  const uint32_t smem = MhaQkvLayout().total;
  if ((rc = prepare(mha_qkv_kernel<BWD>, smem))) return rc;
  const int items = BWD ? 2 * p.ntiles : p.ntiles;
  mha_qkv_kernel<BWD><<<std::min(items, sm_count()), THREADS, smem, stream>>>(maps, p, save, bm);
  return (int)cudaGetLastError();
}

// the long forms' attention launch (t.ctx the context, t.p the saved
// probabilities if not null)
int launch_mha_long_attn(const Params& p, const layer_train::Train& t, cudaStream_t stream) {
  Params pa = p;
  pa.nseq = LONG_TR / p.S;
  const int atiles = (p.B + pa.nseq - 1) / pa.nseq;
  const uint32_t smem = 3 * LONG_TR * LDH * 2 + LONG_TR * 4 +
                        (CONSUMERS / 32 / MHA_SPLIT) * sizeof(SplitXch<MHA_SPLIT>) + 1024;
  const auto kernel =
      t.p32 != nullptr ? mha_long_attn_kernel<true> : mha_long_attn_kernel<false>;
  int rc = prepare(kernel, smem);
  if (rc) return rc;
  kernel<<<dim3(atiles, NH), CONSUMERS, smem, stream>>>(pa, t);
  return (int)cudaGetLastError();
}

// K10 / K11's forward: S <= 32 one launch, else three (p.qkv the head-major
// scratch, t.ctx the context between the last two)
int launch_mha(Params p, const layer_train::Train& t, const void* wqkv, const void* wo,
               cudaStream_t stream) {
  const long long rows = (long long)p.B * p.S;
  int rc;
  if (p.S <= 32) {
    p.nseq = TR / p.S;
    p.ntiles = (p.B + p.nseq - 1) / p.nseq;
    Maps maps;
    if ((rc = make_mha_maps(&maps, wqkv, wo, p.x, rows))) return rc;
    const uint32_t smem = MhaShortLayout().total;
    const auto kernel =
        t.p32 != nullptr ? mha_short_kernel<false, true> : mha_short_kernel<false, false>;
    if ((rc = prepare(kernel, smem))) return rc;
    kernel<<<std::min(p.ntiles, sm_count()), THREADS, smem, stream>>>(maps, p, t);
    return (int)cudaGetLastError();
  }
  if ((rc = launch_mha_qkv<false>(p, wqkv, wo, t.qkv, stream))) return rc;
  if ((rc = launch_mha_long_attn(p, t, stream))) return rc;
  Maps out_maps;
  if ((rc = make_mha_maps(&out_maps, wqkv, wo, t.ctx, rows))) return rc;
  p.ntiles = (int)((rows + TR - 1) / TR);
  const uint32_t smem3 = MhaOutLayout().total;
  if ((rc = prepare(mha_out_kernel, smem3))) return rc;
  mha_out_kernel<<<std::min(p.ntiles, sm_count()), THREADS, smem3, stream>>>(out_maps, p);
  return (int)cudaGetLastError();
}

// K11's backward, its first launches: the forward's in save mode (t.qkv
// row-major, t.p32, t.ctx) without the out projection; S <= 32 one launch,
// else two (p.qkv the head-major scratch), the first of which computes dctx
// = g Wo into p.out
int launch_mha_recompute(Params p, const layer_train::Train& t, const void* wqkv, const void* wo,
                         const void* g, cudaStream_t stream) {
  const long long rows = (long long)p.B * p.S;
  int rc;
  if (p.S <= 32) {
    p.nseq = TR / p.S;
    p.ntiles = (p.B + p.nseq - 1) / p.nseq;
    Maps maps;
    if ((rc = make_mha_maps(&maps, wqkv, wo, p.x, rows))) return rc;
    const uint32_t smem = MhaShortLayout().total;
    if ((rc = prepare(mha_short_kernel<true, true>, smem))) return rc;
    mha_short_kernel<true, true><<<std::min(p.ntiles, sm_count()), THREADS, smem, stream>>>(maps,
                                                                                          p, t);
    return (int)cudaGetLastError();
  }
  MhaBwdMaps bm;
  if ((rc = make_tma_2d_cached(&bm.g, g, false, DM, (uint64_t)rows, DM * 2, 64, TR)) ||
      (rc = make_tma_2d_cached(&bm.wo, wo, false, DM, DM, DM * 2, 64, 64)))
    return rc;
  if ((rc = launch_mha_qkv<true>(p, wqkv, wo, t.qkv, stream, bm))) return rc;
  return launch_mha_long_attn(p, t, stream);
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

// S <= MAX_SEQ_LONG; qkv: scratch of B*S*3D elements of the activation
// type. is_f32: activations and weights are float (TF32 products), else
// bf16: at D = 256 with 8 heads (F a multiple of 64 up to 1024) the wgmma
// kernels of layer_infer.cuh, at other widths (head dim 8, 16 or 32)
// layer_long.cuh's on 64-row tiles.
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
  if (D != layer_infer::DM || H != layer_infer::NH)
    return launch_forward<bf16, 64, 64, false>(
        make_params<bf16>(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                          out, B, S, D, F, H, causal, scale),
        (bf16*)qkv, (cudaStream_t)stream);
  return layer_infer::launch_long(
      layer_infer::make_params(x, seq_bias, ln1, bqkv, bo, ln2, b1, b2, mask, out, B, S, F,
                               causal, scale),
      wqkv, wo, w1, w2, qkv, (cudaStream_t)stream);
}

// K10 and K11's forward in bfloat16 at D = 256, 8 heads, 1 <= S <= 256
// (ops/attention.py): x [B*S][D], wqkv [3D][D], bqkv [3D], wo [D][D], bo
// [D], mask [B][S] (float32, additive), out [B*S][D]; thr = floor(rate
// 2^24) (0: no dropout, K10), kp = 1 / (1 - rate). S <= 32 is one launch;
// 33 <= S <= 256 three, through qkv [H][B*S][96] (scratch) and ctx [B*S][D]
// (the context). qkv_save [B*S][3D] (row-major), p_save [B][H][S][S] (the
// probabilities before dropout, float32, each row's keys up to its warp's
// last row's when causal) and, for S <= 32, ctx receive the forward's QKV,
// probabilities and context if not null (a test's view).
extern "C" int dsvg_mha_bf16(const void* x, const void* wqkv, const void* bqkv, const void* wo,
                             const void* bo, const void* mask, void* out, void* qkv, void* ctx,
                             void* qkv_save, void* p_save, int B, int S, int causal, int seed,
                             int thr, float kp, float scale, void* stream) {
  if (B < 1 || S < 1 || S > layer_infer::LONG_S ||
      (S > 32 && (qkv == nullptr || ctx == nullptr)))
    return (int)cudaErrorInvalidValue;
  layer_infer::Params p = layer_infer::make_params(x, nullptr, nullptr, bqkv, bo, nullptr, nullptr,
                                                   nullptr, mask, out, B, S, 0, causal, scale);
  p.qkv = (bf16*)qkv;
  const layer_train::Train t = {(bf16*)qkv_save, nullptr, (bf16*)ctx,    nullptr,
                                nullptr,         seed,    (unsigned)thr, kp,
                                (float*)p_save};
  return layer_infer::launch_mha(p, t, wqkv, wo, (cudaStream_t)stream);
}

// K11's backward in bfloat16 at D = 256, 8 heads, 1 <= S <= 256, its first
// launches (layer_bwd.cu's dsvg_mha_bwd_bf16 runs them first): the forward's
// launches of dsvg_mha_bf16 in save mode, on its operands x, wqkv, bqkv and
// mask, and g [B*S][D], wo [D][D]: QKV row-major into qkv_rows [B*S][3D]
// (and head-major into qkv [H][B*S][96], a scratch, for 33 <= S), the
// probabilities before dropout into p [B][H][S][S] (float32; when causal,
// every key after a row's own 0 for S <= 32, unwritten past its warp's last
// row's key for 33 <= S), the context into ctx [B*S][D], all equal to the
// bit to the forward's; for 33 <= S also dctx = g Wo, rounded, into dctx
// [B*S][D] (g and wo unread for S <= 32).
extern "C" int dsvg_mha_recompute_bf16(const void* x, const void* wqkv, const void* bqkv,
                                       const void* wo, const void* mask, const void* g, void* qkv,
                                       void* qkv_rows, void* p, void* ctx, void* dctx, int B,
                                       int S, int causal, int seed, int thr, float kp,
                                       float scale, void* stream) {
  if (B < 1 || S < 1 || S > layer_infer::LONG_S || (S > 32 && qkv == nullptr))
    return (int)cudaErrorInvalidValue;
  layer_infer::Params prm = layer_infer::make_params(x, nullptr, nullptr, bqkv, nullptr, nullptr,
                                                     nullptr, nullptr, mask, dctx, B, S, 0, causal,
                                                     scale);
  prm.qkv = (bf16*)qkv;
  const layer_train::Train t = {(bf16*)qkv_rows, nullptr, (bf16*)ctx,    nullptr,
                                nullptr,         seed,    (unsigned)thr, kp,
                                (float*)p};
  return layer_infer::launch_mha_recompute(prm, t, wqkv, wo, g, (cudaStream_t)stream);
}
