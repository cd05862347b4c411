// K4 backward: everything of the layer's backward that is local to a row or
// a sequence (see ops/layer_vjp.py); the weight products follow in wgrad.cu.
// K11's backward at D = 256 in bfloat16 (dsvg_mha_bwd_bf16, at the end) runs
// the saved mode's attention backward (on float32 probabilities) and the row
// products dctx = g Wo (S <= 32) and dx = dqkv Wqkv here, after its recompute
// in layer_long.cu.
// The saved mode's bfloat16 short form at D = 256 is three wgmma / mma.sync
// launches on layer_train.cuh's device code. The float32 form, the narrower
// bfloat16 widths and the recompute mode run layer_bwd.cuh's device code,
// which K7's stack backward (stack.cu) runs too; in the recompute mode a
// launch of the forward tile (layer_fwd.cuh, FWD_WORKSPACE) comes first and
// fills the layer's workspace (the old forward's arithmetic, not the wgmma
// forward's: the recomputed intermediates differ from that forward's in
// their last bits).
#include "layer_bwd.cuh"
#include "layer_fwd.cuh"
#include "layer_train.cuh"

using namespace layer_bwd;

namespace layer_train {
namespace {

constexpr int FF_BWD_STAGES = 4;

struct FfBwdLayout {
  uint32_t a, hid, ring, prm, sums, bars, total;
  __host__ __device__ FfBwdLayout() {
    Carve c;
    a = c.take(KSL * TR * 128);          // df, then da: the A operand
    hid = c.take(4 * FC * 128);          // two hidden buffers a warpgroup
    ring = c.take(FF_BWD_STAGES * STAGE);
    prm = c.take(2 * DM * 4, 16);        // LN2's scale and bias
    sums = c.take(8 * 2 * DM * 4, 16);   // the warps' LayerNorm column sums
    bars = c.take(2 * FF_BWD_STAGES * 8, 8);
    total = c.off + 1024;
  }
};

// the FF, LN2 and out-projection backward (see layer_train.cuh)
__global__ void __launch_bounds__(THREADS, 1)
    bwd_ff_kernel(const __grid_constant__ FfBwdMaps maps, const __grid_constant__ Bwd b) {
  const FfBwdLayout L;
  unsigned char* base = smem_base();
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bars);
  Ring ring;
  ring.init(base + L.ring, bars, FF_BWD_STAGES);
  if (threadIdx.x == 0) {
    init_ring_bars(bars, FF_BWD_STAGES);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    setmaxnreg_dec<24>();
    if (threadIdx.x != CONSUMERS) return;
    for (int tile = blockIdx.x; tile < b.ntiles; tile += gridDim.x)
      produce_ff_bwd(ring, maps, tile * b.nseq * b.S, b.F);
    return;
  }

  setmaxnreg_inc<240>();
  const Lane ln;
  float* prm = reinterpret_cast<float*>(base + L.prm);
  float* sums = reinterpret_cast<float*>(base + L.sums);
  for (int i = ln.tid; i < 2 * DM; i += CONSUMERS) prm[i] = bf2f(b.ln2[i]);
  for (int i = ln.tid; i < 8 * 2 * DM; i += CONSUMERS) sums[i] = 0.f;
  named_barrier(1, CONSUMERS);
  float* wsums = sums + (ln.tid >> 5) * 2 * DM;
  unsigned char* as = base + L.a;
  const uint32_t a_wg = smem_u32(as) + ln.wg * 64 * 128;
  const uint32_t hbuf = smem_u32(base + L.hid) + ln.wg * 2 * FC * 128;
  const unsigned key_fh = site_key(b.seed, SITE_FF_HIDDEN), key_ao = site_key(b.seed, SITE_ATTN_OUT);
  for (int tile = blockIdx.x; tile < b.ntiles; tile += gridDim.x) {
    const int seq0 = tile * b.nseq;
    const int nvalid = min(b.nseq, b.B - seq0);
    const int nrows = nvalid * b.S;
    const size_t row0 = (size_t)seq0 * b.S;
    const Rows R = {row0, seq0, nrows, 64 * ln.wg, b.S};
    {  // df = g m into the A operand
      const unsigned char* gs[KSL];
      ring.acquire_x(gs);
      df_rows(b, gs, nrows, row0, 64 * ln.wg + 16 * ln.w, ln.lane, as);
      ring.release_x();
      fence_proxy_async();
      named_barrier(2 + ln.wg, 128);
    }
    // per chunk of the hidden: dh = df W2, dhpre, dxn2 += dhpre W1
    float acc[4][32];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[q][i] = 0.f;
#pragma unroll 1
    for (int c = 0; c < b.F / FC; ++c) {
      float hacc[32];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint32_t st = ring.acquire();
        wgmma_fence();
#pragma unroll
        for (int bx = 0; bx < 2; ++bx)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n64k16_bf16<0, 1>(hacc, desc_sw128(a_wg + (2 * s + bx) * (TR * 128) + 32 * kk),
                                       desc_sw128(st + bx * WBOX + 2048 * kk),
                                       (s | bx | kk) ? 1 : 0);
        wgmma_commit();
        ring.keep1();
      }
      ring.drain();  // this chunk's dh, and the last chunk's dxn2 product, are done
      fence_acc(hacc);
      // dhpre: the saved hidden's ReLU gate and the dropout mask on dh;
      // the dropped hidden for dW2
      const uint32_t hb = hbuf + (c & 1) * FC * 128;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 4 * q + e, rr = m & 1, col = FC * c + 8 * (m >> 1) + 2 * ln.t4;
          const int tr = R.rb + ln.r0 + 8 * rr;
          const size_t row = row0 + tr;
          float dh0 = 0.f, dh1 = 0.f;
          if (tr < nrows) {
            const float2 hv = ldg2(b.h + row * b.F + col);
            dh0 = hv.x > 0.f ? drop_at(hacc[2 * m], key_fh, row, col, b.thr, b.kp) : 0.f;
            dh1 = hv.y > 0.f ? drop_at(hacc[2 * m + 1], key_fh, row, col + 1, b.thr, b.kp) : 0.f;
            *reinterpret_cast<uint32_t*>(b.dhpre + row * b.F + col) = pack_bf16(dh0, dh1);
            *reinterpret_cast<uint32_t*>(b.hd + row * b.F + col) =
                pack_bf16(drop_at(hv.x, key_fh, row, col, b.thr, b.kp),
                          drop_at(hv.y, key_fh, row, col + 1, b.thr, b.kp));
          }
          v[e] = pack_bf16(dh0, dh1);
        }
        stage_quarter(hb, ln, q, v);
      }
      fence_proxy_async();
      named_barrier(2 + ln.wg, 128);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const uint32_t st = ring.acquire();
        wgmma_fence();
#pragma unroll
        for (int bx = 0; bx < 2; ++bx)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n64k16_bf16<0, 1>(acc[2 * hf + bx], desc_sw128(hb + 32 * kk),
                                       desc_sw128(st + bx * WBOX + 2048 * kk), (c | kk) ? 1 : 0);
        wgmma_commit();
        ring.keep1();
      }
    }
    ring.drain();
#pragma unroll
    for (int q = 0; q < 4; ++q) fence_acc(acc[q]);
    // LN2's backward a row a warp, from dxn2 parked in the dx1 scratch rows:
    // dx1 = g + its input gradient (over dxn2); da = dx1 m, staged over the
    // warp's df rows for dctx; xn2 for dW1
    spill_rows(b.dx1, acc, ln, R);
    __syncwarp();
    ln_bwd_rows(b.x1, b.dx1, prm, prm + DM, ln, R, wsums,
                [&](int tr, size_t row, int c0, const float (&xn)[8], const float (&d)[8]) {
                  float gv[8];
                  load8(b.g + row * DM + c0, gv);
#pragma unroll
                  for (int e = 0; e < 8; ++e) gv[e] += d[e];
                  *reinterpret_cast<float4*>(b.dx1 + row * DM + c0) =
                      make_float4(gv[0], gv[1], gv[2], gv[3]);
                  *reinterpret_cast<float4*>(b.dx1 + row * DM + c0 + 4) =
                      make_float4(gv[4], gv[5], gv[6], gv[7]);
#pragma unroll
                  for (int e = 0; e < 8; ++e) gv[e] = drop_at(gv[e], key_ao, row, c0 + e, b.thr, b.kp);
                  const uint4 da = pack8(gv);
                  *reinterpret_cast<uint4*>(b.da + row * DM + c0) = da;
                  *reinterpret_cast<uint4*>(as + (c0 >> 6) * (TR * 128) +
                                            swizzle128(tr, (c0 & 63) * 2)) = da;
                  *reinterpret_cast<uint4*>(b.xn2 + row * DM + c0) = pack8(xn);
                });
    named_barrier(1, CONSUMERS);  // every row's dx1 is written
    // dseq_bias: dx1 summed over each sequence, in row order (the long form's
    // tiles cut sequences: its attention launch sums them, b.dbias null here)
    for (int e = ln.tid; b.dbias != nullptr && e < nvalid * DM; e += CONSUMERS) {
      const int sq = e / DM, col = e - sq * DM;
      const float* src = b.dx1 + (row0 + (size_t)sq * b.S) * DM + col;
      float s = 0.f;
      for (int i = 0; i < b.S; ++i) s += src[(size_t)i * DM];
      b.dbias[(size_t)(seq0 + sq) * DM + col] = s;
    }
    fence_proxy_async();  // da, as wgmma's A operand
    named_barrier(2 + ln.wg, 128);
    rows_by_weight(ring, a_wg, TR * 128, acc);  // dctx = da Wo
    store_rows(b.dctx, acc, ln, R);
  }
  write_sums(sums, b.small, 2 * DM);
}

// the probabilities the attention backward reads: K4's bf16 (b.p), K11's
// float32 (b.p32)
__device__ __forceinline__ const bf16* saved_p(const Bwd& b, const bf16*) { return b.p; }
__device__ __forceinline__ const float* saved_p(const Bwd& b, const float*) { return b.p32; }

// the attention backward (see attn_bwd_tile): 8 warps, no weights
template <class PT>
__global__ void __launch_bounds__(CONSUMERS, 1) bwd_attn_kernel(const __grid_constant__ Bwd b) {
  unsigned char* base = smem_base();
  const PT* P = saved_p(b, (const PT*)nullptr);
  for (int tile = blockIdx.x; tile < b.ntiles; tile += gridDim.x) attn_bwd_tile(b, P, tile, base);
}

constexpr uint32_t QKV_STAGE = TR * 128 + 4 * WBOX;  // a slice of dqkv's K, Wqkv's four quarters
constexpr int QKV_BWD_STAGES = 4;

struct QkvBwdMaps {
  CUtensorMap dqkv, wqkv;  // boxes {64, 128} and {64, 64}
};

struct QkvBwdLayout {
  uint32_t ring, prm, sums, bars, total;
  __host__ __device__ QkvBwdLayout() {
    Carve c;
    ring = c.take(QKV_BWD_STAGES * QKV_STAGE);
    prm = c.take(2 * DM * 4, 16);
    sums = c.take(8 * 2 * DM * 4, 16);
    bars = c.take(2 * QKV_BWD_STAGES * 8, 8);
    total = c.off + 1024;
  }
};

// bwd_qkv_kernel's epilogues: K4's LN1 backward (the product dxn1 = dqkv
// Wqkv), or the product alone, rounded to bf16 (K11's backward): dx = dqkv
// Wqkv into b.dx, or dctx = g Wo into b.dctx (maps.dqkv then g's, maps.wqkv
// Wo's, as it lies)
enum { EPI_LN1, EPI_DX, EPI_DCTX };

// dxn1 = dqkv Wqkv, then LN1's backward: dx = dx1 + its input gradient (or
// EPI's product alone); NSLICES: 64-column slices of the product's K
template <int NSLICES, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
    bwd_qkv_kernel(const __grid_constant__ QkvBwdMaps maps, const __grid_constant__ Bwd b) {
  const QkvBwdLayout L;
  unsigned char* base = smem_base();
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bars);
  RingT<QKV_STAGE> ring;
  ring.init(base + L.ring, bars, QKV_BWD_STAGES);
  if (threadIdx.x == 0) {
    init_ring_bars(bars, QKV_BWD_STAGES);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    setmaxnreg_dec<24>();
    if (threadIdx.x != CONSUMERS) return;
    for (int tile = blockIdx.x; tile < b.ntiles; tile += gridDim.x)
      for (int s = 0; s < NSLICES; ++s) {
        unsigned char* st = ring.produce(QKV_STAGE);
        tma_load_2d(st, &maps.dqkv, ring.bar(), 64 * s, tile * b.nseq * b.S);
        for (int q = 0; q < 4; ++q)
          tma_load_2d(st + TR * 128 + q * WBOX, &maps.wqkv, ring.bar(), 64 * q, 64 * s);
        ring.advance();
      }
    return;
  }

  setmaxnreg_inc<240>();
  const Lane ln;
  float* prm = reinterpret_cast<float*>(base + L.prm);
  float* sums = reinterpret_cast<float*>(base + L.sums);
  if constexpr (EPI == EPI_LN1) {
    for (int i = ln.tid; i < 2 * DM; i += CONSUMERS) prm[i] = bf2f(b.ln1[i]);
    for (int i = ln.tid; i < 8 * 2 * DM; i += CONSUMERS) sums[i] = 0.f;
    named_barrier(1, CONSUMERS);
  }
  float* wsums = sums + (ln.tid >> 5) * 2 * DM;
  for (int tile = blockIdx.x; tile < b.ntiles; tile += gridDim.x) {
    const int seq0 = tile * b.nseq;
    const int nrows = min(b.nseq, b.B - seq0) * b.S;
    const Rows R = {(size_t)seq0 * b.S, seq0, nrows, 64 * ln.wg, b.S};
    float acc[4][32];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[q][i] = 0.f;
#pragma unroll 1
    for (int s = 0; s < NSLICES; ++s) {
      const uint32_t st = ring.acquire();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t a = desc_sw128(st + ln.wg * 64 * 128 + 32 * kk);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wgmma_m64n64k16_bf16<0, 1>(acc[q], a, desc_sw128(st + TR * 128 + q * WBOX + 2048 * kk),
                                     (s | kk) ? 1 : 0);
      }
      wgmma_commit();
      ring.keep1();
    }
    ring.drain();
#pragma unroll
    for (int q = 0; q < 4; ++q) fence_acc(acc[q]);
    if constexpr (EPI != EPI_LN1) {
      store_rows(EPI == EPI_DCTX ? b.dctx : b.dx, acc, ln, R);
      continue;
    }
    // LN1's backward a row a warp, from dxn1 parked in the dy scratch rows
    spill_rows(b.dy, acc, ln, R);
    __syncwarp();
    ln_bwd_rows(b.x, b.dy, prm, prm + DM, ln, R, wsums,
                [&](int, size_t row, int c0, const float (&xn)[8], const float (&d)[8]) {
                  float y[8];
                  load8(b.dx1 + row * DM + c0, y);
#pragma unroll
                  for (int e = 0; e < 8; ++e) y[e] += d[e];
                  *reinterpret_cast<uint4*>(b.dx + row * DM + c0) = pack8(y);
                  *reinterpret_cast<uint4*>(b.xn1 + row * DM + c0) = pack8(xn);
                });
  }
  if constexpr (EPI == EPI_LN1) write_sums(sums, b.small, 0);
}

// ---------------------------------------------------------------- long form
// K4's bfloat16 long form (33 <= S <= 256), saved mode: the row launches
// above on 128-row tiles of all rows (a sequence cut by the tiles: each row
// a "sequence" of one to them, dseq_bias taken here instead), and this
// attention backward, one (tile of whole sequences, head) a block, the
// short form's roundings. Each warp owns 16 query rows: dP = dctx V^T a
// 16-key step at a time (mma.sync m16n8k16), the saved probabilities and
// their dropout factors, dsum = sum_j dp p in a first pass, ds = p (dp -
// dsum) and dQ = dS K in a second (dS rounded to bf16 straight from the
// accumulators); then 16 key rows: dP^T = V dctx^T, dS^T and Pe^T from it,
// dK = dS^T Q and dV = Pe^T dctx in registers over the query steps in order.
// The saved probabilities (PT: K4's bf16, K11's float32) are read from
// device memory a step ahead of use. K11's backward runs it with b.dbias
// null (no seq_bias).
constexpr int LONG_AT = 256;                   // rows of the attention tile
constexpr uint32_t LONG_HEAD = LONG_AT * LDH * 2;  // a head's Q, K, V or dctx rows

// the saved probabilities at `at` and at + 1 (in0, in1: which are the row's,
// else 0), one load of the pair where it is aligned
__device__ __forceinline__ void load_p_pair(const bf16* at, bool in0, bool in1, float& p0,
                                            float& p1) {
  p0 = p1 = 0.f;
  if (in0 && in1 && !(reinterpret_cast<uintptr_t>(at) & 3)) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
    p0 = v.x;
    p1 = v.y;
  } else {
    if (in0) p0 = bf2f(at[0]);
    if (in1) p1 = bf2f(at[1]);
  }
}
__device__ __forceinline__ void load_p_pair(const float* at, bool in0, bool in1, float& p0,
                                            float& p1) {
  p0 = p1 = 0.f;
  if (in0 && in1 && !(reinterpret_cast<uintptr_t>(at) & 7)) {
    const float2 v = *reinterpret_cast<const float2*>(at);
    p0 = v.x;
    p1 = v.y;
  } else {
    if (in0) p0 = at[0];
    if (in1) p1 = at[1];
  }
}

// (two blocks an SM: at most 128 registers a thread)
template <class PT>
__global__ void __launch_bounds__(CONSUMERS, 2)
    bwd_attn_long_kernel(const __grid_constant__ Bwd b, int causal) {
  const PT* P = saved_p(b, (const PT*)nullptr);
  unsigned char* base = smem_base();
  const uint32_t qs = smem_u32(base), ks = qs + LONG_HEAD, vs = ks + LONG_HEAD,
                 cs = vs + LONG_HEAD;
  float* dsum_s = reinterpret_cast<float*>(base + 4 * LONG_HEAD);
  const int tile = blockIdx.x, h = blockIdx.y, S = b.S;
  const int seq0 = tile * b.nseq;
  const int nvalid = min(b.nseq, b.B - seq0);
  const int nrows = nvalid * S;
  const size_t row0 = (size_t)seq0 * S;
  for (int idx = threadIdx.x; idx < 4 * LONG_AT * 4; idx += CONSUMERS) {
    const int m = idx / (LONG_AT * 4), r = (idx >> 2) % LONG_AT, c = idx & 3;
    const size_t row = row0 + (r < nrows ? r : 0);
    const bf16* src = m < 3 ? b.qkv + row * QKV_W + m * DM + h * HEAD_DIM
                            : b.dctx + row * DM + h * HEAD_DIM;
    cp_async16(qs + m * LONG_HEAD + r * LDH * 2 + 16 * c, src + 8 * c, r < nrows);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (h == 0 && b.dbias != nullptr)
    for (int e = threadIdx.x; e < nvalid * DM; e += CONSUMERS) {
      const int sq = e / DM, col = e - sq * DM;
      const float* d1 = b.dx1 + (row0 + (size_t)sq * S) * DM + col;
      float s = 0.f;
      for (int i = 0; i < S; ++i) s += d1[(size_t)i * DM];
      b.dbias[(size_t)(seq0 + sq) * DM + col] = s;
    }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const unsigned key_ap = site_key(b.seed, SITE_ATTN_PROB);
  const float sl = b.scale;
  // the saved probability of (query, key) of the tile's sequence sq, their
  // indices within it
  auto p_at = [&](int sq, int q, int k) -> float {
    return p_value(P[(((size_t)(seq0 + sq) * NH + h) * S + q) * S + k]);
  };

  // ---- the warp's 16 query rows
#pragma unroll 1
  for (int blk = w; blk < LONG_AT / 16; blk += 8) {
    const int q0 = 16 * blk;
    if (q0 >= nrows) break;
    const int qlast = min(q0 + 15, nrows - 1);
    const int kstart = (q0 / S) * S;
    const int kend = causal ? qlast + 1 : (qlast / S + 1) * S;
    const int nk16 = (kend - kstart + 15) >> 4;
    int lo[2], hi[2];
    unsigned prow[2], rh[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = q0 + g + 8 * rr;
      lo[rr] = hi[rr] = 0;
      prow[rr] = 0u;
      if (i < nrows) {
        lo[rr] = (i / S) * S;
        hi[rr] = causal ? i + 1 : lo[rr] + S;
        prow[rr] = (unsigned)(((seq0 + i / S) * NH + h) * S + (i - lo[rr]));
      }
      rh[rr] = row_hash(key_ap, prow[rr]);
    }
    uint32_t cf[2][4];
    load_a(cf[0], cs, LDH, q0, 0, lane);
    load_a(cf[1], cs, LDH, q0, 16, lane);
    float dsum[2] = {0.f, 0.f};
    float oq[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) oq[j][0] = oq[j][1] = oq[j][2] = oq[j][3] = 0.f;
    // the saved probabilities of the thread's rows at the 16-key step u:
    // pv[nt][rr][e] at key kstart + 16 u + 8 nt + 2 t4 + e (0 off the row's
    // keys; one 4-byte load where both of a pair are the row's and
    // aligned), loaded a step ahead of their use
    auto load_p = [&](int u, float (&pv)[2][2][2]) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int j0 = kstart + 16 * u + 8 * nt + 2 * t4;
          const bool in0 = j0 >= lo[rr] && j0 < hi[rr], in1 = j0 + 1 >= lo[rr] && j0 + 1 < hi[rr];
          load_p_pair(P + (size_t)prow[rr] * S + (j0 - lo[rr]), in0, in1, pv[nt][rr][0],
                      pv[nt][rr][1]);
        }
    };
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      float pn[2][2][2];
      load_p(0, pn);
#pragma unroll 1
      for (int u = 0; u < nk16; ++u) {
        float pv[2][2][2];
#pragma unroll
        for (int e = 0; e < 8; ++e) (&pv[0][0][0])[e] = (&pn[0][0][0])[e];
        if (u + 1 < nk16) load_p(u + 1, pn);
        float ds[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          // dPe of keys kstart + 16 u + 8 nt + [0, 8)
          const int kr = min(kstart + 16 * u + 8 * nt + (lane & 7), LONG_AT - 1);
          uint32_t bb[4];
          ldmatrix_x4<false>(bb, vs + kr * (LDH * 2) + (lane >> 3) * 16);
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_m16n8k16_bf16(d, cf[0], bb[0], bb[1]);
          mma_m16n8k16_bf16(d, cf[1], bb[2], bb[3]);
          const int j0 = kstart + 16 * u + 8 * nt + 2 * t4;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int rr = i >> 1, e = i & 1, j = j0 + e;
            ds[nt][i] = 0.f;
            if (j >= lo[rr] && j < hi[rr]) {
              const float dp = b.thr == 0u ? d[i]
                             : (keep_col(rh[rr], (unsigned)(j - lo[rr]), b.thr) ? d[i] * b.kp : 0.f);
              if (pass == 0) dsum[rr] += dp * pv[nt][rr][e];
              else ds[nt][i] = pv[nt][rr][e] * (dp - dsum[rr]);
            }
          }
        }
        if (pass == 1) {
          const uint32_t a[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                                 pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
          const int kr = min(kstart + 16 * u + (lane & 7) + ((lane >> 3) & 1) * 8, LONG_AT - 1);
#pragma unroll
          for (int dd = 0; dd < 2; ++dd) {
            uint32_t bb[4];
            ldmatrix_x4<true>(bb, ks + kr * (LDH * 2) + (16 * dd + 8 * (lane >> 4)) * 2);
            mma_m16n8k16_bf16(oq[2 * dd], a, bb[0], bb[1]);
            mma_m16n8k16_bf16(oq[2 * dd + 1], a, bb[2], bb[3]);
          }
        }
      }
      if (pass == 0) {
        dsum[0] = quad_sum(dsum[0]);
        dsum[1] = quad_sum(dsum[1]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = q0 + g + 8 * rr;
      if (i >= nrows) continue;
      if (t4 == 0) dsum_s[i] = dsum[rr];
      bf16* o = b.dqkv + (row0 + i) * QKV_W + h * HEAD_DIM + 2 * t4;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(o + 8 * j) = pack_bf16(oq[j][2 * rr] * sl, oq[j][2 * rr + 1] * sl);
    }
  }
  __syncthreads();  // every row's dsum is in

  // ---- the warp's 16 key rows
#pragma unroll 1
  for (int blk = w; blk < LONG_AT / 16; blk += 8) {
    const int j0 = 16 * blk;
    if (j0 >= nrows) break;
    const int jl = min(j0 + 15, nrows - 1);
    const int qa = causal ? j0 : (j0 / S) * S;
    const int qend = (jl / S + 1) * S;
    const int nq16 = (qend - qa + 15) >> 4;
    int jj[2], kseq[2], klo[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      jj[rr] = j0 + g + 8 * rr;
      kseq[rr] = jj[rr] < nrows ? jj[rr] / S : -1;
      klo[rr] = kseq[rr] * S;
    }
    uint32_t vf[2][4];
    load_a(vf[0], vs, LDH, j0, 0, lane);
    load_a(vf[1], vs, LDH, j0, 16, lane);
    float ok[4][4], ov[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ok[j][e] = ov[j][e] = 0.f;
    // whether query q sees key row rr: the key's sequence's queries (up to
    // the key when causal)
    auto sees = [&](int rr, int q) {
      return kseq[rr] >= 0 && q >= (causal ? jj[rr] : klo[rr]) && q < klo[rr] + S;
    };
    // the saved probabilities of the 16-query step u: pv[nt][i] at query qa
    // + 16 u + 8 nt + 2 t4 + (i & 1), key row i >> 1 (0 where unseen),
    // loaded a step ahead of their use
    auto load_p = [&](int u, float (&pv)[2][4]) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rr = i >> 1, q = qa + 16 * u + 8 * nt + 2 * t4 + (i & 1);
          pv[nt][i] = sees(rr, q) ? p_at(kseq[rr], q - klo[rr], jj[rr] - klo[rr]) : 0.f;
        }
    };
    float pn[2][4];
    load_p(0, pn);
#pragma unroll 1
    for (int u = 0; u < nq16; ++u) {
      const int qb = qa + 16 * u;
      float pv[2][4];
#pragma unroll
      for (int e = 0; e < 8; ++e) (&pv[0][0])[e] = (&pn[0][0])[e];
      if (u + 1 < nq16) load_p(u + 1, pn);
      float ds[2][4], pe[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        // dPe^T of queries qb + 8 nt + [0, 8)
        const int qr = min(qb + 8 * nt + (lane & 7), LONG_AT - 1);
        uint32_t bb[4];
        ldmatrix_x4<false>(bb, cs + qr * (LDH * 2) + (lane >> 3) * 16);
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_m16n8k16_bf16(d, vf[0], bb[0], bb[1]);
        mma_m16n8k16_bf16(d, vf[1], bb[2], bb[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rr = i >> 1, q = qb + 8 * nt + 2 * t4 + (i & 1);
          ds[nt][i] = pe[nt][i] = 0.f;
          if (sees(rr, q)) {
            const unsigned pr = (unsigned)(((seq0 + kseq[rr]) * NH + h) * S + (q - klo[rr]));
            const float km = drop_at(1.f, key_ap, pr, jj[rr] - klo[rr], b.thr, b.kp);
            pe[nt][i] = pv[nt][i] * km;
            ds[nt][i] = pv[nt][i] * (d[i] * km - dsum_s[q]);
          }
        }
      }
      const uint32_t ad[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                              pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
      const uint32_t ap[4] = {pack_bf16(pe[0][0], pe[0][1]), pack_bf16(pe[0][2], pe[0][3]),
                              pack_bf16(pe[1][0], pe[1][1]), pack_bf16(pe[1][2], pe[1][3])};
      const int qr = min(qb + (lane & 7) + ((lane >> 3) & 1) * 8, LONG_AT - 1);
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
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (jj[rr] >= nrows) continue;
      bf16* o = b.dqkv + (row0 + jj[rr]) * QKV_W + h * HEAD_DIM + 2 * t4;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        *reinterpret_cast<uint32_t*>(o + DM + 8 * d) = pack_bf16(ok[d][2 * rr] * sl, ok[d][2 * rr + 1] * sl);
        *reinterpret_cast<uint32_t*>(o + 2 * DM + 8 * d) = pack_bf16(ov[d][2 * rr], ov[d][2 * rr + 1]);
      }
    }
  }
}

// the persistent grid of the row-local launches: one row of LayerNorm
// partial sums a block
int train_bwd_grid(int B, int S) {
  const int ntiles = (B + TR / S - 1) / (TR / S);
  return std::min(ntiles, sm_count());
}

// The saved mode's bfloat16 short form at D = 256. `t`: BwdParams' 23
// pointers (small_part [grid][4 D]), then the scratch dx1 (f32), dctx
// (bf16) and dy (f32), all [B*S][D].
int launch_train_bwd(void* const* t, int B, int S, int F, int seed, int thr, float kp,
                     float scale, cudaStream_t stream, bool long_form = false, int causal = 0) {
  if (S < 1 || S > (long_form ? LONG_S : 32) || F % FC || F > MAX_F)
    return (int)cudaErrorInvalidValue;
  Bwd b;
  b.x = (const bf16*)t[0];
  b.g = (const bf16*)t[1];
  b.ln1 = (const bf16*)t[2];
  b.ln2 = (const bf16*)t[5];
  b.qkv = (const bf16*)t[8];
  b.p = (const bf16*)t[9];
  b.x1 = (const float*)t[11];
  b.h = (const bf16*)t[12];
  b.dx = (bf16*)t[13];
  b.dbias = (float*)t[14];
  b.xn1 = (bf16*)t[15];
  b.dqkv = (bf16*)t[16];
  b.da = (bf16*)t[17];
  b.xn2 = (bf16*)t[18];
  b.dhpre = (bf16*)t[19];
  b.hd = (bf16*)t[20];
  b.df = (bf16*)t[21];
  b.small = (float*)t[22];
  b.dx1 = (float*)t[23];
  b.dctx = (bf16*)t[24];
  b.dy = (float*)t[25];
  b.B = B;
  b.S = S;
  b.F = F;
  b.nseq = TR / S;
  b.ntiles = (B + b.nseq - 1) / b.nseq;
  b.seed = seed;
  b.thr = (unsigned)thr;
  b.kp = kp;
  b.scale = scale;
  const long long rows = (long long)B * S;
  Bwd rows_b = b;  // the row launches' view: the long form's tiles cut sequences
  if (long_form) {
    rows_b.B = (int)rows;
    rows_b.S = 1;
    rows_b.nseq = TR;
    rows_b.ntiles = (int)((rows + TR - 1) / TR);
    rows_b.dbias = nullptr;
    b.nseq = LONG_AT / S;
    b.ntiles = (B + b.nseq - 1) / b.nseq;
  }
  FfBwdMaps fm;
  QkvBwdMaps qm;
  int rc = bind_device_of(t[0]);
  if (rc == 0) rc = make_tma_2d(&fm.g, t[1], false, DM, (uint64_t)rows, DM * 2, 64, TR);
  if (rc == 0) rc = make_tma_2d(&fm.w2, t[7], false, F, DM, (uint64_t)F * 2, 64, 64);
  if (rc == 0) rc = make_tma_2d(&fm.w1, t[6], false, DM, F, DM * 2, 64, 64);
  if (rc == 0) rc = make_tma_2d(&fm.wo, t[4], false, DM, DM, DM * 2, 64, 64);
  if (rc == 0) rc = make_tma_2d(&qm.dqkv, t[16], false, QKV_W, (uint64_t)rows, QKV_W * 2, 64, TR);
  if (rc == 0) rc = make_tma_2d(&qm.wqkv, t[3], false, DM, QKV_W, DM * 2, 64, 64);
  if (rc) return rc;
  const int grid = train_bwd_grid(rows_b.B, rows_b.S);
  const uint32_t ff_smem = FfBwdLayout().total, attn_smem = AttnBwdLayout().total,
                 qkv_smem = QkvBwdLayout().total,
                 long_smem = 4 * LONG_HEAD + LONG_AT * 4 + 1024;
  if ((rc = prepare(bwd_ff_kernel, ff_smem)) || (rc = prepare(bwd_attn_kernel<bf16>, attn_smem)) ||
      (rc = prepare(bwd_qkv_kernel<QKV_W / 64, EPI_LN1>, qkv_smem)) ||
      (long_form && (rc = prepare(bwd_attn_long_kernel<bf16>, long_smem))))
    return rc;
  bwd_ff_kernel<<<grid, THREADS, ff_smem, stream>>>(fm, rows_b);
  if ((rc = (int)cudaGetLastError())) return rc;
  if (long_form)
    bwd_attn_long_kernel<bf16><<<dim3(b.ntiles, NH), CONSUMERS, long_smem, stream>>>(b, causal);
  else
    bwd_attn_kernel<bf16><<<std::min(b.ntiles, 2 * sm_count()), CONSUMERS, attn_smem, stream>>>(
        b);
  if ((rc = (int)cudaGetLastError())) return rc;
  bwd_qkv_kernel<QKV_W / 64, EPI_LN1><<<grid, THREADS, qkv_smem, stream>>>(qm, rows_b);
  return (int)cudaGetLastError();
}

// K11's backward after its recompute (dsvg_mha_bwd_bf16), over 128-row
// tiles of all rows where a launch is row-local: for S <= 32, dctx = g Wo
// into b.dctx (the long form's recompute computed it); the saved-mode
// attention backward over b.qkv (row-major), b.p32 and b.dctx into b.dqkv;
// then dx = dqkv Wqkv into b.dx. `causal`: the long form's (the short form
// reads every key of a sequence, the probabilities past a row's own 0).
int launch_mha_bwd(Bwd b, const void* wqkv, const void* wo, int causal, cudaStream_t stream) {
  const long long rows = (long long)b.B * b.S;
  QkvBwdMaps dx_maps, dctx_maps;
  int rc = make_tma_2d_cached(&dx_maps.dqkv, b.dqkv, false, QKV_W, (uint64_t)rows, QKV_W * 2,
                              64, TR);
  if (rc == 0) rc = make_tma_2d_cached(&dx_maps.wqkv, wqkv, false, DM, QKV_W, DM * 2, 64, 64);
  if (rc == 0 && b.S <= 32)
    rc = make_tma_2d_cached(&dctx_maps.dqkv, b.g, false, DM, (uint64_t)rows, DM * 2, 64, TR);
  if (rc == 0 && b.S <= 32)
    rc = make_tma_2d_cached(&dctx_maps.wqkv, wo, false, DM, DM, DM * 2, 64, 64);
  if (rc) return rc;
  const uint32_t attn_smem = AttnBwdLayout().total, qkv_smem = QkvBwdLayout().total,
                 long_smem = 4 * LONG_HEAD + LONG_AT * 4 + 1024;
  Bwd rows_b = b;  // the row launches' view: 128-row tiles of all rows
  rows_b.B = (int)rows;
  rows_b.S = 1;
  rows_b.nseq = TR;
  rows_b.ntiles = (int)((rows + TR - 1) / TR);
  const int grid = std::min(rows_b.ntiles, sm_count());
  if (b.S <= 32) {
    if ((rc = prepare(bwd_qkv_kernel<DM / 64, EPI_DCTX>, qkv_smem))) return rc;
    bwd_qkv_kernel<DM / 64, EPI_DCTX><<<grid, THREADS, qkv_smem, stream>>>(dctx_maps, rows_b);
    if ((rc = (int)cudaGetLastError())) return rc;
    b.nseq = TR / b.S;
    b.ntiles = (b.B + b.nseq - 1) / b.nseq;
    if ((rc = prepare(bwd_attn_kernel<float>, attn_smem))) return rc;
    bwd_attn_kernel<float><<<std::min(b.ntiles, 2 * sm_count()), CONSUMERS, attn_smem, stream>>>(
        b);
  } else {
    b.nseq = LONG_AT / b.S;
    b.ntiles = (b.B + b.nseq - 1) / b.nseq;
    if ((rc = prepare(bwd_attn_long_kernel<float>, long_smem))) return rc;
    bwd_attn_long_kernel<float><<<dim3(b.ntiles, NH), CONSUMERS, long_smem, stream>>>(b, causal);
  }
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = prepare(bwd_qkv_kernel<QKV_W / 64, EPI_DX>, qkv_smem))) return rc;
  bwd_qkv_kernel<QKV_W / 64, EPI_DX><<<grid, THREADS, qkv_smem, stream>>>(dx_maps, rows_b);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace layer_train

namespace {

template <class T, int ROWS, int HD, bool RECOMPUTE>
__global__ void __launch_bounds__(NTHREADS) layer_bwd_kernel(BwdParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  layer_bwd_tile<T, ROWS, HD, RECOMPUTE>(p, smem);
}

// the layer_bwd.cuh kernel at the head dim D / H (8, 16 or 32)
template <class T, int ROWS, bool RECOMPUTE = false>
int launch(BwdParams<T> p, cudaStream_t stream) {
  p.nseq = ROWS / p.S;
  const size_t smem = smem_bytes<T, ROWS>(p.D, p.F);
  return with_head_dim(p.D, p.H, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    cudaError_t err = cudaFuncSetAttribute(layer_bwd_kernel<T, ROWS, HD, RECOMPUTE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (p.B + p.nseq - 1) / p.nseq;
    layer_bwd_kernel<T, ROWS, HD, RECOMPUTE><<<blocks, NTHREADS, smem, stream>>>(p);
    return (int)cudaGetLastError();
  });
}

template <class T, int ROWS, int HD>
__global__ void __launch_bounds__(NTHREADS) workspace_kernel(layer_fwd::LayerParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  layer_fwd::layer_tile<T, ROWS, HD, true, layer_fwd::FWD_WORKSPACE>(p, smem);
}

// The recompute mode: the forward tile fills the workspace (QKV, context,
// x1, f32 hidden; FROWS rows a block, as the forward), then the backward
// tile recomputes the probabilities (BROWS rows a block).
template <class T, int FROWS, int BROWS>
int launch_recompute(void* const* t, int B, int S, int D, int F, int H, int causal, int seed,
                     int thr, float kp, float scale, cudaStream_t stream) {
  layer_fwd::LayerParams<T> f = layer_fwd::make_params<T>(
      t[0], t[24], t[2], t[3], t[25], t[4], t[26], t[5], t[6], t[27], t[7], t[28], t[29],
      nullptr, B, S, D, F, H, causal, scale);
  f.qkv_s = (T*)t[8];
  f.ctx_s = (T*)t[10];
  f.x1_s = (float*)t[11];
  f.h32 = (float*)t[23];
  f.seed = seed;
  f.thr = (unsigned)thr;
  f.kp = kp;
  f.nseq = FROWS / S;
  const size_t smem = layer_fwd::smem_bytes<T, FROWS>(D, F);
  const int rc = with_head_dim(D, H, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    cudaError_t err = cudaFuncSetAttribute(workspace_kernel<T, FROWS, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    workspace_kernel<T, FROWS, HD><<<(B + f.nseq - 1) / f.nseq, NTHREADS, smem, stream>>>(f);
    return (int)cudaGetLastError();
  });
  if (rc != 0) return rc;
  BwdParams<T> p = make_params<T>(t, B, S, D, F, H, seed, thr, kp, scale);
  p.h32 = (const float*)t[23];
  p.mask = (const float*)t[29];
  p.causal = causal;
  return launch<T, BROWS, true>(p, stream);
}

}  // namespace

// Rows per block, so that the wrapper can size the per-block partial sums.
extern "C" int dsvg_layer_bwd_rows(int is_f32) { return is_f32 ? 16 : 32; }

// The bfloat16 wgmma form's blocks (rows of its partial sums [blocks][4 D]).
extern "C" int dsvg_layer_train_bwd_grid(int B, int S) { return layer_train::train_bwd_grid(B, S); }

// The same for the bfloat16 long form, whose row launches take 128-row tiles
// of all B*S rows.
extern "C" int dsvg_layer_long_train_bwd_grid(int B, int S) {
  return layer_train::train_bwd_grid(B * S, 1);
}

// K4's bfloat16 long form, saved mode, at D = 256 with 8 heads, F a
// multiple of 256 up to 1024, 1 <= S <= 256: the three row-local launches as
// dsvg_layer_train_bwd's wgmma form (`tensors` in its order: small_part
// [dsvg_layer_long_train_bwd_grid][4 D], then the scratch dx1, dctx, dy),
// the attention by bwd_attn_long_kernel; the weight products are
// dsvg_wgrad_hopper's.
extern "C" int dsvg_layer_long_train_bwd_bf16(void* const* tensors, int B, int S, int F,
                                              int causal, int seed, int thr, float kp,
                                              float scale, void* stream) {
  return layer_train::launch_train_bwd(tensors, B, S, F, seed, thr, kp, scale,
                                       (cudaStream_t)stream, true, causal);
}

// `tensors`: the 23 device pointers of BwdParams, in its order. bfloat16 at
// D = 256, 8 heads (the wgmma form): small_part is [blocks][4 D] and three
// scratch pointers follow, dx1 (f32), dctx (bf16) and dy (f32), [B*S][D]; its weight
// products and bias gradients are dsvg_wgrad_hopper's.
extern "C" int dsvg_layer_train_bwd(void* const* tensors, int B, int S, int D, int F,
                                    int H, int is_f32, int seed, int thr, float kp,
                                    float scale, void* stream) {
  if (is_f32)
    return launch<float, 16>(make_params<float>(tensors, B, S, D, F, H, seed, thr, kp, scale),
                             (cudaStream_t)stream);
  if (layer_train::hopper_form(D, F, H, S))
    return layer_train::launch_train_bwd(tensors, B, S, F, seed, thr, kp, scale,
                                         (cudaStream_t)stream);
  return launch<bf16, 32>(make_params<bf16>(tensors, B, S, D, F, H, seed, thr, kp, scale),
                          (cudaStream_t)stream);
}

// The recompute mode. `tensors`: the 23 pointers of BwdParams, where QKV, the
// context (16-row padded) and x1 are this layer's workspace, written here, and
// the saved probabilities and hidden are not read; then the f32 hidden [rows][F]
// (workspace), seq_bias (or null), bqkv, bo, b1, b2 and the mask [B][S].
extern "C" int dsvg_layer_train_bwd_recompute(void* const* tensors, int B, int S, int D,
                                              int F, int H, int causal, int is_f32, int seed,
                                              int thr, float kp, float scale, void* stream) {
  if (is_f32)
    return launch_recompute<float, 32, 16>(tensors, B, S, D, F, H, causal, seed, thr, kp,
                                           scale, (cudaStream_t)stream);
  return launch_recompute<bf16, 64, 32>(tensors, B, S, D, F, H, causal, seed, thr, kp, scale,
                                        (cudaStream_t)stream);
}

// layer_long.cu: K11's backward, its first launches
extern "C" int dsvg_mha_recompute_bf16(const void* x, const void* wqkv, const void* bqkv,
                                       const void* wo, const void* mask, const void* g, void* qkv,
                                       void* qkv_rows, void* p, void* ctx, void* dctx, int B,
                                       int S, int causal, int seed, int thr, float kp,
                                       float scale, void* stream);

// K11's backward in bfloat16 at D = 256, 8 heads, 1 <= S <= 256 (see
// ops/attention_vjp.py), its launches but the weight products: the
// forward's launches in save mode (dsvg_mha_recompute_bf16: one for S <= 32,
// two above, where the QKV launch also computes dctx = g Wo), for S <= 32
// dctx = g Wo on the dx product's launch, K4's saved-mode attention backward
// on the float32 probabilities (bwd_attn_kernel for S <= 32,
// bwd_attn_long_kernel above) into dqkv [B*S][3D], and dx = dqkv Wqkv
// [B*S][D] (bf16): four launches. x, g, wqkv, bqkv, wo, mask: the forward's
// operands and the output's gradient; wqkv_t unused (the float32 form's);
// qkv [H][B*S][96] (33 <= S), qkv_rows, p (float32), ctx, dctx: the
// recompute's tensors (dsvg_mha_recompute_bf16). The weight gradients follow
// in dsvg_wgrad_hopper: dWqkv = dqkv^T x, dWo = g^T ctx and their column
// sums.
extern "C" int dsvg_mha_bwd_bf16(const void* x, const void* g, const void* wqkv,
                                 const void* wqkv_t, const void* bqkv, const void* wo,
                                 const void* mask, void* qkv, void* qkv_rows, void* p, void* ctx,
                                 void* dctx, void* dqkv, void* dx, int B, int S, int causal,
                                 int seed, int thr, float kp, float scale, void* stream) {
  (void)wqkv_t;
  int rc = dsvg_mha_recompute_bf16(x, wqkv, bqkv, wo, mask, g, qkv, qkv_rows, p, ctx, dctx, B, S,
                                   causal, seed, thr, kp, scale, stream);
  if (rc) return rc;
  layer_train::Bwd b = {};
  b.g = (const bf16*)g;
  b.qkv = (const bf16*)qkv_rows;
  b.p32 = (const float*)p;
  b.dctx = (bf16*)dctx;
  b.dqkv = (bf16*)dqkv;
  b.dx = (bf16*)dx;
  b.B = B;
  b.S = S;
  b.seed = seed;
  b.thr = (unsigned)thr;
  b.kp = kp;
  b.scale = scale;
  return layer_train::launch_mha_bwd(b, wqkv, wo, causal, (cudaStream_t)stream);
}
