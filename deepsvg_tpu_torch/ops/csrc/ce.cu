// K5: softmax cross-entropy of the argument head straight from the decoder
// states, forward and backward; the logits are never stored (see ops/ce.py).
// K8: the same forward against G candidate targets per row (the self-match
// cost), with no backward.
//
// Replaces deepsvg_tpu/ops/ce.py:_fwd_kernel (K5's forward), _bwd_kernel
// (its backward) and _pairwise_kernel (K8). What bounds them on the H100 is
// the tensor cores: at the flagship step's R = 31,744 rows in bf16 the
// forward is 2*R*256*2827 = 45.9 GFLOP, 0.04646 ms at 989 TFLOP/s, and the
// backward three such products, 0.1394 ms; the bytes (y, dy, the head and
// its float32 gradient) are a tenth of that. The float32 form multiplies in
// TF32 at half the rate.
//
// Design. Every kernel is a persistent grid of blocks of three warpgroups:
// one producer warp streams the operands with TMA into a ring of shared
// memory stages guarded by mbarriers (no __syncthreads in the ring), and two
// consumer warpgroups multiply them with wgmma, the products landing in
// registers. A head chunk is NC = 256 bytes of columns per row of D (128
// columns in bf16, 64 in float32). The logits' operands are K-major in the
// 128-byte swizzle TMA writes (hopper.cuh); the float32 form's are rounded to
// TF32 by the wrapper, and its dlg by the kernel, as the wmma form rounded
// them. The head is packed per slot to a multiple of NC columns with zero
// rows and a bias of -inf, so padded columns fall out of the softmax and need
// no mask. What the kernels spend their time on is the softmax work between
// the products, not the products: its exponentials run on the special
// function unit (ex2) with the scale folded into one fma, and bf16 dlg is
// staged with stmatrix.
//
//   ce_fwd:   a work item is (128 rows, slot), warpgroup h owning 64 rows and
//             every column of a chunk; the rows' y stays in shared memory
//             (double-buffered over items in bf16) while the slot's chunks
//             stream by 128-byte slices of D. The logits of a chunk stay in
//             the wgmma accumulators: bias from the stage, a running
//             (max, sum of exp) per row through quad shuffles, each target's
//             logit taken by the thread that holds its column.
//             ce = lse - target logit; lse is kept for the backward.
//   ce_pairwise: the same kernel with G targets a row (K8).
//   ce_bwd_dy: a work item is 64 rows walking every slot's chunks,
//             warpgroup h owning the column slice h of each chunk: the
//             logits again, dlg = (softmax - onehot) * g in registers,
//             rounded to T and staged as the A operand of dy += dlg @ W_chunk.
//             In bf16 the B operand is the chunk already in shared memory,
//             read MN-major, and that product runs on while the next chunk's
//             logits are issued; TF32 takes only K-major operands, so the
//             float32 form streams the chunk of the transposed head too. The
//             two halves' dy are added in a fixed order at the end.
//   ce_bwd_dw: a work item is (chunk, split of the rows), warpgroup h owning
//             the column slice h: the chunk stays in shared memory while the
//             split's 64-row tiles stream by; for each, the logits and dlg
//             again, dlg^T staged, and dW_chunk^T += y^T @ dlg by wgmma, in
//             bf16 from the tile already here (MN-major), in float32 from
//             the transposed states. db is summed beside it in a fixed order.
//             Each split writes its partial sums, unpadded, and
//             dsvg_reduce_partials (wgrad.cu) adds them in a fixed order:
//             no atomics, equal to the bit from run to run.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int THREADS = 384;        // two consumer warpgroups, then the producer's
constexpr int CONSUMERS = 256;
constexpr int ROWS = 64;            // rows of a backward work item, and of a warpgroup
constexpr int FWD_ROWS = 128;       // rows of a forward work item
constexpr int SLICE = 128;          // bytes of K in one row of a TMA box
constexpr int YBOX = ROWS * SLICE;  // one box of 64 rows of y
constexpr float L2E = 1.4426950408889634f;

template <class T>
struct Ce;
template <>
struct Ce<bf16> {
  static constexpr int KS = 64;   // values in a 128-byte slice
  static constexpr int NC = 128;  // columns of a head chunk
  static constexpr int NY = 2;    // y buffers of the forward
  static constexpr int DY_S = 5;  // head stages of the dy kernel
  static constexpr bool F32 = false;
};
template <>
struct Ce<float> {
  static constexpr int KS = 32;
  static constexpr int NC = 64;
  static constexpr int NY = 1;
  static constexpr int DY_S = 3;
  static constexpr bool F32 = true;
};

// one 128-byte slice of K, both operands K-major:
// acc[64 x N] (+)= A[64 x slice] B[N x slice]^T with N = NC (FULL) or KS
template <class T, bool FULL>
__device__ __forceinline__ void mma_slice(float (&acc)[(FULL ? Ce<T>::NC : Ce<T>::KS) / 2],
                                          uint32_t a, uint32_t b, bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = desc_sw128(a + 32 * kk), db = desc_sw128(b + 32 * kk);
    const int scale = (accumulate || kk > 0) ? 1 : 0;
    if constexpr (Ce<T>::F32) {
      if constexpr (FULL)
        wgmma_m64n64k8_tf32(acc, da, db, scale);
      else
        wgmma_m64n32k8_tf32(acc, da, db, scale);
    } else {
      if constexpr (FULL)
        wgmma_m64n128k16_bf16(acc, da, db, scale);
      else
        wgmma_m64n64k16_bf16(acc, da, db, scale);
    }
  }
}

// the float32 form's dy product, K-major: acc[64 x 64] += A[64 x slice] B[64 x slice]^T
__device__ __forceinline__ void mma_slice_n64_tf32(float (&acc)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k8_tf32(acc, desc_sw128(a + 32 * kk), desc_sw128(b + 32 * kk), 1);
}

// bf16 over 64 values of K with one operand MN-major (the head chunk, or a
// tile of the states, as they lie for the logits): 16 rows of K, 2,048
// bytes, a step. acc[64 x 64] += A[64 x 64] B[64 x 64]
template <int TA, int TB>
__device__ __forceinline__ void mma_k64_bf16(float (&acc)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_bf16<TA, TB>(acc, desc_sw128(a + (TA ? 2048 : 32) * kk),
                                 desc_sw128(b + (TB ? 2048 : 32) * kk), 1);
}

// a warpgroup's bf16 dlg [64 rows x 64 columns] (accumulator layout, v) to
// shared memory by stmatrix: K-major in the columns (TRANS = false, row r at
// r * 128 bytes) or in the rows (TRANS = true, column c at c * 128 bytes),
// 128-byte swizzled. The 8x8 block (j, rr) holds rows 16 w + 8 rr + [0, 8)
// and columns 8 j + [0, 8); one stmatrix stores four of them.
template <bool TRANS>
__device__ __forceinline__ void stage_dlg_bf16(uint32_t dst, const float (&v)[32], int w,
                                               int lane) {
  const int mi = lane >> 3, k = lane & 7;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = 2 * q + (mi >> 1), rr = mi & 1;
    const uint32_t at = TRANS ? swizzle128(8 * j + k, 32 * w + 16 * rr)
                              : swizzle128(16 * w + 8 * rr + k, 16 * j);
    // block (2 q + b, rr) is matrix 2 b + rr: elements 4 j + 2 rr and + 1
    stmatrix_x4<TRANS>(dst + at, pack_bf16(v[8 * q], v[8 * q + 1]),
                       pack_bf16(v[8 * q + 2], v[8 * q + 3]), pack_bf16(v[8 * q + 4], v[8 * q + 5]),
                       pack_bf16(v[8 * q + 6], v[8 * q + 7]));
  }
}

// a consumer thread's place: warpgroup h, warp w in it, the rows r0 and
// r0 + 8 it holds in a wgmma accumulator, and its column pair 2 * t4 in
// every group of 8 columns
struct Lane {
  int tid, h, wtid, w, g, t4, r0;
  __device__ __forceinline__ Lane() {
    tid = threadIdx.x;
    h = tid >> 7;
    wtid = tid & 127;
    w = wtid >> 5;
    g = (tid & 31) >> 2;
    t4 = tid & 3;
    r0 = 16 * w + g;
  }
  // accumulator element i: its row and column
  __device__ __forceinline__ int row(int i) const { return r0 + ((i >> 1) & 1) * 8; }
  __device__ __forceinline__ int col(int i) const { return 8 * (i >> 2) + 2 * t4 + (i & 1); }
};

struct Dims {
  int R, D, n_args, vocab, awp, dks, dn, items;
};

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty, int n) {
  for (int i = 0; i < n; ++i) {
    mbar_init(&full[i], 1);
    mbar_init(&empty[i], CONSUMERS);
  }
}

// ------------------------------------------------------------------ forward
// A work item is (128 rows, slot); warpgroup h owns rows [64 h, 64 h + 64)
// and every column of each chunk.
struct FwdLayout {
  uint32_t y, w, tl, bars, total;
  static constexpr int S = 4;  // head stages
  __host__ __device__ FwdLayout(int dks, int ny, int nc, int G) {
    Carve c;
    y = c.take(ny * dks * FWD_ROWS * SLICE);
    w = c.take(S * (nc * SLICE + 1024));
    tl = c.take(2 * ROWS * G * 4, 16);
    bars = c.take((2 * ny + 2 * S) * 8, 8);
    total = c.off + 1024;
  }
};

struct FwdArgs {
  Dims d;
  int G;
  const int* tgt;     // [R][G * n_args], variant-major
  const float* bias;  // [n_args * awp], -inf in padded columns
  float* ce;          // [R][G * n_args]
  float* lse;         // [R][n_args], or null
};

template <class T>
__global__ void __launch_bounds__(THREADS, 1)
    ce_fwd_kernel(const __grid_constant__ CUtensorMap tmY, const __grid_constant__ CUtensorMap tmW,
                  const __grid_constant__ FwdArgs p) {
  constexpr int KS = Ce<T>::KS, NC = Ce<T>::NC, NY = Ce<T>::NY, S = FwdLayout::S;
  constexpr uint32_t BOX = FWD_ROWS * SLICE, WSZ = NC * SLICE + 1024;
  const Dims& d = p.d;
  const FwdLayout L(d.dks, NY, NC, p.G);
  unsigned char* base = smem_base();
  unsigned char* ybuf = base + L.y;
  unsigned char* wst = base + L.w;
  const uint32_t ysz = d.dks * BOX;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t *yfull = bars, *yempty = bars + NY, *wfull = bars + 2 * NY, *wempty = bars + 2 * NY + S;
  if (threadIdx.x == 0) {
    init_ring(yfull, yempty, NY);
    init_ring(wfull, wempty, S);
    fence_barrier_init();
  }
  __syncthreads();
  const int nch = d.awp / NC;

  if (threadIdx.x >= CONSUMERS) {  // the producer
    setmaxnreg_dec<40>();
    if (threadIdx.x != CONSUMERS) return;
    PipeState ys, ws;
    for (int item = blockIdx.x; item < d.items; item += gridDim.x) {
      const int tile = item / d.n_args, slot = item % d.n_args;
      mbar_wait(&yempty[ys.stage], ys.phase ^ 1);
      mbar_arrive_expect_tx(&yfull[ys.stage], ysz);
      for (int k = 0; k < d.dks; ++k)
        tma_load_2d(ybuf + ys.stage * ysz + k * BOX, &tmY, &yfull[ys.stage], k * KS,
                    tile * FWD_ROWS);
      ys.advance(NY);
      for (int j = 0; j < nch; ++j) {
        const int col0 = slot * d.awp + j * NC;
        for (int k = 0; k < d.dks; ++k) {
          unsigned char* st = wst + ws.stage * WSZ;
          mbar_wait(&wempty[ws.stage], ws.phase ^ 1);
          mbar_arrive_expect_tx(&wfull[ws.stage], NC * SLICE + NC * 4);
          tma_load_2d(st, &tmW, &wfull[ws.stage], k * KS, col0);
          bulk_load(st + NC * SLICE, p.bias + col0, NC * 4, &wfull[ws.stage]);
          ws.advance(S);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const Lane ln;
  const int K = p.G * d.n_args;
  // the target logits a row's quad found in this slot: [row][G], zero where none
  float* tl = reinterpret_cast<float*>(base + L.tl) + ln.h * ROWS * p.G;
  PipeState ys, ws;
  for (int item = blockIdx.x; item < d.items; item += gridDim.x) {
    const int tile = item / d.n_args, slot = item % d.n_args;
    const int row0 = tile * FWD_ROWS + ln.h * ROWS;
    if (ln.t4 == 0)
      for (int q = 0; q < p.G; ++q) tl[ln.r0 * p.G + q] = tl[(ln.r0 + 8) * p.G + q] = 0.f;
    __syncwarp();
    float m[2] = {-INFINITY, -INFINITY}, s[2] = {0.f, 0.f};
    mbar_wait(&yfull[ys.stage], ys.phase);
    const uint32_t ya = smem_u32(ybuf + ys.stage * ysz) + ln.h * ROWS * SLICE;
    for (int j = 0; j < nch; ++j) {
      float acc[NC / 2];
      int prev = 0;
      for (int k = 0; k < d.dks; ++k) {
        mbar_wait(&wfull[ws.stage], ws.phase);
        wgmma_fence();
        mma_slice<T, true>(acc, ya + k * BOX, smem_u32(wst + ws.stage * WSZ), k > 0);
        wgmma_commit();
        if (k > 0) {
          wgmma_wait<1>();
          mbar_arrive(&wempty[prev]);
        }
        prev = ws.stage;
        ws.advance(S);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      const float* bias = reinterpret_cast<const float*>(wst + prev * WSZ + NC * SLICE);
      float cmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < NC / 2; ++i) {
        acc[i] += bias[ln.col(i)];
        cmax[(i >> 1) & 1] = fmaxf(cmax[(i >> 1) & 1], acc[i]);
      }
      mbar_arrive(&wempty[prev]);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        cmax[rr] = fmaxf(cmax[rr], __shfl_xor_sync(FULL_MASK, cmax[rr], 1));
        cmax[rr] = fmaxf(cmax[rr], __shfl_xor_sync(FULL_MASK, cmax[rr], 2));
        const float mn = fmaxf(m[rr], cmax[rr]);
        s[rr] *= ex2((m[rr] - mn) * L2E);
        m[rr] = mn;
      }
#pragma unroll
      for (int i = 0; i < NC / 2; ++i)
        s[(i >> 1) & 1] += ex2(fmaf(acc[i], L2E, -m[(i >> 1) & 1] * L2E));
      // each target's logit, by the thread that holds its column
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = row0 + ln.r0 + 8 * rr;
        if (row >= d.R) continue;
        for (int q = 0; q < p.G; ++q) {
          const int t = p.tgt[(size_t)row * K + q * d.n_args + slot];
          const int c = t - j * NC;
          if (t < 0 || t >= d.vocab || c < 0 || c >= NC || ((c & 7) >> 1) != ln.t4) continue;
          float v = 0.f;
#pragma unroll
          for (int i = 0; i < NC / 2; ++i)
            if (((i >> 1) & 1) == rr && (i >> 2) == (c >> 3) && (i & 1) == (c & 1)) v = acc[i];
          tl[(ln.r0 + 8 * rr) * p.G + q] = v;
        }
      }
    }
    mbar_arrive(&yempty[ys.stage]);
    ys.advance(NY);
    // the slot's end: the row's sum over its quad, in one order on every lane
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      s[rr] += __shfl_xor_sync(FULL_MASK, s[rr], 1);
      s[rr] += __shfl_xor_sync(FULL_MASK, s[rr], 2);
    }
    __syncwarp();
    if (ln.t4 == 0) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = ln.r0 + 8 * rr, row = row0 + r;
        const float l = m[rr] + logf(s[rr]);
        if (row < d.R) {
          for (int q = 0; q < p.G; ++q)
            p.ce[(size_t)row * K + q * d.n_args + slot] = l - tl[r * p.G + q];
          if (p.lse != nullptr) p.lse[(size_t)row * d.n_args + slot] = l;
        }
      }
    }
    __syncwarp();
  }
}

// ------------------------------------------------------------------ backward, shared
template <class T>
struct BwdArgs {
  Dims d;
  const int* tgt;     // [R][n_args]
  const float* bias;  // [n_args * awp]
  const float* g;     // [R][n_args]
  const float* lse;   // [R][n_args]
  T* dy;              // [R][D]
  float* dw_part;     // [splits][n_args * vocab][D]
  float* db_part;     // [splits][n_args * vocab]
  int splits, tiles_per_split;
};

// the row's (lse, g, target) for a slot; a row beyond R has g = 0, and a
// target outside [0, vocab) is -1
struct RowTerm {
  float lse, g;  // after ready(): lse holds -lse * log2(e), -inf beyond R
  int t;
  // issue the loads; ready() before the first dlg()
  __device__ __forceinline__ void load(const float* lse_p, const float* g_p, const int* tgt,
                                       int row, int slot, const Dims& d) {
    lse = INFINITY, g = 0.f, t = -1;
    if (row < d.R) {
      const size_t i = (size_t)row * d.n_args + slot;
      lse = lse_p[i];
      g = g_p[i];
      t = tgt[i];
    }
  }
  __device__ __forceinline__ void ready(int vocab) {
    lse *= -L2E;
    if (t >= vocab) t = -1;
  }
  // dlg of a logit in column `col` of the slot: (softmax - onehot) * g
  __device__ __forceinline__ float dlg(float logit, int col) const {
    float v = ex2(fmaf(logit, L2E, lse)) * g;
    if (col == t) v -= g;
    return v;
  }
};

// ------------------------------------------------------------------ backward, dy
// A work item is 64 rows; warpgroup h owns the column slice h of each chunk.
struct DyLayout {
  uint32_t y, ring, dlg, bars, total;
  static constexpr uint32_t STAGE = 32768 + 1024;  // head boxes, then the chunk's bias
  __host__ __device__ DyLayout(int dks, int S) {
    Carve c;
    y = c.take(dks * YBOX);
    ring = c.take(S * STAGE);
    dlg = c.take(2 * ROWS * SLICE);
    bars = c.take((2 + 2 * S) * 8, 8);
    total = c.off + 1024;
  }
};

template <class T>
__global__ void __launch_bounds__(THREADS, 1)
    ce_bwd_dy_kernel(const __grid_constant__ CUtensorMap tmY,
                     const __grid_constant__ CUtensorMap tmW,
                     const __grid_constant__ CUtensorMap tmWt, const __grid_constant__ BwdArgs<T> p) {
  constexpr int KS = Ce<T>::KS, NC = Ce<T>::NC, S = Ce<T>::DY_S;
  constexpr int QW = 32768 / (NC * SLICE);  // head boxes in a stage
  const Dims& d = p.d;
  const DyLayout L(d.dks, S);
  unsigned char* base = smem_base();
  unsigned char* ybuf = base + L.y;
  unsigned char* ring = base + L.ring;
  const uint32_t ysz = d.dks * YBOX;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t *yfull = bars, *yempty = bars + 1, *full = bars + 2, *empty = bars + 2 + S;
  if (threadIdx.x == 0) {
    init_ring(yfull, yempty, 1);
    init_ring(full, empty, S);
    fence_barrier_init();
  }
  __syncthreads();
  const int nch = d.awp / NC;
  const int nw = (d.dks + QW - 1) / QW;  // head stages a chunk (at most 2)

  if (threadIdx.x >= CONSUMERS) {
    setmaxnreg_dec<40>();
    if (threadIdx.x != CONSUMERS) return;
    PipeState ys, rs;
    for (int tile = blockIdx.x; tile < d.items; tile += gridDim.x) {
      mbar_wait(yempty, ys.phase ^ 1);
      mbar_arrive_expect_tx(yfull, ysz);
      for (int k = 0; k < d.dks; ++k) tma_load_2d(ybuf + k * YBOX, &tmY, yfull, k * KS, tile * ROWS);
      ys.advance(1);
      for (int slot = 0; slot < d.n_args; ++slot)
        for (int j = 0; j < nch; ++j) {
          const int col0 = slot * d.awp + j * NC;
          for (int q = 0; q < nw; ++q) {
            unsigned char* st = ring + rs.stage * DyLayout::STAGE;
            const int nb = min(QW, d.dks - q * QW);
            const bool last = q == nw - 1;
            mbar_wait(&empty[rs.stage], rs.phase ^ 1);
            mbar_arrive_expect_tx(&full[rs.stage], nb * NC * SLICE + (last ? NC * 4 : 0));
            for (int b = 0; b < nb; ++b)
              tma_load_2d(st + b * NC * SLICE, &tmW, &full[rs.stage], (q * QW + b) * KS, col0);
            if (last) bulk_load(st + 32768, p.bias + col0, NC * 4, &full[rs.stage]);
            rs.advance(S);
          }
          if constexpr (Ce<T>::F32)  // TF32 reads the head K-major in the columns too
            for (int c = 0; c < 2; ++c) {
              mbar_wait(&empty[rs.stage], rs.phase ^ 1);
              mbar_arrive_expect_tx(&full[rs.stage], d.dn * SLICE);
              tma_load_2d(ring + rs.stage * DyLayout::STAGE, &tmWt, &full[rs.stage],
                          col0 + c * KS, 0);
              rs.advance(S);
            }
        }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const Lane ln;
  const int np = d.dn / 64;  // 64-column pieces of dy
  unsigned char* dlg = base + L.dlg + ln.h * ROWS * SLICE;  // [64 rows][this slice]
  const uint32_t dlg_a = smem_u32(dlg);
  float acc3[4][32];
  PipeState ys, rs;
  // bf16: the previous chunk's head stages, released once its dy product is
  // known done (it runs on while the next chunk's logits are issued)
  int prev[2] = {0, 0}, nprev = 0;
  for (int tile = blockIdx.x; tile < d.items; tile += gridDim.x) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc3[q][i] = 0.f;
    mbar_wait(yfull, ys.phase);
    const uint32_t ya = smem_u32(ybuf);
    for (int slot = 0; slot < d.n_args; ++slot) {
      RowTerm rt[2];
      rt[0].load(p.lse, p.g, p.tgt, tile * ROWS + ln.r0, slot, d);
      rt[1].load(p.lse, p.g, p.tgt, tile * ROWS + ln.r0 + 8, slot, d);
      rt[0].ready(d.vocab);
      rt[1].ready(d.vocab);
      for (int j = 0; j < nch; ++j) {
        float acc[KS / 2];
        int held[2] = {0, 0};
        for (int q = 0; q < nw; ++q) {
          mbar_wait(&full[rs.stage], rs.phase);
          const uint32_t st = smem_u32(ring + rs.stage * DyLayout::STAGE) + ln.h * KS * SLICE;
          const int nb = min(QW, d.dks - q * QW);
          wgmma_fence();
          for (int b = 0; b < nb; ++b)
            mma_slice<T, false>(acc, ya + (q * QW + b) * YBOX, st + b * NC * SLICE, q + b > 0);
          wgmma_commit();
          held[q] = rs.stage;
          rs.advance(S);
        }
        wgmma_wait<0>();
        fence_acc(acc);
        for (int q = 0; q < nprev; ++q) mbar_arrive(&empty[prev[q]]);
        nprev = 0;
        const float* bias =
            reinterpret_cast<const float*>(ring + held[nw - 1] * DyLayout::STAGE + 32768) +
            ln.h * KS;
        const int c0 = j * NC + ln.h * KS;
        float v[KS / 2];
#pragma unroll
        for (int i = 0; i < KS / 2; ++i)
          v[i] = rt[(i >> 1) & 1].dlg(acc[i] + bias[ln.col(i)], c0 + ln.col(i));
        named_barrier(2 + ln.h, 128);  // every warp's part of the last dy product is done
        if constexpr (Ce<T>::F32) {
#pragma unroll
          for (int i = 0; i < KS / 2; i += 2)
            *reinterpret_cast<float2*>(dlg + swizzle128(ln.row(i), ln.col(i) * 4)) =
                make_float2(to_tf32(v[i]), to_tf32(v[i + 1]));
        } else {
          stage_dlg_bf16<false>(dlg_a, v, ln.w, ln.tid & 31);
        }
        fence_proxy_async();
        named_barrier(2 + ln.h, 128);
        if constexpr (Ce<T>::F32) {
          // dy += dlg @ W_chunk from the transposed head's slice of this half
          for (int q = 0; q < nw; ++q) mbar_arrive(&empty[held[q]]);
          for (int c = 0; c < 2; ++c) {
            mbar_wait(&full[rs.stage], rs.phase);
            if (c == ln.h) {
              const uint32_t st = smem_u32(ring + rs.stage * DyLayout::STAGE);
              wgmma_fence();
#pragma unroll
              for (int q = 0; q < 4; ++q)
                if (q < np) mma_slice_n64_tf32(acc3[q], dlg_a, st + q * 64 * SLICE);
              wgmma_commit();
              wgmma_wait<0>();
            }
            mbar_arrive(&empty[rs.stage]);
            rs.advance(S);
          }
        } else {
          // dy += dlg @ W_chunk from the chunk already here: box q holds the
          // 64 values of D of piece q for each column, rows of K
          wgmma_fence();
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (q < np)
              mma_k64_bf16<0, 1>(acc3[q], dlg_a,
                                 smem_u32(ring + held[q / QW] * DyLayout::STAGE) +
                                     (q % QW) * NC * SLICE + ln.h * KS * SLICE);
          wgmma_commit();
          for (int q = 0; q < nw; ++q) prev[q] = held[q];
          nprev = nw;
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < 4; ++q) fence_acc(acc3[q]);
    for (int q = 0; q < nprev; ++q) mbar_arrive(&empty[prev[q]]);
    nprev = 0;
    mbar_arrive(yempty);
    ys.advance(1);
    // dy = half 0 + half 1, a 64-column piece at a time through shared memory
    float* xch = reinterpret_cast<float*>(base + L.dlg);
    named_barrier(1, CONSUMERS);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= np) break;
      if (ln.h == 1)
#pragma unroll
        for (int i = 0; i < 32; ++i) xch[i * 128 + ln.wtid] = acc3[q][i];
      named_barrier(1, CONSUMERS);
      if (ln.h == 0) {
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int row = tile * ROWS + ln.row(i), col = q * 64 + ln.col(i);
          if (row < d.R && col < d.D)
            store2(p.dy + (size_t)row * d.D + col, acc3[q][i] + xch[i * 128 + ln.wtid],
                   acc3[q][i + 1] + xch[(i + 1) * 128 + ln.wtid]);
        }
      }
      named_barrier(1, CONSUMERS);
    }
  }
}

// ------------------------------------------------------------------ backward, dW and db
// A work item is (chunk, split of the row tiles); warpgroup h owns the
// column slice h of the chunk.
struct DwLayout {
  uint32_t w, ring, dlg, bars, total;
  static constexpr int S = 4;
  static constexpr uint32_t STAGE = 32768;
  __host__ __device__ DwLayout(int dks, int nc) {
    Carve c;
    w = c.take(dks * nc * SLICE + 1024);
    ring = c.take(S * STAGE);
    dlg = c.take(2 * ROWS * SLICE);
    bars = c.take((2 + 2 * S) * 8, 8);
    total = c.off + 1024;
  }
};

template <class T>
__global__ void __launch_bounds__(THREADS, 1)
    ce_bwd_dw_kernel(const __grid_constant__ CUtensorMap tmY,
                     const __grid_constant__ CUtensorMap tmW,
                     const __grid_constant__ CUtensorMap tmYt, const __grid_constant__ BwdArgs<T> p) {
  constexpr int KS = Ce<T>::KS, NC = Ce<T>::NC, S = DwLayout::S;
  constexpr int QY = 4;                         // boxes of y in a stage
  constexpr int NS = ROWS * sizeof(T) / SLICE;  // 128-byte slices of a row tile
  const Dims& d = p.d;
  const DwLayout L(d.dks, NC);
  unsigned char* base = smem_base();
  unsigned char* wbuf = base + L.w;
  unsigned char* ring = base + L.ring;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t *wfull = bars, *wempty = bars + 1, *full = bars + 2, *empty = bars + 2 + S;
  if (threadIdx.x == 0) {
    init_ring(wfull, wempty, 1);
    init_ring(full, empty, S);
    fence_barrier_init();
  }
  __syncthreads();
  const int nch = d.awp / NC, chunks = d.n_args * nch;
  const int ny = (d.dks + QY - 1) / QY;  // y stages a row tile (one in bf16)
  const int ntiles = (d.R + ROWS - 1) / ROWS;
  const uint32_t wsz = d.dks * NC * SLICE;

  if (threadIdx.x >= CONSUMERS) {
    setmaxnreg_dec<40>();
    if (threadIdx.x != CONSUMERS) return;
    PipeState ws, rs;
    for (int item = blockIdx.x; item < d.items; item += gridDim.x) {
      const int split = item / chunks, chunk = item % chunks;
      const int col0 = (chunk / nch) * d.awp + (chunk % nch) * NC;
      mbar_wait(wempty, ws.phase ^ 1);
      mbar_arrive_expect_tx(wfull, wsz + NC * 4);
      for (int k = 0; k < d.dks; ++k) tma_load_2d(wbuf + k * NC * SLICE, &tmW, wfull, k * KS, col0);
      bulk_load(wbuf + wsz, p.bias + col0, NC * 4, wfull);
      ws.advance(1);
      const int t1 = min(ntiles, (split + 1) * p.tiles_per_split);
      for (int t = split * p.tiles_per_split; t < t1; ++t) {
        for (int q = 0; q < ny; ++q) {
          unsigned char* st = ring + rs.stage * DwLayout::STAGE;
          const int nb = min(QY, d.dks - q * QY);
          mbar_wait(&empty[rs.stage], rs.phase ^ 1);
          mbar_arrive_expect_tx(&full[rs.stage], nb * YBOX);
          for (int b = 0; b < nb; ++b)
            tma_load_2d(st + b * YBOX, &tmY, &full[rs.stage], (q * QY + b) * KS, t * ROWS);
          rs.advance(S);
        }
        if constexpr (Ce<T>::F32)  // TF32 reads the states K-major in the rows too
          for (int s = 0; s < NS; ++s) {
            mbar_wait(&empty[rs.stage], rs.phase ^ 1);
            mbar_arrive_expect_tx(&full[rs.stage], d.dn * SLICE);
            tma_load_2d(ring + rs.stage * DwLayout::STAGE, &tmYt, &full[rs.stage],
                        t * ROWS + s * KS, 0);
            rs.advance(S);
          }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const Lane ln;
  const int np = d.dn / 64;  // 64-row pieces of dW^T
  unsigned char* dlg = base + L.dlg + ln.h * ROWS * SLICE;  // dlg^T: [KS columns][64 rows]
  const uint32_t dlg_a = smem_u32(dlg);
  const int cols = d.n_args * d.vocab;
  float acc3[4][KS / 2];
  float db[KS / 4];
  PipeState ws, rs;
  for (int item = blockIdx.x; item < d.items; item += gridDim.x) {
    const int split = item / chunks, chunk = item % chunks;
    const int slot = chunk / nch, c0 = (chunk % nch) * NC + ln.h * KS;  // within the slot
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < KS / 2; ++i) acc3[q][i] = 0.f;
#pragma unroll
    for (int i = 0; i < KS / 4; ++i) db[i] = 0.f;
    mbar_wait(wfull, ws.phase);
    const uint32_t wa = smem_u32(wbuf) + ln.h * KS * SLICE;
    const float* bias = reinterpret_cast<const float*>(wbuf + wsz) + ln.h * KS;
    const int t1 = min(ntiles, (split + 1) * p.tiles_per_split);
    int prev = -1;  // bf16: the last tile's stage, released once its dW product is done
    for (int t = split * p.tiles_per_split; t < t1; ++t) {
      float acc[KS / 2];
      int held[2] = {0, 0};
      for (int q = 0; q < ny; ++q) {
        mbar_wait(&full[rs.stage], rs.phase);
        const uint32_t st = smem_u32(ring + rs.stage * DwLayout::STAGE);
        const int nb = min(QY, d.dks - q * QY);
        wgmma_fence();
        for (int b = 0; b < nb; ++b)
          mma_slice<T, false>(acc, st + b * YBOX, wa + (q * QY + b) * NC * SLICE, q + b > 0);
        wgmma_commit();
        held[q] = rs.stage;
        rs.advance(S);
      }
      RowTerm rt[2];  // loaded while the products run
      rt[0].load(p.lse, p.g, p.tgt, t * ROWS + ln.r0, slot, d);
      rt[1].load(p.lse, p.g, p.tgt, t * ROWS + ln.r0 + 8, slot, d);
      wgmma_wait<0>();
      fence_acc(acc);
      if (prev >= 0) mbar_arrive(&empty[prev]);
      prev = -1;
      if constexpr (Ce<T>::F32)
        for (int q = 0; q < ny; ++q) mbar_arrive(&empty[held[q]]);
      rt[0].ready(d.vocab);
      rt[1].ready(d.vocab);
      float v[KS / 2];
#pragma unroll
      for (int i = 0; i < KS / 2; ++i) {
        v[i] = rt[(i >> 1) & 1].dlg(acc[i] + bias[ln.col(i)], c0 + ln.col(i));
        db[(i >> 2) * 2 + (i & 1)] += v[i];
      }
      named_barrier(2 + ln.h, 128);  // every warp's part of the last dW product is done
      // dlg^T, K-major in the rows: 128-byte slices of KS rows
      if constexpr (Ce<T>::F32) {
#pragma unroll
        for (int i = 0; i < KS / 2; ++i) {
          const int c = ln.col(i), r = ln.row(i);
          *reinterpret_cast<float*>(dlg + (r / KS) * (KS * SLICE) + swizzle128(c, (r % KS) * 4)) =
              to_tf32(v[i]);
        }
      } else {
        stage_dlg_bf16<true>(dlg_a, v, ln.w, ln.tid & 31);
      }
      fence_proxy_async();
      named_barrier(2 + ln.h, 128);
      if constexpr (Ce<T>::F32) {
        // dW^T += y^T @ dlg from the transposed states, a slice of rows a stage
        for (int s = 0; s < NS; ++s) {
          mbar_wait(&full[rs.stage], rs.phase);
          const uint32_t st = smem_u32(ring + rs.stage * DwLayout::STAGE);
          wgmma_fence();
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (q < np) mma_slice<T, false>(acc3[q], st + q * 64 * SLICE, dlg_a + s * KS * SLICE, true);
          wgmma_commit();
          wgmma_wait<0>();
          mbar_arrive(&empty[rs.stage]);
          rs.advance(S);
        }
      } else {
        // dW^T += y^T @ dlg from the row tile already here: box q holds the
        // 64 values of D of piece q for each row, rows of K; it runs on
        // while the next tile's logits are issued
        const uint32_t st = smem_u32(ring + held[0] * DwLayout::STAGE);
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < np) mma_k64_bf16<1, 0>(acc3[q], st + q * YBOX, dlg_a);
        wgmma_commit();
        prev = held[0];
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < 4; ++q) fence_acc(acc3[q]);
    if (prev >= 0) mbar_arrive(&empty[prev]);
    mbar_arrive(wempty);
    ws.advance(1);
    // this split's dW rows of the chunk: acc3[q] is dW^T, rows d, columns c
    float* dw = p.dw_part + (size_t)split * cols * d.D;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= np) break;
#pragma unroll
      for (int i = 0; i < KS / 2; ++i) {
        const int dd = q * 64 + ln.row(i), c = c0 + ln.col(i);
        if (dd < d.D && c < d.vocab) dw[(size_t)(slot * d.vocab + c) * d.D + dd] = acc3[q][i];
      }
    }
    // db: over the 8 row groups of a warp, then the 4 warps in order
#pragma unroll
    for (int i = 0; i < KS / 4; ++i) {
      db[i] += __shfl_xor_sync(FULL_MASK, db[i], 4);
      db[i] += __shfl_xor_sync(FULL_MASK, db[i], 8);
      db[i] += __shfl_xor_sync(FULL_MASK, db[i], 16);
    }
    float* dbx = reinterpret_cast<float*>(dlg);  // [warp][KS], free after the last product
    named_barrier(2 + ln.h, 128);
    if (ln.g == 0)
#pragma unroll
      for (int i = 0; i < KS / 4; ++i) dbx[ln.w * KS + 8 * (i >> 1) + 2 * ln.t4 + (i & 1)] = db[i];
    named_barrier(2 + ln.h, 128);
    if (ln.wtid < KS && c0 + ln.wtid < d.vocab)
      p.db_part[(size_t)split * cols + slot * d.vocab + c0 + ln.wtid] =
          ((dbx[ln.wtid] + dbx[KS + ln.wtid]) + dbx[2 * KS + ln.wtid]) + dbx[3 * KS + ln.wtid];
    named_barrier(2 + ln.h, 128);
  }
}

// ------------------------------------------------------------------ the head as the kernels read it
// wa [n_args * vocab][D] and ba float32 -> w [n_args * awp][D] in T (float32
// rounded to TF32), zero rows beyond vocab, and bias [n_args * awp] float32
// (the value in T), -inf beyond vocab; one block a packed row
template <class T>
__global__ void pack_head_kernel(const float* __restrict__ wa, const float* __restrict__ ba,
                                 T* __restrict__ w, float* __restrict__ bias, int vocab, int awp,
                                 int D) {
  const int row = blockIdx.x, slot = row / awp, c = row - slot * awp;
  const bool real = c < vocab;
  const float* src = wa + ((size_t)slot * vocab + c) * D;
  for (int k = threadIdx.x; k < D; k += blockDim.x) {
    const float v = real ? src[k] : 0.f;
    if constexpr (Ce<T>::F32)
      w[(size_t)row * D + k] = to_tf32(v);
    else
      w[(size_t)row * D + k] = from_f<T>(v);
  }
  if (threadIdx.x == 0) bias[row] = real ? to_f(from_f<T>(ba[(size_t)slot * vocab + c])) : -INFINITY;
}

// ------------------------------------------------------------------ launchers
template <class T>
Dims dims(int R, int D, int n_args, int vocab, int awp, int items) {
  Dims d;
  d.R = R;
  d.D = D;
  d.n_args = n_args;
  d.vocab = vocab;
  d.awp = awp;
  d.dks = (D + Ce<T>::KS - 1) / Ce<T>::KS;
  d.dn = (D + 63) / 64 * 64;
  d.items = items;
  return d;
}

// y [R][D] (128-byte slices of D, `rows` rows), the packed head
// [n_args * awp][D] (slices of D, NC rows)
template <class T>
int y_and_head_maps(CUtensorMap* tmY, CUtensorMap* tmW, const void* y, const void* w,
                    const Dims& d, int rows) {
  constexpr bool f32 = Ce<T>::F32;
  int rc = bind_device_of(y);
  if (rc == 0) rc = make_tma_2d(tmY, y, f32, d.D, d.R, (uint64_t)d.D * sizeof(T), Ce<T>::KS, rows);
  if (rc == 0)
    rc = make_tma_2d(tmW, w, f32, d.D, (uint64_t)d.n_args * d.awp, (uint64_t)d.D * sizeof(T),
                     Ce<T>::KS, Ce<T>::NC);
  return rc;
}

// raise a kernel's dynamic shared memory limit to `smem`, once per size:
// `limit` is the launcher's own record of what it set
template <class K>
int prepare(K kernel, uint32_t smem, uint32_t& limit) {
  if (smem <= limit) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) limit = smem;
  return (int)err;
}

template <class T>
int launch_fwd(const void* y, const void* w, const void* bias, const void* tgt, void* ce,
               void* lse, int R, int D, int n_args, int vocab, int awp, int G,
               cudaStream_t stream) {
  FwdArgs p;
  p.d = dims<T>(R, D, n_args, vocab, awp, (R + FWD_ROWS - 1) / FWD_ROWS * n_args);
  p.G = G;
  p.tgt = (const int*)tgt;
  p.bias = (const float*)bias;
  p.ce = (float*)ce;
  p.lse = (float*)lse;
  CUtensorMap tmY, tmW;
  int rc = y_and_head_maps<T>(&tmY, &tmW, y, w, p.d, FWD_ROWS);
  if (rc) return rc;
  const uint32_t smem = FwdLayout(p.d.dks, Ce<T>::NY, Ce<T>::NC, G).total;
  static uint32_t limit = 0;
  if ((rc = prepare(ce_fwd_kernel<T>, smem, limit))) return rc;
  ce_fwd_kernel<T><<<std::min(p.d.items, sm_count()), THREADS, smem, stream>>>(tmY, tmW, p);
  return (int)cudaGetLastError();
}

template <class T>
BwdArgs<T> bwd_args(const void* bias, const void* tgt, const void* g, const void* lse,
                    const Dims& d) {
  BwdArgs<T> p = {};
  p.d = d;
  p.tgt = (const int*)tgt;
  p.bias = (const float*)bias;
  p.g = (const float*)g;
  p.lse = (const float*)lse;
  return p;
}

template <class T>
int launch_dy(const void* y, const void* w, const void* wt, const void* bias, const void* tgt,
              const void* g, const void* lse, void* dy, int R, int D, int n_args, int vocab,
              int awp, cudaStream_t stream) {
  BwdArgs<T> p = bwd_args<T>(bias, tgt, g, lse,
                             dims<T>(R, D, n_args, vocab, awp, (R + ROWS - 1) / ROWS));
  p.dy = (T*)dy;
  CUtensorMap tmY, tmW, tmWt = {};
  int rc = y_and_head_maps<T>(&tmY, &tmW, y, w, p.d, ROWS);
  // float32: the transposed head [D][n_args * awp], slices of its columns
  if (rc == 0 && Ce<T>::F32)
    rc = make_tma_2d(&tmWt, wt, true, (uint64_t)n_args * awp, D, (uint64_t)n_args * awp * 4,
                     Ce<T>::KS, p.d.dn);
  if (rc) return rc;
  const uint32_t smem = DyLayout(p.d.dks, Ce<T>::DY_S).total;
  static uint32_t limit = 0;
  if ((rc = prepare(ce_bwd_dy_kernel<T>, smem, limit))) return rc;
  ce_bwd_dy_kernel<T><<<std::min(p.d.items, sm_count()), THREADS, smem, stream>>>(tmY, tmW, tmWt,
                                                                                  p);
  return (int)cudaGetLastError();
}

template <class T>
int launch_dw(const void* y, const void* yt, int yt_stride, const void* w, const void* bias,
              const void* tgt, const void* g, const void* lse, void* dw_part, void* db_part,
              int R, int D, int n_args, int vocab, int awp, int splits, cudaStream_t stream) {
  const int ntiles = (R + ROWS - 1) / ROWS;
  BwdArgs<T> p = bwd_args<T>(bias, tgt, g, lse,
                             dims<T>(R, D, n_args, vocab, awp, n_args * (awp / Ce<T>::NC) * splits));
  p.dw_part = (float*)dw_part;
  p.db_part = (float*)db_part;
  p.splits = splits;
  p.tiles_per_split = (ntiles + splits - 1) / splits;
  CUtensorMap tmY, tmW, tmYt = {};
  int rc = y_and_head_maps<T>(&tmY, &tmW, y, w, p.d, ROWS);
  // float32: the transposed states [D][yt_stride], slices of the rows
  if (rc == 0 && Ce<T>::F32)
    rc = make_tma_2d(&tmYt, yt, true, R, D, (uint64_t)yt_stride * 4, Ce<T>::KS, p.d.dn);
  if (rc) return rc;
  const uint32_t smem = DwLayout(p.d.dks, Ce<T>::NC).total;
  static uint32_t limit = 0;
  if ((rc = prepare(ce_bwd_dw_kernel<T>, smem, limit))) return rc;
  ce_bwd_dw_kernel<T><<<std::min(p.d.items, sm_count()), THREADS, smem, stream>>>(tmY, tmW, tmYt,
                                                                                  p);
  return (int)cudaGetLastError();
}

}  // namespace

// wa, ba: the head's float32 masters; w, bias as the kernels read them
extern "C" int dsvg_ce_pack_head(const void* wa, const void* ba, void* w, void* bias, int n_args,
                                 int vocab, int awp, int D, int is_f32, void* stream) {
  const int rows = n_args * awp;
  if (is_f32)
    pack_head_kernel<float><<<rows, 128, 0, (cudaStream_t)stream>>>(
        (const float*)wa, (const float*)ba, (float*)w, (float*)bias, vocab, awp, D);
  else
    pack_head_kernel<bf16><<<rows, 128, 0, (cudaStream_t)stream>>>(
        (const float*)wa, (const float*)ba, (bf16*)w, (float*)bias, vocab, awp, D);
  return (int)cudaGetLastError();
}

// is_f32 (every entry point): y, the head and dy are float (TF32 products),
// else bf16. The head is packed per slot to `awp` columns (a multiple of 128
// in bf16, 64 in float), its bias float32 with -inf in the padded columns.
extern "C" int dsvg_ce_fwd(const void* y, const void* w, const void* bias, const void* tgt,
                           void* ce, void* lse, int R, int D, int n_args, int vocab, int awp,
                           int is_f32, void* stream) {
  if (is_f32)
    return launch_fwd<float>(y, w, bias, tgt, ce, lse, R, D, n_args, vocab, awp, 1,
                             (cudaStream_t)stream);
  return launch_fwd<bf16>(y, w, bias, tgt, ce, lse, R, D, n_args, vocab, awp, 1,
                          (cudaStream_t)stream);
}

// tgt and ce [R][G * n_args], variant-major
extern "C" int dsvg_ce_pairwise(const void* y, const void* w, const void* bias, const void* tgt,
                                void* ce, int R, int D, int n_args, int vocab, int awp, int G,
                                int is_f32, void* stream) {
  if (is_f32)
    return launch_fwd<float>(y, w, bias, tgt, ce, nullptr, R, D, n_args, vocab, awp, G,
                             (cudaStream_t)stream);
  return launch_fwd<bf16>(y, w, bias, tgt, ce, nullptr, R, D, n_args, vocab, awp, G,
                          (cudaStream_t)stream);
}

// wt: the packed head transposed, [D][n_args * awp], read by the float32
// form only (null in bf16)
extern "C" int dsvg_ce_bwd_dy(const void* y, const void* w, const void* wt, const void* bias,
                              const void* tgt, const void* g, const void* lse, void* dy, int R,
                              int D, int n_args, int vocab, int awp, int is_f32, void* stream) {
  if (is_f32)
    return launch_dy<float>(y, w, wt, bias, tgt, g, lse, dy, R, D, n_args, vocab, awp,
                            (cudaStream_t)stream);
  return launch_dy<bf16>(y, w, wt, bias, tgt, g, lse, dy, R, D, n_args, vocab, awp,
                         (cudaStream_t)stream);
}

// yt: y transposed, [D][yt_stride] (yt_stride >= R, 16-byte rows), read by
// the float32 form only (null in bf16); dw_part [splits][n_args * vocab][D],
// db_part [splits][n_args * vocab]
extern "C" int dsvg_ce_bwd_dw(const void* y, const void* yt, int yt_stride, const void* w,
                              const void* bias, const void* tgt, const void* g, const void* lse,
                              void* dw_part, void* db_part, int R, int D, int n_args, int vocab,
                              int awp, int splits, int is_f32, void* stream) {
  if (is_f32)
    return launch_dw<float>(y, yt, yt_stride, w, bias, tgt, g, lse, dw_part, db_part, R, D,
                            n_args, vocab, awp, splits, (cudaStream_t)stream);
  return launch_dw<bf16>(y, yt, yt_stride, w, bias, tgt, g, lse, dw_part, db_part, R, D, n_args,
                         vocab, awp, splits, (cudaStream_t)stream);
}
