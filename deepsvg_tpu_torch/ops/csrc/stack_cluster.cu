// K7 on Hopper: an L-layer stack of fused training layers, forward in one
// launch and the row-local part of the backward in one launch, on thread
// block clusters (see ops/stack_vjp.py for the whole op). Replaces the Pallas
// kernels deepsvg_tpu/ops/stack_vjp.py:_stack_fwd_kernel and
// _stack_bwd_kernel.
//
// What bounds it. At the stacks' shapes (E2 and D2: B <= 64 sequences of
// S = 8, D = 256, F = 512, H = 8, L = 4) a layer is 1 MFLOP a row and its
// weights 1 MB (bf16): microseconds of work for the whole card. The older
// kernel (stack.cu: one block of 8 warps runs all L layers of 64 rows, each
// warp reading its weight fragments from L2 with nothing in flight) filled 8
// of 132 SMs and waited on L2. So the design buys parallelism first, keeps
// the weights in flight second, and then shortens the latency chains of the
// few warps an SM holds.
//
// Parallelism: a tile of whole sequences (R rows: 32 in bf16, 16 in float
// activations) is computed by a cluster of H blocks, block c of the cluster
// owning head c and 1/H of the output columns of every product:
//   QKV     head c's 3 x 32 columns, then its attention over the tile's
//           sequences;
//   out projection, FF2   the D / H = 32 columns c*32..;
//   FF1     the F / H columns c*F/H...
// A product's input rows are needed whole, so every output slice is pushed
// into the same columns of the other blocks' shared memory (distributed
// shared memory, 16 bytes a store), and a cluster barrier (release /
// acquire) follows: four such exchanges a layer (context, attention output,
// FF hidden, FF output). The residual stream (f32), the LayerNorms and the
// rounding of each layer's output to the activation type are computed in
// every block on whole rows, the same arithmetic on the same values, so the
// blocks agree to the bit and no row sum crosses the cluster. Between layers
// the stream stays in shared memory; only what the backward reads goes to
// device memory, each block writing its own columns. At B=60, S=8 the grid is
// 15 tiles x 8 blocks (bf16) and 30 x 8 (float32), against 8 and 15 blocks
// before; a block holds 174-226 KiB of shared memory, one block an SM.
//
// Receive buffers are reused every other exchange: a block pushes exchange
// k + 2 only after the barrier of exchange k + 1, which every block reaches
// after it has read exchange k, so no push lands in memory still being read.
// A block leaves only after the last barrier of its last layer, after which
// no block writes into another.
//
// Weights: a block reads only its slices (128 KB a layer in bf16, 256 KB in
// float32), through a ring of NS stages in shared memory fed by cp.async
// (16 bytes a thread, all threads, one commit group a stage): the next
// chunks, across layer boundaries, are in flight while the current chunk
// computes (the ring's waits measured about 100 cycles a layer). The slices
// are short-row gathers (the backward reads W[:, 32 columns], 64 bytes a row
// in bf16), which per-row bulk copies would issue one at a time; cp.async
// also lands each row with a 16-byte pad, so the fragment loads below are
// free of bank conflicts.
//
// Latency: 8 warps an SM leave little to hide a dependent chain behind, so
// the width D is a template parameter (no integer division by it, every
// row loop unrolled), row passes hold all of a warp's rows in registers and
// fuse the residual updates with the LayerNorms, column sums run on all
// warps (per-warp partial sums, then added in warp order), the next layer's
// vectors (LayerNorms, bias columns) are loaded into registers a layer ahead,
// and at S <= 8 a warp runs attention for 4 queries at once (lane 8 q + key).
//
// Products: a block's output piece is R x 32 on mma.sync (bf16 m16n8k16;
// float32 as TF32 m16n8k8, operands rounded to nearest as the TF32 wmma of
// the older code), each warp one 16 x 8 tile with two accumulators over
// alternate k-steps; with 16-row tiles (float32) warps 0-3 and 4-7 take each
// half of a chunk's K, added in fixed order. R is below wgmma's 64 rows.
//
// Dropout hashes each element at its global (row, column), and the
// probabilities at ((sequence * H + head) * S + query, key), so the masks
// are those of K4 and of the plain version, layer l seeded with
// stack_layer_seed(seed, l).
//
// The backward runs the layers in reverse on the same cluster layout:
//   df = g * mask (whole rows, every block) -> dhpre's F/H columns (W2's
//   columns) -> pushed -> dxn2's 32 columns (W1's columns, over F) ->
//   pushed -> LN2 backward on whole rows (dx1, da) -> dctx of head c (Wo's
//   columns) -> head c's attention backward (dq, dk, dv) -> pushed ->
//   dxn1's 32 columns (Wqkv's columns, over 3D) -> pushed -> LN1 backward
//   on whole rows: dx, rounded, the next layer's g.
// It writes the rounded operands of the four weight products (each block
// its columns) for the weight-gradient launch, and each tile's column sums
// (LayerNorm and bias gradients, [tiles][L][9D + F], each block its
// columns), which dsvg_reduce_partials adds in tile order. No atomics: the
// gradients are equal to the bit from run to run.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace stack_cluster {

constexpr int NS = 4;          // weight ring stages
constexpr int HD = HEAD_DIM;   // 32: a head's columns, and a piece's
constexpr int PADB = 8;        // elements of pad a row of a backward chunk
constexpr uint32_t STAGE = 20480;  // bytes a stage (the larger chunk)
constexpr int VEC_PER_THREAD = 6;  // the forward's per-layer vectors: fwd_vec <= 6 NTHREADS

template <class T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int R = 32, KC = 256, PAD = 8, KS = 16;
};
template <>
struct Cfg<float> {
  static constexpr int R = 16, KC = 128, PAD = 4, KS = 8;
};

// a weight chunk's K: the largest multiple of 64 up to kc that divides K
__host__ __device__ constexpr int chunk_k(int K, int kc) {
  for (int c = kc; c >= 64; c -= 64)
    if (K % c == 0) return c;
  return 64;
}

__host__ __device__ inline int round128(int v) { return (v + 127) / 128 * 128; }

// shared memory of the forward: the residual stream (f32), the push buffer
// of the attention and FF outputs (f32), the push buffer of the context and
// FF hidden, the LayerNorm output, head c's QKV, the ring
// the forward's per-layer vectors, as f32: LN1, LN2 (scale, bias), then
// this block's columns of bqkv (q, k, v), bo, b1 (fc of them) and b2
__host__ __device__ inline int fwd_vec(int D, int fc) { return 4 * D + 5 * HD + fc; }

struct FwdLayout {
  int xres, z, x, xn, qkv, vec, red, ring, total;
  __host__ __device__ FwdLayout(int R, int D, int F, int esz, int pad) {
    int o = 0;
    xres = o; o += round128(R * D * 4);
    z = o; o += round128(R * D * 4);
    x = o; o += round128(R * ((D > F ? D : F) + pad) * esz);
    xn = o; o += round128(R * (D + pad) * esz);
    qkv = o; o += round128(R * (3 * HD + pad) * esz);
    vec = o; o += round128(fwd_vec(D, F / (D / HD)) * 4);
    red = o; o += R == 16 ? 2048 : 0;
    ring = o; o += NS * (int)STAGE;
    total = o;
  }
};

// shared memory of the backward: the residual gradient (f32: g, dx1, dx),
// the push buffer of dxn2 and dxn1 (f32), the push buffer of dhpre and
// dqkv, df / da, head c's QKV, probabilities and dctx, the column sums'
// partial sums, LN1 and LN2, the ring
struct BwdLayout {
  int y, z, x, a, qkv, pr, dctx, cs, vec, red, ring, total;
  __host__ __device__ BwdLayout(int R, int D, int F, int esz, int pad) {
    int o = 0;
    y = o; o += round128(R * D * 4);
    z = o; o += round128(R * D * 4);
    x = o; o += round128(R * ((3 * D > F ? 3 * D : F) + pad) * esz);
    a = o; o += round128(R * (D + pad) * esz);
    qkv = o; o += round128(R * (3 * HD + pad) * esz);
    pr = o; o += round128(R * R * esz);
    dctx = o; o += round128(R * (HD + pad) * esz);
    cs = o; o += NTHREADS * 4 * 4;
    vec = o; o += round128(4 * D * esz);
    red = o; o += R == 16 ? 2048 : 0;
    ring = o; o += NS * (int)STAGE;
    total = o;
  }
};

// ---- cp.async
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <class T>
struct Weights {
  const T *wqkv, *wo, *w1, *w2;
};

template <class T>
__host__ __device__ int fwd_chunks(int D, int F, int H) {
  using C = Cfg<T>;
  const int nd = D / chunk_k(D, C::KC), nf = F / chunk_k(F, C::KC);
  return (4 + F / H / HD) * nd + nf;
}

template <class T>
__host__ __device__ int bwd_chunks(int D, int F, int H) {
  using C = Cfg<T>;
  const int nd = D / chunk_k(D, C::KC), nf = F / chunk_k(F, C::KC);
  return (F / H / HD + 1) * nd + nf + 3 * D / chunk_k(3 * D, C::KC);
}

// The weight ring: chunk q lives in stage q % NS. acquire() waits for chunk
// q (its own copies, then a block barrier for everyone's), then refills the
// stage that chunk q - 1 used (every thread is past it) with chunk q + NS - 1.
//
// A layer's chunks, for block c. Forward: QKV (head c's q, k, v rows), wo's
// rows c*32.., w1's rows c*F/H.. in 32-row pieces, w2's rows c*32..; each
// piece of 32 rows in chunks of K, landing with a row pitch of K chunk + PAD
// (rows of 16-byte copies). Backward: w2's columns c*F/H.. in 32-column
// pieces (K = D), w1's columns c*32.. (K = F), wo's columns c*32.. (K = D),
// wqkv's columns c*32.. (K = 3D); chunks of K rows, pitch 32 + PADB.
template <class T, int D, bool BWD>
struct Ring {
  static constexpr int KC = Cfg<T>::KC, PAD = Cfg<T>::PAD, V = 16 / sizeof(T);
  static constexpr int kd = chunk_k(D, KC), nd = D / kd, k3 = chunk_k(3 * D, KC);
  unsigned char* base;
  Weights<T> w;
  int q, total, per_layer, L, c, F, kf, nf, fc;

  __device__ Ring(unsigned char* base_, const Weights<T>& w_, int L_, int c_, int F_)
      : base(base_), w(w_), q(0), L(L_), c(c_), F(F_) {
    kf = chunk_k(F, KC);
    nf = F / kf;
    fc = F / (D / HD);
    per_layer = BWD ? bwd_chunks<T>(D, F, D / HD) : fwd_chunks<T>(D, F, D / HD);
    total = L * per_layer;
  }

  // nr rows of PER 16-byte copies from src (row stride ld) to dst (pitch)
  template <int PER>
  __device__ __forceinline__ void copy(T* dst, int pitch, const T* src, int ld, int nr) {
    for (int i = threadIdx.x; i < nr * PER; i += NTHREADS) {
      const int r = i / PER, j = i % PER;
      cp_async16(dst + r * pitch + j * V, src + (size_t)r * ld + j * V);
    }
  }

  __device__ void issue(int n) {
    const int layer = n / per_layer;
    const int l = BWD ? L - 1 - layer : layer;
    int e = n - layer * per_layer;
    const T* wqkv = w.wqkv + (size_t)l * 3 * D * D;
    const T* wo = w.wo + (size_t)l * D * D;
    const T* w1 = w.w1 + (size_t)l * F * D;
    const T* w2 = w.w2 + (size_t)l * D * F;
    T* dst = reinterpret_cast<T*>(base + (n % NS) * STAGE);
    const int npc = fc / HD;  // 32-wide pieces of the FF columns
    if constexpr (!BWD) {
      if (e < 4 * nd + npc * nd) {
        const T* src;
        if (e < 3 * nd) src = wqkv + (size_t)((e / nd) * D + c * HD) * D + (e % nd) * kd;
        else if (e < 4 * nd) src = wo + (size_t)(c * HD) * D + (e - 3 * nd) * kd;
        else {
          e -= 4 * nd;
          src = w1 + (size_t)(c * fc + (e / nd) * HD) * D + (e % nd) * kd;
        }
        copy<kd / V>(dst, kd + PAD, src, D, HD);
      } else {
        e -= 4 * nd + npc * nd;
        const T* src = w2 + (size_t)(c * HD) * F + e * kf;
        switch (kf / V) {  // kf: 64, 128, 192 or 256
          case 64 / V: copy<64 / V>(dst, kf + PAD, src, F, HD); break;
          case 128 / V: copy<128 / V>(dst, kf + PAD, src, F, HD); break;
          case 192 / V: copy<192 / V>(dst, kf + PAD, src, F, HD); break;
          default: copy<256 / V>(dst, kf + PAD, src, F, HD); break;
        }
      }
    } else {
      constexpr int P = HD / V, pitch = HD + PADB;
      if (e < npc * nd) copy<P>(dst, pitch, w2 + (size_t)((e % nd) * kd) * F + c * fc + (e / nd) * HD, F, kd);
      else if ((e -= npc * nd) < nf) copy<P>(dst, pitch, w1 + (size_t)(e * kf) * D + c * HD, D, kf);
      else if ((e -= nf) < nd) copy<P>(dst, pitch, wo + (size_t)(e * kd) * D + c * HD, D, kd);
      else copy<P>(dst, pitch, wqkv + (size_t)((e - nd) * k3) * D + c * HD, D, k3);
    }
  }
  __device__ void start() {
    for (int n = 0; n < NS - 1; ++n) {
      if (n < total) issue(n);
      cp_async_commit();
    }
  }
  __device__ const T* acquire() {
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (q + NS - 1 < total) issue(q + NS - 1);
    cp_async_commit();
    const T* s = reinterpret_cast<const T*>(base + (q % NS) * STAGE);
    ++q;
    return s;
  }
};

// ---- mma fragments. A: row-major [rows][lda] activations; B from a forward
// chunk [n][pitch] (K contiguous) or a backward chunk [k][pitch] (N
// contiguous). Lane (g, t4) = (lane / 4, lane % 4).
__device__ __forceinline__ uint32_t u32_at(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t tf32_at(const float* p) {
  return __float_as_uint(hopper::to_tf32(*p));
}

__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* A, int lda, int m0, int k,
                                       int g, int t4) {
  const bf16* p = A + (size_t)(m0 + g) * lda + k + 2 * t4;
  a[0] = u32_at(p);
  a[1] = u32_at(p + 8 * lda);
  a[2] = u32_at(p + 8);
  a[3] = u32_at(p + 8 * lda + 8);
}
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const float* A, int lda, int m0, int k,
                                       int g, int t4) {
  const float* p = A + (size_t)(m0 + g) * lda + k + t4;
  a[0] = tf32_at(p);
  a[1] = tf32_at(p + 8 * lda);
  a[2] = tf32_at(p + 4);
  a[3] = tf32_at(p + 8 * lda + 4);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1, bf16) {
  hopper::mma_m16n8k16_bf16(d, a, b0, b1);
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1, float) {
  hopper::mma_m16n8k8_tf32(d, a, b0, b1);
}

// acc (this warp's tile: rows m0.., columns n0.. of the piece) = A[:, 0:K]
// times the piece's K x 32 weights, read chunk by chunk from the ring.
// KN: the chunks are [k][n] (backward), else [n][k]. With 16-row tiles
// (float32) the 4 tiles of a piece take warps 0-3 and 4-7 each half of every
// chunk's K; the halves are added through `red` (2 KB) in fixed order, and
// the sum is valid in warps 0-3 (with 32-row tiles, in every warp).
template <class T, bool KN, class RingT>
__device__ __forceinline__ void piece(RingT& ring, const T* A, int lda, int K, int kch, int m0,
                                      int n0, float* red, float (&acc)[4]) {
  constexpr int KS = Cfg<T>::KS;
  constexpr bool KSPLIT = Cfg<T>::R == 16;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3, warp = threadIdx.x >> 5;
  const int kh = KSPLIT ? kch / 2 : kch, kbeg = KSPLIT ? (warp >> 2) * kh : 0;
  float acc1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kch) {
    const T* W = ring.acquire();
    if constexpr (!KN) {
      const int pitch = kch + Cfg<T>::PAD;
#pragma unroll 4
      for (int kk = kbeg; kk < kbeg + kh; kk += 2 * KS) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = kk + h * KS;
          uint32_t a[4], b0, b1;
          load_a(a, A, lda, m0, k0 + k, g, t4);
          if constexpr (sizeof(T) == 2) {
            const bf16* p = reinterpret_cast<const bf16*>(W) + (size_t)(n0 + g) * pitch + k + 2 * t4;
            b0 = u32_at(p);
            b1 = u32_at(p + 8);
          } else {
            const float* p = reinterpret_cast<const float*>(W) + (size_t)(n0 + g) * pitch + k + t4;
            b0 = tf32_at(p);
            b1 = tf32_at(p + 4);
          }
          if (h == 0) mma(acc, a, b0, b1, T());
          else mma(acc1, a, b0, b1, T());
        }
      }
    } else {
      constexpr int pitch = HD + PADB;
#pragma unroll 4
      for (int kk = kbeg; kk < kbeg + kh; kk += 2 * KS) {
        uint32_t b[4];
        if constexpr (sizeof(T) == 2) {
          // rows kk + lane, columns n0..n0+7: the B fragments of two k-steps
          hopper::ldmatrix_x4<true>(
              b, hopper::smem_u32(reinterpret_cast<const bf16*>(W) + (size_t)(kk + lane) * pitch + n0));
        } else {
          const float* p = reinterpret_cast<const float*>(W) + (size_t)(kk + t4) * pitch + n0 + g;
          b[0] = tf32_at(p);
          b[1] = tf32_at(p + 4 * pitch);
          b[2] = tf32_at(p + 8 * pitch);
          b[3] = tf32_at(p + 12 * pitch);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t a[4];
          load_a(a, A, lda, m0, k0 + kk + h * KS, g, t4);
          if (h == 0) mma(acc, a, b[0], b[1], T());
          else mma(acc1, a, b[2], b[3], T());
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += acc1[i];
  if constexpr (KSPLIT) {
    // the second K halves' sums go to warps 0-3 (red is free: the previous
    // piece's reads were before the barrier of this piece's first acquire)
    if (warp >= 4) *reinterpret_cast<float4*>(red + ((warp - 4) * 32 + lane) * 4) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    __syncthreads();
    if (warp < 4) {
      const float4 o = *reinterpret_cast<const float4*>(red + (warp * 32 + lane) * 4);
      acc[0] += o.x;
      acc[1] += o.y;
      acc[2] += o.z;
      acc[3] += o.w;
    }
  }
}

// Copy rows [0, R) x columns [c0, c0 + nc) of a shared buffer (row pitch ld)
// into the same place of every other block of the cluster, 16 bytes a store.
template <class E>
__device__ __forceinline__ void push(cg::cluster_group& cl, int C, E* buf, int ld, int c0,
                                     int nc, int R) {
  constexpr int V = 16 / sizeof(E);
  const int per = nc / V, n = R * per;
  const unsigned me = cl.block_rank();
  for (int e = threadIdx.x; e < n * (C - 1); e += NTHREADS) {
    const int k = e / n, i = e - k * n;
    const int r = i / per, j = i - r * per;
    E* src = buf + (size_t)r * ld + c0 + j * V;
    E* dst = cl.map_shared_rank(src, (me + 1 + k) % (unsigned)C);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  }
}

// the sums of N values across the warp, the N shuffle chains interleaved
template <int N>
__device__ __forceinline__ void warp_sums(float (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] += __shfl_xor_sync(FULL_MASK, v[k], o);
}

// Row passes hold a warp's rows in registers: x[k][j] is row warp + k *
// NWARPS, column lane + 32 j (so j == c is this block's own column
// c * 32 + lane). LayerNorm of such rows into xn (T), with the f32 scale and
// bias ln [2][D].
template <class T, int D, int RPW>
__device__ __forceinline__ void ln_regs(const float (&x)[RPW][D / 32], const float* ln, T* xn,
                                        int ldn, int warp, int lane) {
  constexpr int NJ = D / 32;
  float mu[RPW], var[RPW];
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) s += x[k][j];
    mu[k] = s;
  }
  warp_sums(mu);
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    mu[k] /= D;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float d = x[k][j] - mu[k];
      v += d * d;
    }
    var[k] = v;
  }
  warp_sums(var);
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const float rstd = rsqrtf(var[k] / D + LN_EPS);
    const int r = warp + k * NWARPS;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = lane + 32 * j;
      xn[(size_t)r * ldn + col] = from_f<T>((x[k][j] - mu[k]) * rstd * ln[col] + ln[D + col]);
    }
  }
}

// sums over the rows r < nrows of val(r, i) for each column i < ncols, into
// out(i, sum): the rows in NTHREADS / ncols groups, each summed in row order
// by one thread, then the groups added in order through `scratch` (NTHREADS
// floats). Every thread of the block calls it.
template <class Val, class Out>
__device__ __forceinline__ void column_sums(int ncols, int nrows, float* scratch, Val val,
                                            Out out) {
  if (ncols >= NTHREADS) {
    for (int i = threadIdx.x; i < ncols; i += NTHREADS) {
      float s = 0.f;
      for (int r = 0; r < nrows; ++r) s += val(r, i);
      out(i, s);
    }
    return;
  }
  const int ng = NTHREADS / ncols, per = (nrows + ng - 1) / ng;
  const int i = threadIdx.x % ncols, grp = threadIdx.x / ncols;
  if (grp < ng) {
    float s = 0.f;
    for (int r = grp * per; r < min(nrows, grp * per + per); ++r) s += val(r, i);
    scratch[grp * ncols + i] = s;
  }
  __syncthreads();
  if (threadIdx.x < ncols) {
    float s = 0.f;
    for (int k = 0; k < ng; ++k) s += scratch[k * ncols + threadIdx.x];
    out(threadIdx.x, s);
  }
  __syncthreads();
}

template <class T>
struct FwdArgs {
  Weights<T> w;  // wqkv, wo, w1, w2
  const T *x, *bias, *ln1, *bqkv, *bo, *ln2, *b1, *b2;
  const float* mask;
  T *out, *xs, *qkv_s, *p_s, *ctx_s, *h_s;
  float* x1_s;
  int L, B, S, F, causal, seed, rows_pad;
  unsigned thr;
  float kp, scale;
};

template <class T, int D>
__global__ void __launch_bounds__(NTHREADS, 1) stack_fwd_kernel(const FwdArgs<T> p) {
  using C = Cfg<T>;
  constexpr int R = C::R, PAD = C::PAD, H = D / HD, NJ = D / 32, RPW = R / NWARPS;
  constexpr int ldn = D + PAD, ldq = 3 * HD + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.block_rank();
  const int F = p.F, S = p.S, fc = F / H;
  const FwdLayout lay(R, D, F, sizeof(T), PAD);
  float* xres = reinterpret_cast<float*>(smem + lay.xres);
  float* Z = reinterpret_cast<float*>(smem + lay.z);
  T* X = reinterpret_cast<T*>(smem + lay.x);
  T* xn = reinterpret_cast<T*>(smem + lay.xn);
  T* qkv = reinterpret_cast<T*>(smem + lay.qkv);
  float* vec = reinterpret_cast<float*>(smem + lay.vec);
  const int ldx = (D > F ? D : F) + PAD;
  const int nseq = R / S, seq0 = (blockIdx.x / H) * nseq;
  const int nvalid = min(nseq, p.B - seq0), nrows = nvalid * S;
  const size_t row0 = (size_t)seq0 * S, rows = (size_t)p.B * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int m0 = R == 16 ? 0 : (warp >> 2) * 16, n0 = (warp & 3) * 8;
  const bool active = warp < R / 4;  // the warps holding a piece's sums
  float* red = reinterpret_cast<float*>(smem + lay.red);
  const bool drop = p.thr != 0u;
  const int kd = chunk_k(D, C::KC), kf = chunk_k(F, C::KC);
  const int vb = 4 * D, nvec = fwd_vec(D, fc);

  Ring<T, D, false> ring(smem + lay.ring, p.w, p.L, c, F);
  ring.start();
  // a layer's vectors (LN1, LN2, then this block's bias columns), loaded
  // into registers (VEC_PER_THREAD a thread) well before they are stored
  float pv[VEC_PER_THREAD];
  auto vec_get = [&](int l) {
#pragma unroll
    for (int m = 0; m < VEC_PER_THREAD; ++m) {
      const int i = m * NTHREADS + threadIdx.x;
      pv[m] = 0.f;
      if (i < nvec) {
        const T* src;
        if (i < 2 * D) src = p.ln1 + (size_t)l * 2 * D + i;
        else if (i < vb) src = p.ln2 + (size_t)l * 2 * D + i - 2 * D;
        else if (i < vb + 3 * HD)
          src = p.bqkv + (size_t)l * 3 * D + ((i - vb) / HD) * D + c * HD + (i - vb) % HD;
        else if (i < vb + 4 * HD) src = p.bo + (size_t)l * D + c * HD + i - vb - 3 * HD;
        else if (i < vb + 4 * HD + fc) src = p.b1 + (size_t)l * F + c * fc + i - vb - 4 * HD;
        else src = p.b2 + (size_t)l * D + c * HD + i - vb - 4 * HD - fc;
        pv[m] = to_f(*src);
      }
    }
  };
  auto vec_put = [&]() {
#pragma unroll
    for (int m = 0; m < VEC_PER_THREAD; ++m) {
      const int i = m * NTHREADS + threadIdx.x;
      if (i < nvec) vec[i] = pv[m];
    }
  };
  vec_get(0);
  vec_put();
  // the tile's input rows into the residual stream, and LN1 of layer 0
  {
    float x[RPW][NJ];
#pragma unroll
    for (int k = 0; k < RPW; ++k)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int r = warp + k * NWARPS;
        x[k][j] = r < nrows ? to_f(p.x[(row0 + r) * D + lane + 32 * j]) : 0.f;
      }
#pragma unroll
    for (int k = 0; k < RPW; ++k)
#pragma unroll
      for (int j = 0; j < NJ; ++j) xres[(warp + k * NWARPS) * D + lane + 32 * j] = x[k][j];
    __syncthreads();
    ln_regs<T, D, RPW>(x, vec, xn, ldn, warp, lane);
  }
  cl.sync();  // every block of the cluster is running before any push

  for (int l = 0; l < p.L; ++l) {
    const int seed = stack_layer_seed(p.seed, l);
    // QKV of head c: q, k, v pieces
    for (int j = 0; j < 3; ++j) {
      float acc[4];
      piece<T, false>(ring, xn, ldn, D, kd, m0, n0, red, acc);
      if (active) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + g + 8 * h, n = n0 + 2 * t4, col = j * D + c * HD + n;
          const float v0 = acc[2 * h] + vec[vb + j * HD + n];
          const float v1 = acc[2 * h + 1] + vec[vb + j * HD + n + 1];
          store2(qkv + (size_t)r * ldq + j * HD + n, v0, v1);
          if (r < nrows) store2(p.qkv_s + ((size_t)l * rows + row0 + r) * 3 * D + col, v0, v1);
        }
      }
    }
    __syncthreads();

    const bool next = l + 1 < p.L;
    if (next) vec_get(l + 1);

    // attention of head c; the context into X's columns c*32.., zero on
    // unused rows. S <= 8: a warp a (sequence, 4 queries), lane 8 q + j for
    // query q, key j, each lane of a query 4 context columns. Else a warp a
    // (sequence, every groups-th query), lane j = key j.
    {
      const unsigned key = site_key(seed, SITE_ATTN_PROB);
      const int groups = S <= 8 ? 0 : nvalid >= NWARPS ? 1 : NWARPS / nvalid;
      T* ps = p.p_s + (size_t)l * p.B * H * S * S;
      const int slot = lane >> 3, kj = lane & 7, passes = (S + 3) / 4;
      for (int item = warp; S <= 8 && item < nvalid * passes; item += NWARPS) {
        const int sq = item / passes, i = (item - sq * passes) * 4 + slot;
        const T* base = qkv + (size_t)sq * S * ldq;
        const bool has_key = kj < S, has_q = i < S;
        const T* qr = base + (size_t)(has_q ? i : 0) * ldq;
        const T* kr = base + (size_t)(has_key ? kj : 0) * ldq + HD;
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < HD; d += 2) {
          const float2 q2 = load2(qr + d), k2 = load2(kr + d);
          s = fmaf(q2.x, k2.x, s);
          s = fmaf(q2.y, k2.y, s);
        }
        s = s * p.scale + (has_key ? p.mask[(size_t)(seq0 + sq) * S + kj] : -INFINITY);
        if (!has_key || (p.causal && kj > i)) s = -INFINITY;
        float m = s;
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, o));
        const float e = m != -INFINITY ? expf(s - m) : 0.f;
        float sum = e;
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL_MASK, sum, o);
        float pr = m != -INFINITY ? e / sum : 0.f;
        const size_t prow = ((size_t)(seq0 + sq) * H + c) * S + i;
        if (has_key && has_q) ps[prow * S + kj] = from_f<T>(pr);
        if (drop) pr = keep_elem(key, (unsigned)prow, (unsigned)kj, p.thr) ? pr * p.kp : 0.f;
        pr = round_to<T>(pr);
        float cv[4] = {0.f, 0.f, 0.f, 0.f};
        for (int j = 0; j < S; ++j) {
          const float pj = __shfl_sync(FULL_MASK, pr, slot * 8 + j);
          const T* vr = base + (size_t)j * ldq + 2 * HD + 4 * kj;
          const float2 va = load2(vr), vb = load2(vr + 2);
          cv[0] = fmaf(pj, va.x, cv[0]);
          cv[1] = fmaf(pj, va.y, cv[1]);
          cv[2] = fmaf(pj, vb.x, cv[2]);
          cv[3] = fmaf(pj, vb.y, cv[3]);
        }
        if (has_q) {
          T* xr = X + (size_t)(sq * S + i) * ldx + c * HD + 4 * kj;
          store2(xr, cv[0], cv[1]);
          store2(xr + 2, cv[2], cv[3]);
        }
      }
      for (int item = warp; item < nvalid * groups; item += NWARPS) {
        const int sq = item / groups, part = item - sq * groups;
        const T* base = qkv + (size_t)sq * S * ldq;
        const bool has_key = lane < S;
        const T* kr = base + (size_t)(has_key ? lane : 0) * ldq + HD;
        float kf32[HD];
#pragma unroll
        for (int d = 0; d < HD; ++d) kf32[d] = has_key ? to_f(kr[d]) : 0.f;
        const float mval = has_key ? p.mask[(size_t)(seq0 + sq) * S + lane] : -INFINITY;
        const T* vcol = base + 2 * HD + lane;
        const size_t prow0 = ((size_t)(seq0 + sq) * H + c) * S;
        for (int i = part; i < S; i += groups) {
          const T* qr = base + (size_t)i * ldq;
          float s = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) s = fmaf(to_f(qr[d]), kf32[d], s);
          s = s * p.scale + mval;
          if (!has_key || (p.causal && lane > i)) s = -INFINITY;
          const float m = warp_max(s);
          float pr = 0.f;
          if (m != -INFINITY) {
            const float e = expf(s - m);
            pr = e / warp_sum(e);
          }
          if (has_key) ps[(prow0 + i) * S + lane] = from_f<T>(pr);
          if (drop) pr = keep_elem(key, (unsigned)(prow0 + i), (unsigned)lane, p.thr) ? pr * p.kp : 0.f;
          pr = round_to<T>(pr);
          float cv = 0.f;
          for (int j = 0; j < S; ++j)
            cv = fmaf(__shfl_sync(FULL_MASK, pr, j), to_f(vcol[(size_t)j * ldq]), cv);
          X[(size_t)(sq * S + i) * ldx + c * HD + lane] = from_f<T>(cv);
        }
      }
      for (int r = nrows + warp; r < R; r += NWARPS) X[(size_t)r * ldx + c * HD + lane] = from_f<T>(0.f);
    }
    __syncthreads();
    for (int r = warp; r < nrows; r += NWARPS)
      p.ctx_s[((size_t)l * p.rows_pad + row0 + r) * D + c * HD + lane] = X[(size_t)r * ldx + c * HD + lane];
    push<T>(cl, H, X, ldx, c * HD, HD, R);
    cl.sync();

    // out projection, columns c*32..: the attention output into Z
    {
      const unsigned key = site_key(seed, SITE_ATTN_OUT);
      float acc[4];
      piece<T, false>(ring, X, ldx, D, kd, m0, n0, red, acc);
      if (active) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + g + 8 * h, col = c * HD + n0 + 2 * t4;
          const float* b = vec + vb + 3 * HD + n0 + 2 * t4;
          float a0 = acc[2 * h] + b[0], a1 = acc[2 * h + 1] + b[1];
          if (drop) {
            const unsigned rh = row_hash(key, (unsigned)(row0 + r));
            a0 = keep_col(rh, col, p.thr) ? a0 * p.kp : 0.f;
            a1 = keep_col(rh, col + 1, p.thr) ? a1 * p.kp : 0.f;
          }
          *reinterpret_cast<float2*>(Z + (size_t)r * D + col) = make_float2(a0, a1);
        }
      }
    }
    __syncthreads();
    push<float>(cl, H, Z, D, c * HD, HD, R);
    cl.sync();

    // x1
    {
      const T* bias = p.bias + ((size_t)l * p.B + seq0) * D;
      float x[RPW][NJ], bv[RPW][NJ];
#pragma unroll
      for (int k = 0; k < RPW; ++k) {
        const int r = warp + k * NWARPS, sq = r / S;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          bv[k][j] = r < nrows ? to_f(bias[(size_t)sq * D + lane + 32 * j]) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < RPW; ++k) {
        const int r = warp + k * NWARPS;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int e = r * D + lane + 32 * j;
          float v = xres[e] + Z[e];
          if (r < nrows) {
            v += bv[k][j];
            if (j == c) p.x1_s[((size_t)l * rows + row0 + r) * D + lane + 32 * j] = v;
          }
          xres[e] = v;
          x[k][j] = v;
        }
      }
      ln_regs<T, D, RPW>(x, vec + 2 * D, xn, ldn, warp, lane);
    }

    // FF1 + ReLU, columns c*F/H.. in 32-column pieces, into X
    {
      const unsigned key = site_key(seed, SITE_FF_HIDDEN);
      for (int j = 0; j < fc / HD; ++j) {
        float acc[4];
        piece<T, false>(ring, xn, ldn, D, kd, m0, n0, red, acc);
        if (active) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = m0 + g + 8 * h, col = c * fc + j * HD + n0 + 2 * t4;
            const float* b = vec + vb + 4 * HD + j * HD + n0 + 2 * t4;
            float h0 = fmaxf(acc[2 * h] + b[0], 0.f), h1 = fmaxf(acc[2 * h + 1] + b[1], 0.f);
            if (r < nrows) store2(p.h_s + ((size_t)l * rows + row0 + r) * F + col, h0, h1);
            if (drop) {
              const unsigned rh = row_hash(key, (unsigned)(row0 + r));
              h0 = keep_col(rh, col, p.thr) ? h0 * p.kp : 0.f;
              h1 = keep_col(rh, col + 1, p.thr) ? h1 * p.kp : 0.f;
            }
            store2(X + (size_t)r * ldx + col, h0, h1);
          }
        }
      }
    }
    __syncthreads();
    push<T>(cl, H, X, ldx, c * fc, fc, R);
    cl.sync();

    // FF2
    {
      const unsigned key = site_key(seed, SITE_FF_OUT);
      float acc[4];
      piece<T, false>(ring, X, ldx, F, kf, m0, n0, red, acc);
      if (active) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + g + 8 * h, col = c * HD + n0 + 2 * t4;
          const float* b = vec + vb + 4 * HD + fc + n0 + 2 * t4;
          float f0 = acc[2 * h] + b[0], f1 = acc[2 * h + 1] + b[1];
          if (drop) {
            const unsigned rh = row_hash(key, (unsigned)(row0 + r));
            f0 = keep_col(rh, col, p.thr) ? f0 * p.kp : 0.f;
            f1 = keep_col(rh, col + 1, p.thr) ? f1 * p.kp : 0.f;
          }
          *reinterpret_cast<float2*>(Z + (size_t)r * D + col) = make_float2(f0, f1);
        }
      }
    }
    __syncthreads();
    push<float>(cl, H, Z, D, c * HD, HD, R);
    cl.sync();

    // the layer's output
    // block's columns to xs (or out); LN1 of the next layer
    if (next) vec_put();
    __syncthreads();
    {
      T* dst = l == p.L - 1 ? p.out : p.xs + (size_t)l * rows * D;
      float x[RPW][NJ];
#pragma unroll
      for (int k = 0; k < RPW; ++k) {
        const int r = warp + k * NWARPS;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int e = r * D + lane + 32 * j;
          const float v = round_to<T>(xres[e] + Z[e]);
          xres[e] = v;
          x[k][j] = v;
          if (j == c && r < nrows) dst[(row0 + r) * D + lane + 32 * j] = from_f<T>(v);
        }
      }
      if (next) ln_regs<T, D, RPW>(x, vec, xn, ldn, warp, lane);
    }
  }
}

template <class T>
struct BwdArgs {
  Weights<T> w;
  const T *x, *xs, *g, *ln1, *ln2, *qkv_s, *p_s, *h_s;
  const float* x1_s;
  T *dx, *xn1_o, *dqkv_o, *da_o, *xn2_o, *dhpre_o, *hd_o, *df_o;
  float *dbias, *small_part;
  int L, B, S, F, seed, rows_pad;
  unsigned thr;
  float kp, scale;
};

// offsets into a layer's column sums: dln1 (scale, bias), dbqkv, dbo, dln2
// (scale, bias), db1, db2 (layer_bwd.cuh's SmallOff)
struct Small {
  int dln1_s, dln1_b, dbqkv, dbo, dln2_s, dln2_b, db1, db2, total;
  __device__ Small(int D, int F)
      : dln1_s(0), dln1_b(D), dbqkv(2 * D), dbo(5 * D), dln2_s(6 * D), dln2_b(7 * D),
        db1(8 * D), db2(8 * D + F), total(9 * D + F) {}
};

// LayerNorm backward on a warp's rows from the layer's saved input rows
// `xin` (T or f32; loaded together first) and dy = Z: Y + rstd (dxh -
// mean(dxh) - xh mean(dxh xh)) handed to post(k, j, r, value, xh, dy) for
// the valid rows, and post(k, j, r, 0, 0, 0) on the unused ones.
template <class T, int D, int RPW, class In, class Post>
__device__ __forceinline__ void ln_bwd_regs(const In* xin, const T* ln, const float* Z,
                                            const float* Y, int nrows, int warp, int lane,
                                            Post post) {
  constexpr int NJ = D / 32;
  float x[RPW][NJ], dxh[RPW][NJ], mu[RPW], var[RPW], s1[RPW], s2[RPW];
#pragma unroll
  for (int k = 0; k < RPW; ++k)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int r = warp + k * NWARPS;
      x[k][j] = r < nrows ? to_f(xin[(size_t)r * D + lane + 32 * j]) : 0.f;
    }
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) s += x[k][j];
    mu[k] = s;
  }
  warp_sums(mu);
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    mu[k] /= D;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float d = x[k][j] - mu[k];
      v += d * d;
    }
    var[k] = v;
  }
  warp_sums(var);
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int r = warp + k * NWARPS;
    const float rstd = rsqrtf(var[k] / D + LN_EPS);
    var[k] = rstd;
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = lane + 32 * j;
      const float xh = (x[k][j] - mu[k]) * rstd;
      x[k][j] = xh;
      dxh[k][j] = Z[(size_t)r * D + col] * to_f(ln[col]);
      a += dxh[k][j];
      b += dxh[k][j] * xh;
    }
    s1[k] = a;
    s2[k] = b;
  }
  warp_sums(s1);
  warp_sums(s2);
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int r = warp + k * NWARPS;
    const float m1 = s1[k] / D, m2 = s2[k] / D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = lane + 32 * j;
      if (r < nrows)
        post(k, j, r, Y[(size_t)r * D + col] + var[k] * (dxh[k][j] - m1 - x[k][j] * m2), x[k][j],
             Z[(size_t)r * D + col]);
      else
        post(k, j, r, 0.f, 0.f, 0.f);
    }
  }
}

template <class T, int D>
__global__ void __launch_bounds__(NTHREADS, 1) stack_bwd_kernel(const BwdArgs<T> p) {
  using C = Cfg<T>;
  constexpr int R = C::R, PAD = C::PAD, H = D / HD, NJ = D / 32, RPW = R / NWARPS;
  constexpr int ldn = D + PAD, ldq = 3 * HD + PAD, ldc = HD + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int c = (int)cl.block_rank();
  const int F = p.F, S = p.S, fc = F / H;
  const BwdLayout lay(R, D, F, sizeof(T), PAD);
  float* Y = reinterpret_cast<float*>(smem + lay.y);
  float* Z = reinterpret_cast<float*>(smem + lay.z);
  T* X = reinterpret_cast<T*>(smem + lay.x);
  T* A = reinterpret_cast<T*>(smem + lay.a);
  T* qkv = reinterpret_cast<T*>(smem + lay.qkv);
  T* pr_s = reinterpret_cast<T*>(smem + lay.pr);
  T* dctx = reinterpret_cast<T*>(smem + lay.dctx);
  float* cs = reinterpret_cast<float*>(smem + lay.cs);  // [NWARPS][4][32] partial sums
  T* vec = reinterpret_cast<T*>(smem + lay.vec);
  const int ldx = (3 * D > F ? 3 * D : F) + PAD;
  const int tile = blockIdx.x / H, nseq = R / S, seq0 = tile * nseq;
  const int nvalid = min(nseq, p.B - seq0), nrows = nvalid * S;
  const size_t row0 = (size_t)seq0 * S, rows = (size_t)p.B * S, rp = p.rows_pad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int m0 = R == 16 ? 0 : (warp >> 2) * 16, n0 = (warp & 3) * 8;
  const bool active = warp < R / 4;  // the warps holding a piece's sums
  float* red = reinterpret_cast<float*>(smem + lay.red);
  const bool drop = p.thr != 0u;
  const int kd = chunk_k(D, C::KC), kf = chunk_k(F, C::KC), k3 = chunk_k(3 * D, C::KC);
  const Small off(D, F);
  const int oc = c * HD + lane;  // this lane's own column in the row passes

  Ring<T, D, true> ring(smem + lay.ring, p.w, p.L, c, F);
  ring.start();
  {
    float y[RPW][NJ];
#pragma unroll
    for (int k = 0; k < RPW; ++k)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int r = warp + k * NWARPS;
        y[k][j] = r < nrows ? to_f(p.g[(row0 + r) * D + lane + 32 * j]) : 0.f;
      }
#pragma unroll
    for (int k = 0; k < RPW; ++k)
#pragma unroll
      for (int j = 0; j < NJ; ++j) Y[(warp + k * NWARPS) * D + lane + 32 * j] = y[k][j];
  }
  cl.sync();

  for (int l = p.L - 1; l >= 0; --l) {
    const int seed = stack_layer_seed(p.seed, l);
    const unsigned key_ao = site_key(seed, SITE_ATTN_OUT), key_fh = site_key(seed, SITE_FF_HIDDEN),
                   key_fo = site_key(seed, SITE_FF_OUT), key_ap = site_key(seed, SITE_ATTN_PROB);
    float* small = p.small_part + ((size_t)tile * p.L + l) * off.total;
    const T* h_s = p.h_s + (size_t)l * rows * F;
    const T* ln1 = vec;
    const T* ln2 = vec + 2 * D;
    // this layer's LN1 and LN2, head c's QKV (the unused rows zero) and
    // probabilities, all of a thread's loads issued before its stores (16
    // bytes a load but the probabilities)
    {
      constexpr int V = 16 / sizeof(T), NL = 4 * D / V, PR = 3 * HD / V, NVEC = NL + R * PR;
      constexpr int NV = (NVEC + NTHREADS - 1) / NTHREADS, NP = (R * R + NTHREADS - 1) / NTHREADS;
      const T* qs = p.qkv_s + ((size_t)l * rows + row0) * 3 * D + c * HD;
      const T* ps = p.p_s + (((size_t)l * p.B + seq0) * H + c) * S * S;
      const int np = nvalid * S * S;
      uint4 v[NV];
      T pv[NP];
#pragma unroll
      for (int m = 0; m < NV; ++m) {
        const int i = m * NTHREADS + threadIdx.x, u = i - NL;
        v[m] = make_uint4(0u, 0u, 0u, 0u);
        if (i < NL / 2) v[m] = *reinterpret_cast<const uint4*>(p.ln1 + (size_t)l * 2 * D + i * V);
        else if (i < NL) v[m] = *reinterpret_cast<const uint4*>(p.ln2 + (size_t)l * 2 * D + (i - NL / 2) * V);
        else if (i < NVEC && u / PR < nrows)
          v[m] = *reinterpret_cast<const uint4*>(qs + (size_t)(u / PR) * 3 * D + (u % PR) / (HD / V) * D +
                                                  (u % (HD / V)) * V);
      }
#pragma unroll
      for (int m = 0; m < NP; ++m) {
        const int i = m * NTHREADS + threadIdx.x;
        pv[m] = i < np ? ps[(size_t)(i / (S * S)) * H * S * S + i % (S * S)] : from_f<T>(0.f);
      }
#pragma unroll
      for (int m = 0; m < NV; ++m) {
        const int i = m * NTHREADS + threadIdx.x, u = i - NL;
        if (i < NL) *reinterpret_cast<uint4*>(vec + i * V) = v[m];
        else if (i < NVEC)
          *reinterpret_cast<uint4*>(qkv + (size_t)(u / PR) * ldq + (u % PR) * V) = v[m];
      }
#pragma unroll
      for (int m = 0; m < NP; ++m) {
        const int i = m * NTHREADS + threadIdx.x;
        if (i < np) pr_s[i] = pv[m];
      }
    }
    // the dropped FF hidden of this block's columns, for the dW2 product
#pragma unroll
    for (int k = 0; k < RPW; ++k) {
      const int r = warp + k * NWARPS;
      if (r >= nrows) continue;
      const unsigned rh = row_hash(key_fh, (unsigned)(row0 + r));
#pragma unroll 4
      for (int m = lane; m < fc; m += 32) {
        const int col = c * fc + m;
        float h = to_f(h_s[(row0 + r) * F + col]);
        if (drop) h = keep_col(rh, col, p.thr) ? h * p.kp : 0.f;
        p.hd_o[((size_t)l * rp + row0 + r) * F + col] = from_f<T>(h);
      }
    }
    // df = g * mask on whole rows, into A; this block's columns of df, and
    // their sums (db2)
    {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < RPW; ++k) {
        const int r = warp + k * NWARPS;
        const unsigned rh = row_hash(key_fo, (unsigned)(row0 + r));
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = lane + 32 * j;
          float v = Y[r * D + col];
          if (drop) v = keep_col(rh, col, p.thr) ? v * p.kp : 0.f;
          A[(size_t)r * ldn + col] = from_f<T>(v);
          if (j == c && r < nrows) {
            p.df_o[((size_t)l * rp + row0 + r) * D + col] = from_f<T>(v);
            s += v;
          }
        }
      }
      cs[warp * 128 + lane] = s;
    }
    __syncthreads();
    if (threadIdx.x < HD) {
      float s = 0.f;
      for (int w = 0; w < NWARPS; ++w) s += cs[w * 128 + threadIdx.x];
      small[off.db2 + c * HD + threadIdx.x] = s;
    }

    // dhpre, columns c*F/H..: (df @ W2) * relu'(h) * mask, into X
    for (int j = 0; j < fc / HD; ++j) {
      float acc[4];
      piece<T, true>(ring, A, ldn, D, kd, m0, n0, red, acc);
      if (active) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + g + 8 * h, col = c * fc + j * HD + n0 + 2 * t4;
          float d0 = 0.f, d1 = 0.f;
          if (r < nrows) {
            const float2 hv = load2(h_s + (row0 + r) * F + col);
            d0 = hv.x > 0.f ? acc[2 * h] : 0.f;
            d1 = hv.y > 0.f ? acc[2 * h + 1] : 0.f;
            if (drop) {
              const unsigned rh = row_hash(key_fh, (unsigned)(row0 + r));
              d0 = keep_col(rh, col, p.thr) ? d0 * p.kp : 0.f;
              d1 = keep_col(rh, col + 1, p.thr) ? d1 * p.kp : 0.f;
            }
            store2(p.dhpre_o + ((size_t)l * rp + row0 + r) * F + col, d0, d1);
          }
          store2(X + (size_t)r * ldx + col, d0, d1);
        }
      }
    }
    __syncthreads();
    push<T>(cl, H, X, ldx, c * fc, fc, R);
    cl.sync();
    column_sums(fc, nrows, cs, [&](int r, int i) { return to_f(X[(size_t)r * ldx + c * fc + i]); },
                [&](int i, float s) { small[off.db1 + c * fc + i] = s; });

    // dxn2, columns c*32..: dhpre @ W1, into Z
    {
      float acc[4];
      piece<T, true>(ring, X, ldx, F, kf, m0, n0, red, acc);
      if (active) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + g + 8 * h, col = c * HD + n0 + 2 * t4;
          *reinterpret_cast<float2*>(Z + (size_t)r * D + col) = make_float2(acc[2 * h], acc[2 * h + 1]);
        }
      }
    }
    __syncthreads();
    push<float>(cl, H, Z, D, c * HD, HD, R);
    cl.sync();

    // LN2 backward
    // of LN2(x1) and da for the weight products, and their sums (dln2, dbo)
    {
      float sums[3] = {0.f, 0.f, 0.f};
      unsigned rh[RPW];
#pragma unroll
      for (int k = 0; k < RPW; ++k) rh[k] = row_hash(key_ao, (unsigned)(row0 + warp + k * NWARPS));
      const float sc = to_f(ln2[oc]), sb = to_f(ln2[D + oc]);
      ln_bwd_regs<T, D, RPW>(
          p.x1_s + ((size_t)l * rows + row0) * D, ln2, Z, Y, nrows, warp, lane,
          [&](int k, int j, int r, float dx1, float xh, float dy) {
            const int col = lane + 32 * j;
            Y[(size_t)r * D + col] = dx1;
            float da = dx1;
            if (drop && r < nrows) da = keep_col(rh[k], col, p.thr) ? da * p.kp : 0.f;
            A[(size_t)r * ldn + col] = from_f<T>(da);
            if (j == c && r < nrows) {
              const size_t row = row0 + r;
              sums[0] += dy * xh;
              sums[1] += dy;
              sums[2] += da;
              p.xn2_o[((size_t)l * rp + row) * D + col] = from_f<T>(xh * sc + sb);
              p.da_o[((size_t)l * rp + row) * D + col] = from_f<T>(da);
            }
          });
#pragma unroll
      for (int q = 0; q < 3; ++q) cs[warp * 128 + q * 32 + lane] = sums[q];
    }
    __syncthreads();
    if (threadIdx.x < 3 * HD) {
      const int q = threadIdx.x / HD, t = threadIdx.x % HD;
      float s = 0.f;
      for (int w = 0; w < NWARPS; ++w) s += cs[w * 128 + q * 32 + t];
      small[(q == 0 ? off.dln2_s : q == 1 ? off.dln2_b : off.dbo) + c * HD + t] = s;
    }
    // dseq_bias: dx1 summed over each sequence, this block's columns
    for (int e = threadIdx.x; e < nvalid * HD; e += NTHREADS) {
      const int sq = e / HD, col = c * HD + e % HD;
      float s = 0.f;
      for (int i = 0; i < S; ++i) s += Y[(size_t)(sq * S + i) * D + col];
      p.dbias[((size_t)l * p.B + seq0 + sq) * D + col] = s;
    }

    // dctx of head c: da @ Wo's columns c*32..
    {
      float acc[4];
      piece<T, true>(ring, A, ldn, D, kd, m0, n0, red, acc);
      if (active) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + g + 8 * h, n = n0 + 2 * t4;
          store2(dctx + (size_t)r * ldc + n, acc[2 * h], acc[2 * h + 1]);
        }
      }
    }
    __syncthreads();

    // attention backward of head c: a warp a (sequence, every groups-th
    // query), lane j = key j; dq into X's columns c*32..; each warp's dk and
    // dv sums through Z (free here), added in query-group order into X's
    // columns D + c*32.., 2D + c*32..
    // (S <= 8 and room in Z: a warp a (sequence, 4 queries), lane 8 q + j
    // for query q, key j; each query's dk and dv terms added over the 4
    // queries by shuffles, then through Z over the warps)
    {
      const int cap = R * D / (nvalid * S * 2 * HD);  // partial sums Z holds
      const int slot = lane >> 3, kj = lane & 7, passes = (S + 3) / 4;
      const bool fast = S <= 8 && passes <= cap;
      const int groups = fast ? 0 : max(1, min(nvalid >= NWARPS ? 1 : NWARPS / nvalid, cap));
      const int parts = fast ? passes : groups;
      for (int item = warp; fast && item < nvalid * passes; item += NWARPS) {
        const int sq = item / passes, i = (item - sq * passes) * 4 + slot;
        const T* base = qkv + (size_t)sq * S * ldq;
        const bool has_key = kj < S, has_q = i < S;
        const int ic = has_q ? i : 0, jc = has_key ? kj : 0;
        const T* dc = dctx + (size_t)(sq * S + ic) * ldc;
        const T* vr = base + (size_t)jc * ldq + 2 * HD;
        const T* qr = base + (size_t)ic * ldq;
        const float pr = has_key && has_q ? to_f(pr_s[(sq * S + i) * S + kj]) : 0.f;
        const size_t prow = ((size_t)(seq0 + sq) * H + c) * S + i;
        float km = 1.f;
        if (drop) km = keep_elem(key_ap, (unsigned)prow, (unsigned)kj, p.thr) ? p.kp : 0.f;
        const float pe = round_to<T>(pr * km);
        float dp = 0.f;
#pragma unroll
        for (int d = 0; d < HD; d += 2) {
          const float2 c2 = load2(dc + d), v2 = load2(vr + d);
          dp = fmaf(c2.x, v2.x, dp);
          dp = fmaf(c2.y, v2.y, dp);
        }
        dp *= km;
        float t = dp * pr;
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) t += __shfl_xor_sync(FULL_MASK, t, o);
        const float ds = round_to<T>(pr * (dp - t));
        float q4[4] = {0.f, 0.f, 0.f, 0.f};
        for (int j = 0; j < S; ++j) {
          const float dsj = __shfl_sync(FULL_MASK, ds, slot * 8 + j);
          const T* kr = base + (size_t)j * ldq + HD + 4 * kj;
          const float2 ka = load2(kr), kb = load2(kr + 2);
          q4[0] = fmaf(dsj, ka.x, q4[0]);
          q4[1] = fmaf(dsj, ka.y, q4[1]);
          q4[2] = fmaf(dsj, kb.x, q4[2]);
          q4[3] = fmaf(dsj, kb.y, q4[3]);
        }
        if (has_q) {
          T* xr = X + (size_t)(sq * S + i) * ldx + c * HD + 4 * kj;
          store2(xr, q4[0] * p.scale, q4[1] * p.scale);
          store2(xr + 2, q4[2] * p.scale, q4[3] * p.scale);
        }
        float* pk = Z + ((size_t)item * S + jc) * 2 * HD;
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          float xk = ds * to_f(qr[d]), xv = pe * to_f(dc[d]);
          xk += __shfl_xor_sync(FULL_MASK, xk, 8);
          xv += __shfl_xor_sync(FULL_MASK, xv, 8);
          xk += __shfl_xor_sync(FULL_MASK, xk, 16);
          xv += __shfl_xor_sync(FULL_MASK, xv, 16);
          if (has_key && (d >> 3) == slot) {
            pk[d] = xk;
            pk[HD + d] = xv;
          }
        }
      }
      for (int item = warp; item < nvalid * groups; item += NWARPS) {
        const int sq = item / groups, part = item - sq * groups;
        const T* base = qkv + (size_t)sq * S * ldq;
        const bool has_key = lane < S;
        const int jr = has_key ? lane : 0;
        float vf[HD], dk[HD], dv[HD];
#pragma unroll
        for (int d = 0; d < HD; ++d) {
          vf[d] = has_key ? to_f(base[(size_t)jr * ldq + 2 * HD + d]) : 0.f;
          dk[d] = 0.f;
          dv[d] = 0.f;
        }
        const size_t prow0 = ((size_t)(seq0 + sq) * H + c) * S;
        for (int i = part; i < S; i += groups) {
          const T* dc = dctx + (size_t)(sq * S + i) * ldc;
          const T* qr = base + (size_t)i * ldq;
          const float pr = has_key ? to_f(pr_s[(sq * S + i) * S + lane]) : 0.f;
          float km = 1.f;
          if (drop) km = keep_elem(key_ap, (unsigned)(prow0 + i), (unsigned)lane, p.thr) ? p.kp : 0.f;
          const float pe = round_to<T>(pr * km);
          float dp = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) {
            const float dcd = to_f(dc[d]);
            dp = fmaf(dcd, vf[d], dp);
            dv[d] = fmaf(pe, dcd, dv[d]);
          }
          dp *= km;
          const float ds = round_to<T>(pr * (dp - warp_sum(dp * pr)));
          float dq = 0.f;
          for (int j = 0; j < S; ++j)
            dq = fmaf(__shfl_sync(FULL_MASK, ds, j), to_f(base[(size_t)j * ldq + HD + lane]), dq);
#pragma unroll
          for (int d = 0; d < HD; ++d) dk[d] = fmaf(ds, to_f(qr[d]), dk[d]);
          X[(size_t)(sq * S + i) * ldx + c * HD + lane] = from_f<T>(dq * p.scale);
        }
        if (has_key) {
          float* pk = Z + ((size_t)item * S + lane) * 2 * HD;
#pragma unroll
          for (int d = 0; d < HD; ++d) {
            pk[d] = dk[d];
            pk[HD + d] = dv[d];
          }
        }
      }
      __syncthreads();
      for (int e = threadIdx.x; e < nvalid * S * HD; e += NTHREADS) {
        const int d = e % HD, j = (e / HD) % S, sq = e / (HD * S);
        float sk = 0.f, sv = 0.f;
        for (int part = 0; part < parts; ++part) {
          const float* pk = Z + ((size_t)(sq * parts + part) * S + j) * 2 * HD;
          sk += pk[d];
          sv += pk[HD + d];
        }
        T* xr = X + (size_t)(sq * S + j) * ldx;
        xr[D + c * HD + d] = from_f<T>(sk * p.scale);
        xr[2 * D + c * HD + d] = from_f<T>(sv);
      }
      for (int r = nrows + warp; r < R; r += NWARPS)
#pragma unroll
        for (int part = 0; part < 3; ++part) X[(size_t)r * ldx + part * D + c * HD + lane] = from_f<T>(0.f);
    }
    __syncthreads();
    for (int part = 0; part < 3; ++part) push<T>(cl, H, X, ldx, part * D + c * HD, HD, R);
    cl.sync();
    for (int r = warp; r < nrows; r += NWARPS)
#pragma unroll
      for (int part = 0; part < 3; ++part) {
        const int col = part * D + c * HD + lane;
        p.dqkv_o[((size_t)l * rp + row0 + r) * 3 * D + col] = X[(size_t)r * ldx + col];
      }
    column_sums(3 * HD, nrows, cs,
                [&](int r, int i) { return to_f(X[(size_t)r * ldx + (i / HD) * D + c * HD + i % HD]); },
                [&](int i, float s) { small[off.dbqkv + (i / HD) * D + c * HD + i % HD] = s; });

    // dxn1, columns c*32..: dqkv @ Wqkv, into Z
    {
      float acc[4];
      piece<T, true>(ring, X, ldx, 3 * D, k3, m0, n0, red, acc);
      if (active) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + g + 8 * h, col = c * HD + n0 + 2 * t4;
          *reinterpret_cast<float2*>(Z + (size_t)r * D + col) = make_float2(acc[2 * h], acc[2 * h + 1]);
        }
      }
    }
    __syncthreads();
    push<float>(cl, H, Z, D, c * HD, HD, R);
    cl.sync();

    // LN1 backward
    // block's columns of LN1(x) for the dWqkv product (and dx at layer 0),
    // and their sums (dln1)
    {
      float sums[2] = {0.f, 0.f};
      const float sc = to_f(ln1[oc]), sb = to_f(ln1[D + oc]);
      const T* xin = (l == 0 ? p.x : p.xs + (size_t)(l - 1) * rows * D) + row0 * D;
      ln_bwd_regs<T, D, RPW>(
          xin, ln1, Z, Y, nrows, warp, lane,
          [&](int, int j, int r, float dx, float xh, float dy) {
            const int col = lane + 32 * j;
            const float v = round_to<T>(dx);
            Y[(size_t)r * D + col] = v;
            if (j == c && r < nrows) {
              const size_t row = row0 + r;
              sums[0] += dy * xh;
              sums[1] += dy;
              p.xn1_o[((size_t)l * rp + row) * D + col] = from_f<T>(xh * sc + sb);
              if (l == 0) p.dx[row * D + col] = from_f<T>(v);
            }
          });
#pragma unroll
      for (int q = 0; q < 2; ++q) cs[warp * 128 + q * 32 + lane] = sums[q];
    }
    __syncthreads();
    if (threadIdx.x < 2 * HD) {
      const int q = threadIdx.x / HD, t = threadIdx.x % HD;
      float s = 0.f;
      for (int w = 0; w < NWARPS; ++w) s += cs[w * 128 + q * 32 + t];
      small[(q == 0 ? off.dln1_s : off.dln1_b) + c * HD + t] = s;
    }
    __syncthreads();
  }
}

template <class Args, class Kernel>
int launch(Kernel kernel, const Args& a, int tiles, int H, int smem, int need, void* stream) {
  if (smem != need) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * H);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = H;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class T>
int fwd(void* const* t, int L, int B, int S, int D, int F, int H, int causal, int seed, int thr,
        float kp, float scale, int smem, void* stream) {
  using C = Cfg<T>;
  if (D != H * HD || D % 64 || D > 256 || F % D ||
      fwd_vec(D, F / H) > VEC_PER_THREAD * NTHREADS)
    return (int)cudaErrorInvalidValue;
  FwdArgs<T> a;
  a.x = (const T*)t[0];
  a.bias = (const T*)t[1];
  a.ln1 = (const T*)t[2];
  a.w.wqkv = (const T*)t[3];
  a.bqkv = (const T*)t[4];
  a.w.wo = (const T*)t[5];
  a.bo = (const T*)t[6];
  a.ln2 = (const T*)t[7];
  a.w.w1 = (const T*)t[8];
  a.b1 = (const T*)t[9];
  a.w.w2 = (const T*)t[10];
  a.b2 = (const T*)t[11];
  a.mask = (const float*)t[12];
  a.out = (T*)t[13];
  a.xs = (T*)t[14];
  a.qkv_s = (T*)t[15];
  a.p_s = (T*)t[16];
  a.ctx_s = (T*)t[17];
  a.x1_s = (float*)t[18];
  a.h_s = (T*)t[19];
  a.L = L;
  a.B = B;
  a.S = S;
  a.F = F;
  a.causal = causal;
  a.seed = seed;
  a.rows_pad = (B * S + 15) / 16 * 16;
  a.thr = (unsigned)thr;
  a.kp = kp;
  a.scale = scale;
  const int tiles = (B + C::R / S - 1) / (C::R / S);
  const int need = FwdLayout(C::R, D, F, sizeof(T), C::PAD).total;
  switch (D) {
    case 64: return launch(stack_fwd_kernel<T, 64>, a, tiles, H, smem, need, stream);
    case 128: return launch(stack_fwd_kernel<T, 128>, a, tiles, H, smem, need, stream);
    case 192: return launch(stack_fwd_kernel<T, 192>, a, tiles, H, smem, need, stream);
    default: return launch(stack_fwd_kernel<T, 256>, a, tiles, H, smem, need, stream);
  }
}

template <class T>
int bwd(void* const* t, int L, int B, int S, int D, int F, int H, int seed, int thr, float kp,
        float scale, int smem, void* stream) {
  using C = Cfg<T>;
  if (D != H * HD || D % 64 || D > 256 || F % D) return (int)cudaErrorInvalidValue;
  BwdArgs<T> a;
  a.x = (const T*)t[0];
  a.xs = (const T*)t[1];
  a.g = (const T*)t[2];
  a.ln1 = (const T*)t[3];
  a.w.wqkv = (const T*)t[4];
  a.w.wo = (const T*)t[5];
  a.ln2 = (const T*)t[6];
  a.w.w1 = (const T*)t[7];
  a.w.w2 = (const T*)t[8];
  a.qkv_s = (const T*)t[9];
  a.p_s = (const T*)t[10];
  a.x1_s = (const float*)t[11];
  a.h_s = (const T*)t[12];
  a.dx = (T*)t[13];
  a.dbias = (float*)t[14];
  a.xn1_o = (T*)t[15];
  a.dqkv_o = (T*)t[16];
  a.da_o = (T*)t[17];
  a.xn2_o = (T*)t[18];
  a.dhpre_o = (T*)t[19];
  a.hd_o = (T*)t[20];
  a.df_o = (T*)t[21];
  a.small_part = (float*)t[22];
  a.L = L;
  a.B = B;
  a.S = S;
  a.F = F;
  a.seed = seed;
  a.rows_pad = (B * S + 15) / 16 * 16;
  a.thr = (unsigned)thr;
  a.kp = kp;
  a.scale = scale;
  const int tiles = (B + C::R / S - 1) / (C::R / S);
  const int need = BwdLayout(C::R, D, F, sizeof(T), C::PAD).total;
  switch (D) {
    case 64: return launch(stack_bwd_kernel<T, 64>, a, tiles, H, smem, need, stream);
    case 128: return launch(stack_bwd_kernel<T, 128>, a, tiles, H, smem, need, stream);
    case 192: return launch(stack_bwd_kernel<T, 192>, a, tiles, H, smem, need, stream);
    default: return launch(stack_bwd_kernel<T, 256>, a, tiles, H, smem, need, stream);
  }
}

}  // namespace stack_cluster

// Stack forward on clusters. `t`: x, bias [L][B][D], ln1, wqkv, bqkv, wo, bo,
// ln2, w1, b1, w2, b2 (each [L][...]), mask [B][S], out, xs [L-1][rows][D],
// and the saved qkv [L][rows][3D], p [L][B][H][S][S], ctx [L][rows_pad][D],
// x1 (f32) [L][rows][D], h [L][rows][F]. `smem`: the launch plan's bytes
// (ops/stack_vjp.py:stack_launch_plan), which must equal the kernel's.

extern "C" int dsvg_stack_cluster_fwd(void* const* t, int L, int B, int S, int D, int F, int H,
                                      int causal, int is_f32, int seed, int thr, float kp,
                                      float scale, int smem, void* stream) {
  if (is_f32)
    return stack_cluster::fwd<float>(t, L, B, S, D, F, H, causal, seed, thr, kp, scale, smem,
                                     stream);
  return stack_cluster::fwd<bf16>(t, L, B, S, D, F, H, causal, seed, thr, kp, scale, smem,
                                  stream);
}

// Stack backward on clusters, row-local part. `t`: x, xs, g, ln1, wqkv, wo,
// ln2, w1, w2, the saved qkv, p, x1, h, then dx, dbias (f32) [L][B][D], the
// product operands xn1, dqkv, da, xn2, dhpre, hd, df (each
// [L][rows_pad][...]), and the per-tile column sums (f32) [tiles][L][9D + F].
extern "C" int dsvg_stack_cluster_bwd(void* const* t, int L, int B, int S, int D, int F, int H,
                                      int is_f32, int seed, int thr, float kp, float scale,
                                      int smem, void* stream) {
  if (is_f32)
    return stack_cluster::bwd<float>(t, L, B, S, D, F, H, seed, thr, kp, scale, smem, stream);
  return stack_cluster::bwd<bf16>(t, L, B, S, D, F, H, seed, thr, kp, scale, smem, stream);
}
