// K9 on Hopper: one token of the autoregressive decode through all L decoder
// layers against the key/value caches, plus the final LayerNorm (see
// ops/decode.py for the op). Replaces the Pallas kernel
// deepsvg_tpu/ops/decode.py:_decode_kernel at the flagship's width (D = 256,
// 8 heads of 32); decode.cu keeps the other widths.
//
// What bounds it. A step must read the caches of the positions before
// `index`: at R = 1024 rows, L = 4 and index 120 that is 503 MB in bf16 (1,007
// MB in float32), 0.15 (0.30) ms at 3.35 TB/s, against 4.3 GFLOP of products.
// The older kernel (decode.cu) streams the caches well, but each of its 128
// blocks read its wmma B fragments of the whole weight stack straight from
// L2 (4.2 MB a block, 537 MB a step in bf16) with few loads in flight: a fixed
// cost of about 0.24 ms a step.
//
// Layout. A block owns 8 rows and every head, as the older kernel: 16
// warps, the residual stream (f32) in shared memory through the L layers,
// the attention a warp a (row, head) pair. The cache stream is the older
// kernel's: a warp streams its pair's [index, 32] key and value slices, four
// lanes a position with one 16-byte load each (two in float32), UNROLL
// rounds of eight positions in flight (4 KB a warp, 64 KB an SM), folded into
// an online softmax; then the token's own key and value as one more term.
// The loads are evict-first (each cache byte is read once a step). Only the
// positions before `index` are read. R = 1024 is 128 blocks, one an SM.
//
// Weights. Two blocks form a cluster and split every product by its output
// columns: for the cluster's 16 rows, block c computes columns c*128 ..
// c*128 + 127 of each 256-column slab of a product, so it reads only its half
// of the weight stack (2.1 MB a step in bf16, where every block of the
// older kernel read all 4.2 MB). Its weight rows reach shared memory in boxes
// of 128 rows x 128 bytes of K (16 KB) through a TMA ring of NS stages that
// runs ahead across products and layers, 128-byte swizzled (the mma
// fragments are read at the swizzled addresses, free of bank conflicts). The
// two blocks exchange rows through distributed shared memory: each writes
// its rows of a product's input (the LN output, the context) into both
// blocks' 16-row input buffer, and each product's outputs go to the block
// that owns the row (QKV; the out projection and FF2 into a staging buffer
// the owner adds to its residual), the FF hidden into both blocks; a cluster
// barrier follows each of the seven exchanges a layer. A buffer is written
// again only after a barrier that both blocks reach after their last read of
// it.
//
// Products: [16 rows] x [K] x [128 columns] a slab on mma.sync (bf16
// m16n8k16; float32 as TF32 m16n8k8), an 8-column tile a warp, summed over
// the slabs of K in registers. A cluster of two blocks of one block an SM
// fits 66 to a wave, so R = 1024 runs in one wave.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace decode_cluster {

constexpr int DM = 256;           // the model width this form takes
constexpr int HD = HEAD_DIM;      // 32
constexpr int NH = DM / HD;       // heads
constexpr int ROWS = 8;           // rows a block
constexpr int CLUSTER = 2;        // blocks sharing the weight slabs
constexpr int NW = 16;            // warps a block
constexpr int NT = NW * 32;
constexpr int SLAB_N = 256;       // output columns of a product's slab
constexpr int HALF_N = SLAB_N / CLUSTER;   // a block's share: its TMA box
constexpr int PAIR = ROWS * CLUSTER;       // the cluster's rows
constexpr uint32_t STAGE_BYTES = HALF_N * 128;   // 16 KB
constexpr int MAX_F = 1024;

// by activation type: K elements of a slab row (128 bytes), the mma depth,
// the cache rounds a lane loads ahead, the ring's stages
template <class T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int KW = 64, KS = 16, UNROLL = 4, NS = 8;
};
template <>
struct Cfg<float> {
  static constexpr int KW = 32, KS = 8, UNROLL = 2, NS = 6;
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// shared memory: the ring (1024-byte aligned, for the swizzle), the
// residual (f32), QKV of the block's rows (f32; k and v rounded to T), the
// out-projection / FF2 output of its rows (f32), the cluster's 16 rows of
// the LN output, the context and the FF hidden (T), the ring's barriers
struct Layout {
  int ring, xres, qkv, z, xn, ctx, hid, bars, total;
  __host__ __device__ Layout(int F, int esz, int ns) {
    int o = 0;
    ring = o; o += ns * (int)STAGE_BYTES;
    xres = o; o += ROWS * DM * 4;
    qkv = o; o += ROWS * 3 * DM * 4;
    z = o; o += ROWS * DM * 4;
    xn = o; o += round_up(PAIR * (DM + 16 / esz) * esz, 128);
    ctx = o; o += round_up(PAIR * (DM + 16 / esz) * esz, 128);
    hid = o; o += round_up(PAIR * (F + 16 / esz) * esz, 128);
    bars = o; o += 2 * ns * 8;
    total = o + 1024;   // the base is aligned up to 1024 bytes in the kernel
  }
};

template <class T>
struct Params {
  CUtensorMap wqkv, wo, w1, w2;   // [L*3D][D], [L*D][D], [L*F][D], [L*D][F]; boxes 128 x 128 B
  const T *x, *seq_bias, *ln1, *bqkv, *bo, *ln2, *b1, *b2, *lnf;
  const T *kc, *vc;
  const float* key_pad;
  T *y, *k_new, *v_new;
  int R, T_, F, L, index;
  float scale;
};

// A step's slabs in order, per layer: Wqkv (3 row chunks x D / KW), Wo
// (D / KW), W1 (F / 256 row chunks x D / KW), W2 (F / KW); slab n's tensor
// map and coordinates {k, row} of its first row
template <class T>
struct Slabs {
  static constexpr int KW = Cfg<T>::KW, ND = DM / KW;
  int F, per_layer;
  __device__ Slabs(int F_) : F(F_), per_layer(4 * ND + (F / SLAB_N) * ND + F / KW) {}
  __device__ const CUtensorMap* at(const Params<T>& p, int n, int& k, int& row) const {
    const int l = n / per_layer;
    int e = n - l * per_layer;
    if (e < 3 * ND) {
      k = (e % ND) * KW;
      row = l * 3 * DM + (e / ND) * SLAB_N;
      return &p.wqkv;
    }
    if ((e -= 3 * ND) < ND) {
      k = e * KW;
      row = l * DM;
      return &p.wo;
    }
    if ((e -= ND) < (F / SLAB_N) * ND) {
      k = (e % ND) * KW;
      row = l * F + (e / ND) * SLAB_N;
      return &p.w1;
    }
    e -= (F / SLAB_N) * ND;
    k = e * KW;
    row = l * DM;
    return &p.w2;
  }
};

// The weight ring: slab n lives in stage n % NS. Thread 0 issues a slab's
// box once every warp has released the stage's previous slab (the stage's
// empty barrier counts the 16 warps), NS - 1 slabs ahead of the slab being
// read; the full barrier counts the box's bytes. Every warp reads every slab
// in the same order.
template <class T>
struct Ring {
  static constexpr int NS = Cfg<T>::NS;
  const Params<T>& p;
  unsigned char* base;
  uint64_t *full, *empty;
  Slabs<T> slabs;
  int total, n;
  uint32_t me;
  __device__ void issue(int m) {
    const int s = m % NS;
    hopper::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
    int k, row;
    const CUtensorMap* map = slabs.at(p, m, k, row);
    hopper::tma_load_2d(base + s * STAGE_BYTES, map, &full[s], k, row + (int)me * HALF_N);
  }
  __device__ void start() {
    if (threadIdx.x == 0)
      for (int m = 0; m < NS && m < total; ++m) issue(m);
  }
  __device__ const unsigned char* wait() {
    if (threadIdx.x == 0 && n > 0 && n - 1 + NS < total) {
      // the stage of slab n - 1, once every warp is done with it
      hopper::mbar_wait(&empty[(n - 1) % NS], (uint32_t)((n - 1) / NS) & 1u);
      issue(n - 1 + NS);
    }
    const int s = n % NS;
    hopper::mbar_wait(&full[s], (uint32_t)(n / NS) & 1u);
    return base + s * STAGE_BYTES;
  }
  // the warp is done with the current slab
  __device__ void release(int lane) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[n % NS]);
    ++n;
  }
};

// ---- fragments. A: the block's 8 rows [8][lda] in shared memory (the mma's
// rows 8-15 are zero); B: a slab, row n (an output column) of 128 bytes,
// 16-byte chunks swizzled by n % 8. Lane (g, t4) = (lane / 4, lane % 4).
__device__ __forceinline__ uint32_t slab_u32(const unsigned char* slab, int n, int kbyte) {
  return *reinterpret_cast<const uint32_t*>(slab + n * 128 +
                                            ((((kbyte >> 4) ^ (n & 7)) << 4) | (kbyte & 15)));
}

// B fragments of an 8-column tile (columns n.. of the slab, k..) and the mma,
// by activation type
template <class T>
struct Frag;
template <>
struct Frag<bf16> {
  static __device__ __forceinline__ void b(uint32_t& b0, uint32_t& b1, const unsigned char* s,
                                           int n, int k, int t4) {
    b0 = slab_u32(s, n, (k + 2 * t4) * 2);
    b1 = slab_u32(s, n, (k + 8 + 2 * t4) * 2);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    hopper::mma_m16n8k16_bf16(d, a, b0, b1);
  }
};
template <>
struct Frag<float> {
  static __device__ __forceinline__ void b(uint32_t& b0, uint32_t& b1, const unsigned char* s,
                                           int n, int k, int t4) {
    b0 = __float_as_uint(hopper::to_tf32(__uint_as_float(slab_u32(s, n, (k + t4) * 4))));
    b1 = __float_as_uint(hopper::to_tf32(__uint_as_float(slab_u32(s, n, (k + 4 + t4) * 4))));
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    hopper::mma_m16n8k8_tf32(d, a, b0, b1);
  }
};

// A fragment of rows g and g + 8, columns k.. of A [16][lda]
template <class T>
__device__ __forceinline__ void load_a(uint32_t (&f)[4], const T* A, int lda, int k, int g,
                                       int t4);
template <>
__device__ __forceinline__ void load_a<bf16>(uint32_t (&f)[4], const bf16* A, int lda, int k,
                                             int g, int t4) {
  const bf16* p = A + g * lda + k + 2 * t4;
  f[0] = *reinterpret_cast<const uint32_t*>(p);
  f[1] = *reinterpret_cast<const uint32_t*>(p + 8 * lda);
  f[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  f[3] = *reinterpret_cast<const uint32_t*>(p + 8 * lda + 8);
}
template <>
__device__ __forceinline__ void load_a<float>(uint32_t (&f)[4], const float* A, int lda, int k,
                                              int g, int t4) {
  const float* p = A + g * lda + k + t4;
  f[0] = __float_as_uint(hopper::to_tf32(p[0]));
  f[1] = __float_as_uint(hopper::to_tf32(p[8 * lda]));
  f[2] = __float_as_uint(hopper::to_tf32(p[4]));
  f[3] = __float_as_uint(hopper::to_tf32(p[8 * lda + 4]));
}

// The block's columns of out[16][N] = A[16][K] @ W^T: of each 256-column
// chunk of N, columns me*128 .. me*128 + 127, from the ring (K / KW slabs a
// chunk); each warp an 8-column tile; epi(r, n, v0, v1) for columns n, n + 1
// of row r (0-15, the cluster's rows)
template <class T, class RingT, class Epi>
__device__ __forceinline__ void product(RingT& ring, const T* A, int lda, int N, int K, int warp,
                                        int lane, Epi epi) {
  constexpr int KW = Cfg<T>::KW, KS = Cfg<T>::KS;
  const int g = lane >> 2, t4 = lane & 3;
  for (int n0 = 0; n0 < N; n0 += SLAB_N) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f}, acc1[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < K; k0 += KW) {
      const unsigned char* s = ring.wait();
#pragma unroll
      for (int kk = 0; kk < KW; kk += 2 * KS) {
        uint32_t a[4], b0, b1;
        load_a<T>(a, A, lda, k0 + kk, g, t4);
        Frag<T>::b(b0, b1, s, warp * 8 + g, kk, t4);
        Frag<T>::mma(acc, a, b0, b1);
        load_a<T>(a, A, lda, k0 + kk + KS, g, t4);
        Frag<T>::b(b0, b1, s, warp * 8 + g, kk + KS, t4);
        Frag<T>::mma(acc1, a, b0, b1);
      }
      ring.release(lane);
    }
    const int n = n0 + (int)ring.me * HALF_N + warp * 8 + 2 * t4;
    epi(g, n, acc[0] + acc1[0], acc[1] + acc1[1]);
    epi(g + 8, n, acc[2] + acc1[2], acc[3] + acc1[3]);
  }
}

// row `warp` of xres [8][D] -> LN(row) * scale + bias, as T into out (and
// into out2, the same row of the peer block, unless null)
template <class T>
__device__ __forceinline__ void ln_row(const float* xres, const T* __restrict__ ln, T* out,
                                       T* out2, int warp, int lane) {
  const float* xr = xres + warp * DM;
  float s = 0.f;
  for (int c = lane; c < DM; c += 32) s += xr[c];
  const float mu = warp_sum(s) / DM;
  float q = 0.f;
  for (int c = lane; c < DM; c += 32) {
    const float d = xr[c] - mu;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / DM + LN_EPS);
  for (int c = lane; c < DM; c += 32) {
    const T v = from_f<T>((xr[c] - mu) * rstd * to_f(ln[c]) + to_f(ln[DM + c]));
    out[c] = v;
    if (out2) out2[c] = v;
  }
}

// By activation type: the 8 cache elements of a lane (one 16-byte load in
// bf16, two in float)
template <class T>
struct Vec8;
template <>
struct Vec8<bf16> {
  uint4 u;
  __device__ void load(const bf16* p) { u = __ldcs(reinterpret_cast<const uint4*>(p)); }
  __device__ void zero() { u = make_uint4(0, 0, 0, 0); }
  __device__ void unpack(float (&f)[8]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
};
template <>
struct Vec8<float> {
  float4 a, b;
  __device__ void load(const float* p) {
    a = __ldcs(reinterpret_cast<const float4*>(p));
    b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ void unpack(float (&f)[8]) const {
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
    f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  }
};

// online-softmax state of one lane: running max, sum of exp, context of its
// 8 dimensions
struct Online {
  float m, l, acc[8];
  __device__ void init() {
    m = -INFINITY;
    l = 0.f;
#pragma unroll
    for (int d = 0; d < 8; ++d) acc[d] = 0.f;
  }
  __device__ void add(float t, const float (&v)[8]) {
    const float mn = fmaxf(m, t);
    if (mn == -INFINITY) return;
    const float a = expf(m - mn), e = expf(t - mn);
    l = l * a + e;
#pragma unroll
    for (int d = 0; d < 8; ++d) acc[d] = acc[d] * a + e * v[d];
    m = mn;
  }
  __device__ void merge(float m2, float l2, const float (&acc2)[8]) {
    const float mn = fmaxf(m, m2);
    if (mn == -INFINITY) return;
    const float a = expf(m - mn), a2 = expf(m2 - mn);
    l = l * a + l2 * a2;
#pragma unroll
    for (int d = 0; d < 8; ++d) acc[d] = acc[d] * a + acc2[d] * a2;
    m = mn;
  }
};

__device__ __forceinline__ float group_sum(float s) {
  s += __shfl_xor_sync(FULL_MASK, s, 1);
  return s + __shfl_xor_sync(FULL_MASK, s, 2);
}

// context of row `row`, head h of layer l into ctx_r[h*32 ..] and the same
// place of ctx_r2 (the peer block's copy of the row): qkv_r the
// row's q (unscaled), k and v (rounded to T) as f32; lane = 4 x position
// group g (positions g, g + 8, ...) + quarter qd (dimensions qd*8 ..)
template <class T>
__device__ __forceinline__ void attend(const Params<T>& p, int l, int row, int h,
                                       const float* qkv_r, T* ctx_r, T* ctx_r2, int lane) {
  constexpr int UNROLL = Cfg<T>::UNROLL;
  const int idx = p.index;
  const int g = lane >> 2, qd = lane & 3;
  float q[8];
#pragma unroll
  for (int d = 0; d < 8; ++d) q[d] = qkv_r[h * HD + qd * 8 + d] * p.scale;
  const size_t base = ((size_t)l * p.R + row) * p.T_ * DM + h * HD + qd * 8;
  const T* kb = p.kc + base;
  const T* vb = p.vc + base;
  const float* kp = p.key_pad + (size_t)row * p.T_;
  Online st;
  st.init();
  for (int j0 = 0; j0 < idx; j0 += 8 * UNROLL) {
    Vec8<T> ku[UNROLL], vu[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + 8 * u + g;
      ku[u].zero();
      vu[u].zero();
      if (j < idx) {
        ku[u].load(kb + (size_t)j * DM);
        vu[u].load(vb + (size_t)j * DM);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + 8 * u + g;
      float kf[8], vf[8];
      ku[u].unpack(kf);
      vu[u].unpack(vf);
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < 8; ++d) s = fmaf(q[d], kf[d], s);
      s = group_sum(s);
      if (j < idx) st.add(s + kp[j], vf);
    }
  }
  // merge the eight position groups (lanes with the same quarter)
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    float acc2[8];
#pragma unroll
    for (int d = 0; d < 8; ++d) acc2[d] = __shfl_xor_sync(FULL_MASK, st.acc[d], off);
    const float m2 = __shfl_xor_sync(FULL_MASK, st.m, off);
    const float l2 = __shfl_xor_sync(FULL_MASK, st.l, off);
    st.merge(m2, l2, acc2);
  }
  // the token's own key and value
  float s = 0.f, vt[8];
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    s = fmaf(q[d], qkv_r[DM + h * HD + qd * 8 + d], s);
    vt[d] = qkv_r[2 * DM + h * HD + qd * 8 + d];
  }
  s = group_sum(s);
  st.add(s + kp[idx], vt);
  if (g == 0) {
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const T v = from_f<T>(st.m == -INFINITY ? 0.f : st.acc[d] / st.l);
      ctx_r[h * HD + qd * 8 + d] = v;
      ctx_r2[h * HD + qd * 8 + d] = v;
    }
  }
}

template <class T>
__global__ void __launch_bounds__(NT, 1) decode_cluster_kernel(const __grid_constant__ Params<T> p) {
  constexpr int PADE = 16 / sizeof(T), ldn = DM + PADE, NS = Cfg<T>::NS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  cg::cluster_group cl = cg::this_cluster();
  const uint32_t me = cl.block_rank(), peer = me ^ 1u;
  const int F = p.F, ldh = F + PADE, R = p.R;
  const Layout lay(F, sizeof(T), NS);
  float* xres = reinterpret_cast<float*>(smem + lay.xres);   // [8][D], the block's rows
  float* qkv = reinterpret_cast<float*>(smem + lay.qkv);     // [8][3D]
  float* z = reinterpret_cast<float*>(smem + lay.z);         // [8][D]
  T* xn = reinterpret_cast<T*>(smem + lay.xn);               // [16][ldn], the cluster's rows
  T* ctx = reinterpret_cast<T*>(smem + lay.ctx);             // [16][ldn]
  T* hid = reinterpret_cast<T*>(smem + lay.hid);             // [16][ldh]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + NS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair0 = (blockIdx.x / CLUSTER) * PAIR;   // the cluster's first row
  const int row0 = pair0 + (int)me * ROWS;
  const int nrows = max(0, min(ROWS, R - row0));
  const int mine = (int)me * ROWS;                   // the block's rows among the 16
  // the peer block's copies of the same buffers
  float* qkv_peer = cl.map_shared_rank(qkv, peer);
  float* z_peer = cl.map_shared_rank(z, peer);
  T* xn_peer = cl.map_shared_rank(xn, peer);
  T* ctx_peer = cl.map_shared_rank(ctx, peer);
  T* hid_peer = cl.map_shared_rank(hid, peer);

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], NW);
    }
    hopper::fence_barrier_init();
  }
  for (int e = threadIdx.x; e < ROWS * DM; e += NT)
    xres[e] = e / DM < nrows ? to_f(p.x[(size_t)row0 * DM + e]) : 0.f;
  // rows past the batch keep a zero context and hidden
  for (int e = threadIdx.x; e < PAIR * ldn; e += NT) ctx[e] = from_f<T>(0.f);
  for (int e = threadIdx.x; e < PAIR * ldh; e += NT) hid[e] = from_f<T>(0.f);
  __syncthreads();
  const Slabs<T> slabs(F);
  Ring<T> ring{p, smem + lay.ring, full, empty, slabs, p.L * slabs.per_layer, 0, me};
  ring.start();
  cl.sync();  // both blocks are running before any exchange

  // the cluster's row r (0-15): the block's own row, or the peer's
  auto owner = [&](int r, float* local, float* remote, int ld) {
    return (r / ROWS == (int)me ? local : remote) + (r % ROWS) * ld;
  };
  for (int l = 0; l < p.L; ++l) {
    const T* bqkv = p.bqkv + (size_t)l * 3 * DM;
    const T* bo = p.bo + (size_t)l * DM;
    const T* b1 = p.b1 + (size_t)l * F;
    const T* b2 = p.b2 + (size_t)l * DM;

    // LN1 of the block's rows into both blocks' LN output buffer
    if (warp < ROWS)
      ln_row(xres, p.ln1 + (size_t)l * 2 * DM, xn + (mine + warp) * ldn,
             xn_peer + (mine + warp) * ldn, warp, lane);
    cl.sync();
    // QKV, the block's columns of the cluster's rows, to each row's block
    product<T>(ring, xn, ldn, 3 * DM, DM, warp, lane, [&](int r, int n, float v0, float v1) {
      v0 += to_f(bqkv[n]);
      v1 += to_f(bqkv[n + 1]);
      if (n >= DM) {  // the token's key and value: rounded, returned, and used rounded
        const T k0 = from_f<T>(v0), k1 = from_f<T>(v1);
        v0 = to_f(k0);
        v1 = to_f(k1);
        if (pair0 + r < R) {
          T* dst = n < 2 * DM ? p.k_new + ((size_t)l * R + pair0 + r) * DM + (n - DM)
                              : p.v_new + ((size_t)l * R + pair0 + r) * DM + (n - 2 * DM);
          dst[0] = k0;
          dst[1] = k1;
        }
      }
      *reinterpret_cast<float2*>(owner(r, qkv, qkv_peer, 3 * DM) + n) = make_float2(v0, v1);
    });
    cl.sync();

    // attention of the block's rows, every head; the context into both
    // blocks' context buffer
    for (int pair = warp; pair < nrows * NH; pair += NW) {
      const int r = pair / NH, h = pair - r * NH;
      attend<T>(p, l, row0 + r, h, qkv + r * 3 * DM, ctx + (mine + r) * ldn,
                ctx_peer + (mine + r) * ldn, lane);
    }
    cl.sync();

    // out projection (+ bo) of the cluster's rows, to each row's block
    product<T>(ring, ctx, ldn, DM, DM, warp, lane, [&](int r, int n, float v0, float v1) {
      *reinterpret_cast<float2*>(owner(r, z, z_peer, DM) + n) =
          make_float2(v0 + to_f(bo[n]), v1 + to_f(bo[n + 1]));
    });
    cl.sync();
    // residual + attention output + seq_bias, the block's rows
    for (int e = threadIdx.x; e < ROWS * DM; e += NT) {
      const int r = e / DM;
      const float sb = r < nrows ? to_f(p.seq_bias[((size_t)l * R + row0) * DM + e]) : 0.f;
      xres[e] = (xres[e] + z[e]) + sb;
    }
    __syncthreads();

    // LN2, then FF1 + ReLU: the block's hidden columns of the cluster's rows,
    // into both blocks' hidden buffer
    if (warp < ROWS)
      ln_row(xres, p.ln2 + (size_t)l * 2 * DM, xn + (mine + warp) * ldn,
             xn_peer + (mine + warp) * ldn, warp, lane);
    cl.sync();
    product<T>(ring, xn, ldn, F, DM, warp, lane, [&](int r, int n, float v0, float v1) {
      const float h0 = fmaxf(v0 + to_f(b1[n]), 0.f), h1 = fmaxf(v1 + to_f(b1[n + 1]), 0.f);
      store2(hid + r * ldh + n, h0, h1);
      store2(hid_peer + r * ldh + n, h0, h1);
    });
    cl.sync();

    // FF2 (+ b2) of the cluster's rows, to each row's block; then the
    // residual
    product<T>(ring, hid, ldh, DM, F, warp, lane, [&](int r, int n, float v0, float v1) {
      *reinterpret_cast<float2*>(owner(r, z, z_peer, DM) + n) =
          make_float2(v0 + to_f(b2[n]), v1 + to_f(b2[n + 1]));
    });
    cl.sync();
    for (int e = threadIdx.x; e < ROWS * DM; e += NT) xres[e] += z[e];
    __syncthreads();
  }
  if (warp < nrows)
    ln_row(xres, p.lnf, p.y + (size_t)(row0 + warp) * DM, static_cast<T*>(nullptr), warp, lane);
  // no block leaves while its peer may still write into it
  cl.sync();
}

template <class T>
int launch(const void* const* t, int R, int T_, int F, int L, int index, int smem, float scale,
           cudaStream_t stream) {
  const Layout lay(F, sizeof(T), Cfg<T>::NS);
  if (smem != lay.total || F % SLAB_N || F > MAX_F || L < 1) return (int)cudaErrorInvalidValue;
  Params<T> p;
  const bool f32 = sizeof(T) == 4;
  const int kw = Cfg<T>::KW;
  // the weights as 2-D [rows][K] tensors, boxes of 128 rows x KW elements.
  // A decode's steps pass the same weight tensors: their maps are encoded
  // again only when an address or a shape changes.
  CUtensorMap maps[4];
  int rc = hopper::make_tma_2d_cached(&maps[0], t[3], f32, DM, (uint64_t)L * 3 * DM, DM * sizeof(T), kw, HALF_N);
  if (rc == 0) rc = hopper::make_tma_2d_cached(&maps[1], t[5], f32, DM, (uint64_t)L * DM, DM * sizeof(T), kw, HALF_N);
  if (rc == 0) rc = hopper::make_tma_2d_cached(&maps[2], t[8], f32, DM, (uint64_t)L * F, DM * sizeof(T), kw, HALF_N);
  if (rc == 0) rc = hopper::make_tma_2d_cached(&maps[3], t[10], f32, F, (uint64_t)L * DM, (uint64_t)F * sizeof(T), kw, HALF_N);
  if (rc) return rc;
  p.wqkv = maps[0];
  p.wo = maps[1];
  p.w1 = maps[2];
  p.w2 = maps[3];
  p.x = (const T*)t[0];
  p.seq_bias = (const T*)t[1];
  p.ln1 = (const T*)t[2];
  p.bqkv = (const T*)t[4];
  p.bo = (const T*)t[6];
  p.ln2 = (const T*)t[7];
  p.b1 = (const T*)t[9];
  p.b2 = (const T*)t[11];
  p.lnf = (const T*)t[12];
  p.kc = (const T*)t[13];
  p.vc = (const T*)t[14];
  p.key_pad = (const float*)t[15];
  p.y = (T*)t[16];
  p.k_new = (T*)t[17];
  p.v_new = (T*)t[18];
  p.R = R;
  p.T_ = T_;
  p.F = F;
  p.L = L;
  p.index = index;
  p.scale = scale;
  auto kernel = decode_cluster_kernel<T>;
  // the shared-memory attribute, once per device (a decode launches 240
  // steps with the same count)
  static int smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem_set[dev] < smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  const int blocks = (R + ROWS - 1) / ROWS;
  cfg.gridDim = dim3((blocks + CLUSTER - 1) / CLUSTER * CLUSTER);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the clusters one wave holds, at one block an SM
template <class T>
int wave() {
  auto kernel = decode_cluster_kernel<T>;
  const int smem = 232448;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
      cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER * 64);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg) != cudaSuccess) return -1;
  return n;
}

}  // namespace decode_cluster

// The clusters one wave of the decode kernel holds on this card, at one
// block an SM; -1 on error.
extern "C" int dsvg_decode_cluster_wave(int is_f32) {
  return is_f32 ? decode_cluster::wave<float>() : decode_cluster::wave<bf16>();
}

// K9 on clusters of two blocks of 8 rows, D = 256 with 8 heads of 32 (other
// widths: cudaErrorInvalidValue). Pointers as dsvg_decode_step's; F a
// multiple of 256 up to 1024; `smem` the block's bytes (decode_cluster::Layout).
extern "C" int dsvg_decode_cluster(const void* x, const void* seq_bias, const void* ln1,
                                   const void* wqkv, const void* bqkv, const void* wo,
                                   const void* bo, const void* ln2, const void* w1,
                                   const void* b1, const void* w2, const void* b2,
                                   const void* lnf, const void* kc, const void* vc,
                                   const void* key_pad, void* y, void* k_new, void* v_new, int R,
                                   int T, int D, int F, int H, int L, int index, int is_f32,
                                   int smem, float scale, void* stream) {
  if (D != decode_cluster::DM || H != decode_cluster::NH || index < 0 || index >= T || R < 1)
    return (int)cudaErrorInvalidValue;
  const void* t[] = {x,  seq_bias, ln1, wqkv, bqkv, wo, bo,  ln2,   w1,   b1,
                     w2, b2,       lnf, kc,   vc,   key_pad, y, k_new, v_new};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_f32)
    return decode_cluster::launch<float>(t, R, T, F, L, index, smem, scale, s);
  return decode_cluster::launch<bf16>(t, R, T, F, L, index, smem, scale, s);
}
