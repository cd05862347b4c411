// K9: one token of the autoregressive decode through all L decoder layers
// against the key/value caches, plus the final LayerNorm (see ops/decode.py).
//
// A block of 16 warps owns 8 rows and loops over the layers with the f32
// residual in shared memory. The four products of a layer run on the tensor
// cores in m8n32k16 tiles (bf16, f32 accumulate), each warp a 32-column
// strip of the output with the weights read from L2. The attention of a
// (row, head) pair is one warp: it streams the head's [index, HD] key and
// value slices of the row, HD / 8 lanes per position with one 16-byte load
// of each (32 / (HD / 8) positions per warp load: 8 at head dim 32, 16 at 16,
// 32 at 8; four loads of each in flight), and folds the scores into a
// running (max, sum, context) per lane group; the groups are merged by
// shuffles, then the token's own key and value as one more term. The head
// dim HD (8, 16 or 32) is a template parameter, picked from D / H at the
// entry point. Only the positions before `index` are read. 16 warps
// rather than 8 keep twice the loads in flight (measured at N=1024: 0.41
// against 0.55 ms at index 120, PERF.md); loading eight rounds ahead instead
// of four gained less.
//
// The float form (float activations, weights and caches) multiplies in TF32
// (wmma 16x16x8): its A operands hold 16 rows, the block's 8 and 8 zero rows
// whose outputs are dropped, and each lane loads its 8 cache elements as two
// 16-byte loads, two rounds ahead. Its caches are twice the bytes.
#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int DROWS = 8;   // rows of a block
constexpr int DWARPS = 16;
constexpr int DTHREADS = DWARPS * 32;  // with at most 128 registers a thread

// By activation type: the product tiles, the rows the A operands hold in
// shared memory (the TF32 tile has 16 rows; rows 8-15 stay zero and their
// outputs are dropped) and the cache rounds a lane loads ahead (8 floats are
// two 16-byte loads, so float takes two rounds to bf16's four).
template <class T>
struct Dec;

template <>
struct Dec<bf16> {
  static constexpr int TM = 8, TN = 32, TK = 16;
  static constexpr int AROWS = 8;
  static constexpr int UNROLL = 4;
  typedef wmma::fragment<wmma::matrix_a, 8, 32, 16, bf16, wmma::row_major> A;
  typedef wmma::fragment<wmma::matrix_b, 8, 32, 16, bf16, wmma::col_major> B;
  typedef wmma::fragment<wmma::accumulator, 8, 32, 16, float> C;
  // the 8 elements of a lane: one 16-byte load
  struct Vec {
    uint4 u;
    __device__ void load(const bf16* p) { u = *reinterpret_cast<const uint4*>(p); }
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
};

template <>
struct Dec<float> {
  static constexpr int TM = 16, TN = 16, TK = 8;
  static constexpr int AROWS = 16;
  static constexpr int UNROLL = 2;
  typedef Mma<float>::ARow A;
  typedef Mma<float>::BCol B;
  typedef Mma<float>::Acc C;
  struct Vec {
    float4 a, b;
    __device__ void load(const float* p) {
      a = reinterpret_cast<const float4*>(p)[0];
      b = reinterpret_cast<const float4*>(p)[1];
    }
    __device__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
    __device__ void unpack(float (&f)[8]) const {
      f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
      f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
    }
  };
};

template <class T>
struct DecodeParams {
  const T *x, *seq_bias, *ln1, *wqkv, *bqkv, *wo, *bo, *ln2, *w1, *b1, *w2, *b2, *lnf;
  const T *kc, *vc;
  const float* key_pad;
  T *y, *k_new, *v_new;
  int R, T_, D, F, H, L, index;
  float scale;
};

// out[8][N] = A[8][K] @ W^T with W [N][K] (nn.Linear layout, global memory);
// each element handed to epi(r, n, v). Each warp owns TN-column strips; A
// holds AROWS rows, of which the first 8 are the block's.
template <class T, class Epi>
__device__ __forceinline__ void gemm8(const T* A, int lda, const T* __restrict__ W, int N,
                                      int K, float* scr, int warp, int lane, Epi epi) {
  typedef Dec<T> G;
  for (int nt = warp; nt < N / G::TN; nt += DWARPS) {
    typename G::C acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll 4
    for (int k = 0; k < K; k += G::TK) {
      typename G::A a;
      typename G::B b;
      wmma::load_matrix_sync(a, A + k, lda);
      wmma::load_matrix_sync(b, W + (size_t)nt * G::TN * K + k, K);
      Mma<T>::fix(a);
      Mma<T>::fix(b);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(scr, acc, G::TN, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < DROWS * G::TN; e += 32)
      epi(e / G::TN, nt * G::TN + e % G::TN, scr[e]);
    __syncwarp();
  }
}

// row `warp` of xres [8][D] -> LN(row) * scale + bias, as T into out[warp * ldo]
template <class T>
__device__ __forceinline__ void ln_row(const float* xres, int D, const T* __restrict__ ln,
                                       T* out, int warp, int lane) {
  const float* xr = xres + warp * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += xr[c];
  const float mu = warp_sum(s) / D;
  float q = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float d = xr[c] - mu;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / D + LN_EPS);
  for (int c = lane; c < D; c += 32)
    out[c] = from_f<T>((xr[c] - mu) * rstd * to_f(ln[c]) + to_f(ln[D + c]));
}

// online-softmax state of one lane: running max, sum of exp, context of its
// 8 dimensions. merge() folds in another state.
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

// the Q lanes of a position group sum their partial dot products
template <int Q>
__device__ __forceinline__ float group_sum(float s) {
#pragma unroll
  for (int o = 1; o < Q; o <<= 1) s += __shfl_xor_sync(FULL_MASK, s, o);
  return s;
}

// context of row r, head h of layer l into ctx[r][h*HD ..]: lane = Q x group
// g (positions g, g+G, ...) + part qd (dimensions qd*8 .. qd*8+7), with Q =
// HD / 8 lanes a position and G = 32 / Q groups
template <class T, int HD>
__device__ void attend(const DecodeParams<T>& p, int l, int row, int h, const float* qkv_r,
                       T* ctx_r, int lane) {
  constexpr int UNROLL = Dec<T>::UNROLL;
  constexpr int Q = HD / 8, G = 32 / Q;
  typedef typename Dec<T>::Vec Vec;
  const int D = p.D, idx = p.index;
  const int g = lane / Q, qd = lane % Q;
  float q[8], kt[8], vt[8];
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    q[d] = qkv_r[h * HD + qd * 8 + d] * p.scale;
    kt[d] = qkv_r[D + h * HD + qd * 8 + d];
    vt[d] = qkv_r[2 * D + h * HD + qd * 8 + d];
  }
  const size_t base = ((size_t)l * p.R + row) * p.T_ * D + h * HD + qd * 8;
  const T* kb = p.kc + base;
  const T* vb = p.vc + base;
  const float* kp = p.key_pad + (size_t)row * p.T_;
  Online st;
  st.init();
  for (int j0 = 0; j0 < idx; j0 += G * UNROLL) {
    Vec ku[UNROLL], vu[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + G * u + g;
      ku[u].zero();
      vu[u].zero();
      if (j < idx) {
        ku[u].load(kb + (size_t)j * D);
        vu[u].load(vb + (size_t)j * D);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + G * u + g;
      float kf[8], vf[8];
      ku[u].unpack(kf);
      vu[u].unpack(vf);
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < 8; ++d) s = fmaf(q[d], kf[d], s);
      s = group_sum<Q>(s);
      if (j < idx) st.add(s + kp[j], vf);
    }
  }
  // merge the G position groups (lanes with the same part)
#pragma unroll
  for (int off = Q; off < 32; off <<= 1) {
    float acc2[8];
#pragma unroll
    for (int d = 0; d < 8; ++d) acc2[d] = __shfl_xor_sync(FULL_MASK, st.acc[d], off);
    const float m2 = __shfl_xor_sync(FULL_MASK, st.m, off);
    const float l2 = __shfl_xor_sync(FULL_MASK, st.l, off);
    st.merge(m2, l2, acc2);
  }
  // the token's own key and value
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < 8; ++d) s = fmaf(q[d], kt[d], s);
  s = group_sum<Q>(s);
  st.add(s + kp[idx], vt);
  if (g == 0) {
#pragma unroll
    for (int d = 0; d < 8; ++d)
      ctx_r[h * HD + qd * 8 + d] = from_f<T>(st.m == -INFINITY ? 0.f : st.acc[d] / st.l);
  }
}

template <class T>
size_t decode_smem(int D, int F) {
  return (size_t)DROWS * D * sizeof(float) * 4 +
         (size_t)Dec<T>::AROWS * (2 * (D + SPAD) + F + SPAD) * sizeof(T) +
         (size_t)DWARPS * 256 * sizeof(float);
}

template <class T, int HD>
__global__ void __launch_bounds__(DTHREADS) decode_kernel(DecodeParams<T> p) {
  constexpr int AROWS = Dec<T>::AROWS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = p.D, F = p.F, H = p.H, R = p.R;
  const int ldn = D + SPAD, ldh = F + SPAD;
  float* xres = reinterpret_cast<float*>(smem);          // [8][D]   residual
  float* qkv = xres + DROWS * D;                         // [8][3D]  f32; k, v rounded to T
  T* xn = reinterpret_cast<T*>(qkv + DROWS * 3 * D);     // [AROWS][ldn] LN outputs
  T* ctx = xn + AROWS * ldn;                             // [AROWS][ldn] attention context
  T* hid = ctx + AROWS * ldn;                            // [AROWS][ldh] FF hidden
  float* scr = reinterpret_cast<float*>(hid + AROWS * ldh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wscr = scr + warp * 256;
  const int row0 = blockIdx.x * DROWS;
  const int nrows = min(DROWS, R - row0);

  for (int e = threadIdx.x; e < DROWS * D; e += DTHREADS)
    xres[e] = e / D < nrows ? to_f(p.x[(size_t)row0 * D + e]) : 0.f;
  if (AROWS > DROWS) {  // the A rows beyond the block's stay zero
    for (int e = threadIdx.x; e < (AROWS - DROWS) * ldn; e += DTHREADS) {
      xn[DROWS * ldn + e] = from_f<T>(0.f);
      ctx[DROWS * ldn + e] = from_f<T>(0.f);
    }
    for (int e = threadIdx.x; e < (AROWS - DROWS) * ldh; e += DTHREADS)
      hid[DROWS * ldh + e] = from_f<T>(0.f);
  }
  __syncthreads();

  for (int l = 0; l < p.L; ++l) {
    const size_t w3 = (size_t)l * 3 * D * D, wd = (size_t)l * D * D, wf = (size_t)l * F * D;
    const T* bqkv = p.bqkv + (size_t)l * 3 * D;
    const T* bo = p.bo + (size_t)l * D;
    const T* b1 = p.b1 + (size_t)l * F;
    const T* b2 = p.b2 + (size_t)l * D;

    if (warp < DROWS) ln_row(xres, D, p.ln1 + (size_t)l * 2 * D, xn + warp * ldn, warp, lane);
    __syncthreads();
    gemm8(xn, ldn, p.wqkv + w3, 3 * D, D, wscr, warp, lane, [&](int r, int n, float v) {
      v += to_f(bqkv[n]);
      if (n >= D) {  // the token's key and value: rounded, returned, and used rounded
        const T kv = from_f<T>(v);
        v = to_f(kv);
        if (r < nrows) {
          T* dst = n < 2 * D ? p.k_new + ((size_t)l * R + row0 + r) * D + (n - D)
                             : p.v_new + ((size_t)l * R + row0 + r) * D + (n - 2 * D);
          *dst = kv;
        }
      }
      qkv[r * 3 * D + n] = v;
    });
    __syncthreads();

    for (int pair = warp; pair < nrows * H; pair += DWARPS) {
      const int r = pair / H, h = pair - r * H;
      attend<T, HD>(p, l, row0 + r, h, qkv + r * 3 * D, ctx + r * ldn, lane);
    }
    __syncthreads();

    gemm8(ctx, ldn, p.wo + wd, D, D, wscr, warp, lane,
          [&](int r, int n, float v) { xres[r * D + n] += v + to_f(bo[n]); });
    __syncthreads();
    for (int e = threadIdx.x; e < nrows * D; e += DTHREADS)
      xres[e] += to_f(p.seq_bias[((size_t)l * R + row0) * D + e]);
    __syncthreads();

    if (warp < DROWS) ln_row(xres, D, p.ln2 + (size_t)l * 2 * D, xn + warp * ldn, warp, lane);
    __syncthreads();
    gemm8(xn, ldn, p.w1 + wf, F, D, wscr, warp, lane, [&](int r, int n, float v) {
      hid[r * ldh + n] = from_f<T>(fmaxf(v + to_f(b1[n]), 0.f));
    });
    __syncthreads();
    gemm8(hid, ldh, p.w2 + wf, D, F, wscr, warp, lane,
          [&](int r, int n, float v) { xres[r * D + n] += v + to_f(b2[n]); });
    __syncthreads();
  }

  if (warp < nrows) ln_row(xres, D, p.lnf, p.y + (size_t)(row0 + warp) * D, warp, lane);
}

template <class T>
int launch_decode(const void* const* t, int R, int T_, int D, int F, int H, int L, int index,
                  float scale, cudaStream_t stream) {
  DecodeParams<T> p;
  const T** in[] = {&p.x, &p.seq_bias, &p.ln1, &p.wqkv, &p.bqkv, &p.wo, &p.bo, &p.ln2,
                    &p.w1, &p.b1, &p.w2, &p.b2, &p.lnf, &p.kc, &p.vc};
  for (int i = 0; i < 15; ++i) *in[i] = (const T*)t[i];
  p.key_pad = (const float*)t[15];
  p.y = (T*)t[16];
  p.k_new = (T*)t[17];
  p.v_new = (T*)t[18];
  p.R = R;
  p.T_ = T_;
  p.D = D;
  p.F = F;
  p.H = H;
  p.L = L;
  p.index = index;
  p.scale = scale;
  const size_t smem = decode_smem<T>(D, F);
  return with_head_dim(D, H, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    cudaError_t err = cudaFuncSetAttribute(decode_kernel<T, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    decode_kernel<T, HD><<<(R + DROWS - 1) / DROWS, DTHREADS, smem, stream>>>(p);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// x [R][D]; seq_bias [L][R][D]; ln1/ln2 [L][2][D]; wqkv [L][3D][D]; bqkv
// [L][3D]; wo [L][D][D]; bo [L][D]; w1 [L][F][D]; b1 [L][F]; w2 [L][D][F];
// b2 [L][D]; lnf [2][D]; kc/vc [L][R][T][D]; key_pad [R][T] f32; y [R][D];
// k_new/v_new [L][R][D]. All of the activation type (bf16, or float with
// is_f32) but key_pad. D <= 256 with head dim D / H 8, 16 or 32, D and F
// multiples of 32, 0 <= index < T.
extern "C" int dsvg_decode_step(const void* x, const void* seq_bias, const void* ln1,
                                const void* wqkv, const void* bqkv, const void* wo,
                                const void* bo, const void* ln2, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                const void* lnf, const void* kc, const void* vc,
                                const void* key_pad, void* y, void* k_new, void* v_new, int R,
                                int T, int D, int F, int H, int L, int index, int is_f32,
                                float scale, void* stream) {
  if (!narrow_head_dim(D, H) || D > 256 || D % 32 || F % 32 || index < 0 || index >= T)
    return (int)cudaErrorInvalidValue;
  const void* t[] = {x,  seq_bias, ln1, wqkv, bqkv, wo, bo,  ln2,   w1,   b1,
                     w2, b2,       lnf, kc,   vc,   key_pad, y, k_new, v_new};
  if (is_f32)
    return launch_decode<float>(t, R, T, D, F, H, L, index, scale, (cudaStream_t)stream);
  return launch_decode<bf16>(t, R, T, D, F, H, L, index, scale, (cudaStream_t)stream);
}
