// The fused pre-LN transformer layer's forward on one block's rows, shared by
// K2's float32 form and K4's forward (layer.cu) and by K7's stack forward
// (stack.cu); K2's bfloat16 form is layer_infer.cuh's.
//
// A block of 8 warps owns whole sequences: nseq = ROWS / S of them (ROWS = 64
// for bf16 activations: 2x32 for E1, 2x31 for D1 with the ragged rows unused,
// 8x8 for E2/D2; ROWS = 32 for float activations, whose tiles are twice as
// wide in bytes). Everything between the input load and the output store
// stays in shared memory:
//   xres  f32 [ROWS][D]            residual stream
//   xn    T   [ROWS][D+8]          LN output, later the attention context
//   big   T   [ROWS][max(3D,F)+8]  QKV, later the FF hidden
//   scratch f32 [8 warps][16x16]   accumulator tiles for the epilogues
// The four products run on the tensor cores (wmma, bf16 or TF32, f32
// accumulate); each warp owns a 16-column strip of the output over all rows,
// so each weight fragment is read from L2 once per block. Attention runs one
// (sequence, head) per warp: lane j holds key j (S <= 32), the softmax
// subtracts the row max, and a query whose keys are all masked gets zero
// probabilities. The head dim HD (8, 16 or 32) is a template parameter;
// lane c < HD sums output column c of the context (at HD < 32 the other
// lanes only hold their keys).
//
// TRAIN adds dropout at the four sites (attention probabilities, attention
// output, FF hidden, FF output; masks from the hash in common.cuh). What a
// training forward writes beside `out` is its MODE:
//   FWD_SAVE (K4's saved mode, K7): what the backward would otherwise
//     recompute: QKV, the probabilities before dropout, the context, the
//     residual after the attention block (f32) and the FF hidden before
//     dropout;
//   FWD_OUT: `out` alone (K4's recompute mode);
//   FWD_WORKSPACE (the first launch of K4's recompute backward): QKV, the
//     context, the residual after the attention block (f32) and the FF
//     hidden before dropout in f32, then stops: no FF2, no `out`.
// The arithmetic is the same in every mode: `out` is the same to the bit.
#pragma once

#include "common.cuh"

namespace layer_fwd {

enum FwdMode { FWD_SAVE = 0, FWD_OUT = 1, FWD_WORKSPACE = 2 };

template <class T>
struct LayerParams {
  const T* x;
  const T* seq_bias;  // [B][D] or null
  const T* ln1;       // [2][D]: scale, bias
  const T* wqkv;      // [3D][D]
  const T* bqkv;
  const T* wo;        // [D][D]
  const T* bo;
  const T* ln2;
  const T* w1;        // [F][D]
  const T* b1;
  const T* w2;        // [D][F]
  const T* b2;
  const float* mask;  // [B][S] additive
  T* out;
  // training only
  T* qkv_s;           // [B*S][3D]
  T* p_s;             // [B][H][S][S]
  T* ctx_s;           // [B*S][D]
  float* x1_s;        // [B*S][D]
  T* h_s;             // [B*S][F]
  float* h32;         // [B*S][F], FWD_WORKSPACE only
  int B, S, D, F, H, causal, nseq;
  float scale, kp;
  unsigned thr;
  int seed;
};

__host__ __device__ inline int big_ld(int D, int F) {
  return (3 * D > F ? 3 * D : F) + SPAD;
}

template <class T, int ROWS>
size_t smem_bytes(int D, int F) {
  return (size_t)ROWS * D * sizeof(float) + (size_t)ROWS * (D + SPAD) * sizeof(T) +
         (size_t)ROWS * big_ld(D, F) * sizeof(T) + (size_t)NWARPS * 256 * sizeof(float);
}

// One warp per row: [xres += seq_bias; save it;] xn = LN(xres) in f32, stored as T.
template <class T, int ROWS>
__device__ void layer_norm_rows(float* xres, int D, const T* __restrict__ ln, T* xn,
                                int ldn, const T* __restrict__ bias, float* save,
                                int S, int nrows, int warp, int lane) {
  for (int r = warp; r < ROWS; r += NWARPS) {
    float* xr = xres + (size_t)r * D;
    if (bias != nullptr && r < nrows) {
      const T* br = bias + (size_t)(r / S) * D;
      for (int c = lane; c < D; c += 32) xr[c] += to_f(br[c]);
    }
    if (save != nullptr && r < nrows)
      for (int c = lane; c < D; c += 32) save[(size_t)r * D + c] = xr[c];
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += xr[c];
    const float mu = warp_sum(s) / D;
    float v = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = xr[c] - mu;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / D + LN_EPS);
    for (int c = lane; c < D; c += 32)
      xn[(size_t)r * ldn + c] =
          from_f<T>((xr[c] - mu) * rstd * to_f(ln[c]) + to_f(ln[D + c]));
  }
}

// ctx[seq, i, head] = softmax(q_i k^T * scale + mask) v, one warp per
// (sequence, head) of HD columns; probabilities are rounded to T before the
// PV product. SAVE_P: the probabilities before dropout go to p.p_s.
template <class T, int HD, bool TRAIN, bool SAVE_P = TRAIN>
__device__ void attention(const LayerParams<T>& p, const T* qkv, int ldq, T* ctx,
                          int ldc, int seq0, int nvalid, int warp, int lane) {
  const int S = p.S, D = p.D, H = p.H;
  const unsigned key = site_key(p.seed, SITE_ATTN_PROB);
  for (int pair = warp; pair < nvalid * H; pair += NWARPS) {
    const int sq = pair / H, h = pair - sq * H;
    const T* base = qkv + (size_t)sq * S * ldq;
    const bool has_key = lane < S;
    const T* kr = base + (size_t)(has_key ? lane : 0) * ldq + D + h * HD;
    float kf[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) kf[d] = has_key ? to_f(kr[d]) : 0.f;
    const float mval = has_key ? p.mask[(size_t)(seq0 + sq) * S + lane] : -INFINITY;
    const bool has_col = lane < HD;   // the context column this lane sums
    const T* vcol = base + 2 * D + h * HD + (has_col ? lane : 0);
    const size_t prow0 = ((size_t)(seq0 + sq) * H + h) * S;
    for (int i = 0; i < S; ++i) {
      const T* qr = base + (size_t)i * ldq + h * HD;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) s = fmaf(to_f(qr[d]), kf[d], s);
      s = s * p.scale + mval;
      if (!has_key || (p.causal && lane > i)) s = -INFINITY;
      const float m = warp_max(s);  // the same in every lane
      float pr = 0.f;
      if (m != -INFINITY) {
        const float e = expf(s - m);
        pr = e / warp_sum(e);
      }
      if constexpr (TRAIN) {
        if constexpr (SAVE_P)
          if (has_key) p.p_s[(prow0 + i) * S + lane] = from_f<T>(pr);
        if (p.thr != 0u)
          pr = keep_elem(key, (unsigned)(prow0 + i), (unsigned)lane, p.thr) ? pr * p.kp : 0.f;
      }
      pr = round_to<T>(pr);
      float c = 0.f;
      for (int j = 0; j < S; ++j)
        c = fmaf(__shfl_sync(FULL_MASK, pr, j), to_f(vcol[(size_t)j * ldq]), c);
      if (has_col) ctx[(size_t)(sq * S + i) * ldc + h * HD + lane] = from_f<T>(c);
    }
  }
}

// One layer on the sequences of block blockIdx.x: x -> out (and, with TRAIN,
// what MODE writes), heads of HD columns. `smem` holds smem_bytes<T, ROWS>(D,
// F) bytes.
template <class T, int ROWS, int HD, bool TRAIN, int MODE = FWD_SAVE>
__device__ __forceinline__ void layer_tile(const LayerParams<T>& p, unsigned char* smem) {
  constexpr bool SAVE = TRAIN && MODE == FWD_SAVE;
  constexpr bool WORKSPACE = TRAIN && MODE == FWD_WORKSPACE;
  const int D = p.D, F = p.F, S = p.S;
  const int ldn = D + SPAD, ldb = big_ld(D, F);
  float* xres = reinterpret_cast<float*>(smem);
  T* xn = reinterpret_cast<T*>(xres + ROWS * D);
  T* big = xn + ROWS * ldn;
  float* scratch = reinterpret_cast<float*>(big + ROWS * ldb);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wscr = scratch + warp * 256;
  const int seq0 = blockIdx.x * p.nseq;
  const int nvalid = min(p.nseq, p.B - seq0);
  const int nrows = nvalid * S;
  const size_t row0 = (size_t)seq0 * S;
  const bool drop = TRAIN && p.thr != 0u;

  // 1. input tile -> f32 residual, two columns at a time (D is even); unused
  // rows are zero
  for (int e = threadIdx.x * 2; e < ROWS * D; e += NTHREADS * 2) {
    const float2 v = e / D < nrows ? load2(p.x + row0 * D + e) : make_float2(0.f, 0.f);
    xres[e] = v.x;
    xres[e + 1] = v.y;
  }
  __syncthreads();

  // 2. LN1
  layer_norm_rows<T, ROWS>(xres, D, p.ln1, xn, ldn, nullptr, nullptr, S, nrows, warp, lane);
  __syncthreads();

  // 3. QKV = LN1(x) @ Wqkv^T + b, stored as T
  tile_gemm<T, ROWS, true>(xn, ldn, p.wqkv, D, 3 * D, D, wscr, warp, lane, nullptr,
                           [&](int r, int n, float v) {
                             const T q = from_f<T>(v + to_f(p.bqkv[n]));
                             big[r * ldb + n] = q;
                             if constexpr (SAVE || WORKSPACE)
                               if (r < nrows) p.qkv_s[(row0 + r) * 3 * D + n] = q;
                             return 0.f;
                           });
  __syncthreads();

  // 4. attention; the context overwrites xn
  attention<T, HD, TRAIN, SAVE>(p, big, ldb, xn, ldn, seq0, nvalid, warp, lane);
  __syncthreads();
  if constexpr (SAVE || WORKSPACE) {
    for (int e = threadIdx.x; e < nrows * D; e += NTHREADS) {
      const int r = e / D, c = e - r * D;
      p.ctx_s[row0 * D + e] = xn[r * ldn + c];
    }
  }

  // 5. out projection into the residual
  {
    const unsigned key = site_key(p.seed, SITE_ATTN_OUT);
    tile_gemm<T, ROWS, true>(xn, ldn, p.wo, D, D, D, wscr, warp, lane, nullptr,
                             [&](int r, int n, float v) {
                               float a = v + to_f(p.bo[n]);
                               if (drop)
                                 a = keep_elem(key, (unsigned)(row0 + r), n, p.thr) ? a * p.kp : 0.f;
                               xres[r * D + n] += a;
                               return 0.f;
                             });
  }
  __syncthreads();

  // 6. per-sequence bias, then LN2
  layer_norm_rows<T, ROWS>(xres, D, p.ln2, xn, ldn,
                           p.seq_bias ? p.seq_bias + (size_t)seq0 * D : nullptr,
                           SAVE || WORKSPACE ? p.x1_s + row0 * D : nullptr, S, nrows, warp,
                           lane);
  __syncthreads();

  // 7. FF1 + ReLU, stored as T
  {
    const unsigned key = site_key(p.seed, SITE_FF_HIDDEN);
    tile_gemm<T, ROWS, true>(xn, ldn, p.w1, D, F, D, wscr, warp, lane, nullptr,
                             [&](int r, int n, float v) {
                               float h = fmaxf(v + to_f(p.b1[n]), 0.f);
                               if constexpr (SAVE)
                                 if (r < nrows) p.h_s[(row0 + r) * F + n] = from_f<T>(h);
                               if constexpr (WORKSPACE)
                                 if (r < nrows) p.h32[(row0 + r) * F + n] = h;
                               if (drop)
                                 h = keep_elem(key, (unsigned)(row0 + r), n, p.thr) ? h * p.kp : 0.f;
                               big[r * ldb + n] = from_f<T>(h);
                               return 0.f;
                             });
  }
  __syncthreads();
  if constexpr (WORKSPACE) return;

  // 8. FF2 into the residual
  {
    const unsigned key = site_key(p.seed, SITE_FF_OUT);
    tile_gemm<T, ROWS, true>(big, ldb, p.w2, F, D, F, wscr, warp, lane, nullptr,
                             [&](int r, int n, float v) {
                               float f = v + to_f(p.b2[n]);
                               if (drop)
                                 f = keep_elem(key, (unsigned)(row0 + r), n, p.thr) ? f * p.kp : 0.f;
                               xres[r * D + n] += f;
                               return 0.f;
                             });
  }
  __syncthreads();

  // 9. store the valid rows
  for (int e = threadIdx.x * 2; e < nrows * D; e += NTHREADS * 2)
    store2(p.out + row0 * D + e, xres[e], xres[e + 1]);
}

template <class T>
LayerParams<T> make_params(const void* x, const void* seq_bias, const void* ln1,
                           const void* wqkv, const void* bqkv, const void* wo,
                           const void* bo, const void* ln2, const void* w1,
                           const void* b1, const void* w2, const void* b2,
                           const void* mask, void* out, int B, int S, int D, int F,
                           int H, int causal, float scale) {
  LayerParams<T> p;
  p.x = (const T*)x;
  p.seq_bias = (const T*)seq_bias;
  p.ln1 = (const T*)ln1;
  p.wqkv = (const T*)wqkv;
  p.bqkv = (const T*)bqkv;
  p.wo = (const T*)wo;
  p.bo = (const T*)bo;
  p.ln2 = (const T*)ln2;
  p.w1 = (const T*)w1;
  p.b1 = (const T*)b1;
  p.w2 = (const T*)w2;
  p.b2 = (const T*)b2;
  p.mask = (const float*)mask;
  p.out = (T*)out;
  p.qkv_s = p.p_s = p.ctx_s = p.h_s = nullptr;
  p.x1_s = p.h32 = nullptr;
  p.B = B;
  p.S = S;
  p.D = D;
  p.F = F;
  p.H = H;
  p.causal = causal;
  p.nseq = 0;
  p.scale = scale;
  p.kp = 1.f;
  p.thr = 0u;
  p.seed = 0;
  return p;
}

}  // namespace layer_fwd
