// Shared helpers of the port's CUDA kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;

constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }

// activation-type conversions: bf16 or float
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
template <class T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
// v rounded to the activation type, as a float
template <class T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// two neighbouring elements (an even column) as floats, in one access
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

// ---- dropout masks: a counter-based hash of (seed, site, row, column).
// The same integer arithmetic is written in plain torch in ops/dropout.py;
// forward and backward regenerate a mask from its coordinates, so nothing is
// saved and the mask does not depend on the grid or the tile size.
__host__ __device__ __forceinline__ unsigned fmix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

__host__ __device__ __forceinline__ unsigned site_key(int seed, int site) {
  return fmix32((unsigned)seed ^ ((unsigned)(site + 1) * 0x9E3779B9U));
}

// true where the element is kept: the top 24 hash bits, as a fraction, are
// at least the drop rate (thr = floor(rate * 2^24))
__device__ __forceinline__ bool keep_elem(unsigned key, unsigned row, unsigned col,
                                          unsigned thr) {
  return (fmix32(fmix32(row ^ key) + col) >> 8) >= thr;
}

// keep_elem in two parts, for the many columns of one row: the row's hash
// once, then each column's
__device__ __forceinline__ unsigned row_hash(unsigned key, unsigned row) {
  return fmix32(row ^ key);
}
__device__ __forceinline__ bool keep_col(unsigned rh, unsigned col, unsigned thr) {
  return (fmix32(rh + col) >> 8) >= thr;
}

// the seed of layer `layer` of a fused stack (K7): layer l of a stack drops
// exactly what one layer (K4) run with this seed drops. The same mix is
// written in ops/dropout.py:stack_layer_seed; the result is below 2^31.
__host__ __device__ __forceinline__ int stack_layer_seed(int seed, int layer) {
  return (int)(fmix32((unsigned)seed ^ ((unsigned)(layer + 1) * 0x85EBCA6BU)) & 0x7fffffffU);
}

enum DropSite { SITE_ATTN_PROB = 0, SITE_ATTN_OUT = 1, SITE_FF_HIDDEN = 2, SITE_FF_OUT = 3 };

// ---- tensor-core fragments by activation type: bf16 16x16x16, or float as
// TF32 16x16x8 (the operands are rounded to TF32's 10 mantissa bits)
template <class T>
struct Mma;

template <>
struct Mma<bf16> {
  static constexpr int K = 16;
  typedef nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, bf16, nvcuda::wmma::row_major> ARow;
  typedef nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, bf16, nvcuda::wmma::col_major> ACol;
  typedef nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, bf16, nvcuda::wmma::row_major> BRow;
  typedef nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, bf16, nvcuda::wmma::col_major> BCol;
  typedef nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> Acc;
  template <class F>
  static __device__ __forceinline__ void fix(F&) {}
};

template <>
struct Mma<float> {
  static constexpr int K = 8;
  typedef nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 8, nvcuda::wmma::precision::tf32, nvcuda::wmma::row_major> ARow;
  typedef nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 8, nvcuda::wmma::precision::tf32, nvcuda::wmma::col_major> ACol;
  typedef nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 8, nvcuda::wmma::precision::tf32, nvcuda::wmma::row_major> BRow;
  typedef nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 8, nvcuda::wmma::precision::tf32, nvcuda::wmma::col_major> BCol;
  typedef nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 8, float> Acc;
  template <class F>
  static __device__ __forceinline__ void fix(F& f) {
#pragma unroll
    for (int i = 0; i < f.num_elements; ++i) f.x[i] = nvcuda::wmma::__float_to_tf32(f.x[i]);
  }
};

constexpr int SPAD = 8;          // row padding (elements) in shared memory
constexpr float LN_EPS = 1e-5f;
constexpr int HEAD_DIM = 32;     // the head dim of the Hopper forms (D = 256, 8 heads)
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

// ---- head dims of the first port's kernels (layer_fwd.cuh, layer_bwd.cuh,
// layer_long.cuh, layer_long_train.cu, stack.cu, attention.cu, decode.cu):
// a template parameter HD, 8, 16 or 32, picked at the C entry points from
// D / H. The tensor-core tiles of their attention are 16 columns wide, so a
// head's Q, K, V slices in shared memory are padded with zero columns to
// head_pad(HD) (16 at HD = 8), whose products add nothing.
__host__ __device__ constexpr int head_pad(int hd) { return hd < 16 ? 16 : hd; }

// whether D / H is a head dim of those kernels (8, 16 or 32)
inline bool narrow_head_dim(int D, int H) {
  return H >= 1 && D % H == 0 && (D / H == 8 || D / H == 16 || D / H == 32);
}

// fn(std::integral_constant<int, HD>()) for the head dim D / H, or
// cudaErrorInvalidValue where it is not 8, 16 or 32 or H does not divide D.
template <class Fn>
int with_head_dim(int D, int H, Fn&& fn) {
  if (!narrow_head_dim(D, H)) return (int)cudaErrorInvalidValue;
  switch (D / H) {
    case 8: return fn(std::integral_constant<int, 8>());
    case 16: return fn(std::integral_constant<int, 16>());
    case 32: return fn(std::integral_constant<int, 32>());
    default: return (int)cudaErrorInvalidValue;
  }
}

// out[ROWS][N] = A[ROWS][K] @ B, each element handed to `epi(r, n, v)`.
// W_NK: B is given as W[N][K] (out = A @ W^T), else as W[K][N]. `ldw` is W's
// row stride. Each warp owns 16-column strips of the output over all rows.
// With COLSUM, the values `epi` returns are summed per column into colsum[n]
// (a strip's columns belong to one warp, so the sums are taken in a fixed
// order); without it they are dropped.
template <class T, int ROWS, bool W_NK, bool COLSUM = false, class Epi>
__device__ __forceinline__ void tile_gemm(const T* A, int lda, const T* __restrict__ W,
                                          int ldw, int N, int K, float* scratch,
                                          int warp, int lane, float* colsum, Epi epi) {
  typedef Mma<T> M;
  constexpr int RB = ROWS / 16;
  for (int nt = warp; nt < N / 16; nt += NWARPS) {
    typename M::Acc acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) nvcuda::wmma::fill_fragment(acc[r], 0.f);
    for (int k = 0; k < K; k += M::K) {
      if constexpr (W_NK) {
        typename M::BCol b;
        nvcuda::wmma::load_matrix_sync(b, W + (size_t)nt * 16 * ldw + k, ldw);
        M::fix(b);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          typename M::ARow a;
          nvcuda::wmma::load_matrix_sync(a, A + (size_t)r * 16 * lda + k, lda);
          M::fix(a);
          nvcuda::wmma::mma_sync(acc[r], a, b, acc[r]);
        }
      } else {
        typename M::BRow b;
        nvcuda::wmma::load_matrix_sync(b, W + (size_t)k * ldw + nt * 16, ldw);
        M::fix(b);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          typename M::ARow a;
          nvcuda::wmma::load_matrix_sync(a, A + (size_t)r * 16 * lda + k, lda);
          M::fix(a);
          nvcuda::wmma::mma_sync(acc[r], a, b, acc[r]);
        }
      }
    }
    float csum = 0.f;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      nvcuda::wmma::store_matrix_sync(scratch, acc[r], 16, nvcuda::wmma::mem_row_major);
      __syncwarp();
      if constexpr (COLSUM) {
        for (int e = lane; e < 256; e += 32)
          scratch[e] = epi(r * 16 + e / 16, nt * 16 + e % 16, scratch[e]);
        __syncwarp();
        if (lane < 16) {
#pragma unroll
          for (int i = 0; i < 16; ++i) csum += scratch[i * 16 + lane];
        }
      } else {
        for (int e = lane; e < 256; e += 32)
          epi(r * 16 + e / 16, nt * 16 + e % 16, scratch[e]);
      }
      __syncwarp();
    }
    if constexpr (COLSUM) {
      if (lane < 16) colsum[nt * 16 + lane] += csum;
    }
  }
}

// mean and 1/std of a row held 8-per-lane (columns lane, lane+32, ...; D <= 256)
__device__ __forceinline__ void row_stats(const float (&v)[8], int D, int lane,
                                          float& mu, float& rstd) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (lane + 32 * j < D) s += v[j];
  mu = warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (lane + 32 * j < D) {
      const float d = v[j] - mu;
      q += d * d;
    }
  rstd = rsqrtf(warp_sum(q) / D + LN_EPS);
}
