// K3: command + argument heads with a first-index argmax per slot, logits
// never stored (see ops/head.py).
//
// The head arrives packed per slot: slot 0 (commands) is round16(n_cmd)
// rows, slot i >= 1 (argument i-1) round16(vocab) rows, each row a weight
// column of length D; padded columns are masked by index. A block keeps 128
// rows of x in shared memory; per slot it stages up to 64 head columns at a
// time in shared memory (read by all 8 warps), each warp multiplies its 16
// rows with wmma (bf16, f32 accumulate), and two lanes per row fold the
// chunk into a running (max, first index). The float form multiplies in
// TF32 (wmma 16x16x8) with 32-column chunks. A block takes every slot of its
// rows; when the row tiles are fewer than the card's SMs (the autoregressive
// decode's R = N rows a step), the slots go to blocks of their own
// (blockIdx.y), which compute each slot as the one block would.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int HEAD_ROWS = NWARPS * 16;

// head columns staged per chunk: 64 for bf16; 32 for float, whose x tile
// and chunk are twice the bytes (128 x 264 x 4 + 32 x 264 x 4 B fit the
// block's shared memory, 128 + 64 rows would not)
template <class T>
struct HeadCfg {
  static constexpr int CHUNK_TILES = sizeof(T) == 2 ? 4 : 2;
  static constexpr int SCR_LD = CHUNK_TILES * 16 + 4;
};

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

template <class T>
size_t smem_bytes(int D) {
  typedef HeadCfg<T> C;
  return (size_t)(HEAD_ROWS + C::CHUNK_TILES * 16) * (D + SPAD) * sizeof(T) +
         (size_t)NWARPS * 16 * C::SCR_LD * sizeof(float);
}

template <class T>
__global__ void __launch_bounds__(NTHREADS)
    head_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ bias, int* __restrict__ ids, int R,
                int D, int n_cmd, int n_args, int vocab, int slots_per_block) {
  typedef Mma<T> M;
  constexpr int CHUNK_TILES = HeadCfg<T>::CHUNK_TILES;
  constexpr int SCR_LD = HeadCfg<T>::SCR_LD;
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = D + SPAD;
  T* xs = reinterpret_cast<T*>(smem);
  T* ws = xs + HEAD_ROWS * ldx;
  float* scr = reinterpret_cast<float*>(ws + CHUNK_TILES * 16 * ldx);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* wscr = scr + warp * 16 * SCR_LD;
  const int row0 = blockIdx.x * HEAD_ROWS;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte vector
  const int vecs = D / VEC;

  for (int e = threadIdx.x; e < HEAD_ROWS * vecs; e += NTHREADS) {
    const int r = e / vecs, c = e - r * vecs;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < R) v = reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * D)[c];
    *reinterpret_cast<uint4*>(xs + r * ldx + c * VEC) = v;
  }

  const int cw = round16(n_cmd), aw = round16(vocab);
  const int pr = lane >> 1, half = lane & 1;  // two lanes per row
  const int my_row = row0 + warp * 16 + pr;

  const int slot_end = min(n_args + 1, (int)(blockIdx.y + 1) * slots_per_block);
  for (int slot = blockIdx.y * slots_per_block; slot < slot_end; ++slot) {
    const int col0 = slot == 0 ? 0 : cw + (slot - 1) * aw;
    const int tiles = (slot == 0 ? cw : aw) / 16;
    const int valid = slot == 0 ? n_cmd : vocab;
    float best = -INFINITY;
    int best_idx = 0;
    for (int t0 = 0; t0 < tiles; t0 += CHUNK_TILES) {
      const int nt = min(CHUNK_TILES, tiles - t0);
      __syncthreads();  // x is loaded / the previous chunk is consumed
      for (int e = threadIdx.x; e < nt * 16 * vecs; e += NTHREADS) {
        const int r = e / vecs, c = e - r * vecs;
        *reinterpret_cast<uint4*>(ws + r * ldx + c * VEC) =
            reinterpret_cast<const uint4*>(w + (size_t)(col0 + t0 * 16 + r) * D)[c];
      }
      __syncthreads();

      typename M::Acc acc[CHUNK_TILES];
#pragma unroll
      for (int t = 0; t < CHUNK_TILES; ++t) wmma::fill_fragment(acc[t], 0.f);
      for (int k = 0; k < D; k += M::K) {
        typename M::ARow a;
        wmma::load_matrix_sync(a, xs + warp * 16 * ldx + k, ldx);
        M::fix(a);
#pragma unroll
        for (int t = 0; t < CHUNK_TILES; ++t) {
          if (t < nt) {
            typename M::BCol b;
            wmma::load_matrix_sync(b, ws + t * 16 * ldx + k, ldx);
            M::fix(b);
            wmma::mma_sync(acc[t], a, b, acc[t]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < CHUNK_TILES; ++t)
        if (t < nt) wmma::store_matrix_sync(wscr + t * 16, acc[t], SCR_LD, wmma::mem_row_major);
      __syncwarp();

      // each lane scans every other column of its row, then the pair merges
      float cb = -INFINITY;
      int ci = 0x7fffffff;
      for (int c = half; c < nt * 16; c += 2) {
        const int col = t0 * 16 + c;  // index within the slot
        if (col < valid) {
          const float v = wscr[pr * SCR_LD + c] + to_f(bias[col0 + col]);
          if (v > cb) {
            cb = v;
            ci = col;
          }
        }
      }
      const float ob = __shfl_xor_sync(FULL_MASK, cb, 1);
      const int oi = __shfl_xor_sync(FULL_MASK, ci, 1);
      if (ob > cb || (ob == cb && oi < ci)) {
        cb = ob;
        ci = oi;
      }
      if (cb > best) {  // strict: an earlier chunk keeps a tie
        best = cb;
        best_idx = ci;
      }
      __syncwarp();
    }
    if (half == 0 && my_row < R) ids[(size_t)my_row * (n_args + 1) + slot] = best_idx;
  }
}

template <class T>
int launch_head(const void* x, const void* w, const void* bias, void* ids, int R, int D,
                int n_cmd, int n_args, int vocab, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(D);
  cudaError_t err = cudaFuncSetAttribute(
      head_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (R + HEAD_ROWS - 1) / HEAD_ROWS;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int per_block = blocks < sms ? 1 : n_args + 1;
  const dim3 grid(blocks, (n_args + per_block) / per_block);
  head_kernel<T><<<grid, NTHREADS, smem, stream>>>((const T*)x, (const T*)w,
                                                   (const T*)bias, (int*)ids, R, D, n_cmd,
                                                   n_args, vocab, per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// is_f32: x, the head and its bias are float (TF32 products), else bf16
extern "C" int dsvg_head_argmax(const void* x, const void* w, const void* bias,
                                void* ids, int R, int D, int n_cmd, int n_args,
                                int vocab, int is_f32, void* stream) {
  if (is_f32)
    return launch_head<float>(x, w, bias, ids, R, D, n_cmd, n_args, vocab,
                              (cudaStream_t)stream);
  return launch_head<bf16>(x, w, bias, ids, R, D, n_cmd, n_args, vocab, (cudaStream_t)stream);
}
