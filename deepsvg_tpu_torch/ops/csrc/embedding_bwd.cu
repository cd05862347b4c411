// K6: gradients of the embedding tables, a scatter-add of dy rows
// (see ops/embedding.py).
//
//   dcmd[cmd] += dy[row]; darg[i * vocab + arg_i + 1] += dy[row];
//   dgroup[gid] += dy[row]; dpos[row % S] += dy[row]
//
// Replaces deepsvg_tpu/ops/embedding.py:_embed_bwd_kernel, whose sequential
// grid sums in one order on every run. Here every sum is taken in an order
// fixed by the inputs alone, with no atomics: the same inputs give the same
// tables to the bit. What bounds the op on the H100 is reading dy once (16.8
// MB at the flagship's B=128, 5 us); the table rows are few and stay in L2.
//
// Three kinds of table row, three ways to sum them:
// * Hot rows, the n_cmd command rows and each slot's PAD row (arg = -1 ->
//   row i * vocab), which take most of the tokens. embedding_bwd_kernel's
//   token blocks own a run of `tokens_per_block` tokens each, one thread a
//   column, and sum those rows in registers in token order (each token's
//   rows staged as bits in shared memory); each block writes its sums to its
//   own slice of `part` [blocks][n_cmd + n_args][D], and hot_reduce_kernel
//   adds the slices in block order into the tables.
// * Position rows: embedding_bwd_kernel's last S blocks own one row each:
//   dpos[r] = sum_b dy[b][r], each warp over every eighth sequence, eight
//   columns a lane, then the warps' sums added in warp order.
// * Cold rows, the other argument rows and the group rows: a segment sum
//   over the (token, table row) entries ordered by row. dsvg_embedding_bwd_keys
//   writes each entry's key (its table row; hot, out-of-range and absent ids
//   get a key past every row); the wrapper orders the entries by key with a
//   stable sort on the device, so each row's entries come in token order.
//   cold_chunk_kernel gives each warp a chunk of COLD_CHUNK consecutive
//   entries: it sums each run of one key in entry order; a run that is a
//   whole segment goes straight to its table row, a run cut by the chunk's
//   edge goes to the chunk's `head` (the segment began in an earlier chunk)
//   or `tail` (it began here and goes on). cold_join_kernel then adds, for
//   each segment that began in a chunk and goes on, that chunk's tail and
//   the next chunks' heads in chunk order. A row of many tokens is thus
//   summed by many warps, and still in one order.
// An id outside [0, table rows) adds nothing.
#include <algorithm>

#include "common.cuh"

namespace {

// sorted entries a warp of cold_chunk_kernel sums, and tokens a hot block
// sums (ops/embedding.py sizes the scratch by them)
constexpr int COLD_CHUNK = 32;
constexpr int TOKENS_PER_BLOCK = 128;
constexpr int NO_ROW = 0x7fffffff;  // the key of an entry that adds to no cold row
constexpr int HOT_G = 24;           // hot rows a thread sums in registers at a time

template <class T>
__global__ void __launch_bounds__(256)
    embedding_bwd_kernel(const int* __restrict__ cmd, const int* __restrict__ args,
                         const T* __restrict__ dy, float* __restrict__ part,
                         float* __restrict__ dpos, long long rows, int S, int D, int n_args,
                         int n_cmd, int tokens_per_block, int token_blocks) {
  extern __shared__ float hot[];  // a token block's row bits; [8][D] in a position block
  if ((int)blockIdx.x >= token_blocks) {
    const int r = blockIdx.x - token_blocks;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
    const long long nseq = rows / S;
    for (int c0 = lane * 8; c0 < D; c0 += 32 * 8) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (long long b0 = warp; b0 < nseq; b0 += 8 * nwarps) {
        float v[8][8];  // eight sequences' loads in flight, then their sums in order
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const long long b = b0 + q * nwarps;
          const T* src = dy + ((b < nseq ? b : 0) * S + r) * D + c0;
#pragma unroll
          for (int j = 0; j < 8; j += 2) {
            const float2 t = load2(src + j);
            v[q][j] = t.x;
            v[q][j + 1] = t.y;
          }
        }
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (b0 + q * nwarps < nseq)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[j] += v[q][j];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) hot[(size_t)warp * D + c0 + j] = acc[j];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      float s = 0.f;
      for (int w = 0; w < nwarps; ++w) s += hot[(size_t)w * D + c];
      dpos[(size_t)r * D + c] = s;
    }
    return;
  }
  // Each token's hot rows as bits of one word a group of HOT_G rows (a
  // command row, and each slot whose argument is PAD), staged in shared
  // memory; then each thread sums its column of a group's rows in registers,
  // token by token in token order (adding 0 where a token skips a row).
  unsigned* meta = reinterpret_cast<unsigned*>(hot);
  const int n_hot = n_cmd + n_args;
  const long long t0 = (long long)blockIdx.x * tokens_per_block;
  const int ntok = (int)min((long long)tokens_per_block, rows - t0);
  float* out = part + (size_t)blockIdx.x * n_hot * D;
  for (int g0 = 0; g0 < n_hot; g0 += HOT_G) {
    __syncthreads();  // the last group's readers of meta are done
    for (int t = threadIdx.x; t < ntok; t += blockDim.x) {
      const long long tok = t0 + t;
      unsigned m = 0;
      const int id = cmd[tok];
      if (id >= 0 && id < n_cmd && id >= g0 && id - g0 < HOT_G) m |= 1u << (id - g0);
      for (int i = 0; i < n_args; ++i) {
        const int r = n_cmd + i - g0;
        if (r >= 0 && r < HOT_G && args[tok * n_args + i] == -1) m |= 1u << r;
      }
      meta[t] = m;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += blockDim.x) {
      float acc[HOT_G];
#pragma unroll
      for (int r = 0; r < HOT_G; ++r) acc[r] = 0.f;
      for (int tb = 0; tb < ntok; tb += 8) {
        float v[8];  // eight tokens' loads in flight
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = tb + k < ntok ? to_f(dy[(t0 + tb + k) * D + c]) : 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const unsigned m = tb + k < ntok ? meta[tb + k] : 0u;
#pragma unroll
          for (int r = 0; r < HOT_G; ++r) acc[r] += (m >> r) & 1u ? v[k] : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < HOT_G; ++r)
        if (g0 + r < n_hot) out[(size_t)(g0 + r) * D + c] = acc[r];
    }
  }
}

// the hot rows: table row = sum over the blocks' slices, in block order
__global__ void hot_reduce_kernel(const float* __restrict__ part, float* __restrict__ dcmd,
                                  float* __restrict__ darg, int blocks, int n_cmd, int n_args,
                                  int vocab, int D) {
  const int n = (n_cmd + n_args) * D;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += part[(size_t)b * n + i];
  const int r = i / D, c = i - r * D;
  if (r < n_cmd)
    dcmd[(size_t)r * D + c] = s;
  else
    darg[(size_t)(r - n_cmd) * vocab * D + c] = s;
}

// each (token, slot) entry's key: its cold table row (argument rows first,
// i * vocab + arg + 1 with arg >= 0, then the group rows), else NO_ROW
__global__ void cold_keys_kernel(const int* __restrict__ args, const int* __restrict__ groups,
                                 int* __restrict__ keys, long long rows, int n_args, int vocab,
                                 int n_group, int use_group) {
  const int per = n_args + use_group;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * per) return;
  const long long tok = e / per;
  const int j = (int)(e - tok * per);
  int key = NO_ROW;
  if (j < n_args) {
    const int row = args[tok * n_args + j] + 1;
    if (row > 0 && row < vocab) key = j * vocab + row;
  } else {
    const int gid = groups[tok];
    if (gid >= 0 && gid < n_group) key = n_args * vocab + gid;
  }
  keys[e] = key;
}

struct Cold {
  const int* key;        // [E] sorted
  const long long* idx;  // [E] each sorted entry's place before the sort
  float* darg;           // [n_args * vocab][D]
  float* dgroup;         // [n_group][D]
  float* head;           // [chunks][D]
  float* tail;           // [chunks][D]
  long long E;
  int per, D, arg_rows, n_group, chunks;
  __device__ __forceinline__ float* row(int k) const {
    return k < arg_rows ? darg + (size_t)k * D : dgroup + (size_t)(k - arg_rows) * D;
  }
  __device__ __forceinline__ long long end(int c) const {
    return min((long long)(c + 1) * COLD_CHUNK, E);
  }
};

template <class T>
__device__ __forceinline__ void add8(float (&acc)[8], const T* src) {
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    const float2 v = load2(src + j);
    acc[j] += v.x;
    acc[j + 1] += v.y;
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&acc)[8]) {
  *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

// a warp a chunk of the sorted entries, eight columns a lane
template <class T>
__global__ void __launch_bounds__(256)
    cold_chunk_kernel(const T* __restrict__ dy, const __grid_constant__ Cold p) {
  const int c = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (c >= p.chunks) return;
  const int lane = threadIdx.x & 31;
  const long long e0 = (long long)c * COLD_CHUNK, e1 = p.end(c);
  for (long long s = e0; s < e1;) {
    const int k = p.key[s];
    if (k == NO_ROW) break;  // sorted last: the rest of the chunk adds nothing
    long long f = s + 1;
    while (f < e1 && p.key[f] == k) ++f;
    const bool from_before = s == e0 && c > 0 && p.key[e0 - 1] == k;
    const bool goes_on = f == e1 && e1 < p.E && p.key[e1] == k;
    float* dst = from_before ? p.head + (size_t)c * p.D
                             : goes_on ? p.tail + (size_t)c * p.D : p.row(k);
    for (int c0 = lane * 8; c0 < p.D; c0 += 256) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (long long i = s; i < f; ++i) add8(acc, dy + (p.idx[i] / p.per) * p.D + c0);
      store8(dst + c0, acc);
    }
    s = f;
  }
}

// a thread a (chunk, column): the segment that begins in the chunk and goes
// on is its tail plus the next chunks' heads, in chunk order
__global__ void cold_join_kernel(const __grid_constant__ Cold p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)p.chunks * p.D) return;
  const int c = (int)(i / p.D), col = (int)(i - (long long)c * p.D);
  const long long e1 = p.end(c);
  if (e1 >= p.E) return;
  const int k = p.key[e1 - 1];
  if (k == NO_ROW || p.key[e1] != k) return;  // the last run ends in the chunk
  // a chunk of one run that began earlier is a head, joined by its owner
  const long long e0 = (long long)c * COLD_CHUNK;
  if (p.key[e0] == k && c > 0 && p.key[e0 - 1] == k) return;
  float s = p.tail[(size_t)c * p.D + col];
  for (int n = c + 1; n < p.chunks && p.key[(long long)n * COLD_CHUNK] == k; ++n) {
    s += p.head[(size_t)n * p.D + col];
    if (p.key[p.end(n) - 1] != k) break;  // the segment ends in chunk n
  }
  p.row(k)[col] = s;
}

template <class T>
int launch(const int* cmd, const int* args, const T* dy, float* dcmd, float* darg,
           float* dpos, const Cold& cold, float* part, long long rows, int S, int D, int n_args,
           int vocab, int n_cmd, cudaStream_t stream) {
  const int tokens_per_block = TOKENS_PER_BLOCK;
  const size_t smem =
      std::max((size_t)8 * D * sizeof(float), tokens_per_block * sizeof(unsigned));
  const int token_blocks = (int)((rows + tokens_per_block - 1) / tokens_per_block);
  cudaError_t err = cudaFuncSetAttribute(embedding_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  embedding_bwd_kernel<T><<<token_blocks + S, 256, smem, stream>>>(
      cmd, args, dy, part, dpos, rows, S, D, n_args, n_cmd, tokens_per_block, token_blocks);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int nh = (n_cmd + n_args) * D;
  hot_reduce_kernel<<<(nh + 255) / 256, 256, 0, stream>>>(part, dcmd, darg, token_blocks, n_cmd,
                                                         n_args, vocab, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (cold.chunks == 0) return 0;
  cold_chunk_kernel<T><<<(cold.chunks + 7) / 8, 256, 0, stream>>>(dy, cold);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long nj = (long long)cold.chunks * D;
  cold_join_kernel<<<(unsigned)((nj + 255) / 256), 256, 0, stream>>>(cold);
  return (int)cudaGetLastError();
}

}  // namespace

// Each (token, slot) entry's cold-row key into keys [rows * (n_args +
// use_group)] int32, token-major: the input of the wrapper's stable sort.
extern "C" int dsvg_embedding_bwd_keys(const void* args, const void* groups, void* keys,
                                       long long rows, int n_args, int vocab, int n_group,
                                       int use_group, void* stream) {
  const long long n = rows * (n_args + use_group);
  if (n == 0) return 0;
  cold_keys_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const int*)args, (const int*)groups, (int*)keys, rows, n_args, vocab, n_group, use_group);
  return (int)cudaGetLastError();
}

// dcmd, darg and dgroup must be zero on entry; dpos is written. D is a
// multiple of 8. keys [E] sorted and idx [E] int64 (each sorted entry's place
// in dsvg_embedding_bwd_keys' output), E = rows * (n_args + use_group);
// scratch: part [ceil(rows / 128)][n_cmd + n_args][D] floats, head and tail
// [ceil(E / 128)][D] each.
extern "C" int dsvg_embedding_bwd(const void* cmd, const void* args, const void* dy,
                                  void* dcmd, void* darg, void* dgroup, void* dpos,
                                  const void* keys, const void* idx, void* part, void* head,
                                  void* tail, long long rows, int S, int D, int n_args,
                                  int vocab, int n_cmd, int n_group, int use_group, int is_f32,
                                  void* stream) {
  if (D % 8 || S < 1 || rows % S) return (int)cudaErrorInvalidValue;
  Cold cold;
  cold.key = (const int*)keys;
  cold.idx = (const long long*)idx;
  cold.darg = (float*)darg;
  cold.dgroup = (float*)dgroup;
  cold.head = (float*)head;
  cold.tail = (float*)tail;
  cold.per = n_args + use_group;
  cold.E = rows * cold.per;
  cold.D = D;
  cold.arg_rows = n_args * vocab;
  cold.n_group = use_group ? n_group : 0;
  cold.chunks = (int)((cold.E + COLD_CHUNK - 1) / COLD_CHUNK);
  if (is_f32)
    return launch<float>((const int*)cmd, (const int*)args, (const float*)dy, (float*)dcmd,
                         (float*)darg, (float*)dpos, cold, (float*)part, rows, S, D, n_args,
                         vocab, n_cmd, (cudaStream_t)stream);
  return launch<bf16>((const int*)cmd, (const int*)args, (const bf16*)dy, (float*)dcmd,
                      (float*)darg, (float*)dpos, cold, (float*)part, rows, S, D, n_args, vocab,
                      n_cmd, (cudaStream_t)stream);
}
