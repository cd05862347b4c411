// K1: fused SVG-token embedding as a gather-sum (see ops/embedding.py).
//
//   out[row] = CmdT[cmd] + sum_i T_i[arg_i + 1] (+ GroupT[gid]) + PosT[row % S]
//
// Sums are f32, in the order of the one-hot matmuls they replace (command,
// slots 0..10, group, position); the float form is exact (the tables' own
// values, no product to round), the bf16 form rounds once at the store. An id
// outside [0, table rows) contributes zero.
//
// What bounds it on the H100: writing the output (134 MB at the flagship's
// N=1024, 40 us at 3.35 TB/s) and gathering about one argument row a token
// from L2 (the 1.4 MB of tables stay there).
//
// embedding_hopper_kernel (D a multiple of 64, 11 argument slots): a
// persistent grid of 8-warp blocks, one warp a row at a time, 16 bytes a lane
// (8 bf16 or 4 float; a 256-wide bf16 row is one pass of the warp).
// * Each block first copies the rows most tokens read into shared memory:
//   the command rows, each slot's PAD row and, where they fit under
//   HOT_SMEM_MAX, the position rows. Only the non-PAD argument rows and the
//   group rows are gathered from L2, with ld.global.nc.
// * Most rows (padding, and commands whose leading slots are PAD) begin
//   with the same terms; each block adds those prefixes once per command,
//   in the row's order, and a row starts from one: the float32 sum stays
//   the same to the bit with a third of the adds (the kernel is bound by
//   its instructions as much as by its stores).
// * A row's ids are read once, one lane each, and shuffled to the warp; the
//   next three rows' ids are in flight while this row's table rows are, and
//   a row's gathers are all issued before the first add. The position is
//   carried from row to row by the grid's stride: no 64-bit division a row.
// * The output is written with streaming stores (st.global.cs), so that it
//   does not evict the tables from L2.
// embedding_kernel (any other even D): one thread per pair of columns, as the
// first port of the kernel; counted apart by the wrapper.
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int HOPPER_WARPS = 8;
constexpr int HOPPER_ARGS = 11;           // argument slots the kernel unrolls
constexpr int HOT_SMEM_MAX = 96 * 1024;   // the wrapper's budget (ops/embedding.py)

template <class T>
__global__ void embedding_kernel(const int* __restrict__ cmd,
                                 const int* __restrict__ args,
                                 const int* __restrict__ groups,
                                 const T* __restrict__ cmd_t,
                                 const T* __restrict__ arg_t,
                                 const T* __restrict__ group_t,
                                 const T* __restrict__ pos_t,
                                 T* __restrict__ out, long long rows, int S,
                                 int D, int n_args, int vocab, int n_cmd,
                                 int n_group, int use_group) {
  const int half = D / 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows * half) return;
  const long long row = t / half;
  const int c = 2 * (int)(t % half);

  float2 acc = make_float2(0.f, 0.f);
  auto add = [&](const T* table, int n, int id) {
    if (id >= 0 && id < n) {
      const float2 v = load2(table + (long long)id * D + c);
      acc.x += v.x;
      acc.y += v.y;
    }
  };
  add(cmd_t, n_cmd, cmd[row]);
  const int* a = args + row * n_args;
  for (int i = 0; i < n_args; ++i)
    add(arg_t + (long long)i * vocab * D, vocab, a[i] + 1);
  if (use_group) add(group_t, n_group, groups[row]);
  add(pos_t, S, (int)(row % S));
  store2(out + row * D + c, acc.x, acc.y);
}

// 16 bytes of a row as floats: 8 bf16 or 4 float
template <class T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ void add16(float (&acc)[8], const uint4& u, const bf16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc[2 * k] += __uint_as_float(w[k] << 16);
    acc[2 * k + 1] += __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void add16(float (&acc)[8], const uint4& u, const float*) {
  acc[0] += __uint_as_float(u.x);
  acc[1] += __uint_as_float(u.y);
  acc[2] += __uint_as_float(u.z);
  acc[3] += __uint_as_float(u.w);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store16_cs(bf16* p, const float (&acc)[8]) {
  const uint32_t a = pack2(acc[0], acc[1]), b = pack2(acc[2], acc[3]), c = pack2(acc[4], acc[5]),
                 d = pack2(acc[6], acc[7]);
  asm volatile("st.global.cs.v4.b32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(a), "r"(b), "r"(c),
               "r"(d)
               : "memory");
}

__device__ __forceinline__ void store16_cs(float* p, const float (&acc)[8]) {
  asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p), "f"(acc[0]),
               "f"(acc[1]), "f"(acc[2]), "f"(acc[3])
               : "memory");
}

// A row's ids, one lane each: lane 0 the command, lanes 1..11 the argument
// slots (as table rows: arg + 1), lane 12 the group (-1 where unused).
__device__ __forceinline__ int row_id(const int* __restrict__ cmd, const int* __restrict__ args,
                                      const int* __restrict__ groups, long long row, int lane,
                                      int use_group) {
  if (lane == 0) return __ldg(cmd + row);
  if (lane <= HOPPER_ARGS) return __ldg(args + row * HOPPER_ARGS + lane - 1) + 1;
  if (lane == HOPPER_ARGS + 1 && use_group) return __ldg(groups + row);
  return -1;
}

// What a row reads besides its prefix: the PAD rows and the position rows
// (shared memory, or the position rows from L2), the argument and group
// tables (L2), and the row's position and group.
template <class T>
struct Slots {
  const uint4* hot;
  const uint4* pad_rows;
  const T* arg_t;
  const T* group_t;
  const T* pos_t;
  const uint4* pos_rows;
  int D, row16, vocab, n_group, pos_in_smem, pos, g_id;
};

// slots J0..J1-1 added to acc in order, their rows requested before the
// first add
template <class T, int J0, int J1>
__device__ __forceinline__ void add_slots(float (&acc)[8], const int (&a_id)[HOPPER_ARGS],
                                          const Slots<T>& sl, int c) {
  uint4 raw[J1 - J0];
#pragma unroll
  for (int i = J0; i < J1; ++i) {
    raw[i - J0] = make_uint4(0u, 0u, 0u, 0u);
    if (a_id[i] == 0) raw[i - J0] = sl.pad_rows[(size_t)i * sl.row16 + c];
    if (a_id[i] > 0 && a_id[i] < sl.vocab)
      raw[i - J0] = __ldg(reinterpret_cast<const uint4*>(
                              sl.arg_t + ((size_t)i * sl.vocab + a_id[i]) * sl.D) + c);
  }
#pragma unroll
  for (int i = J0; i < J1; ++i)
    if (a_id[i] >= 0 && a_id[i] < sl.vocab) add16(acc, raw[i - J0], (const T*)nullptr);
}

// slots J0..10 (J0 >= 5), the group and the position added to acc in that
// order, all their rows requested before the first add
template <class T, int J0>
__device__ __forceinline__ void finish_row(float (&acc)[8], const int (&a_id)[HOPPER_ARGS],
                                           const Slots<T>& sl, int c) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 raw[HOPPER_ARGS - J0 + 1], graw = zero, praw;
#pragma unroll
  for (int i = J0; i < HOPPER_ARGS; ++i) {
    raw[i - J0] = zero;
    if (a_id[i] == 0) raw[i - J0] = sl.pad_rows[(size_t)i * sl.row16 + c];
    if (a_id[i] > 0 && a_id[i] < sl.vocab)
      raw[i - J0] = __ldg(reinterpret_cast<const uint4*>(
                              sl.arg_t + ((size_t)i * sl.vocab + a_id[i]) * sl.D) + c);
  }
  if (sl.g_id >= 0 && sl.g_id < sl.n_group)
    graw = __ldg(reinterpret_cast<const uint4*>(sl.group_t + (size_t)sl.g_id * sl.D) + c);
  praw = sl.pos_in_smem
             ? sl.pos_rows[(size_t)sl.pos * sl.row16 + c]
             : __ldg(reinterpret_cast<const uint4*>(sl.pos_t + (size_t)sl.pos * sl.D) + c);
#pragma unroll
  for (int i = J0; i < HOPPER_ARGS; ++i)
    if (a_id[i] >= 0 && a_id[i] < sl.vocab) add16(acc, raw[i - J0], (const T*)nullptr);
  if (sl.g_id >= 0 && sl.g_id < sl.n_group) add16(acc, graw, (const T*)nullptr);
  add16(acc, praw, (const T*)nullptr);
}

// The sum's first terms are the same for every row with the same command
// whose first slots are PAD: 0 + CmdT[c] + PadT_0 + ... + PadT_{J-1}. Each
// block adds them once, in that order, for J = 5, 9, 11 (float32, exact as
// a row would add them), and a row starts from the longest that its first
// non-PAD slot allows; the sum goes on in the same order from slot J.
// Shared memory: float prefix[n_cmd][3][D], then the rows of the tables'
// type: the n_cmd command rows, the HOPPER_ARGS PAD rows, and the S position
// rows if pos_in_smem.
__device__ __forceinline__ int prefix_j(int k) { return k == 0 ? 5 : k == 1 ? 9 : 11; }

template <class T>
__global__ void __launch_bounds__(HOPPER_WARPS * 32, 3)
    embedding_hopper_kernel(const int* __restrict__ cmd, const int* __restrict__ args,
                            const int* __restrict__ groups, const T* __restrict__ cmd_t,
                            const T* __restrict__ arg_t, const T* __restrict__ group_t,
                            const T* __restrict__ pos_t, T* __restrict__ out, long long rows,
                            int S, int D, int vocab, int n_cmd, int n_group, int use_group,
                            int pos_in_smem) {
  extern __shared__ uint4 smem16[];
  constexpr int N = Vec16<T>::N;
  const int row16 = D / N;  // 16-byte pieces a row
  float* prefix = reinterpret_cast<float*>(smem16);
  uint4* hot = smem16 + (size_t)n_cmd * 3 * D / 4;
  const int n_hot = n_cmd + HOPPER_ARGS + (pos_in_smem ? S : 0);
  for (int i = threadIdx.x; i < n_hot * row16; i += blockDim.x) {
    const int r = i / row16, c = i - r * row16;
    const T* src = r < n_cmd                 ? cmd_t + (size_t)r * D
                   : r < n_cmd + HOPPER_ARGS ? arg_t + (size_t)(r - n_cmd) * vocab * D
                                             : pos_t + (size_t)(r - n_cmd - HOPPER_ARGS) * D;
    hot[i] = __ldg(reinterpret_cast<const uint4*>(src) + c);
  }
  __syncthreads();
  const T* hot_t = reinterpret_cast<const T*>(hot);
  for (int i = threadIdx.x; i < n_cmd * D; i += blockDim.x) {
    const int c = i / D, col = i - c * D;
    float acc = 0.f;
    acc += to_f(hot_t[(size_t)c * D + col]);
#pragma unroll
    for (int j = 0; j < HOPPER_ARGS; ++j) {
      acc += to_f(hot_t[(size_t)(n_cmd + j) * D + col]);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (j + 1 == prefix_j(k)) prefix[((size_t)c * 3 + k) * D + col] = acc;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * HOPPER_WARPS;
  long long row = (long long)blockIdx.x * HOPPER_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  int pos = (int)(row % S);
  const int pos_step = (int)(stride % S);
  const uint4* pad_rows = hot + (size_t)n_cmd * row16;
  const uint4* pos_rows = pad_rows + (size_t)HOPPER_ARGS * row16;
  // the ids of this row and the next three of the warp, in flight ahead of
  // their use (each row's ids come from device memory once)
  int id = row_id(cmd, args, groups, row, lane, use_group), id1 = -1, id2 = -1, id3 = -1;
  if (row + stride < rows) id1 = row_id(cmd, args, groups, row + stride, lane, use_group);
  if (row + 2 * stride < rows) id2 = row_id(cmd, args, groups, row + 2 * stride, lane, use_group);
  if (row + 3 * stride < rows) id3 = row_id(cmd, args, groups, row + 3 * stride, lane, use_group);
  for (; row < rows; row += stride) {
    const int c_id = __shfl_sync(FULL_MASK, id, 0);
    int a_id[HOPPER_ARGS];
#pragma unroll
    for (int i = 0; i < HOPPER_ARGS; ++i) a_id[i] = __shfl_sync(FULL_MASK, id, 1 + i);
    const int g_id = __shfl_sync(FULL_MASK, id, HOPPER_ARGS + 1);
    // the row's first non-PAD slot, and the prefix it starts from (k < 0:
    // none, the sum starts at 0 with the command, if any, at slot 0)
    const unsigned pads = __ballot_sync(FULL_MASK, lane >= 1 && lane <= HOPPER_ARGS && id == 0);
    const int first = __ffs(~pads >> 1) - 1;   // slots 0..first-1 PAD
    const bool cmd_ok = c_id >= 0 && c_id < n_cmd;
    const int k = !cmd_ok ? -1 : first >= 11 ? 2 : first >= 9 ? 1 : first >= 5 ? 0 : -1;
    id = id1;
    id1 = id2;
    id2 = id3;
    if (row + 4 * stride < rows) id3 = row_id(cmd, args, groups, row + 4 * stride, lane, use_group);
    const Slots<T> sl{hot, pad_rows, arg_t, group_t, pos_t, pos_rows, D, row16, vocab, n_group,
                      pos_in_smem, pos, g_id};
    for (int c = lane; c < row16; c += 32) {
      // the row's path by its prefix, a branch the whole warp takes: a
      // padding row adds the prefix, the group and the position; a line the
      // prefix and two slots; and so on
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (k >= 0) {
        const float4* src =
            reinterpret_cast<const float4*>(prefix + ((size_t)c_id * 3 + k) * D + (size_t)c * N);
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          const float4 v = src[q];
          acc[4 * q] = v.x;
          acc[4 * q + 1] = v.y;
          acc[4 * q + 2] = v.z;
          acc[4 * q + 3] = v.w;
        }
      }
      if (k == 2) {
        finish_row<T, 11>(acc, a_id, sl, c);
      } else if (k == 1) {
        finish_row<T, 9>(acc, a_id, sl, c);
      } else if (k == 0) {
        finish_row<T, 5>(acc, a_id, sl, c);
      } else {
        if (cmd_ok) add16(acc, hot[(size_t)c_id * row16 + c], (const T*)nullptr);
        add_slots<T, 0, 5>(acc, a_id, sl, c);  // rare: fewer registers, two waits
        finish_row<T, 5>(acc, a_id, sl, c);
      }
      store16_cs(out + (size_t)row * D + (size_t)c * N, acc);
    }
    pos += pos_step;
    if (pos >= S) pos -= S;
  }
}

template <class T>
int launch_hopper(const int* cmd, const int* args, const int* groups, const T* cmd_t,
                  const T* arg_t, const T* group_t, const T* pos_t, T* out, long long rows,
                  int S, int D, int vocab, int n_cmd, int n_group, int use_group,
                  int pos_in_smem, int smem, cudaStream_t stream) {
  static int max_set = 0;  // the dynamic shared memory cap, raised once
  if (!max_set) {
    cudaError_t err = cudaFuncSetAttribute(embedding_hopper_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           HOT_SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    max_set = 1;
  }
  static int occ_smem = -1, occ = 0;  // blocks an SM at the last shared memory size
  if (occ_smem != smem) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, embedding_hopper_kernel<T>, HOPPER_WARPS * 32, smem);
    if (err != cudaSuccess) return (int)err;
    occ_smem = smem;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (rows + HOPPER_WARPS - 1) / HOPPER_WARPS;
  const int blocks = (int)std::min<long long>(need, (long long)sms * std::max(occ, 1));
  embedding_hopper_kernel<T><<<blocks, HOPPER_WARPS * 32, smem, stream>>>(
      cmd, args, groups, cmd_t, arg_t, group_t, pos_t, out, rows, S, D, vocab, n_cmd, n_group,
      use_group, pos_in_smem);
  return (int)cudaGetLastError();
}

}  // namespace

// is_f32: the tables and the output are float, else bf16 (the older kernel)
extern "C" int dsvg_embedding(const void* cmd, const void* args,
                              const void* groups, const void* cmd_t,
                              const void* arg_t, const void* group_t,
                              const void* pos_t, void* out, long long rows,
                              int S, int D, int n_args, int vocab, int n_cmd,
                              int n_group, int use_group, int is_f32, void* stream) {
  const int threads = 256;
  const long long work = rows * (D / 2);
  const unsigned blocks = (unsigned)((work + threads - 1) / threads);
  if (is_f32)
    embedding_kernel<float><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)cmd, (const int*)args, (const int*)groups, (const float*)cmd_t,
        (const float*)arg_t, (const float*)group_t, (const float*)pos_t, (float*)out, rows,
        S, D, n_args, vocab, n_cmd, n_group, use_group);
  else
    embedding_kernel<bf16><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)cmd, (const int*)args, (const int*)groups, (const bf16*)cmd_t,
        (const bf16*)arg_t, (const bf16*)group_t, (const bf16*)pos_t, (bf16*)out, rows, S,
        D, n_args, vocab, n_cmd, n_group, use_group);
  return (int)cudaGetLastError();
}

// The Hopper kernel: D a multiple of 64, 11 argument slots, every pointer
// 16-byte aligned; `smem` bytes of shared memory hold the hot rows (the
// wrapper's plan: n_cmd + 11 rows, and the S position rows if pos_in_smem).
extern "C" int dsvg_embedding_hopper(const void* cmd, const void* args, const void* groups,
                                     const void* cmd_t, const void* arg_t, const void* group_t,
                                     const void* pos_t, void* out, long long rows, int S, int D,
                                     int vocab, int n_cmd, int n_group, int use_group,
                                     int pos_in_smem, int smem, int is_f32, void* stream) {
  if (D % 64 || smem > HOT_SMEM_MAX || S < 1) return (int)cudaErrorInvalidValue;
  if (is_f32)
    return launch_hopper<float>((const int*)cmd, (const int*)args, (const int*)groups,
                                (const float*)cmd_t, (const float*)arg_t, (const float*)group_t,
                                (const float*)pos_t, (float*)out, rows, S, D, vocab, n_cmd,
                                n_group, use_group, pos_in_smem, smem, (cudaStream_t)stream);
  return launch_hopper<bf16>((const int*)cmd, (const int*)args, (const int*)groups,
                             (const bf16*)cmd_t, (const bf16*)arg_t, (const bf16*)group_t,
                             (const bf16*)pos_t, (bf16*)out, rows, S, D, vocab, n_cmd, n_group,
                             use_group, pos_in_smem, smem, (cudaStream_t)stream);
}
