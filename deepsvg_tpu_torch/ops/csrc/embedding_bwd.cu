// K6: gradients of the embedding tables, a scatter-add of dy rows
// (see ops/embedding.py).
//
//   dcmd[cmd] += dy[row]; darg[i * vocab + arg_i + 1] += dy[row];
//   dgroup[gid] += dy[row]; dpos[row % S] += dy[row]
//
// Replaces deepsvg_tpu/ops/embedding.py:_embed_bwd_kernel, whose sequential
// grid sums in one order on every run. Here every sum is taken in an order
// fixed by the inputs alone, with no float atomics, no sort and no zero fill:
// the same inputs give the same tables to the bit, and every element of the
// four tables is written once. What bounds the op on the H100 is reading dy
// once (16.8 MB at the flagship's B=128, 5 us); the table rows are few.
//
// One launch of a persistent grid, every block resident (a cooperative
// launch), in two phases with one grid-wide barrier between them. Tokens come
// in blocks of 128, or of 256 above 132 x 128 tokens (the last block ragged;
// the size is the wrapper's, fixed by the token count); a table row is
//   hot:  a command row, or a slot's PAD row (arg = -1 -> row i * vocab);
//   cold: any other argument row, or a group row (R = n_args * vocab +
//         n_group of them, numbered as darg's rows, then dgroup's).
// Phase 1, a block a token block at a time:
// * the hot rows' sums over the token block: eight groups of tb / 8 tokens,
//   each thread four columns and HOT_G hot rows in registers (a token's hot
//   rows as bits), summed in token order; the groups' sums are added in
//   group order through shared memory and written to `part` [token
//   block][hot row][D];
// * the cold entries sorted by row within the token block, in token order
//   (a counting sort): one warp a slot ranks the slot's tokens 32 at a time
//   with __match_any_sync, in token order, counting in shared memory (a
//   slot's rows are its own, so no two warps touch one counter); an
//   exclusive scan of the counts gives each row's first place; each entry's
//   token goes to `list` [token block][place] and the scan to `lp` [R +
//   1][token block];
// * a row's entries in the block, where there are at least LONG, summed in
//   chunks of CHUNK in token order into `seg`, the chunk's first place in
//   `list` marked with its slot.
// Phase 2, a warp a unit of work, each warp taking the next unit when free
// (an integer counter; which warp sums a unit changes nothing in its sums):
// * a cold row: its items in token-block order (a short segment's tokens'
//   dy rows, a long one's chunk sums), eight at a time, summed in that order
//   (eight columns a lane);
// * a position row's eight columns: lane l sums sequences l, l + 32, ... in
//   order, then the lanes' sums are added in a fixed butterfly;
// * a hot row's eight columns: lane l sums token blocks l, l + 32, ... of
//   `part` in order, then the same butterfly.
// An id outside [0, table rows) adds nothing. The grid barrier's counters
// live in this module, so one K6 runs at a time on a card (the port runs one
// stream).
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int GROUPS = 8;                 // token groups of the hot sums
constexpr int QUADS = THREADS / GROUPS;   // four-column quads a pass: 256 columns
constexpr int HOT_G = 9;                  // hot rows in registers at a time
constexpr int LONG = 8;                   // a block's entries of one row summed in phase 1
constexpr int CHUNK = 32;                 // entries of such a row a warp sums at a time
constexpr int STAMPS = 8;                 // clock readings a block (see dsvg_embedding_bwd)
constexpr int ITEMS = 512;                // a warp's buffer of a cold row's items in phase 2

struct Params {
  const int* cmd;     // [rows]
  const int* args;    // [rows][n_args]
  const int* groups;  // [rows] (use_group)
  const void* dy;     // [rows][D], bf16 or float
  float* dcmd;        // [n_cmd][D]
  float* darg;        // [n_args * vocab][D]
  float* dgroup;      // [n_group][D]
  float* dpos;        // [S][D]
  float* part;        // [ntb][n_cmd + n_args][D]
  int* lp;            // [R + 1][ntb]
  int* list;          // [ntb][tb * per]
  float* seg;         // [ntb][tb * per / LONG][D] the sums of a block's long segments
  unsigned long long* stamps;  // [n_stamps][STAMPS] or null: each block's phase times
  long long rows;
  int S, D, n_args, vocab, n_cmd, n_group, use_group, ntb, R, per, n_stamps;
  int tb;             // tokens a token block: 128, or 256 above 132 x 128 tokens
};

__device__ __forceinline__ void stamp(const Params& p, int k) {
  if (p.stamps != nullptr && threadIdx.x == 0 && (int)blockIdx.x < p.n_stamps) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.stamps[blockIdx.x * STAMPS + k] = t;
  }
}

__device__ unsigned k6_arrived = 0;
__device__ unsigned k6_generation = 0;
__device__ unsigned k6_next_unit = 0;  // phase 2's units are taken in turn

// every block of the grid waits here until all have arrived; what a block
// wrote before is seen by every block after (read it with ld.global.cg)
__device__ __forceinline__ void grid_barrier() {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = &k6_generation;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(&k6_arrived, 1u) == gridDim.x - 1) {
      atomicExch(&k6_arrived, 0u);
      __threadfence();
      atomicAdd(&k6_generation, 1u);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// eight columns of a dy row, added to acc
__device__ __forceinline__ void add8(float (&acc)[8], const bf16* p) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc[2 * k] += __uint_as_float(w[k] << 16);
    acc[2 * k + 1] += __uint_as_float(w[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void add8(float (&acc)[8], const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  acc[0] += a.x; acc[1] += a.y; acc[2] += a.z; acc[3] += a.w;
  acc[4] += b.x; acc[5] += b.y; acc[6] += b.z; acc[7] += b.w;
}

__device__ __forceinline__ void load8(float (&v)[8], const bf16* p) {
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = 0.f;
  add8(v, p);
}
__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = 0.f;
  add8(v, p);
}

__device__ __forceinline__ void store8(float* dst, const float (&acc)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

// the lanes' acc added in a fixed butterfly; lane 0 writes the sum
__device__ __forceinline__ void butterfly_store(float (&acc)[8], float* dst, int lane) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] += __shfl_xor_sync(FULL_MASK, acc[j], o);
  if (lane == 0) store8(dst, acc);
}

// exclusive scan of a[0..n) in place, by the whole block
__device__ void block_scan(int* a, int n, int* warp_sums) {
  const int per_thread = (n + THREADS - 1) / THREADS;
  const int i0 = min(n, (int)threadIdx.x * per_thread), i1 = min(n, i0 + per_thread);
  int own = 0;
  for (int i = i0; i < i1; ++i) own += a[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < WARPS ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL_MASK, w, o);
      if (lane >= o) w += v;
    }
    if (lane < WARPS) warp_sums[lane] = w;
  }
  __syncthreads();
  int run = incl - own + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int i = i0; i < i1; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
}

// shared memory of phase 1 (the wrapper sizes it: ops/embedding.py k6_plan)
struct Shared {
  unsigned* bits;  // [tb] each token's hot rows
  int* keys;       // [tb][per] each entry's cold row, or -1
  int* rank;       // [tb][per] its place among its row's entries of the block
  int* cnt;        // [R + 1] the block's count of each cold row, then its scan
  int* list;       // [tb * per] the block's entries' tokens, ordered by row
  float* comb;     // [GROUPS][HOT_G][QUADS * 4]
  int* warp_sums;  // [WARPS]
};

__device__ Shared carve(unsigned char* smem, const Params& p) {
  Shared s;
  s.bits = reinterpret_cast<unsigned*>(smem);
  s.keys = reinterpret_cast<int*>(s.bits + p.tb);
  s.rank = s.keys + p.tb * p.per;
  s.cnt = s.rank + p.tb * p.per;
  s.list = s.cnt + ((p.R + 1 + 3) & ~3);
  s.comb = reinterpret_cast<float*>(s.list + p.tb * p.per);
  s.warp_sums = reinterpret_cast<int*>(s.comb + GROUPS * HOT_G * QUADS * 4);
  return s;
}

template <class T>
__device__ void hot_sums(const Params& p, int tb, long long t0, int nt, const Shared& s) {
  const T* dy = static_cast<const T*>(p.dy);
  const int n_hot = p.n_cmd + p.n_args;
  const int q = threadIdx.x / QUADS, cq = threadIdx.x % QUADS;
  const int per_group = p.tb / GROUPS;
  const int k1 = max(0, min(per_group, nt - q * per_group));  // this group's tokens
  for (int c0 = 0; c0 < p.D; c0 += QUADS * 4) {
    const int col = c0 + cq * 4;
    const bool on = col < p.D;
    for (int g0 = 0; g0 < n_hot; g0 += HOT_G) {
      float acc[HOT_G][4];
#pragma unroll
      for (int r = 0; r < HOT_G; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
      if (on) {
        for (int k = 0; k < k1; k += 4) {
          float4 v[4];
          unsigned m[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = q * per_group + k + u;
            const bool in = k + u < k1;
            v[u] = in ? load4(dy + (size_t)(t0 + i) * p.D + col) : make_float4(0.f, 0.f, 0.f, 0.f);
            m[u] = in ? s.bits[i] >> g0 : 0u;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int r = 0; r < HOT_G; ++r)
              if ((m[u] >> r) & 1u) {
                acc[r][0] += v[u].x;
                acc[r][1] += v[u].y;
                acc[r][2] += v[u].z;
                acc[r][3] += v[u].w;
              }
        }
      }
      __syncthreads();  // the last readers of comb are done
      if (on)
#pragma unroll
        for (int r = 0; r < HOT_G; ++r)
          reinterpret_cast<float4*>(s.comb)[(q * HOT_G + r) * QUADS + cq] =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      __syncthreads();
      for (int u = threadIdx.x; u < HOT_G * QUADS; u += THREADS) {
        const int r = u / QUADS, cq2 = u - r * QUADS, col2 = c0 + cq2 * 4;
        const int row = g0 + r;
        if (col2 >= p.D || row >= n_hot) continue;
        const float4* src = reinterpret_cast<const float4*>(s.comb);
        float4 sum = src[r * QUADS + cq2];
        for (int q2 = 1; q2 < GROUPS; ++q2) {
          const float4 v = src[(q2 * HOT_G + r) * QUADS + cq2];
          sum.x += v.x;
          sum.y += v.y;
          sum.z += v.z;
          sum.w += v.w;
        }
        *reinterpret_cast<float4*>(p.part + ((size_t)tb * n_hot + row) * p.D + col2) = sum;
      }
    }
  }
}

// `first`: the block's first token block, whose steps are stamped
template <class T>
__device__ void token_block(const Params& p, int tb, const Shared& s, bool first) {
  const long long t0 = (long long)tb * p.tb;
  const int nt = (int)min((long long)p.tb, p.rows - t0);
  const int arg_rows = p.n_args * p.vocab;
  {  // the block's dy rows toward L2 while the ids are staged and ranked
    const char* base = static_cast<const char*>(p.dy) + (size_t)t0 * p.D * sizeof(T);
    const size_t bytes = (size_t)nt * p.D * sizeof(T);
    for (size_t o = (size_t)threadIdx.x * 128; o < bytes; o += (size_t)THREADS * 128)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(base + o));
  }
  // the block's argument ids, read once with every thread (s.list is free
  // until the scatter below)
  for (int i = threadIdx.x; i < nt * p.n_args; i += THREADS)
    s.list[i] = p.args[t0 * p.n_args + i];
  __syncthreads();
  for (int i = threadIdx.x; i < p.tb; i += THREADS) {
    unsigned m = 0;
    int* key = s.keys + i * p.per;
    for (int j = 0; j < p.per; ++j) key[j] = -1;
    if (i < nt) {
      const long long t = t0 + i;
      const int c = p.cmd[t];
      if (c >= 0 && c < p.n_cmd) m |= 1u << c;
      for (int j = 0; j < p.n_args; ++j) {
        const int a = s.list[i * p.n_args + j];
        if (a == -1)
          m |= 1u << (p.n_cmd + j);
        else if (a >= 0 && a + 1 < p.vocab)
          key[j] = j * p.vocab + a + 1;
      }
      if (p.use_group) {
        const int g = p.groups[t];
        if (g >= 0 && g < p.n_group) key[p.n_args] = arg_rows + g;
      }
    }
    s.bits[i] = m;
  }
  for (int i = threadIdx.x; i <= p.R; i += THREADS) s.cnt[i] = 0;
  __syncthreads();
  if (first) stamp(p, 1);
  // each entry's place among its row's entries of the block, in token order
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < p.per) {
    for (int i0 = 0; i0 < p.tb; i0 += 32) {
      const int e = (i0 + lane) * p.per + warp;
      const int key = s.keys[e];
      const unsigned same = __match_any_sync(FULL_MASK, key);
      const int before = __popc(same & ((1u << lane) - 1u));
      const int base = key >= 0 ? s.cnt[key] : 0;
      __syncwarp();
      if (key >= 0) {
        s.rank[e] = base + before;
        if (before == 0) s.cnt[key] = base + __popc(same);
      }
      __syncwarp();
    }
  }
  hot_sums<T>(p, tb, t0, nt, s);  // its barriers also put the ranking before the scan
  if (first) stamp(p, 2);
  block_scan(s.cnt, p.R + 1, s.warp_sums);
  __syncthreads();
  for (int i = threadIdx.x; i <= p.R; i += THREADS) p.lp[(size_t)i * p.ntb + tb] = s.cnt[i];
  const int n_entries = s.cnt[p.R];
  for (int e = threadIdx.x; e < p.tb * p.per; e += THREADS) {
    const int key = s.keys[e];
    if (key >= 0) s.list[s.cnt[key] + s.rank[e]] = (int)(t0 + e / p.per);
  }
  __syncthreads();
  // a row's segment of at least LONG entries is summed here in chunks of
  // CHUNK entries (the last one takes the rest, so every chunk has at least
  // LONG), each in token order; a chunk's sum goes to the slot start / LONG
  // of `seg` (chunks at least LONG apart: no two share one), and its first
  // list place to -(slot + 1). The long rows are queued (in any order: each
  // chunk's sum is its own), then chunk j of queue entry e is summed by warp
  // (j * queued + e) % 16
  if (first) stamp(p, 7);
  int* queue = s.rank;          // free since the scatter
  int* queued = s.warp_sums;    // free since the scan
  if (threadIdx.x == 0) *queued = 0;
  __syncthreads();
  for (int e = threadIdx.x; e < p.tb * p.per; e += THREADS) {
    const int key = s.keys[e];
    if (key >= 0 && s.list[s.cnt[key]] == (int)(t0 + e / p.per) &&
        s.cnt[key + 1] - s.cnt[key] >= LONG)
      queue[atomicAdd(queued, 1)] = key;  // the segment's first entry queues its row
  }
  __syncthreads();
  const int n_queued = *queued;
  const T* dy = static_cast<const T*>(p.dy);
  for (int u = warp; u < n_queued * (p.tb / CHUNK); u += WARPS) {
    const int r = queue[u % n_queued], jj = u / n_queued;
    const int nn = s.cnt[r + 1] - s.cnt[r];
    if (jj >= max(1, nn / CHUNK)) continue;
    const int b = s.cnt[r] + jj * CHUNK;
    const int len = jj == max(1, nn / CHUNK) - 1 ? nn - jj * CHUNK : CHUNK;
    float* dst = p.seg + ((size_t)tb * (p.tb * p.per / LONG) + b / LONG) * p.D;
    for (int c0 = 0; c0 < p.D; c0 += 256) {
      const int col = c0 + lane * 8;
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (col < p.D) {
        for (int i = 0; i < len; i += 8) {
          float v[8][8];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (i + q < len) load8(v[q], dy + (size_t)s.list[b + i + q] * p.D + col);
#pragma unroll
          for (int q = 0; q < 8; ++q)
            if (i + q < len)
#pragma unroll
              for (int c = 0; c < 8; ++c) acc[c] += v[q][c];
        }
        store8(dst + col, acc);
      }
    }
  }
  __syncthreads();  // every chunk read its tokens; now mark the chunks
  for (int u = threadIdx.x; u < n_queued * (p.tb / CHUNK); u += THREADS) {
    const int row = queue[u % n_queued], j = u / n_queued;
    const int n = s.cnt[row + 1] - s.cnt[row];
    if (j < max(1, n / CHUNK)) {
      const int b = s.cnt[row] + j * CHUNK;
      s.list[b] = -(b / LONG + 1);
    }
  }
  __syncthreads();
  if (first) stamp(p, 3);
  int* list = p.list + (size_t)tb * p.tb * p.per;
  for (int i = threadIdx.x; i < n_entries; i += THREADS) list[i] = s.list[i];
  __syncthreads();  // the next token block reuses the shared arrays
}

// the items of a cold row's sum, in order, in a warp's buffer of shared
// memory: a token (its dy row) or -(slot + 1) (a long segment's sum in
// phase 1), with its token block; added to acc eight at a time, the eight
// rows requested before the first add
template <class T>
__device__ void add_items(const Params& p, float (&acc)[8], const int* items, const int* tbs,
                          int n, int col) {
  const T* dy = static_cast<const T*>(p.dy);
  const size_t seg_slots = (size_t)p.tb * p.per / LONG;
  for (int i0 = 0; i0 < n; i0 += 8) {
    float v[8][8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (i0 + j < n) {
        const int it = items[i0 + j];
        if (it < 0) {
          const float4* src = reinterpret_cast<const float4*>(
              p.seg + ((size_t)tbs[i0 + j] * seg_slots + (-it - 1)) * p.D + col);
          const float4 x = __ldcg(src), y = __ldcg(src + 1);
          v[j][0] = x.x; v[j][1] = x.y; v[j][2] = x.z; v[j][3] = x.w;
          v[j][4] = y.x; v[j][5] = y.y; v[j][6] = y.z; v[j][7] = y.w;
        } else {
          load8(v[j], dy + (size_t)it * p.D + col);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (i0 + j < n)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[c] += v[j][c];
  }
}

// a cold row, eight columns a lane: its places in 4 x 32 token blocks and
// each busy block's first entry are read together, the blocks' items
// written in order to the warp's buffer (ITEMS of them; a short segment
// brings its tokens, a long one its sum), then added
template <class T>
__device__ void cold_row(const Params& p, int r, int lane, int* items, int* tbs) {
  const int arg_rows = p.n_args * p.vocab;
  if (r < arg_rows && r % p.vocab == 0) return;  // a PAD row: hot
  float* dst = r < arg_rows ? p.darg + (size_t)r * p.D : p.dgroup + (size_t)(r - arg_rows) * p.D;
  constexpr int ROUNDS = 4;
  for (int c0 = 0; c0 < p.D; c0 += 256) {
    const int col = c0 + lane * 8;
    const bool on = col < p.D;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int n_items = 0;
    for (int tb00 = 0; tb00 < p.ntb; tb00 += 32 * ROUNDS) {
      int bs[ROUNDS], ns[ROUNDS], firsts[ROUNDS];
#pragma unroll
      for (int q = 0; q < ROUNDS; ++q) {
        const int tb = tb00 + q * 32 + lane;
        bs[q] = ns[q] = 0;
        if (tb < p.ntb) {
          bs[q] = __ldcg(p.lp + (size_t)r * p.ntb + tb);
          ns[q] = __ldcg(p.lp + (size_t)(r + 1) * p.ntb + tb) - bs[q];
        }
      }
#pragma unroll
      for (int q = 0; q < ROUNDS; ++q)
        firsts[q] = ns[q] > 0
                        ? __ldcg(p.list + (size_t)(tb00 + q * 32 + lane) * p.tb * p.per + bs[q])
                        : 0;
#pragma unroll
      for (int q = 0; q < ROUNDS; ++q) {
        const int tb = tb00 + q * 32 + lane;
        // items: a short segment's tokens, or a long one's chunk sums
        const bool sums = firsts[q] < 0;
        const int mine = ns[q] == 0 ? 0 : sums ? max(1, ns[q] / CHUNK) : ns[q];
        int off = mine;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int t = __shfl_up_sync(FULL_MASK, off, o);
          if (lane >= o) off += t;
        }
        const int total = __shfl_sync(FULL_MASK, off, 31);
        if (total == 0) continue;
        if (n_items + total > ITEMS) {  // a round brings at most 32 x max(LONG - 1, 4)
          __syncwarp();
          if (on) add_items<T>(p, acc, items, tbs, n_items, col);
          n_items = 0;
          __syncwarp();
        }
        off = n_items + off - mine;
        if (mine > 0) {
          items[off] = firsts[q];
          tbs[off] = tb;
          const int* list = p.list + (size_t)tb * p.tb * p.per + bs[q];
          for (int t = 1; t < mine; ++t) {
            items[off + t] = __ldcg(list + (sums ? t * CHUNK : t));
            tbs[off + t] = tb;
          }
        }
        n_items += total;
      }
    }
    __syncwarp();
    if (on) {
      add_items<T>(p, acc, items, tbs, n_items, col);
      store8(dst + col, acc);
    }
    __syncwarp();
  }
}

// a position row's eight columns
template <class T>
__device__ void pos_cols(const Params& p, int unit, int lane) {
  const T* dy = static_cast<const T*>(p.dy);
  const int octs = p.D / 8;
  const int sp = unit / octs, col = (unit - sp * octs) * 8;
  const long long nseq = p.rows / p.S;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (long long b0 = lane; b0 < nseq; b0 += 8 * 32) {
    float v[8][8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (b0 + 32 * u < nseq) load8(v[u], dy + ((b0 + 32 * u) * p.S + sp) * p.D + col);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (b0 + 32 * u < nseq)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] += v[u][j];
  }
  butterfly_store(acc, p.dpos + (size_t)sp * p.D + col, lane);
}

// a hot row's eight columns: the token blocks' sums
__device__ void hot_cols(const Params& p, int unit, int lane) {
  const int octs = p.D / 8, n_hot = p.n_cmd + p.n_args;
  const int h = unit / octs, col = (unit - h * octs) * 8;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int tb = lane; tb < p.ntb; tb += 32) {
    const float4* src =
        reinterpret_cast<const float4*>(p.part + ((size_t)tb * n_hot + h) * p.D + col);
    const float4 a = __ldcg(src), b = __ldcg(src + 1);
    acc[0] += a.x; acc[1] += a.y; acc[2] += a.z; acc[3] += a.w;
    acc[4] += b.x; acc[5] += b.y; acc[6] += b.z; acc[7] += b.w;
  }
  float* dst = h < p.n_cmd ? p.dcmd + (size_t)h * p.D
                           : p.darg + (size_t)(h - p.n_cmd) * p.vocab * p.D;
  butterfly_store(acc, dst + col, lane);
}

template <class T>
__global__ void __launch_bounds__(THREADS, 1)
    embedding_bwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Shared s = carve(smem, p);
  stamp(p, 0);
  if (blockIdx.x == 0 && threadIdx.x == 0) k6_next_unit = 0;  // read after the barrier
  for (int tb = blockIdx.x; tb < p.ntb; tb += gridDim.x)
    token_block<T>(p, tb, s, tb == (int)blockIdx.x);
  stamp(p, 4);
  grid_barrier();
  stamp(p, 5);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int octs = p.D / 8;
  const int n_cold = p.R, n_pos = p.S * octs, n_hot = (p.n_cmd + p.n_args) * octs;
  // phase 2 reuses the shared memory: each warp's buffer of items. A warp
  // takes the next unit when it is free (each unit's sums are its own, in
  // a fixed order, whichever warp takes it): the cold rows, of uneven cost,
  // first, then the position and hot units
  int* items = reinterpret_cast<int*>(smem) + (size_t)warp * 2 * ITEMS;
  const int units = n_cold + n_pos + n_hot;
  for (;;) {
    int u = 0;
    if (lane == 0) u = (int)atomicAdd(&k6_next_unit, 1u);
    u = __shfl_sync(FULL_MASK, u, 0);
    if (u >= units) break;
    if (u < n_cold)
      cold_row<T>(p, u, lane, items, items + ITEMS);
    else if (u < n_cold + n_pos)
      pos_cols<T>(p, u - n_cold, lane);
    else
      hot_cols(p, u - n_cold - n_pos, lane);
  }
  __syncthreads();
  stamp(p, 6);
}

template <class T>
int launch(const Params& p, int smem, cudaStream_t stream) {
  static int max_set = 0, occ_smem = -1, occ = 0;
  if (!max_set) {  // the dynamic shared memory cap, raised once
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaError_t err = cudaFuncSetAttribute(embedding_bwd_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return (int)err;
    max_set = 1;
  }
  if (occ_smem != smem) {  // blocks an SM at this shared memory size
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, embedding_bwd_kernel<T>, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    occ_smem = smem;
  }
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  void* kargs[] = {const_cast<Params*>(&p)};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)embedding_bwd_kernel<T>,
                                                dim3(sms * occ), dim3(THREADS), kargs,
                                                (size_t)smem, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// dcmd [n_cmd][D], darg [n_args * vocab][D], dgroup [n_group][D] and dpos
// [S][D] are all written (no zero fill needed). D is a multiple of 8 and
// rows of S. part, lp, list and seg are the wrapper's workspace, `smem`
// bytes of shared memory a block (both from ops/embedding.py k6_plan), where
// R = n_args * vocab + n_group, per = n_args + use_group, tb the tokens a
// block (128 or 256), ntb = ceil(rows / tb). stamps, if not null,
// [n_stamps][8] uint64: for the first n_stamps blocks, the card's clock
// (ns) at the start; in the block's first token block after the ids'
// staging, after the ranking and the hot sums, after the scan, the scatter
// and the long segments; after phase 1; after the barrier; at the end; and
// (slot 7) in the first token block after the scan and the scatter, before
// the long segments.
extern "C" int dsvg_embedding_bwd(const void* cmd, const void* args, const void* groups,
                                  const void* dy, void* dcmd, void* darg, void* dgroup,
                                  void* dpos, void* part, void* lp, void* list, void* seg,
                                  void* stamps, long long rows, int S, int D, int n_args,
                                  int vocab, int n_cmd, int n_group, int use_group, int n_stamps,
                                  int tb, int smem, int is_f32, void* stream) {
  if (D % 8 || S < 1 || rows % S || n_cmd + n_args > 32 || n_args + use_group > WARPS ||
      (tb != 128 && tb != 256))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.cmd = (const int*)cmd;
  p.args = (const int*)args;
  p.groups = (const int*)groups;
  p.dy = dy;
  p.dcmd = (float*)dcmd;
  p.darg = (float*)darg;
  p.dgroup = (float*)dgroup;
  p.dpos = (float*)dpos;
  p.part = (float*)part;
  p.lp = (int*)lp;
  p.list = (int*)list;
  p.seg = (float*)seg;
  p.stamps = (unsigned long long*)stamps;
  p.n_stamps = stamps ? n_stamps : 0;
  p.rows = rows;
  p.S = S;
  p.D = D;
  p.n_args = n_args;
  p.vocab = vocab;
  p.n_cmd = n_cmd;
  p.n_group = n_group;
  p.use_group = use_group;
  p.tb = tb;
  p.ntb = (int)((rows + tb - 1) / tb);
  p.R = n_args * vocab + n_group;
  p.per = n_args + use_group;
  if (is_f32) return launch<float>(p, smem, (cudaStream_t)stream);
  return launch<bf16>(p, smem, (cudaStream_t)stream);
}
