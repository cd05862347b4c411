// K3: command + argument heads with a first-index argmax per slot, logits
// never stored (see ops/head.py).
//
// Replaces deepsvg_tpu/ops/head.py:_head_kernel (wrapper fused_head_argmax).
// What bounds it on the H100 is the tensor cores: at the flagship's N=1024
// (R = 253,952 rows) the heads are 2 R D C = 368 GFLOP (C = 2,834 real
// columns), 0.37 ms at 989 TFLOP/s bf16, 0.74 ms at 495 TFLOP/s TF32; the
// inputs are 130 MB (0.04 ms).
//
// The head arrives packed per slot (ops/head.py:pack_head): slot 0 (the
// commands) is round16(n_cmd) columns, slot i >= 1 (argument i - 1)
// round16(vocab), each a row of D weights; columns past a slot's valid ones
// are masked by index and cannot win.
//
// Design: K5's forward (ce.cu) with its log-sum-exp replaced by a running
// (max, first index). A persistent grid of blocks of two consumer
// warpgroups and one producer warp. A work item is (tile of 128 MT rows,
// slot), each warpgroup owning 64 MT of the rows (MT = 2 in bf16 where the
// tiles fill the card, else 1); a block takes a run of consecutive items,
// tile-major, so the tile's x stays in shared memory across its slots and is
// loaded by TMA once. The producer streams the slot's head through an
// mbarrier ring of chunks of NC = 128 columns by 128-byte slices of D (a
// slot's last 16 columns as a narrow chunk: 257 classes are 128 + 128 + 16
// columns), each chunk's bias beside its last slice. The consumers multiply
// on wgmma (bf16 m64nNk16, or TF32 m64nNk8 for float), the logits stay in the
// accumulators, the bias is added from the stage, and each thread keeps a
// running (max, first index) for each of its rows over the columns it
// holds, in increasing order (a strict > keeps the first); at the slot's end
// the quad's four are merged by shuffles, ties going to the smaller index
// (jnp.argmax's rule).
//
// TF32: wgmma reads float32 bits as TF32 by dropping the low 13 bits. The
// float form's operands are rounded to nearest first: x in the kernel, each
// warpgroup rounding its own rows of a tile in shared memory (cvt.rna.tf32)
// when the tile arrives; the head by the wrapper, once per packed head.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int THREADS = 384;  // two consumer warpgroups, then the producer's
constexpr int CONSUMERS = 256;
constexpr int NC = 128;       // columns of a full head chunk
constexpr int NARROW = 16;    // columns of a narrow chunk
constexpr int SLICE = 128;    // bytes of K in one row of a TMA box
constexpr uint32_t WBOX = NC * SLICE;
constexpr uint32_t STAGE = WBOX + 1024;  // the head box, then the chunk's bias
constexpr int NO_INDEX = 0x7fffffff;

template <class T>
struct Hd;
template <>
struct Hd<bf16> {
  static constexpr int KS = 64;  // values of K in a 128-byte slice
  static constexpr bool F32 = false;
};
template <>
struct Hd<float> {
  static constexpr int KS = 32;
  static constexpr bool F32 = true;
};

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

struct Args {
  const unsigned char* bias;  // [C] in T
  int* ids;                   // [R][n_args + 1]
  int R, n_cmd, n_args, vocab, dks, nslots, items, stages;
  uint32_t elem;              // bytes of T
  // slot s: its first packed column, width (a multiple of 16) and valid columns
  __device__ __forceinline__ void slot(int s, int& col0, int& width, int& valid) const {
    const int cw = round16(n_cmd), aw = round16(vocab);
    col0 = s == 0 ? 0 : cw + (s - 1) * aw;
    width = s == 0 ? cw : aw;
    valid = s == 0 ? n_cmd : vocab;
  }
  // block b's run of items [first, last)
  __device__ __forceinline__ void run(int& first, int& last) const {
    first = (int)((long long)blockIdx.x * items / gridDim.x);
    last = (int)((long long)(blockIdx.x + 1) * items / gridDim.x);
  }
};

__device__ __forceinline__ int chunk_cols(int width, int j) { return min(NC, width - j * NC); }

struct Layout {
  uint32_t y, ring, bars, total;
  __host__ __device__ Layout(int dks, int mt, int stages) {
    Carve c;
    y = c.take(dks * 128 * mt * SLICE);
    ring = c.take(stages * STAGE);
    bars = c.take((2 + 2 * stages) * 8, 8);
    total = c.off + 1024;
  }
};

// a consumer thread's place (as ce.cu's)
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
  __device__ __forceinline__ int col(int i) const { return 8 * (i >> 2) + 2 * t4 + (i & 1); }
};

// one 128-byte slice of K of the warpgroup's MT row tiles against a chunk
// of N columns: acc[mt] (+)= A_mt[64 x slice] B[N x slice]^T, both K-major
template <class T, int N, int MT>
__device__ __forceinline__ void mma_slice(float (&acc)[MT][N / 2], uint32_t a, uint32_t b,
                                          bool accumulate) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = desc_sw128(a + mt * 64 * SLICE + 32 * kk), db = desc_sw128(b + 32 * kk);
      const int scale = (accumulate || kk > 0) ? 1 : 0;
      if constexpr (Hd<T>::F32) {
        if constexpr (N == NC)
          wgmma_m64n128k8_tf32(acc[mt], da, db, scale);
        else
          wgmma_m64n16k8_tf32(acc[mt], da, db, scale);
      } else {
        if constexpr (N == NC)
          wgmma_m64n128k16_bf16(acc[mt], da, db, scale);
        else
          wgmma_m64n16k16_bf16(acc[mt], da, db, scale);
      }
    }
}

__device__ __forceinline__ float2 bias2(const bf16* b) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b));
}
__device__ __forceinline__ float2 bias2(const float* b) {
  return *reinterpret_cast<const float2*>(b);
}

// one chunk of N columns (chunk j of the slot): its products over the dks
// slices from the ring, then the running (max, first index) of each row the
// thread holds; releases the chunk's stages. MASK: some of the chunk's
// columns lie past the slot's valid ones.
template <class T, int N, int MT, bool MASK>
__device__ __forceinline__ void chunk(const Args& p, const Lane& ln, unsigned char* ring,
                                      uint64_t* wfull, uint64_t* wempty, PipeState& ws,
                                      uint32_t ya, uint32_t box, int j, int valid,
                                      float (&best)[MT][2], int (&bidx)[MT][2]) {
  float acc[MT][N / 2];
  int prev = 0;
  for (int k = 0; k < p.dks; ++k) {
    mbar_wait(&wfull[ws.stage], ws.phase);
    wgmma_fence();
    mma_slice<T, N, MT>(acc, ya + k * box, smem_u32(ring + ws.stage * STAGE), k > 0);
    wgmma_commit();
    if (k > 0) {
      wgmma_wait<1>();
      mbar_arrive(&wempty[prev]);
    }
    prev = ws.stage;
    ws.advance(p.stages);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
  const T* bias = reinterpret_cast<const T*>(ring + prev * STAGE + WBOX);
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {  // the column pair (col(i), col(i) + 1)
    const float2 b = bias2(bias + ln.col(i));
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = j * NC + ln.col(i) + e;
      if (!MASK || c < valid) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const float v = acc[mt][i + e] + (e ? b.y : b.x);
          const int rr = (i >> 1) & 1;
          if (v > best[mt][rr]) {
            best[mt][rr] = v;
            bidx[mt][rr] = c;
          }
        }
      }
    }
  }
  mbar_arrive(&wempty[prev]);
}

template <class T, int MT>
__global__ void __launch_bounds__(THREADS, 1)
    head_kernel(const __grid_constant__ CUtensorMap tmX, const __grid_constant__ CUtensorMap tmW,
                const __grid_constant__ CUtensorMap tmW16, const __grid_constant__ Args p) {
  constexpr int KS = Hd<T>::KS, ROWS = 128 * MT;
  constexpr uint32_t BOX = ROWS * SLICE;
  const Layout L(p.dks, MT, p.stages);
  unsigned char* base = smem_base();
  unsigned char* ybuf = base + L.y;
  unsigned char* ring = base + L.ring;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t *yfull = bars, *yempty = bars + 1, *wfull = bars + 2, *wempty = bars + 2 + p.stages;
  if (threadIdx.x == 0) {
    mbar_init(yfull, 1);
    mbar_init(yempty, CONSUMERS);
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(&wfull[i], 1);
      mbar_init(&wempty[i], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  int first, last;
  p.run(first, last);

  if (threadIdx.x >= CONSUMERS) {  // the producer
    setmaxnreg_dec<40>();
    if (threadIdx.x != CONSUMERS) return;
    PipeState ys, ws;
    for (int item = first; item < last; ++item) {
      const int tile = item / p.nslots, s = item - tile * p.nslots;
      if (item == first || s == 0) {  // a new tile of x
        mbar_wait(yempty, ys.phase ^ 1);
        mbar_arrive_expect_tx(yfull, p.dks * BOX);
        for (int k = 0; k < p.dks; ++k)
          tma_load_2d(ybuf + k * BOX, &tmX, yfull, k * KS, tile * ROWS);
        ys.advance(1);
      }
      int col0, width, valid;
      p.slot(s, col0, width, valid);
      for (int j = 0; j * NC < width; ++j) {
        const int n = chunk_cols(width, j), c = col0 + j * NC;
        const bool narrow = n <= NARROW;
        for (int k = 0; k < p.dks; ++k) {
          unsigned char* st = ring + ws.stage * STAGE;
          const bool last_k = k == p.dks - 1;  // the bias comes with the last slice
          mbar_wait(&wempty[ws.stage], ws.phase ^ 1);
          mbar_arrive_expect_tx(&wfull[ws.stage],
                                (narrow ? NARROW : NC) * SLICE + (last_k ? n * p.elem : 0));
          tma_load_2d(st, narrow ? &tmW16 : &tmW, &wfull[ws.stage], k * KS, c);
          if (last_k)
            bulk_load(st + WBOX, p.bias + (size_t)c * p.elem, n * p.elem, &wfull[ws.stage]);
          ws.advance(p.stages);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const Lane ln;
  const uint32_t ya = smem_u32(ybuf) + ln.h * 64 * MT * SLICE;  // the warpgroup's rows
  PipeState ys, ws;
  for (int item = first; item < last; ++item) {
    const int tile = item / p.nslots, s = item - tile * p.nslots;
    if (item == first || s == 0) {
      mbar_wait(yfull, ys.phase);
      if constexpr (Hd<T>::F32) {
        // round the warpgroup's rows of x to TF32 where they lie
        for (int k = 0; k < p.dks; ++k) {
          float4* r = reinterpret_cast<float4*>(ybuf + k * BOX + ln.h * 64 * MT * SLICE);
          for (int e = ln.wtid; e < 64 * MT * SLICE / 16; e += 128) {
            float4 v = r[e];
            v.x = to_tf32(v.x);
            v.y = to_tf32(v.y);
            v.z = to_tf32(v.z);
            v.w = to_tf32(v.w);
            r[e] = v;
          }
        }
        fence_proxy_async();
        named_barrier(2 + ln.h, 128);
      }
    }
    int col0, width, valid;
    p.slot(s, col0, width, valid);
    float best[MT][2];
    int bidx[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        best[mt][rr] = -INFINITY;
        bidx[mt][rr] = NO_INDEX;
      }
    for (int j = 0; j * NC < width; ++j) {
      if (chunk_cols(width, j) <= NARROW)
        chunk<T, NARROW, MT, true>(p, ln, ring, wfull, wempty, ws, ya, BOX, j, valid, best, bidx);
      else if ((j + 1) * NC <= valid)
        chunk<T, NC, MT, false>(p, ln, ring, wfull, wempty, ws, ya, BOX, j, valid, best, bidx);
      else
        chunk<T, NC, MT, true>(p, ln, ring, wfull, wempty, ws, ya, BOX, j, valid, best, bidx);
    }
    if (item + 1 == last || s + 1 == p.nslots) {  // the tile's last item here
      mbar_arrive(yempty);
      ys.advance(1);
    }
    // merge the quad's four, ties to the smaller index
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float v = best[mt][rr];
        int x = bidx[mt][rr];
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          const float ov = __shfl_xor_sync(FULL_MASK, v, off);
          const int ox = __shfl_xor_sync(FULL_MASK, x, off);
          if (ov > v || (ov == v && ox < x)) {
            v = ov;
            x = ox;
          }
        }
        const int row = tile * ROWS + ln.h * 64 * MT + mt * 64 + ln.r0 + 8 * rr;
        if (ln.t4 == 0 && row < p.R) p.ids[(size_t)row * p.nslots + s] = x == NO_INDEX ? 0 : x;
      }
  }
}

template <class T, int MT>
int launch(const void* x, const void* w, const void* bias, void* ids, int R, int D, int n_cmd,
           int n_args, int vocab, int stages, cudaStream_t stream) {
  constexpr int KS = Hd<T>::KS;
  constexpr bool f32 = Hd<T>::F32;
  Args p;
  p.bias = (const unsigned char*)bias;
  p.ids = (int*)ids;
  p.R = R;
  p.n_cmd = n_cmd;
  p.n_args = n_args;
  p.vocab = vocab;
  p.dks = (D + KS - 1) / KS;
  p.nslots = n_args + 1;
  p.items = (R + 128 * MT - 1) / (128 * MT) * p.nslots;
  p.stages = stages;
  p.elem = sizeof(T);
  const long long C = round16(n_cmd) + (long long)n_args * round16(vocab);
  CUtensorMap tmX, tmW, tmW16;
  int rc = bind_device_of(x);
  if (rc == 0) rc = make_tma_2d(&tmX, x, f32, D, R, (uint64_t)D * sizeof(T), KS, 128 * MT);
  if (rc == 0) rc = make_tma_2d(&tmW, w, f32, D, C, (uint64_t)D * sizeof(T), KS, NC);
  if (rc == 0) rc = make_tma_2d(&tmW16, w, f32, D, C, (uint64_t)D * sizeof(T), KS, NARROW);
  if (rc) return rc;
  const uint32_t smem = Layout(p.dks, MT, stages).total;
  cudaError_t err = cudaFuncSetAttribute(head_kernel<T, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  head_kernel<T, MT><<<std::min(p.items, sm_count()), THREADS, smem, stream>>>(tmX, tmW, tmW16, p);
  return (int)cudaGetLastError();
}

constexpr uint32_t SMEM_MAX = 232448;

// the ring's stages (4, else fewer down to 2) that fit beside the x tile, or 0
inline int stages_for(int dks, int mt) {
  for (int s = 4; s >= 2; --s)
    if (Layout(dks, mt, s).total <= SMEM_MAX) return s;
  return 0;
}

template <class T>
int dispatch(const void* x, const void* w, const void* bias, void* ids, int R, int D, int n_cmd,
             int n_args, int vocab, cudaStream_t stream) {
  const int dks = (D + Hd<T>::KS - 1) / Hd<T>::KS;
  // two row tiles a warpgroup where they fit and still fill the card (bf16)
  if constexpr (!Hd<T>::F32) {
    const int s2 = stages_for(dks, 2);
    if (s2 && (long long)(R + 255) / 256 * (n_args + 1) >= sm_count())
      return launch<T, 2>(x, w, bias, ids, R, D, n_cmd, n_args, vocab, s2, stream);
  }
  const int s1 = stages_for(dks, 1);
  if (!s1) return (int)cudaErrorInvalidValue;
  return launch<T, 1>(x, w, bias, ids, R, D, n_cmd, n_args, vocab, s1, stream);
}

}  // namespace

// is_f32: x, the head and its bias are float (TF32 products; the head
// already rounded to TF32), else bf16. D a multiple of 16; the bias 16-byte
// aligned.
extern "C" int dsvg_head_argmax(const void* x, const void* w, const void* bias,
                                void* ids, int R, int D, int n_cmd, int n_args,
                                int vocab, int is_f32, void* stream) {
  if (D % 16 || R < 1) return (int)cudaErrorInvalidValue;
  if (is_f32)
    return dispatch<float>(x, w, bias, ids, R, D, n_cmd, n_args, vocab, (cudaStream_t)stream);
  return dispatch<bf16>(x, w, bias, ids, R, D, n_cmd, n_args, vocab, (cudaStream_t)stream);
}
