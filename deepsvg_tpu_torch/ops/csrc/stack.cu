// K7's older kernels: an L-layer stack of fused training layers, forward in
// one launch and the row-local part of the backward in one launch (see
// ops/stack_vjp.py). The stack runs here only at widths the cluster kernels
// (stack_cluster.cu) do not take: F not a multiple of D, or a cluster block
// over the shared memory a block can use; the wrapper chooses from the
// shapes before the launch and counts these launches apart.
//
// Every part of a layer is local to a row except attention, which stays
// inside one sequence. So a block that owns whole sequences runs all L layers
// of its rows in a loop, with no synchronisation across blocks: the TPU
// kernel's sequential (L,) grid becomes this loop. Each layer is K4's older
// device code (layer_fwd.cuh, layer_bwd.cuh) on the same rows per block, with
// the layer's weights, saved tensors and outputs at offsets of [L, ...]
// buffers and the dropout seed stack_layer_seed(seed, l).
//
// The activation between two layers is rounded to the activation type and
// goes through global memory: layer l writes the rows of its block, and layer
// l + 1 of the same block reads them back after a __syncthreads() (the rows
// stay in L2). The forward keeps each layer's input for the backward; the
// backward carries the gradient between layers the same way, in reverse.
#include "layer_bwd.cuh"
#include "layer_fwd.cuh"

namespace {

template <class T, int ROWS>
__global__ void __launch_bounds__(NTHREADS)
    stack_fwd_kernel(layer_fwd::LayerParams<T> base, T* xs, int L, int rows_pad, int seed) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t B = base.B, S = base.S, D = base.D, F = base.F, H = base.H;
  const size_t rows = B * S;
  for (int l = 0; l < L; ++l) {
    layer_fwd::LayerParams<T> p = base;
    p.x = l == 0 ? base.x : xs + (size_t)(l - 1) * rows * D;
    p.out = l == L - 1 ? base.out : xs + (size_t)l * rows * D;
    p.seq_bias = base.seq_bias + l * B * D;
    p.ln1 = base.ln1 + l * 2 * D;
    p.wqkv = base.wqkv + l * 3 * D * D;
    p.bqkv = base.bqkv + l * 3 * D;
    p.wo = base.wo + l * D * D;
    p.bo = base.bo + l * D;
    p.ln2 = base.ln2 + l * 2 * D;
    p.w1 = base.w1 + l * F * D;
    p.b1 = base.b1 + l * F;
    p.w2 = base.w2 + l * D * F;
    p.b2 = base.b2 + l * D;
    p.qkv_s = base.qkv_s + l * rows * 3 * D;
    p.p_s = base.p_s + l * B * H * S * S;
    p.ctx_s = base.ctx_s + l * (size_t)rows_pad * D;
    p.x1_s = base.x1_s + l * rows * D;
    p.h_s = base.h_s + l * rows * F;
    p.seed = stack_layer_seed(seed, l);
    layer_fwd::layer_tile<T, ROWS, true>(p, smem);
    __syncthreads();
  }
}

// the stack's own pointers beside those of one layer's backward
template <class T>
struct StackBwd {
  const T* x;    // the stack input (layer 0's)
  const T* xs;   // [L-1][rows][D]: the inputs of layers 1..L-1
  const T* g;    // the gradient of the stack output
  T* dx;         // the gradient of the stack input
  T* dcur;       // [L-1][rows][D]: dcur[l], the gradient of layer l's output
  int L, rows_pad, seed;
};

template <class T, int ROWS>
__global__ void __launch_bounds__(NTHREADS)
    stack_bwd_kernel(layer_bwd::BwdParams<T> base, StackBwd<T> st) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t B = base.B, S = base.S, D = base.D, F = base.F, H = base.H;
  const size_t rows = B * S, rp = st.rows_pad;
  const int L = st.L;
  for (int l = L - 1; l >= 0; --l) {
    layer_bwd::BwdParams<T> p = base;
    p.x = l == 0 ? st.x : st.xs + (size_t)(l - 1) * rows * D;
    p.g = l == L - 1 ? st.g : st.dcur + (size_t)l * rows * D;
    p.dx = l == 0 ? st.dx : st.dcur + (size_t)(l - 1) * rows * D;
    p.ln1 = base.ln1 + l * 2 * D;
    p.wqkv = base.wqkv + l * 3 * D * D;
    p.wo = base.wo + l * D * D;
    p.ln2 = base.ln2 + l * 2 * D;
    p.w1 = base.w1 + l * F * D;
    p.w2 = base.w2 + l * D * F;
    p.qkv_s = base.qkv_s + l * rows * 3 * D;
    p.p_s = base.p_s + l * B * H * S * S;
    p.ctx_s = base.ctx_s + l * rp * D;
    p.x1_s = base.x1_s + l * rows * D;
    p.h_s = base.h_s + l * rows * F;
    p.dbias = base.dbias + l * B * D;
    p.xn1_o = base.xn1_o + l * rp * D;
    p.dqkv_o = base.dqkv_o + l * rp * 3 * D;
    p.da_o = base.da_o + l * rp * D;
    p.xn2_o = base.xn2_o + l * rp * D;
    p.dhpre_o = base.dhpre_o + l * rp * F;
    p.hd_o = base.hd_o + l * rp * F;
    p.df_o = base.df_o + l * rp * D;
    p.small_part = base.small_part + l * (9 * D + F);
    p.seed = stack_layer_seed(st.seed, l);
    layer_bwd::layer_bwd_tile<T, ROWS>(p, smem);
    __syncthreads();
  }
}

template <class T, int ROWS>
int launch_fwd(void* const* t, int L, int B, int S, int D, int F, int H, int causal,
               int seed, int thr, float kp, float scale, cudaStream_t stream) {
  layer_fwd::LayerParams<T> p = layer_fwd::make_params<T>(
      t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7], t[8], t[9], t[10], t[11], t[12], t[13],
      B, S, D, F, H, causal, scale);
  p.qkv_s = (T*)t[15];
  p.p_s = (T*)t[16];
  p.ctx_s = (T*)t[17];
  p.x1_s = (float*)t[18];
  p.h_s = (T*)t[19];
  p.thr = (unsigned)thr;
  p.kp = kp;
  p.nseq = ROWS / S;
  const size_t smem = layer_fwd::smem_bytes<T, ROWS>(D, F);
  cudaError_t err = cudaFuncSetAttribute(stack_fwd_kernel<T, ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + p.nseq - 1) / p.nseq;
  const int rows_pad = (B * S + 15) / 16 * 16;
  stack_fwd_kernel<T, ROWS><<<blocks, NTHREADS, smem, stream>>>(p, (T*)t[14], L, rows_pad,
                                                                 seed);
  return (int)cudaGetLastError();
}

template <class T, int ROWS>
int launch_bwd(void* const* t, int L, int B, int S, int D, int F, int H, int seed, int thr,
               float kp, float scale, cudaStream_t stream) {
  layer_bwd::BwdParams<T> p;
  p.x = p.g = nullptr;
  p.dx = nullptr;
  p.ln1 = (const T*)t[3];
  p.wqkv = (const T*)t[4];
  p.wo = (const T*)t[5];
  p.ln2 = (const T*)t[6];
  p.w1 = (const T*)t[7];
  p.w2 = (const T*)t[8];
  p.qkv_s = (const T*)t[9];
  p.p_s = (const T*)t[10];
  p.ctx_s = (const T*)t[11];
  p.x1_s = (const float*)t[12];
  p.h_s = (const T*)t[13];
  p.dbias = (float*)t[16];
  p.xn1_o = (T*)t[17];
  p.dqkv_o = (T*)t[18];
  p.da_o = (T*)t[19];
  p.xn2_o = (T*)t[20];
  p.dhpre_o = (T*)t[21];
  p.hd_o = (T*)t[22];
  p.df_o = (T*)t[23];
  p.small_part = (float*)t[24];
  p.small_stride = (long long)L * (9 * D + F);
  p.B = B;
  p.S = S;
  p.D = D;
  p.F = F;
  p.H = H;
  p.nseq = ROWS / S;
  p.seed = seed;
  p.thr = (unsigned)thr;
  p.kp = kp;
  p.scale = scale;
  StackBwd<T> st;
  st.x = (const T*)t[0];
  st.xs = (const T*)t[1];
  st.g = (const T*)t[2];
  st.dx = (T*)t[14];
  st.dcur = (T*)t[15];
  st.L = L;
  st.rows_pad = (B * S + 15) / 16 * 16;
  st.seed = seed;
  const size_t smem = layer_bwd::smem_bytes<T, ROWS>(D, F);
  cudaError_t err = cudaFuncSetAttribute(stack_bwd_kernel<T, ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + p.nseq - 1) / p.nseq;
  stack_bwd_kernel<T, ROWS><<<blocks, NTHREADS, smem, stream>>>(p, st);
  return (int)cudaGetLastError();
}

}  // namespace

// Stack forward. `t`: x, bias [L][B][D], ln1, wqkv, bqkv, wo, bo, ln2, w1, b1,
// w2, b2 (each [L][...]), mask [B][S], out, xs [L-1][rows][D], and the saved
// qkv [L][rows][3D], p [L][B][H][S][S], ctx [L][rows_pad][D], x1 (f32)
// [L][rows][D], h [L][rows][F]; rows = B*S, rows_pad = rows rounded up to 16.
extern "C" int dsvg_stack_train_fwd(void* const* t, int L, int B, int S, int D, int F, int H,
                                    int causal, int is_f32, int seed, int thr, float kp,
                                    float scale, void* stream) {
  if (is_f32)
    return launch_fwd<float, 32>(t, L, B, S, D, F, H, causal, seed, thr, kp, scale,
                                 (cudaStream_t)stream);
  return launch_fwd<bf16, 64>(t, L, B, S, D, F, H, causal, seed, thr, kp, scale,
                              (cudaStream_t)stream);
}

// Stack backward, row-local part. `t`: x, xs, g, ln1, wqkv, wo, ln2, w1, w2,
// the five saved tensors, dx, dcur [L-1][rows][D], dbias (f32) [L][B][D], the
// product operands xn1, dqkv, da, xn2, dhpre, hd, df (each [L][rows_pad][...]),
// and the per-block column sums (f32) [blocks][L][9D + F].
extern "C" int dsvg_stack_train_bwd(void* const* t, int L, int B, int S, int D, int F, int H,
                                    int is_f32, int seed, int thr, float kp, float scale,
                                    void* stream) {
  if (is_f32)
    return launch_bwd<float, 16>(t, L, B, S, D, F, H, seed, thr, kp, scale,
                                 (cudaStream_t)stream);
  return launch_bwd<bf16, 32>(t, L, B, S, D, F, H, seed, thr, kp, scale,
                              (cudaStream_t)stream);
}
