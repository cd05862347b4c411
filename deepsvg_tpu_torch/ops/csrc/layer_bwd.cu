// K4 backward, first launch: everything of the layer's backward that is local
// to a row or a sequence (see ops/layer_vjp.py). The device code is in
// layer_bwd.cuh, which K7's stack backward (stack.cu) runs too. In the
// recompute mode a launch of the forward tile (layer_fwd.cuh, FWD_WORKSPACE)
// comes first and fills the layer's workspace.
#include "layer_bwd.cuh"
#include "layer_fwd.cuh"

using namespace layer_bwd;

namespace {

template <class T, int ROWS, bool RECOMPUTE>
__global__ void __launch_bounds__(NTHREADS) layer_bwd_kernel(BwdParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  layer_bwd_tile<T, ROWS, RECOMPUTE>(p, smem);
}

template <class T, int ROWS, bool RECOMPUTE = false>
int launch(BwdParams<T> p, cudaStream_t stream) {
  p.nseq = ROWS / p.S;
  const size_t smem = smem_bytes<T, ROWS>(p.D, p.F);
  cudaError_t err = cudaFuncSetAttribute(layer_bwd_kernel<T, ROWS, RECOMPUTE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.B + p.nseq - 1) / p.nseq;
  layer_bwd_kernel<T, ROWS, RECOMPUTE><<<blocks, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <class T, int ROWS>
__global__ void __launch_bounds__(NTHREADS) workspace_kernel(layer_fwd::LayerParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  layer_fwd::layer_tile<T, ROWS, true, layer_fwd::FWD_WORKSPACE>(p, smem);
}

// The recompute mode: the forward tile fills the workspace (QKV, context,
// x1, f32 hidden; FROWS rows a block, as the forward), then the backward
// tile recomputes the probabilities (BROWS rows a block).
template <class T, int FROWS, int BROWS>
int launch_recompute(void* const* t, int B, int S, int D, int F, int H, int causal, int seed,
                     int thr, float kp, float scale, cudaStream_t stream) {
  layer_fwd::LayerParams<T> f = layer_fwd::make_params<T>(
      t[0], t[24], t[2], t[3], t[25], t[4], t[26], t[5], t[6], t[27], t[7], t[28], t[29],
      nullptr, B, S, D, F, H, causal, scale);
  f.qkv_s = (T*)t[8];
  f.ctx_s = (T*)t[10];
  f.x1_s = (float*)t[11];
  f.h32 = (float*)t[23];
  f.seed = seed;
  f.thr = (unsigned)thr;
  f.kp = kp;
  f.nseq = FROWS / S;
  const size_t smem = layer_fwd::smem_bytes<T, FROWS>(D, F);
  cudaError_t err = cudaFuncSetAttribute(workspace_kernel<T, FROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  workspace_kernel<T, FROWS><<<(B + f.nseq - 1) / f.nseq, NTHREADS, smem, stream>>>(f);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  BwdParams<T> p = make_params<T>(t, B, S, D, F, H, seed, thr, kp, scale);
  p.h32 = (const float*)t[23];
  p.mask = (const float*)t[29];
  p.causal = causal;
  return launch<T, BROWS, true>(p, stream);
}

}  // namespace

// Rows per block, so that the wrapper can size the per-block partial sums.
extern "C" int dsvg_layer_bwd_rows(int is_f32) { return is_f32 ? 16 : 32; }

// `tensors`: the 23 device pointers of BwdParams, in its order.
extern "C" int dsvg_layer_train_bwd(void* const* tensors, int B, int S, int D, int F,
                                    int H, int is_f32, int seed, int thr, float kp,
                                    float scale, void* stream) {
  if (is_f32)
    return launch<float, 16>(make_params<float>(tensors, B, S, D, F, H, seed, thr, kp, scale),
                             (cudaStream_t)stream);
  return launch<bf16, 32>(make_params<bf16>(tensors, B, S, D, F, H, seed, thr, kp, scale),
                          (cudaStream_t)stream);
}

// The recompute mode. `tensors`: the 23 pointers of BwdParams, where QKV, the
// context (16-row padded) and x1 are this layer's workspace, written here, and
// the saved probabilities and hidden are not read; then the f32 hidden [rows][F]
// (workspace), seq_bias (or null), bqkv, bo, b1, b2 and the mask [B][S].
extern "C" int dsvg_layer_train_bwd_recompute(void* const* tensors, int B, int S, int D,
                                              int F, int H, int causal, int is_f32, int seed,
                                              int thr, float kp, float scale, void* stream) {
  if (is_f32)
    return launch_recompute<float, 32, 16>(tensors, B, S, D, F, H, causal, seed, thr, kp,
                                           scale, (cudaStream_t)stream);
  return launch_recompute<bf16, 64, 32>(tensors, B, S, D, F, H, causal, seed, thr, kp, scale,
                                        (cudaStream_t)stream);
}
