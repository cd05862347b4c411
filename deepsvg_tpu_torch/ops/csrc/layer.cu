// K2 and the forward of K4, saved and recompute mode: one fused pre-LN
// transformer layer per launch (see ops/layer.py and ops/layer_vjp.py). The
// layer's device code is in layer_fwd.cuh, which K7's stack forward
// (stack.cu) and K4's recompute backward (layer_bwd.cu) run too.
#include "layer_fwd.cuh"

using namespace layer_fwd;

namespace {

template <class T, int ROWS, bool TRAIN, int MODE>
__global__ void __launch_bounds__(NTHREADS) layer_kernel(LayerParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  layer_tile<T, ROWS, TRAIN, MODE>(p, smem);
}

template <class T, int ROWS, bool TRAIN, int MODE = FWD_SAVE>
int launch(LayerParams<T> p, cudaStream_t stream) {
  p.nseq = ROWS / p.S;
  const size_t smem = smem_bytes<T, ROWS>(p.D, p.F);
  cudaError_t err = cudaFuncSetAttribute(layer_kernel<T, ROWS, TRAIN, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.B + p.nseq - 1) / p.nseq;
  layer_kernel<T, ROWS, TRAIN, MODE><<<blocks, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Inference layer. is_f32: activations and weights are float (TF32 products),
// else bf16.
extern "C" int dsvg_layer(const void* x, const void* seq_bias, const void* ln1,
                          const void* wqkv, const void* bqkv, const void* wo,
                          const void* bo, const void* ln2, const void* w1,
                          const void* b1, const void* w2, const void* b2,
                          const void* mask, void* out, int B, int S, int D,
                          int F, int H, int causal, int is_f32, float scale,
                          void* stream) {
  if (is_f32)
    return launch<float, 32, false>(
        make_params<float>(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2,
                           mask, out, B, S, D, F, H, causal, scale),
        (cudaStream_t)stream);
  return launch<bf16, 64, false>(
      make_params<bf16>(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                        out, B, S, D, F, H, causal, scale),
      (cudaStream_t)stream);
}

// Training forward: dropout (thr = floor(rate * 2^24), kp = 1 / (1 - rate))
// and the saved tensors.
extern "C" int dsvg_layer_train_fwd(
    const void* x, const void* seq_bias, const void* ln1, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* ln2,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* mask, void* out, void* qkv_s, void* p_s, void* ctx_s, void* x1_s,
    void* h_s, int B, int S, int D, int F, int H, int causal, int is_f32, int seed,
    int thr, float kp, float scale, void* stream) {
  if (is_f32) {
    LayerParams<float> p = make_params<float>(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2,
                                              w1, b1, w2, b2, mask, out, B, S, D, F, H,
                                              causal, scale);
    p.qkv_s = (float*)qkv_s;
    p.p_s = (float*)p_s;
    p.ctx_s = (float*)ctx_s;
    p.x1_s = (float*)x1_s;
    p.h_s = (float*)h_s;
    p.seed = seed;
    p.thr = (unsigned)thr;
    p.kp = kp;
    return launch<float, 32, true>(p, (cudaStream_t)stream);
  }
  LayerParams<bf16> p = make_params<bf16>(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1,
                                          b1, w2, b2, mask, out, B, S, D, F, H, causal,
                                          scale);
  p.qkv_s = (bf16*)qkv_s;
  p.p_s = (bf16*)p_s;
  p.ctx_s = (bf16*)ctx_s;
  p.x1_s = (float*)x1_s;
  p.h_s = (bf16*)h_s;
  p.seed = seed;
  p.thr = (unsigned)thr;
  p.kp = kp;
  return launch<bf16, 64, true>(p, (cudaStream_t)stream);
}

// Training forward of the recompute mode: dropout as dsvg_layer_train_fwd,
// `out` alone written (to the bit the saved mode's). The arguments are
// dsvg_layer_train_fwd's; the five saved-tensor pointers are not read.
extern "C" int dsvg_layer_train_fwd_recompute(
    const void* x, const void* seq_bias, const void* ln1, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* ln2,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* mask, void* out, void*, void*, void*, void*, void*, int B, int S, int D,
    int F, int H, int causal, int is_f32, int seed, int thr, float kp, float scale,
    void* stream) {
  if (is_f32) {
    LayerParams<float> p = make_params<float>(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2,
                                              w1, b1, w2, b2, mask, out, B, S, D, F, H,
                                              causal, scale);
    p.seed = seed;
    p.thr = (unsigned)thr;
    p.kp = kp;
    return launch<float, 32, true, FWD_OUT>(p, (cudaStream_t)stream);
  }
  LayerParams<bf16> p = make_params<bf16>(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1,
                                          b1, w2, b2, mask, out, B, S, D, F, H, causal,
                                          scale);
  p.seed = seed;
  p.thr = (unsigned)thr;
  p.kp = kp;
  return launch<bf16, 64, true, FWD_OUT>(p, (cudaStream_t)stream);
}
