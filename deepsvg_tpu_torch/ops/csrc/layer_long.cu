// K2, long form (see ops/layer.py): one fused pre-LN layer over sequences of
// up to 256 rows in two launches. The device code is in layer_long.cuh,
// which K4's long form (layer_long_train.cu) compiles with its training
// switch.
#include "layer_long.cuh"

using namespace layer_long;

// S <= MAX_SEQ_LONG, head dim HEAD_DIM; qkv: scratch [B*S][3D] of the
// activation type. is_f32: activations and weights are float (TF32
// products), else bf16.
extern "C" int dsvg_layer_long(const void* x, const void* seq_bias, const void* ln1,
                               const void* wqkv, const void* bqkv, const void* wo,
                               const void* bo, const void* ln2, const void* w1,
                               const void* b1, const void* w2, const void* b2,
                               const void* mask, void* qkv, void* out, int B, int S, int D,
                               int F, int H, int causal, int is_f32, float scale,
                               void* stream) {
  if (S < 1 || S > MAX_SEQ_LONG) return (int)cudaErrorInvalidValue;
  if (is_f32)
    return launch_forward<float, 32, 32, false>(
        make_params<float>(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask,
                           out, B, S, D, F, H, causal, scale),
        (float*)qkv, (cudaStream_t)stream);
  return launch_forward<bf16, 64, 64, false>(
      make_params<bf16>(x, seq_bias, ln1, wqkv, bqkv, wo, bo, ln2, w1, b1, w2, b2, mask, out,
                        B, S, D, F, H, causal, scale),
      (bf16*)qkv, (cudaStream_t)stream);
}
