// K4 backward, first launch: everything of the layer's backward that is local
// to a row or a sequence (see ops/layer_vjp.py). The device code is in
// layer_bwd.cuh, which K7's stack backward (stack.cu) runs too.
#include "layer_bwd.cuh"

using namespace layer_bwd;

namespace {

template <class T, int ROWS>
__global__ void __launch_bounds__(NTHREADS) layer_bwd_kernel(BwdParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  layer_bwd_tile<T, ROWS>(p, smem);
}

template <class T, int ROWS>
int launch(BwdParams<T> p, cudaStream_t stream) {
  p.nseq = ROWS / p.S;
  const size_t smem = smem_bytes<T, ROWS>(p.D, p.F);
  cudaError_t err = cudaFuncSetAttribute(layer_bwd_kernel<T, ROWS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.B + p.nseq - 1) / p.nseq;
  layer_bwd_kernel<T, ROWS><<<blocks, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
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
