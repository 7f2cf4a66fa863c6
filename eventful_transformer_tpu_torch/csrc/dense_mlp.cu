// The dense block's MLP half, written for Hopper.
//
// Replaces eventful_transformer_tpu/ops/pallas/dense_mlp.py::
// dense_mlp_residual:
//
//   xl = rnd(ln(x))                       float32 LN, rounded to the weights
//   h  = rnd(gelu(xl @ W1 + b1))          float32 sum, bias and GELU
//   y  = rnd(rnd(h @ W2 + b2) + x)
//
// The TPU kernel keeps a 256-row block of the (N, 4C) hidden in VMEM; here
// the hidden (B, N, 4C) makes one round trip through device memory, like
// the MLP of kernel C (gate_group.cu). Three launches: the LN row pass into
// a (B, N, C) scratch (ln_select_kernel with no coverage), GEMM1 with the
// bias + GELU epilogue, and GEMM2 with the bias + residual epilogue. The two
// GEMMs are the time, bound like every GEMM of gemm.cuh by the simple
// tile's shared-memory traffic.
#include "common.cuh"
#include "gemm.cuh"

namespace etk {

// y[m, c] = rnd(rnd(acc + b2[c]) + x[m, c])      (dense_mlp.py:38-43)
template <typename T>
struct ResidualEpilogue {
  const T* bias;
  const T* x;
  T* out;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    const int64_t i = (int64_t)m * ld + n;
    out[i] = from_f<T>(rnd<T>(acc + to_f(bias[n])) + to_f(x[i]));
  }
};

template <typename T>
int dense_mlp_residual(const void* x, const void* ln_scale, const void* ln_bias, const void* w1,
                       const void* b1, const void* w2, const void* b2, void* y, void* xl,
                       void* h, int rows, int c, int hidden, cudaStream_t stream) {
  ln_select_kernel<T><<<rows, kRowThreads, row_smem_bytes(c), stream>>>(
      (const T*)x, (T*)xl, nullptr, (const T*)ln_scale, (const T*)ln_bias, c);
  ETK_CHECK_LAUNCH();
  launch_gemm<T>((const T*)xl, DenseRows{}, (const T*)w1, rows, c, hidden,
                 BiasGeluEpilogue<T>{(const T*)b1, (T*)h, hidden}, stream);
  ETK_CHECK_LAUNCH();
  launch_gemm<T>((const T*)h, DenseRows{}, (const T*)w2, rows, hidden, c,
                 ResidualEpilogue<T>{(const T*)b2, (const T*)x, (T*)y, c}, stream);
  ETK_CHECK_LAUNCH();
  return 0;
}

}  // namespace etk

extern "C" int etk_dense_mlp_residual(int dtype, const void* x, const void* ln_scale,
                                      const void* ln_bias, const void* w1, const void* b1,
                                      const void* w2, const void* b2, void* y, void* xl, void* h,
                                      int rows, int c, int hidden, void* stream) {
  ETK_DISPATCH(dtype, return etk::dense_mlp_residual<T>(x, ln_scale, ln_bias, w1, b1, w2, b2, y,
                                                        xl, h, rows, c, hidden,
                                                        (cudaStream_t)stream));
}
