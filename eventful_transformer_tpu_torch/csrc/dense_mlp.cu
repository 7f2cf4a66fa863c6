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
// a (B, N, C) scratch (row_pass.cuh's select with no coverage, in the body
// ``row_body`` the wrapper passes), GEMM1 with the
// bias + GELU epilogue, and GEMM2 with the bias + residual epilogue (one
// more each where the plan splits K). The two GEMMs are the time: in
// bfloat16 they run on the wgmma core of gemm_tc.cuh, bound by the tensor
// cores' rate, with the (B, N, 4C) hidden's round trip (100 MB at
// ViTDet-1024) and the LN pass the bytes beside it; in float32 (and for
// shapes gemm_tc.cuh does not take) on gemm.cuh's tile, bound by its
// shared-memory traffic. The wrapper picks the core
// (ops/gemm_core.py::gemm_core) and the split of each GEMM's K steps.
#include "common.cuh"
#include "gemm.cuh"
#include "gemm_tc.cuh"
#include "row_pass.cuh"

namespace etk {

// y[m, c] = rnd(rnd(acc + b2[c]) + x[m, c])      (dense_mlp.py:38-43)
template <typename T>
struct ResidualEpilogue {
  const T* bias;
  const T* x;
  T* out;
  int ld;
  using Loaded = float2;  // (bias, x)
  __device__ __forceinline__ float2 load(int m, int n) const {
    return make_float2(to_f(bias[n]), to_f(x[(int64_t)m * ld + n]));
  }
  __device__ __forceinline__ void store(int m, int n, float acc, float2 bx) const {
    out[(int64_t)m * ld + n] = from_f<T>(rnd<T>(acc + bx.x) + bx.y);
  }
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    store(m, n, acc, load(m, n));
  }
};

template <typename T>
int dense_mlp_residual(int row_body, const void* x, const void* ln_scale, const void* ln_bias,
                       const void* w1, const void* b1, const void* w2, const void* b2, void* y,
                       void* xl, void* h, int rows, int c, int hidden, GemmCall gemm1,
                       GemmCall gemm2, cudaStream_t stream) {
  int err = launch_select<T>(row_body, (const T*)x, (T*)xl, nullptr, (const T*)ln_scale,
                             (const T*)ln_bias, rows, c, stream);
  if (err != 0) return err;
  err = launch_gemm_core<T, false>((const T*)xl, rows, DenseRows{}, (const T*)w1, rows, c,
                                   hidden, BiasGeluEpilogue<T>{(const T*)b1, (T*)h, hidden},
                                   gemm1, stream);
  if (err != 0) return err;
  return launch_gemm_core<T, false>((const T*)h, rows, DenseRows{}, (const T*)w2, rows, hidden, c,
                                    ResidualEpilogue<T>{(const T*)b2, (const T*)x, (T*)y, c},
                                    gemm2, stream);
}

}  // namespace etk

// core: ops/gemm_core.py CORE_CODES, both GEMMs; split1, split2: each
// GEMM's split of its K steps; ws: the float32 workspace of the larger
// split (null when neither splits); row_body: the LN pass's body
// (ops/row_pass.py ROW_BODY_CODES).
extern "C" int etk_dense_mlp_residual(int dtype, int row_body, const void* x, const void* ln_scale,
                                      const void* ln_bias, const void* w1, const void* b1,
                                      const void* w2, const void* b2, void* y, void* xl, void* h,
                                      int rows, int c, int hidden, int core, int split1,
                                      int split2, void* ws, void* stream) {
  const etk::GemmCall gemm1{core, split1, (float*)ws}, gemm2{core, split2, (float*)ws};
  ETK_DISPATCH(dtype, return etk::dense_mlp_residual<T>(row_body, x, ln_scale, ln_bias, w1, b1, w2,
                                                        b2, y, xl, h, rows, c, hidden, gemm1,
                                                        gemm2, (cudaStream_t)stream));
}
