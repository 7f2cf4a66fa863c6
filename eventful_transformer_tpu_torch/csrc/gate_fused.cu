// The fused gate-group kernels of the gate-fusion regimes "v1", "v1v2" and
// "v3", written for Hopper.
//
// ln_select_matmul replaces eventful_transformer_tpu/ops/pallas/gate_fused.py::
// ln_select_matmul in its "post", "none" and "pre" forms:
//
//   p' = where(cov, ln(x) | x, p)          (in place, rounded to p's dtype)
//   y  = rnd(p' W + wb)                    (every row; float32 sums and bias)
//   y  = rnd(ln(p') W + wb)                ("pre", gate_fused.py:79-81)
//
// select_linear_skip_norms replaces gate_fused.py::select_linear_skip_norms,
// the projection group of "v3":
//
//   p'    = where(cov, x, p)                               (in place)
//   y     = rnd(rnd(p' W + wb) + skip)                     (gate_fused.py:169-172)
//   norms = ||ln(y) * scale + bias - p_next||, y rounded   (the MLP gate's)
//   norms = ||y - p_next||                                  (next_ln=False)
//
// The TPU kernels hold a 256-row block of x, p and the whole W in VMEM and
// feed p' to the MXU without a round trip. Here the simple first version:
// the select row pass of common.cuh (one 256-thread block per token row,
// p' written in place), then the tiled GEMM of gemm.cuh over all rows of
// p' (a dense recompute, as the TPU kernel does; it reads p' back from
// device memory, in W's dtype, which the wrappers require p to have) with
// the bias (and skip) epilogue, and for select_linear_skip_norms a third
// launch, the ln_norms row pass (next_ln=False: the plain difference norm)
// over the rounded y. At ViViT-B (12 views, N = 197, C = 768) the qkv GEMM
// (2364 x 768 x 2304, 8.4 G multiply-adds) dominates; the row passes move x
// and p once (7 MB in bf16).
//
// "pre" normalises every row of p' before the GEMM, and p' is stored
// nowhere else: an LN row pass (the ln_select_kernel with every row
// selected) writes ln(p') in W's dtype to a scratch that the GEMM reads.
// The TPU kernel normalises its float32 p'; x and p share one dtype (the
// wrapper checks it), so that equals the stored p' the pass reads back.
// The extra pass moves 2 x N x C elements, as much as the select pass.
#include "common.cuh"
#include "gemm.cuh"

namespace etk {

// y[m, n] = rnd(rnd(acc + wb[n]) + skip[m, n])
template <typename T>
struct BiasSkipEpilogue {
  const T* bias;
  const T* skip;
  T* out;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    const int64_t i = (int64_t)m * ld + n;
    out[i] = from_f<T>(rnd<T>(acc + to_f(bias[n])) + to_f(skip[i]));
  }
};

template <typename T>
void select_rows_pass(const T* x, T* p, const float* cov, const T* scale, const T* bias,
                      int64_t rows, int c, cudaStream_t stream) {
  if (scale != nullptr) {
    ln_select_kernel<T><<<(unsigned)rows, kRowThreads, row_smem_bytes(c), stream>>>(
        x, p, cov, scale, bias, c);
  } else {
    select_rows_kernel<T><<<(unsigned)rows, kRowThreads, 0, stream>>>(x, p, cov, c);
  }
}

}  // namespace etk

extern "C" {

// ln_mode 0 "none", 1 "post", 2 "pre" (ops/common.py::LN_MODES);
// scale, bias null for "none"; a, the (rows, c) scratch of ln(p'), null
// but for "pre"
int etk_ln_select_matmul(int dtype, const void* x, void* p, const void* cov, const void* scale,
                         const void* bias, const void* w, const void* wb, void* y, void* a,
                         long long rows, int c, int f, int ln_mode, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  ETK_DISPATCH(dtype, {
    etk::select_rows_pass<T>((const T*)x, (T*)p, (const float*)cov,
                             ln_mode == 1 ? (const T*)scale : nullptr, (const T*)bias, rows, c, s);
    ETK_CHECK_LAUNCH();
    const T* mm_in = (const T*)p;
    if (ln_mode == 2) {
      etk::ln_select_kernel<T><<<(unsigned)rows, etk::kRowThreads, etk::row_smem_bytes(c), s>>>(
          (const T*)p, (T*)a, nullptr, (const T*)scale, (const T*)bias, c);
      ETK_CHECK_LAUNCH();
      mm_in = (const T*)a;
    }
    etk::launch_gemm<T>(mm_in, etk::DenseRows{}, (const T*)w, (int)rows, c, f,
                        etk::BiasEpilogue<T>{(const T*)wb, (T*)y, f}, s);
    ETK_CHECK_LAUNCH();
    return 0;
  });
}

// scale, bias null with next_ln == 0
int etk_select_linear_skip_norms(int dtype, const void* x, void* p, const void* cov,
                                 const void* w, const void* wb, const void* skip,
                                 const void* p_next, const void* scale, const void* bias, void* y,
                                 void* norms, long long rows, int c, int f, int next_ln,
                                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  ETK_DISPATCH(dtype, {
    etk::select_rows_pass<T>((const T*)x, (T*)p, (const float*)cov, nullptr, nullptr, rows, c, s);
    ETK_CHECK_LAUNCH();
    etk::launch_gemm<T>((const T*)p, etk::DenseRows{}, (const T*)w, (int)rows, c, f,
                        etk::BiasSkipEpilogue<T>{(const T*)wb, (const T*)skip, (T*)y, f}, s);
    ETK_CHECK_LAUNCH();
    if (next_ln) {
      etk::ln_norms_kernel<T><<<(unsigned)rows, etk::kRowThreads, etk::row_smem_bytes(f), s>>>(
          (const T*)y, (const T*)p_next, (const T*)scale, (const T*)bias, (float*)norms, f);
    } else {
      etk::diff_norms_kernel<T><<<(unsigned)rows, etk::kRowThreads, 32 * sizeof(float), s>>>(
          (const T*)y, (const T*)p_next, (float*)norms, f);
    }
    ETK_CHECK_LAUNCH();
    return 0;
  });
}

}  // extern "C"
