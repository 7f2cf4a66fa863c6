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
// feed p' to the MXU without a round trip. Here each C entry issues its
// stages as separate launches:
//   * the select row pass of row_pass.cuh (select_warp_kernel: one warp a
//     token row, p' written in place at the selected rows; the block body
//     of common.cuh for shapes off its rule, ``row_body``), which moves cov
//     and x and p' at the selected rows;
//   * "pre" only: an LN row pass (the same select with every row
//     selected) writes ln(p') in W's dtype to a scratch, since p' is
//     stored nowhere else. The TPU kernel normalises its float32 p'; x and
//     p share one dtype (the wrapper checks it), so that equals the stored
//     p' the pass reads back. It moves 2 x N x C elements, as much as the
//     select pass;
//   * the GEMM over every row (a dense recompute, as the TPU kernel does)
//     with the bias (and skip) epilogue, on the core the wrapper picks
//     (ops/gemm_core.py::gemm_core): in bfloat16 the wgmma core of
//     gemm_tc.cuh, A by TMA from the gate state the select pass has just
//     written (or from "pre"'s scratch), bound by the tensor cores' rate
//     (the qkv GEMM, 2364 x 768 x 2304 at ViViT-B's 12 views: 8.4 G
//     multiply-adds) or, for the 768-wide projection, by the epilogue's
//     bytes and one wave of 114 tiles; in float32 (and for shapes or views
//     gemm_tc.cuh does not take) gemm.cuh's tile, bound by its
//     shared-memory traffic. A launch the rule would not send to the
//     wgmma core is refused there; there is no fallback;
//   * select_linear_skip_norms only: the ln_norms row pass over the rounded
//     y (next_ln=False: the difference norm, diff_norms_warp_kernel), in
//     the same row body as the select.
// What is left: p' (and "pre"'s ln(p')) makes one round trip through
// device memory between the row pass and the GEMM. The row pass could
// write the GEMM's A tiles straight into shared memory, and "pre"'s LN
// pass could become the GEMM's A producer, which would save the scratch
// and one launch.
#include "common.cuh"
#include "gemm.cuh"
#include "gemm_tc.cuh"
#include "row_pass.cuh"

namespace etk {

// y[m, n] = rnd(rnd(acc + wb[n]) + skip[m, n])   (gate_fused.py:169-172);
// kernel B's ProjEpilogue rounds acc first, this one does not. load() reads
// the operands, store() writes, as gemm.cuh's BiasEpilogue.
template <typename T>
struct BiasSkipEpilogue {
  const T* bias;
  const T* skip;
  T* out;
  int ld;
  using Loaded = float2;  // (bias, skip)
  __device__ __forceinline__ float2 load(int m, int n) const {
    return make_float2(to_f(bias[n]), to_f(skip[(int64_t)m * ld + n]));
  }
  __device__ __forceinline__ void store(int m, int n, float acc, float2 bs) const {
    out[(int64_t)m * ld + n] = from_f<T>(rnd<T>(acc + bs.x) + bs.y);
  }
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    store(m, n, acc, load(m, n));
  }
};

}  // namespace etk

// core: ops/gemm_core.py CORE_CODES; split: the GEMM's split of its K
// steps; ws: its float32 workspace (null unsplit).
extern "C" {

// ln_mode 0 "none", 1 "post", 2 "pre" (ops/common.py::LN_MODES);
// scale, bias null for "none"; a, the (rows, c) scratch of ln(p'), null
// but for "pre"; row_body: the body of the select and LN passes
// (ops/row_pass.py ROW_BODY_CODES)
int etk_ln_select_matmul(int dtype, int row_body, const void* x, void* p, const void* cov,
                         const void* scale, const void* bias, const void* w, const void* wb,
                         void* y, void* a, long long rows, int c, int f, int ln_mode, int core,
                         int split, void* ws, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const etk::GemmCall gemm{core, split, (float*)ws};
  ETK_DISPATCH(dtype, {
    if (!etk::warp_row_takes<T>(row_body, {c}, {x, p, scale, bias, a}))
      return (int)cudaErrorInvalidValue;
    int err = etk::launch_select<T>(row_body, (const T*)x, (T*)p, (const float*)cov,
                                    ln_mode == 1 ? (const T*)scale : nullptr, (const T*)bias,
                                    rows, c, s);
    if (err != 0) return err;
    const T* mm_in = (const T*)p;
    if (ln_mode == 2) {
      err = etk::launch_select<T>(row_body, (const T*)p, (T*)a, nullptr, (const T*)scale,
                                  (const T*)bias, rows, c, s);
      if (err != 0) return err;
      mm_in = (const T*)a;
    }
    return etk::launch_gemm_core<T, false>(mm_in, rows, etk::DenseRows{}, (const T*)w, (int)rows,
                                           c, f, etk::BiasEpilogue<T>{(const T*)wb, (T*)y, f},
                                           gemm, s);
  });
}

// scale, bias null with next_ln == 0; row_body: the body of the select and
// norms passes (ops/row_pass.py ROW_BODY_CODES)
int etk_select_linear_skip_norms(int dtype, int row_body, const void* x, void* p,
                                 const void* cov, const void* w, const void* wb,
                                 const void* skip, const void* p_next, const void* scale,
                                 const void* bias, void* y, void* norms, long long rows, int c,
                                 int f, int next_ln, int core, int split, void* ws,
                                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const etk::GemmCall gemm{core, split, (float*)ws};
  ETK_DISPATCH(dtype, {
    if (!etk::warp_row_takes<T>(row_body, {c, f}, {x, p, y, p_next, scale, bias}))
      return (int)cudaErrorInvalidValue;
    int err = etk::launch_select<T>(row_body, (const T*)x, (T*)p, (const float*)cov, nullptr,
                                    nullptr, rows, c, s);
    if (err != 0) return err;
    err = etk::launch_gemm_core<T, false>(
        (const T*)p, rows, etk::DenseRows{}, (const T*)w, (int)rows, c, f,
        etk::BiasSkipEpilogue<T>{(const T*)wb, (const T*)skip, (T*)y, f}, gemm, s);
    if (err != 0) return err;
    if (next_ln)
      return etk::launch_ln_norms<T>(row_body, (const T*)y, (const T*)p_next,
                                     (const T*)scale, (const T*)bias, (float*)norms, rows, f,
                                     s);
    return etk::launch_diff_norms<T>(row_body, (const T*)y, (const T*)p_next, (float*)norms,
                                     rows, f, s);
  });
}

}  // extern "C"
