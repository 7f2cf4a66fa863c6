// Kernels A and B of the eventful block step, written for Hopper.
//
// Replaces eventful_transformer_tpu/ops/pallas/block_fused.py:
//   * qkv_attention_group (kernel A): p_qkv' = where(cov, ln(x), p_qkv);
//     qkv = rnd(p_qkv' @ Wqkv) + b; H-head softmax attention; proj-gate
//     norms ||attn - p_proj||;
//   * proj_group (kernel B): p_proj' = where(cov, attn, p_proj);
//     y1 = rnd(rnd(p_proj' @ Wproj) + b) + skip; MLP-gate norms
//     ||ln(y1) - p_mlp||.
//
// The TPU kernels run one grid step per batch element with the whole
// (N, 3C) block in VMEM. That gives 8 blocks for 132 SMs at the flagship
// shapes, and the block (197 x 2304 x 4 B = 1.8 MB) is far beyond the
// 227 KB of shared memory a block may use. Here each wrapper issues several
// hand-written launches instead:
//   A: LN select row pass (in place) -> GEMM into a (B, N, 3C) scratch ->
//      attention, the kernel of attention.cuh (in bfloat16 its tensor-core
//      body, 64 queries a block; in float32 the CUDA-core body, 32) ->
//      difference-norm row pass;
//   B: select row pass (in place) -> GEMM with the bias + skip epilogue ->
//      LN-norms row pass.
// The row passes run the warp-per-row body of row_pass.cuh
// (select_warp_kernel, diff_norms_warp_kernel, ln_norms_kernel) where
// ops/row_pass.py::row_body takes the shapes, the block-per-row body of
// common.cuh otherwise; the wrapper passes the body (``row_body``).
// The row passes move a few MB each. The GEMMs dominate the time at
// the flagship shapes (B.N = 1576 rows, K = 768, N = 2304 and 768); they
// take the core the wrapper picks (ops/gemm_core.py::gemm_core): in
// bfloat16 the wgmma core of gemm_tc.cuh, A read by TMA from the gate state
// the row pass has just written, bound by the tensor cores' rate beside the
// epilogue's bytes (bias, skip, the output); in float32 (and for shapes
// gemm_tc.cuh does not take) gemm.cuh's tile, bound by its shared-memory
// traffic. The qkv intermediate makes one round trip through device memory
// (5.8 MB in bf16 at B=8), which later work can keep on chip.
#include "attention.cuh"
#include "common.cuh"
#include "gemm.cuh"
#include "gemm_tc.cuh"
#include "row_pass.cuh"

namespace etk {

// The epilogues read their operands in load() and write in store(), so
// that gemm_tc.cuh loads several elements' operands before their stores
// (gemm.cuh's BiasEpilogue); operator() is the two in turn.

// qkv[m, n] = rnd(rnd(acc) + b[n])      (block_fused.py:94)
template <typename T>
struct QkvEpilogue {
  const T* bias;
  T* out;
  int ld;
  using Loaded = float;
  __device__ __forceinline__ float load(int, int n) const { return to_f(bias[n]); }
  __device__ __forceinline__ void store(int m, int n, float acc, float b) const {
    out[(int64_t)m * ld + n] = from_f<T>(rnd<T>(acc) + b);
  }
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    store(m, n, acc, load(m, n));
  }
};

// y1[m, n] = rnd(rnd(rnd(acc) + b[n]) + skip[m, n])   (block_fused.py:205-207)
template <typename T>
struct ProjEpilogue {
  const T* bias;
  const T* skip;
  T* out;
  int ld;
  using Loaded = float2;  // (bias, skip)
  __device__ __forceinline__ float2 load(int m, int n) const {
    return make_float2(to_f(bias[n]), to_f(skip[(int64_t)m * ld + n]));
  }
  __device__ __forceinline__ void store(int m, int n, float acc, float2 bs) const {
    const float proj = rnd<T>(rnd<T>(acc) + bs.x);
    out[(int64_t)m * ld + n] = from_f<T>(proj + bs.y);
  }
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    store(m, n, acc, load(m, n));
  }
};

template <typename T>
int qkv_attention_group(int body, int row_body, const void* x, void* p_qkv,
                        const float* cov, const void* p_proj, const void* ln_scale,
                        const void* ln_bias, const void* w, const void* bias, void* qkv,
                        void* attn, float* norms, int bsz, int n, int c, int heads,
                        float inv_scale, GemmCall gemm, cudaStream_t stream) {
  const int rows = bsz * n;
  if (!warp_row_takes<T>(row_body, {c}, {x, p_qkv, ln_scale, ln_bias, attn, p_proj}))
    return (int)cudaErrorInvalidValue;
  int err = launch_select<T>(row_body, (const T*)x, (T*)p_qkv, cov, (const T*)ln_scale,
                             (const T*)ln_bias, rows, c, stream);
  if (err != 0) return err;
  err = launch_gemm_core<T, false>((const T*)p_qkv, rows, DenseRows{}, (const T*)w, rows, c,
                                   3 * c, QkvEpilogue<T>{(const T*)bias, (T*)qkv, 3 * c}, gemm,
                                   stream);
  if (err != 0) return err;
  err = launch_attention<T>(body, (const T*)qkv, nullptr, (T*)attn, bsz, n, c, heads, inv_scale,
                            0, 0, stream);
  if (err != 0) return err;
  return launch_diff_norms<T>(row_body, (const T*)attn, (const T*)p_proj, norms, rows, c, stream);
}

template <typename T>
int proj_group(int row_body, const void* attn, void* p_proj, const float* cov, const void* skip,
               const void* p_mlp, const void* w, const void* bias, const void* ln_scale,
               const void* ln_bias, void* y1, float* norms, int bsz, int n, int c, GemmCall gemm,
               cudaStream_t stream) {
  const int rows = bsz * n;
  if (!warp_row_takes<T>(row_body, {c}, {attn, p_proj, y1, p_mlp, ln_scale, ln_bias}))
    return (int)cudaErrorInvalidValue;
  int err = launch_select<T>(row_body, (const T*)attn, (T*)p_proj, cov, nullptr, nullptr, rows,
                             c, stream);
  if (err != 0) return err;
  err = launch_gemm_core<T, false>(
      (const T*)p_proj, rows, DenseRows{}, (const T*)w, rows, c, c,
      ProjEpilogue<T>{(const T*)bias, (const T*)skip, (T*)y1, c}, gemm, stream);
  if (err != 0) return err;
  return launch_ln_norms<T>(row_body, (const T*)y1, (const T*)p_mlp, (const T*)ln_scale,
                            (const T*)ln_bias, norms, rows, c, stream);
}

}  // namespace etk

// core: ops/gemm_core.py CORE_CODES; split: the GEMM's plan code
// (gemm_core.plan_args: the split of its K steps, or the float32 tile);
// ws: its float32 workspace (null unsplit).
extern "C" {

// body: the attention stage's (ops/window_attention.py BODY_CODES); row_body:
// the row passes' (ops/row_pass.py ROW_BODY_CODES)
int etk_qkv_attention_group(int dtype, int body, int row_body, const void* x, void* p_qkv,
                            const void* cov,
                            const void* p_proj, const void* ln_scale, const void* ln_bias,
                            const void* w, const void* bias, void* qkv, void* attn, void* norms,
                            int bsz, int n, int c, int heads, float inv_scale, int core,
                            int split, void* ws, void* stream) {
  const etk::GemmCall gemm{core, split, (float*)ws};
  ETK_DISPATCH(dtype, return etk::qkv_attention_group<T>(
                          body, row_body, x, p_qkv, (const float*)cov, p_proj, ln_scale,
                          ln_bias, w, bias, qkv, attn, (float*)norms, bsz, n, c, heads,
                          inv_scale, gemm, (cudaStream_t)stream));
}

// row_body: the body of the select and norms stages (ops/row_pass.py ROW_BODY_CODES)
int etk_proj_group(int dtype, int row_body, const void* attn, void* p_proj, const void* cov,
                   const void* skip, const void* p_mlp, const void* w, const void* bias,
                   const void* ln_scale, const void* ln_bias, void* y1, void* norms, int bsz,
                   int n, int c, int core, int split, void* ws, void* stream) {
  const etk::GemmCall gemm{core, split, (float*)ws};
  ETK_DISPATCH(dtype, return etk::proj_group<T>(row_body, attn, p_proj, (const float*)cov, skip,
                                                p_mlp, w, bias, ln_scale, ln_bias, y1,
                                                (float*)norms, bsz, n, c, gemm,
                                                (cudaStream_t)stream));
}

}  // extern "C"
