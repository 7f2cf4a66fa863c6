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
//   A: ln_select row pass (in place) -> tiled GEMM into a (B, N, 3C)
//      scratch -> attention, the kernel of attention.cuh (in bfloat16 its
//      tensor-core body, 64 queries a block; in float32 the CUDA-core body,
//      32) -> diff-norms row pass;
//   B: select row pass (in place) -> GEMM with the bias + skip epilogue ->
//      LN-norms row pass.
// The row passes are bound by memory bytes; the GEMMs dominate the time at
// the flagship shapes and are bound by the simple GEMM's shared-memory
// traffic (gemm.cuh). The qkv intermediate makes one round trip through
// device memory (5.8 MB in bf16 at B=8), which later work can keep on chip.
#include "attention.cuh"
#include "common.cuh"
#include "gemm.cuh"

namespace etk {

// qkv[m, n] = rnd(rnd(acc) + b[n])      (block_fused.py:94)
template <typename T>
struct QkvEpilogue {
  const T* bias;
  T* out;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    out[(int64_t)m * ld + n] = from_f<T>(rnd<T>(acc) + to_f(bias[n]));
  }
};

// y1[m, n] = rnd(rnd(rnd(acc) + b[n]) + skip[m, n])   (block_fused.py:205-207)
template <typename T>
struct ProjEpilogue {
  const T* bias;
  const T* skip;
  T* out;
  int ld;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    const int64_t i = (int64_t)m * ld + n;
    const float proj = rnd<T>(rnd<T>(acc) + to_f(bias[n]));
    out[i] = from_f<T>(proj + to_f(skip[i]));
  }
};

template <typename T>
int qkv_attention_group(int body, const void* x, void* p_qkv, const float* cov,
                        const void* p_proj, const void* ln_scale, const void* ln_bias,
                        const void* w, const void* bias, void* qkv, void* attn, float* norms,
                        int bsz, int n, int c, int heads, float inv_scale, cudaStream_t stream) {
  const int rows = bsz * n;
  const size_t row_smem = row_smem_bytes(c);
  ln_select_kernel<T><<<rows, kRowThreads, row_smem, stream>>>(
      (const T*)x, (T*)p_qkv, cov, (const T*)ln_scale, (const T*)ln_bias, c);
  ETK_CHECK_LAUNCH();
  launch_gemm<T>((const T*)p_qkv, DenseRows{}, (const T*)w, rows, c, 3 * c,
                 QkvEpilogue<T>{(const T*)bias, (T*)qkv, 3 * c}, stream);
  ETK_CHECK_LAUNCH();
  const int err = launch_attention<T>(body, (const T*)qkv, nullptr, (T*)attn, bsz, n, c, heads,
                                      inv_scale, 0, 0, stream);
  if (err != 0) return err;
  diff_norms_kernel<T><<<rows, kRowThreads, row_smem, stream>>>(
      (const T*)attn, (const T*)p_proj, norms, c);
  ETK_CHECK_LAUNCH();
  return 0;
}

template <typename T>
int proj_group(const void* attn, void* p_proj, const float* cov, const void* skip,
               const void* p_mlp, const void* w, const void* bias, const void* ln_scale,
               const void* ln_bias, void* y1, float* norms, int bsz, int n, int c,
               cudaStream_t stream) {
  const int rows = bsz * n;
  const size_t row_smem = row_smem_bytes(c);
  select_rows_kernel<T><<<rows, kRowThreads, 0, stream>>>((const T*)attn, (T*)p_proj, cov, c);
  ETK_CHECK_LAUNCH();
  launch_gemm<T>((const T*)p_proj, DenseRows{}, (const T*)w, rows, c, c,
                 ProjEpilogue<T>{(const T*)bias, (const T*)skip, (T*)y1, c}, stream);
  ETK_CHECK_LAUNCH();
  ln_norms_kernel<T><<<rows, kRowThreads, row_smem, stream>>>(
      (const T*)y1, (const T*)p_mlp, (const T*)ln_scale, (const T*)ln_bias, norms, c);
  ETK_CHECK_LAUNCH();
  return 0;
}

}  // namespace etk

extern "C" {

int etk_qkv_attention_group(int dtype, int body, const void* x, void* p_qkv, const void* cov,
                            const void* p_proj, const void* ln_scale, const void* ln_bias,
                            const void* w, const void* bias, void* qkv, void* attn, void* norms,
                            int bsz, int n, int c, int heads, float inv_scale, void* stream) {
  ETK_DISPATCH(dtype, return etk::qkv_attention_group<T>(
                          body, x, p_qkv, (const float*)cov, p_proj, ln_scale, ln_bias, w, bias,
                          qkv, attn, (float*)norms, bsz, n, c, heads, inv_scale,
                          (cudaStream_t)stream));
}

int etk_proj_group(int dtype, const void* attn, void* p_proj, const void* cov, const void* skip,
                   const void* p_mlp, const void* w, const void* bias, const void* ln_scale,
                   const void* ln_bias, void* y1, void* norms, int bsz, int n, int c,
                   void* stream) {
  ETK_DISPATCH(dtype, return etk::proj_group<T>(attn, p_proj, (const float*)cov, skip, p_mlp, w,
                                                bias, ln_scale, ln_bias, y1, (float*)norms, bsz,
                                                n, c, (cudaStream_t)stream));
}

}  // extern "C"
