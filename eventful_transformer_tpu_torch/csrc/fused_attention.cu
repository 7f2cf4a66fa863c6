// fused_attention, written for Hopper.
//
// Replaces eventful_transformer_tpu/ops/pallas/attention.py::
// fused_attention: multi-head attention over packed qkv rows (B, N, 3C)
// -> (B, N, C), no bias, with the JAX kernel's own rounding points
// (attention.py:33-58), which are not those of the port's other attention
// kernels: q taken to float32 and scaled by the float32 1/scale there, no
// rounding to the working dtype; the softmax in float32; without the
// matmul-2 cast the probabilities stay float32 and multiply v as read,
// with it (``cast``, bfloat16 only) the probabilities and v are rounded to
// bfloat16 first; the output rounded to the working dtype once.
//
// The TPU kernel takes one batch row a grid step with its (N, 3C) block in
// VMEM and loops over the heads. Here the body is attention.cuh's, one
// block per (batch row, head, query tile) with K and V of one head in
// shared memory, in the kAttnF32Probs or kAttnBf16Probs form. Its bound is
// the bytes of qkv and out in bfloat16, the float32 operations in float32.
// In bfloat16 the tensor-core body (attention_tc.cuh) runs it: q split into
// two bfloat16 parts for q.kT, and without the cast the float32
// probabilities too, so that the products keep float32's precision on the
// tensor cores at twice their work; in float32 the CUDA-core body, bound by
// its float32 shared-memory dot products.
#include "attention.cuh"

extern "C" int etk_fused_attention(int dtype, int body, const void* qkv, void* out, int bsz,
                                   int n, int c, int heads, float inv_scale, int cast,
                                   void* stream) {
  ETK_DISPATCH(dtype, {
    if (cast) {
      return etk::launch_attention<T, etk::kAttnBf16Probs>(
          body, (const T*)qkv, nullptr, (T*)out, bsz, n, c, heads, inv_scale, 0, 0,
          (cudaStream_t)stream);
    }
    return etk::launch_attention<T, etk::kAttnF32Probs>(body, (const T*)qkv, nullptr, (T*)out,
                                                        bsz, n, c, heads, inv_scale, 0, 0,
                                                        (cudaStream_t)stream);
  });
}
