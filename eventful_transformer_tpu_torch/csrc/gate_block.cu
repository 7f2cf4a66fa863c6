// The split select/scatter pair of the window-resident qkv buffer, written
// for Hopper.
//
// Replaces eventful_transformer_tpu/ops/pallas/gate_block.py:
//   * block_select_p: p' = where(cov, ln(x) | x, p), in place. The TPU
//     kernel tiles 1024 rows of (N, C) per grid step; here one 256-thread
//     block per token row (3528 blocks at ViTDet-672 with 2 streams), the
//     row passes of common.cuh. Bound by the bytes of x and p it reads and
//     the selected rows it writes (5.4 MB read in bf16 at B = 2, N = 1764,
//     C = 768).
//   * block_scatter_rows: b'[index[j]] = h[j] on the window-major buffer
//     (B, NW, F), in place; index (B, KP) in any order, -1 in an invalid
//     slot. The TPU kernel rebuilds each (rows, KP) one-hot in VMEM and
//     blends every row of b; here one block per (batch, slot) copies h's
//     row to its target row and leaves every other row of b untouched, so
//     the pass moves 2 x KP x F elements (2.4 MB in bf16 at KP = 256,
//     F = 2304) instead of the whole buffer. The result is the same where
//     valid indices are distinct, which top-k selection guarantees.
#include "common.cuh"

namespace etk {

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
scatter_rows_kernel(T* __restrict__ b, const int* __restrict__ index, const T* __restrict__ h,
                    int nw, int kp, int f) {
  const int64_t slot = blockIdx.x;  // batch * kp + j
  const int target = index[slot];
  if (target < 0) return;  // invalid slot: never matches a row
  const int64_t batch = slot / kp;
  T* dst = b + (batch * nw + target) * (int64_t)f;
  const T* src = h + slot * (int64_t)f;
  for (int i = threadIdx.x; i < f; i += blockDim.x) dst[i] = src[i];
}

}  // namespace etk

extern "C" {

int etk_block_select_p(int dtype, const void* x, void* p, const void* cov, const void* scale,
                       const void* bias, int apply_ln, long long rows, int c, void* stream) {
  ETK_DISPATCH(dtype, {
    if (apply_ln) {
      etk::ln_select_kernel<T><<<(unsigned)rows, etk::kRowThreads, etk::row_smem_bytes(c),
                                 (cudaStream_t)stream>>>((const T*)x, (T*)p, (const float*)cov,
                                                         (const T*)scale, (const T*)bias, c);
    } else {
      etk::select_rows_kernel<T><<<(unsigned)rows, etk::kRowThreads, 0, (cudaStream_t)stream>>>(
          (const T*)x, (T*)p, (const float*)cov, c);
    }
    ETK_CHECK_LAUNCH();
    return 0;
  });
}

int etk_block_scatter_rows(int dtype, void* b, const void* index, const void* h, int bsz,
                           int nw, int kp, int f, void* stream) {
  ETK_DISPATCH(dtype, {
    etk::scatter_rows_kernel<T><<<(unsigned)(bsz * kp), etk::kRowThreads, 0,
                                  (cudaStream_t)stream>>>((T*)b, (const int*)index,
                                                          (const T*)h, nw, kp, f);
    ETK_CHECK_LAUNCH();
    return 0;
  });
}

}  // extern "C"
