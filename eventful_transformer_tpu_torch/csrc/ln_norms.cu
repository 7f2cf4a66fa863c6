// ln_norms, the gate-norm row reduction, written for Hopper (CUDA C++ in
// the same nvcc build as the other kernels, not Triton).
//
// Replaces eventful_transformer_tpu/ops/pallas/gate_fused.py::ln_norms:
// norms[r] = ||ln(x[r]) * scale + bias - p[r]||_2 in float32. The TPU
// kernel tiles 256 token rows per grid step; here one 256-thread block
// takes one token row (1576 blocks at the flagship shapes), keeps the row
// in shared memory for the two-pass mean and variance, and reads x and p
// once from device memory. It is bound by those bytes (4.8 MB in bf16 at
// B=8, N=197, C=768).
#include "common.cuh"

extern "C" {

int etk_ln_norms(int dtype, const void* x, const void* p, const void* scale, const void* bias,
                 void* out, long long rows, int c, void* stream) {
  ETK_DISPATCH(dtype, {
    etk::ln_norms_kernel<T><<<(unsigned)rows, etk::kRowThreads, etk::row_smem_bytes(c),
                              (cudaStream_t)stream>>>((const T*)x, (const T*)p,
                                                      (const T*)scale, (const T*)bias,
                                                      (float*)out, c);
    ETK_CHECK_LAUNCH();
    return 0;
  });
}

const char* etk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
