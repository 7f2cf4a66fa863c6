// ln_norms, the gate-norm row reduction, written for Hopper (CUDA C++ in
// the same nvcc build as the other kernels, not Triton).
//
// Replaces eventful_transformer_tpu/ops/pallas/gate_fused.py::ln_norms:
// norms[r] = ||ln(x[r]) * scale + bias - p[r]||_2 in float32. The TPU
// kernel tiles 256 token rows per grid step; here one warp takes one token
// row, 8 rows to a block (197 blocks at the flagship's B=8, N=197), loads x
// and p once with 16-byte loads into registers and reduces by warp
// shuffles, without shared memory or barriers (row_pass.cuh). The call
// moves 4.8 MB in bfloat16 at that shape, a bound of 1.4 us, so it waits on
// the latency of its loads more than on their bytes. A width or an operand
// the warp body does not take goes to the block-per-row body of
// common.cuh (``body`` 0, ops/row_pass.py::row_body).
#include "row_pass.cuh"

extern "C" {

int etk_ln_norms(int dtype, int body, const void* x, const void* p, const void* scale,
                 const void* bias, void* out, long long rows, int c, void* stream) {
  ETK_DISPATCH(dtype, return etk::launch_ln_norms<T>(body, (const T*)x, (const T*)p,
                                                     (const T*)scale, (const T*)bias,
                                                     (float*)out, rows, c,
                                                     (cudaStream_t)stream));
}

const char* etk_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
