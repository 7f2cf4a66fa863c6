// Device helpers shared by the eventful kernels: element types, block
// reductions, the float32 LayerNorm of ops/common.py::ln_f32, the
// block-per-row body of the row kernels (the warp-per-row body is
// row_pass.cuh) and the XLA float32 erf behind the exact GELU
// (ops/common.py::gelu_exact).
//
// Every kernel is a template over the working dtype T (float or
// __nv_bfloat16). Arithmetic is float32; rnd<T> marks each point where the
// JAX kernels round to the working dtype, and the port keeps all of them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace etk {

constexpr float kLnEps = 1e-6f;
constexpr int kRowThreads = 256;  // threads of a one-row-per-block kernel

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// float32 value of v rounded to T
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the block; every thread gets the result. ``red`` is 32 floats
// of shared memory; blockDim.x is a multiple of 32.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  return red[0];
}

// Two-pass float32 mean and 1/sqrt(var + eps) of a row held in shared
// memory, as jnp.mean and jnp.mean(square(x - mean)) compute them.
__device__ __forceinline__ void ln_stats(const float* row, int c, float* red, float& mean,
                                         float& rstd) {
  float s = 0.f;
  for (int i = threadIdx.x; i < c; i += blockDim.x) s += row[i];
  mean = block_sum(s, red) / (float)c;
  float v = 0.f;
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    const float d = row[i] - mean;
    v += d * d;
  }
  rstd = rsqrtf(block_sum(v, red) / (float)c + kLnEps);
}

template <typename T>
__device__ __forceinline__ float ln_value(float v, float mean, float rstd, const T* scale,
                                          const T* bias, int i) {
  return (v - mean) * rstd * to_f(scale[i]) + to_f(bias[i]);
}

// Load row ``r`` of a (rows, c) T matrix into shared float32 ``row``.
template <typename T>
__device__ __forceinline__ void load_row(const T* src, int64_t r, int c, float* row) {
  const T* s = src + r * c;
  for (int i = threadIdx.x; i < c; i += blockDim.x) row[i] = to_f(s[i]);
  __syncthreads();
}

// ||ln(row) * scale + bias - p[r]||_2 of a row already in shared memory.
template <typename T>
__device__ __forceinline__ float ln_error_norm(const float* row, const T* p, int64_t r, int c,
                                               const T* scale, const T* bias, float* red) {
  float mean, rstd;
  ln_stats(row, c, red, mean, rstd);
  const T* pr = p + r * c;
  float acc = 0.f;
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    const float e = ln_value(row[i], mean, rstd, scale, bias, i) - to_f(pr[i]);
    acc += e * e;
  }
  return sqrtf(block_sum(acc, red));
}

// ---------------------------------------------------------------------------
// Row kernels, the block-per-row body: one block of kRowThreads threads per
// token row, the row staged in dynamic shared memory ((c + 32) floats), each
// block_sum three barriers. The warp-per-row body (row_pass.cuh) takes the
// calls whose shapes it holds; these kernels the others (launch_ln_norms,
// launch_select and launch_diff_norms pick by the rule's body code).
// ---------------------------------------------------------------------------

// out[r] = ||ln(x[r]) * scale + bias - p[r]||_2
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
ln_norms_block_kernel(const T* __restrict__ x, const T* __restrict__ p,
                      const T* __restrict__ scale, const T* __restrict__ bias,
                      float* __restrict__ out, int c) {
  extern __shared__ float smem[];
  float* row = smem;
  float* red = smem + c;
  const int64_t r = blockIdx.x;
  load_row(x, r, c, row);
  const float norm = ln_error_norm(row, p, r, c, scale, bias, red);
  if (threadIdx.x == 0) out[r] = norm;
}

// p[r] = ln(x[r]) * scale + bias where cov[r] > 0 (in place; other rows
// keep p, which where(cov, ln(x), p).astype(p.dtype) leaves unchanged);
// every row when cov is null
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
ln_select_kernel(const T* __restrict__ x, T* __restrict__ p, const float* __restrict__ cov,
                 const T* __restrict__ scale, const T* __restrict__ bias, int c) {
  extern __shared__ float smem[];
  const int64_t r = blockIdx.x;
  if (cov != nullptr && !(cov[r] > 0.f)) return;  // uniform over the block
  float* row = smem;
  float* red = smem + c;
  load_row(x, r, c, row);
  float mean, rstd;
  ln_stats(row, c, red, mean, rstd);
  T* pr = p + r * c;
  for (int i = threadIdx.x; i < c; i += blockDim.x)
    pr[i] = from_f<T>(ln_value(row[i], mean, rstd, scale, bias, i));
}

// p[r] = a[r] where cov[r] > 0 (in place)
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
select_rows_kernel(const T* __restrict__ a, T* __restrict__ p, const float* __restrict__ cov,
                   int c) {
  const int64_t r = blockIdx.x;
  if (!(cov[r] > 0.f)) return;
  for (int i = threadIdx.x; i < c; i += blockDim.x) p[r * c + i] = a[r * c + i];
}

// out[r] = ||a[r] - p[r]||_2
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
diff_norms_kernel(const T* __restrict__ a, const T* __restrict__ p, float* __restrict__ out,
                  int c) {
  extern __shared__ float smem[];
  const int64_t r = blockIdx.x;
  float acc = 0.f;
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    const float e = to_f(a[r * c + i]) - to_f(p[r * c + i]);
    acc += e * e;
  }
  acc = block_sum(acc, smem);
  if (threadIdx.x == 0) out[r] = sqrtf(acc);
}

inline size_t row_smem_bytes(int c) { return (size_t)(c + 32) * sizeof(float); }

// ---------------------------------------------------------------------------
// Exact GELU with XLA's float32 erf (rational fit on [-4, 4])
// ---------------------------------------------------------------------------

__device__ __forceinline__ float erf_f32(float x) {
  x = fminf(fmaxf(x, -4.f), 4.f);
  const float x2 = x * x;
  float a = -2.72614225801306e-10f;
  a = a * x2 + 2.77068142495902e-08f;
  a = a * x2 + -2.10102402082508e-06f;
  a = a * x2 + -5.69250639462346e-05f;
  a = a * x2 + -7.34990630326855e-04f;
  a = a * x2 + -2.95459980854025e-03f;
  a = a * x2 + -1.60960333262415e-02f;
  float b = -1.45660718464996e-05f;
  b = b * x2 + -2.13374055278905e-04f;
  b = b * x2 + -1.68282697438203e-03f;
  b = b * x2 + -7.37332916720468e-03f;
  b = b * x2 + -1.42647390514189e-02f;
  return x * a / b;
}

__device__ __forceinline__ float gelu_exact(float x) {
  return x * 0.5f * (1.f + erf_f32(x * 0.70710678118654752f));
}

}  // namespace etk

// Dispatch a templated launch on the dtype code the wrappers pass
// (0 = float32, 1 = bfloat16).
#define ETK_DISPATCH(dtype, ...)                  \
  do {                                            \
    if ((dtype) == 0) {                           \
      using T = float;                            \
      __VA_ARGS__;                                \
    } else if ((dtype) == 1) {                    \
      using T = __nv_bfloat16;                    \
      __VA_ARGS__;                                \
    } else {                                      \
      return (int)cudaErrorInvalidValue;          \
    }                                             \
  } while (0)

// Return the launch error, if any, from an extern "C" entry.
#define ETK_CHECK_LAUNCH()                        \
  do {                                            \
    cudaError_t err_ = cudaGetLastError();        \
    if (err_ != cudaSuccess) return (int)err_;    \
  } while (0)
