// put_rows as one kernel, written for Hopper.
//
// Replaces eventful_transformer_tpu/ops/pallas/scatter_blend.py::
// scatter_blend, the one-hot blend
//
//   out[b, n] = rnd(x[b, n] * (1 - cov[b, n]) + sum_j [index[b, j] == n] * values[b, j])
//
// in float32, cov[b, n] the number of valid slots j naming row n (a slot
// with mask false, or an index outside [0, N), names none), values already
// in x's dtype (the wrapper casts them). The TPU kernel builds each (64, 512)
// output tile's (k, 64) slice of the one-hot matrix and runs a (64, k) x
// (k, 512) MXU product against the values. Here a block of 256 threads
// takes kBlendRows rows of one batch row: it loads the batch row's k
// indices (int64, as PyTorch indexes; -1 for a masked-off slot) into
// shared memory, finds each of its rows' first matching slot
// and match count there (shared atomics), then writes the rows: x * 1 + 0
// for a row no slot names, x * 0 + values[first] for a row one slot names,
// and for a row that several name the sum of their values in slot order
// (exact for two: -x + v1 + v2, as the one-hot product gives). Rows that no
// slot names are still written, as the blend writes every row: the kernel
// reads x and the k value rows once and writes out once, and is bound by
// those bytes (at 672, B = 2, N = 1764, C = 2304, k = 256 in bf16: 16.3 MB
// read, 16.3 MB written and 2.4 MB of values, 10.4 us at 3.35 TB/s).
#include <limits.h>

#include "common.cuh"

namespace etk {

constexpr int kBlendRows = 8, kBlendThreads = 256;
constexpr int kBlendMaxSlots = 12288;  // the indices in the default 48 KB of shared memory

template <typename T>
__global__ void __launch_bounds__(kBlendThreads)
scatter_blend_kernel(const T* __restrict__ x, const T* __restrict__ values,
                     const int64_t* __restrict__ index, const bool* __restrict__ mask,
                     T* __restrict__ out, int n, int c, int k) {
  extern __shared__ int idx[];  // k indices of this batch row, -1 where none
  __shared__ int first[kBlendRows], count[kBlendRows];
  const int b = blockIdx.y, n0 = blockIdx.x * kBlendRows;
  if (threadIdx.x < kBlendRows) {
    first[threadIdx.x] = INT_MAX;
    count[threadIdx.x] = 0;
  }
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const int64_t slot = (int64_t)b * k + j;
    const int64_t i = index[slot];
    idx[j] = (i < 0 || i >= n || (mask != nullptr && !mask[slot])) ? -1 : (int)i;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const int r = idx[j] - n0;
    if (r >= 0 && r < kBlendRows) {
      atomicMin(&first[r], j);
      atomicAdd(&count[r], 1);
    }
  }
  __syncthreads();
  const int rows = min(kBlendRows, n - n0);
  const T* vb = values + (int64_t)b * k * c;
  for (int r = 0; r < rows; ++r) {
    const int cnt = count[r], j0 = first[r];
    const int64_t row = ((int64_t)b * n + n0 + r) * c;
    const float keep = 1.f - (float)cnt;
    for (int col = threadIdx.x; col < c; col += blockDim.x) {
      float acc = 0.f;
      if (cnt == 1) {
        acc = to_f(vb[(int64_t)j0 * c + col]);
      } else if (cnt > 1) {
        for (int j = j0; j < k; ++j)
          if (idx[j] == n0 + r) acc = __fadd_rn(acc, to_f(vb[(int64_t)j * c + col]));
      }
      out[row + col] = from_f<T>(__fadd_rn(__fmul_rn(to_f(x[row + col]), keep), acc));
    }
  }
}

}  // namespace etk

extern "C" int etk_scatter_blend(int dtype, const void* x, const void* values, const void* index,
                                 const void* mask, void* out, int bsz, int n, int c, int k,
                                 void* stream) {
  if (k > etk::kBlendMaxSlots) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + etk::kBlendRows - 1) / etk::kBlendRows, bsz);
  ETK_DISPATCH(dtype, {
    etk::scatter_blend_kernel<T><<<grid, etk::kBlendThreads, k * sizeof(int),
                                   (cudaStream_t)stream>>>(
        (const T*)x, (const T*)values, (const int64_t*)index, (const bool*)mask, (T*)out, n, c,
        k);
    ETK_CHECK_LAUNCH();
    return 0;
  });
}
