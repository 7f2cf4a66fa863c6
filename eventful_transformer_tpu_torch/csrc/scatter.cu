// Row scatter and row gather by index, written for Hopper.
//
// Replace eventful_transformer_tpu/ops/pallas/scatter.py::scatter_rows_inplace
// and ::gather_rows:
//
//   scatter: buffer[b, index[b, i]] = values[b, i]   where mask[b, i], in place
//   gather:  rows[b, i] = buffer[b, index[b, i]]
//
// The TPU kernels run one grid step per (b, i) slot, with the indices
// prefetched as scalars, and DMA one row from device memory to device
// memory. Here one warp takes one slot: it reads the slot's index (and
// mask) itself and copies the row with 16-byte loads and stores, neighbouring
// lanes on neighbouring addresses; 8 slots a block of 256 threads. The
// copies move 2 K C elements and do no arithmetic, so the kernels are bound
// by those bytes (at stgt_672's qkv buffer, B = 2, K = 256, C = 2304 in
// bfloat16: 4.7 MB, 1.4 us at 3.35 TB/s) and, at such sizes, by the launch.
//
// The scatter casts values to the buffer's dtype in the kernel (rounding
// to nearest even, as the JAX wrapper's astype does, scatter.py:62); rows of
// one dtype are copied as raw bytes, so both kernels are exact copies. A
// slot whose index lies outside [0, N) writes nothing (the scatter) or a
// row of zeros (the gather); the TPU kernels leave that undefined. Distinct
// valid indices are the contract (scatter.py:9): two slots naming one row
// race, as the TPU's DMAs do.
#include <type_traits>

#include "common.cuh"

namespace etk {

constexpr int kRowCopyThreads = 256;  // 8 warps, one slot each

__device__ __forceinline__ int64_t slot_index(const void* index, int idx64, int64_t slot) {
  return idx64 ? ((const int64_t*)index)[slot] : (int64_t)((const int*)index)[slot];
}

// 8 elements of a row as float32
__device__ __forceinline__ void load8(const float* src, float* v) {
  const float4 a = ((const float4*)src)[0], b = ((const float4*)src)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* v) {
  const uint4 raw = *(const uint4*)src;
  const __nv_bfloat16* h = (const __nv_bfloat16*)&raw;
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
}
__device__ __forceinline__ void store8(float* dst, const float* v) {
  ((float4*)dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  ((float4*)dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* v) {
  uint4 raw;
  __nv_bfloat16* h = (__nv_bfloat16*)&raw;
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(v[i]);
  *(uint4*)dst = raw;
}

// One row of c elements (c a multiple of 8, both rows 16-byte aligned) from
// src to dst by one warp: raw 16-byte words where the types agree, else
// through float32.
template <typename TD, typename TS>
__device__ __forceinline__ void copy_row(TD* __restrict__ dst, const TS* __restrict__ src, int c,
                                         int lane) {
  if constexpr (std::is_same_v<TD, TS>) {
    const int words = c * (int)sizeof(TD) / 16;
    const uint4* s = (const uint4*)src;
    uint4* d = (uint4*)dst;
    for (int w = lane; w < words; w += 32) d[w] = s[w];
  } else {
    float v[8];
    for (int e = lane * 8; e < c; e += 32 * 8) {
      load8(src + e, v);
      store8(dst + e, v);
    }
  }
}

template <typename TB, typename TV>
__global__ void __launch_bounds__(kRowCopyThreads)
scatter_rows_kernel(TB* __restrict__ buffer, const TV* __restrict__ values, const void* index,
                    int idx64, const bool* __restrict__ mask, int slots, int n, int c, int k) {
  const int slot = blockIdx.x * (kRowCopyThreads / 32) + (threadIdx.x >> 5);
  if (slot >= slots) return;
  if (mask != nullptr && !mask[slot]) return;
  const int64_t i = slot_index(index, idx64, slot);
  if (i < 0 || i >= n) return;
  copy_row(buffer + ((int64_t)(slot / k) * n + i) * c, values + (int64_t)slot * c, c,
           threadIdx.x & 31);
}

template <typename T>
__global__ void __launch_bounds__(kRowCopyThreads)
gather_rows_kernel(const T* __restrict__ buffer, const void* index, int idx64,
                   T* __restrict__ rows, int slots, int n, int c, int k) {
  const int slot = blockIdx.x * (kRowCopyThreads / 32) + (threadIdx.x >> 5);
  if (slot >= slots) return;
  const int64_t i = slot_index(index, idx64, slot);
  T* dst = rows + (int64_t)slot * c;
  const int lane = threadIdx.x & 31;
  if (i < 0 || i >= n) {
    const int words = c * (int)sizeof(T) / 16;
    for (int w = lane; w < words; w += 32) ((uint4*)dst)[w] = make_uint4(0, 0, 0, 0);
    return;
  }
  copy_row(dst, buffer + ((int64_t)(slot / k) * n + i) * c, c, lane);
}

inline dim3 row_copy_grid(int slots) {
  return dim3((slots + kRowCopyThreads / 32 - 1) / (kRowCopyThreads / 32));
}

}  // namespace etk

extern "C" {

// buffer (bsz, n, c) in dtype, values (bsz, k, c) in values_dtype, index
// (bsz, k) int32 or (idx64) int64, mask (bsz, k) bool or null.
int etk_scatter_rows(int dtype, int values_dtype, void* buffer, const void* values,
                     const void* index, int idx64, const void* mask, int bsz, int n, int c, int k,
                     void* stream) {
  const int slots = bsz * k;
  if (slots == 0) return 0;
  const dim3 grid = etk::row_copy_grid(slots);
  ETK_DISPATCH(dtype, {
    using TB = T;
    ETK_DISPATCH(values_dtype, {
      etk::scatter_rows_kernel<TB, T><<<grid, etk::kRowCopyThreads, 0, (cudaStream_t)stream>>>(
          (TB*)buffer, (const T*)values, index, idx64, (const bool*)mask, slots, n, c, k);
      ETK_CHECK_LAUNCH();
      return 0;
    });
  });
}

// buffer (bsz, n, c), index (bsz, k) int32 or (idx64) int64 -> rows (bsz,
// k, c).
int etk_gather_rows(int dtype, const void* buffer, const void* index, int idx64, void* rows,
                    int bsz, int n, int c, int k, void* stream) {
  const int slots = bsz * k;
  if (slots == 0) return 0;
  ETK_DISPATCH(dtype, {
    etk::gather_rows_kernel<T><<<etk::row_copy_grid(slots), etk::kRowCopyThreads, 0,
                                 (cudaStream_t)stream>>>((const T*)buffer, index, idx64, (T*)rows,
                                                         slots, n, c, k);
    ETK_CHECK_LAUNCH();
    return 0;
  });
}

}  // extern "C"
