// The blocked gate kernels of large token counts, written for Hopper.
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
//   * block_select_scatter: the gate-state select, the scatter-blend of the
//     k-row op output into the token buffer, the skip (or x) add and the
//     next gate's norms, over every row of the row-major state:
//
//       p' = where(cov, ln(x) | x, p)                       (in place)
//       b' = where(cov, h[slot(i)] (0 if i is in no slot), b) (in place)
//       y  = rnd(b' + skip | x);  norms = ||ln(y) - p_next||  (optional)
//
//     The TPU kernel tiles 512 rows per grid step and copies h's rows with
//     a (rows, KP) one-hot matmul on the MXU. Here two launches: one block
//     per batch row inverts the index list into a token -> slot map in
//     shared memory (16 KB at N = 4096) and writes it out; then one
//     256-thread block per token row does the whole row pass, reading x,
//     p, b (+ skip, + p_next) once and writing p', b' (selected rows only)
//     and y. At ViTDet-1024 (B = 2, N = 4096) the qkv group's b pass
//     (F = 2304, 38 MB read in bf16) is the largest memory term; the
//     projection and MLP groups (F = C = 768) move about 25 MB each.
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

constexpr int kSlotThreads = 1024;

// slot[b, i] = j where index[b, j] == i, else -1; an index outside [0, n)
// marks an invalid slot and maps nothing. Dynamic shared memory: n ints.
__global__ void __launch_bounds__(kSlotThreads)
slot_map_kernel(const int* __restrict__ index, int* __restrict__ slot, int n, int kp) {
  extern __shared__ int map[];
  const int64_t b = blockIdx.x;
  for (int i = threadIdx.x; i < n; i += blockDim.x) map[i] = -1;
  __syncthreads();
  for (int j = threadIdx.x; j < kp; j += blockDim.x) {
    const int t = index[b * kp + j];
    if (t >= 0 && t < n) map[t] = j;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) slot[b * n + i] = map[i];
}

// One row r of the blocked group. ``scale`` null: the gate takes x itself
// (apply_ln=False). ``res``: the skip (width f) or x (residual_x, f == c),
// null without a y output; ``norms`` null without the next gate. Dynamic
// shared memory: (max(c, f) + 32) floats.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
select_scatter_kernel(const T* __restrict__ x, T* __restrict__ p, T* __restrict__ b,
                      const float* __restrict__ cov, const int* __restrict__ slot,
                      const T* __restrict__ h, const T* __restrict__ scale,
                      const T* __restrict__ bias, const T* __restrict__ res, T* __restrict__ y,
                      const T* __restrict__ p_next, const T* __restrict__ next_scale,
                      const T* __restrict__ next_bias, float* __restrict__ norms, int n, int c,
                      int f, int kp) {
  extern __shared__ float smem[];
  float* row = smem;
  float* red = smem + max(c, f);
  const int64_t r = blockIdx.x;
  const bool sel = cov[r] > 0.f;  // uniform over the block
  if (sel) {
    T* pr = p + r * c;
    if (scale != nullptr) {
      load_row(x, r, c, row);
      float mean, rstd;
      ln_stats(row, c, red, mean, rstd);
      for (int i = threadIdx.x; i < c; i += blockDim.x)
        pr[i] = from_f<T>(ln_value(row[i], mean, rstd, scale, bias, i));
      __syncthreads();  // row is reused below
    } else {
      for (int i = threadIdx.x; i < c; i += blockDim.x) pr[i] = x[r * c + i];
    }
  }
  const int j = sel ? slot[r] : -1;
  const T* hr = j >= 0 ? h + ((r / n) * kp + j) * (int64_t)f : nullptr;
  for (int i = threadIdx.x; i < f; i += blockDim.x) {
    const int64_t e = r * f + i;
    float bv;
    if (sel) {
      bv = hr != nullptr ? to_f(hr[i]) : 0.f;
      b[e] = from_f<T>(bv);
    } else {
      bv = to_f(b[e]);
    }
    if (res != nullptr) {
      const float yv = rnd<T>(bv + to_f(res[e]));
      y[e] = from_f<T>(yv);
      row[i] = yv;
    }
  }
  if (norms == nullptr) return;  // uniform over the block
  __syncthreads();
  const float norm = ln_error_norm(row, p_next, r, f, next_scale, next_bias, red);
  if (threadIdx.x == 0) norms[r] = norm;
}

template <typename T>
int block_select_scatter(const void* x, void* p, void* b, const float* cov, const int* index,
                         const void* h, const void* scale, const void* bias, const void* skip,
                         int residual_x, const void* p_next, const void* next_scale,
                         const void* next_bias, void* y, float* norms, int* slot, int bsz, int n,
                         int c, int f, int kp, cudaStream_t stream) {
  const size_t map_smem = (size_t)n * sizeof(int);
  if (map_smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        slot_map_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)map_smem);
    if (err != cudaSuccess) return (int)err;
  }
  slot_map_kernel<<<bsz, kSlotThreads, map_smem, stream>>>(index, slot, n, kp);
  ETK_CHECK_LAUNCH();
  const T* res = skip != nullptr ? (const T*)skip : (residual_x ? (const T*)x : nullptr);
  select_scatter_kernel<T><<<(unsigned)((int64_t)bsz * n), kRowThreads,
                             row_smem_bytes(c > f ? c : f), stream>>>(
      (const T*)x, (T*)p, (T*)b, cov, slot, (const T*)h, (const T*)scale, (const T*)bias, res,
      (T*)y, (const T*)p_next, (const T*)next_scale, (const T*)next_bias, norms, n, c, f, kp);
  ETK_CHECK_LAUNCH();
  return 0;
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

int etk_block_select_scatter(int dtype, const void* x, void* p, void* b, const void* cov,
                             const void* index, const void* h, const void* scale,
                             const void* bias, const void* skip, int residual_x,
                             const void* p_next, const void* next_scale, const void* next_bias,
                             void* y, void* norms, void* slot, int bsz, int n, int c, int f,
                             int kp, void* stream) {
  ETK_DISPATCH(dtype, return etk::block_select_scatter<T>(
                          x, p, b, (const float*)cov, (const int*)index, h, scale, bias, skip,
                          residual_x, p_next, next_scale, next_bias, y, (float*)norms,
                          (int*)slot, bsz, n, c, f, kp, (cudaStream_t)stream));
}

}  // extern "C"
