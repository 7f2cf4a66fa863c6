// put_rows as one kernel, written for Hopper.
//
// Replaces eventful_transformer_tpu/ops/pallas/scatter_blend.py::
// scatter_blend, the one-hot blend
//
//   out[b, n] = rnd(x[b, n] * (1 - cov[b, n]) + sum_j [index[b, j] == n] * values[b, j])
//
// in float32, cov[b, n] the number of valid slots j naming row n (a slot
// with mask false, or an index outside [0, N), names none), each value
// first rounded to x's dtype (the kernel casts float32 or bfloat16 values
// itself). The TPU kernel builds each (64, 512) output tile's (k, 64) slice
// of the one-hot matrix and runs a (64, k) x (k, 512) MXU product against
// the values. The blend does no real arithmetic: it reads x and the k value
// rows once and writes out once, and is bound by those bytes (at stgt_672's
// qkv buffer, B = 2, N = 1764, C = 2304, k = 256 in bfloat16: 16.3 MB read,
// 16.3 MB written and 2.4 MB of values, 10.4 us at 3.35 TB/s).
//
// So the kernel is a bulk row copy that rewrites the few rows the slots
// name on the way (k = 256 of 1764 rows at 672):
//   * a grid over (tile of R rows, batch row); each block walks the tiles
//     blockIdx.x, blockIdx.x + gridDim.x, ... of its batch row through a
//     ring of ``stages`` tiles in shared memory (R, the stages and the grid
//     from ops/row_copy.py::blend_plan);
//   * one thread loads each tile with one cp.async.bulk (R contiguous rows,
//     no tensor map) on the stage's mbarrier, ``stages`` tiles ahead;
//   * while a tile is in flight the block reads its batch row's k indices
//     with 16-byte loads and marks, in shared memory, each of the tile's
//     rows' match count and first slot (shared atomics);
//   * once the tile has landed, the threads rewrite only the named rows in
//     shared memory: 16-byte reads of the value rows, the float32 sum of
//     their values in slot order (exact for two: -x + v1 + v2, as the
//     one-hot product gives), one rounding; rows no slot names are not
//     touched, their bytes go back out as they came in (x * 1 + 0 is x, up
//     to the sign of a zero);
//   * one thread stores the tile with one bulk store and waits for it to
//     have read the stage before the stage takes another tile.
// A launch whose rows are not whole 16-byte words, or whose x or out does
// not start on a 16-byte boundary, cannot take bulk copies: its blocks walk
// the same tiles and blend each element with the threads' own loads and
// stores.
#include <limits.h>

#include <type_traits>

#include "async_copy.cuh"
#include "common.cuh"

namespace etk {

constexpr int kBlendThreads = 256;
constexpr int kBlendMaxRows = 256;  // rows of a tile; one thread resets each row's marks
static_assert(kBlendMaxRows <= kBlendThreads, "one thread a row's marks");

// The row that slot ``slot`` names, or -1.
__device__ __forceinline__ int64_t blend_slot_row(const void* index, int idx64, const bool* mask,
                                                  int64_t slot, int n) {
  const int64_t i = idx64 ? ((const int64_t*)index)[slot] : (int64_t)((const int*)index)[slot];
  return (i < 0 || i >= n || (mask != nullptr && !mask[slot])) ? -1 : i;
}

// count[r] and first[r] of the tile's rows n0 + r, r < rows, from the k
// slots of batch row b: the indices in 16-byte words where they lie on
// 16-byte boundaries, the rest one at a time.
__device__ __forceinline__ void blend_marks(const void* index, int idx64, const bool* mask, int b,
                                            int k, int n, int n0, int rows, int* count,
                                            int* first) {
  const int64_t base = (int64_t)b * k;
  auto mark = [&](int j, int64_t i) {
    if (i < 0 || i >= n || (mask != nullptr && !mask[base + j])) return;
    const int64_t r = i - n0;
    if (r >= 0 && r < rows) {
      atomicAdd(&count[r], 1);
      atomicMin(&first[r], j);
    }
  };
  const int size = idx64 ? 8 : 4, per_word = 16 / size;
  const char* start = (const char*)index + base * size;
  const int lead = min(k, (int)(((16 - (uintptr_t)start % 16) % 16) / size));
  const int words = (k - lead) / per_word, tail = lead + words * per_word;
  for (int j = threadIdx.x; j < lead; j += blockDim.x)
    mark(j, idx64 ? ((const int64_t*)start)[j] : ((const int*)start)[j]);
  const uint4* w = (const uint4*)(start + (int64_t)lead * size);
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const uint4 raw = w[i];
    const int j = lead + i * per_word;
    if (idx64) {
      const int64_t* e = (const int64_t*)&raw;
      mark(j, e[0]);
      mark(j + 1, e[1]);
    } else {
      const int* e = (const int*)&raw;
      for (int q = 0; q < 4; ++q) mark(j + q, e[q]);
    }
  }
  for (int j = tail + threadIdx.x; j < k; j += blockDim.x)
    mark(j, idx64 ? ((const int64_t*)start)[j] : ((const int*)start)[j]);
}

// a value as the blend adds it: rounded to x's dtype T, as float32
template <typename T, typename TV>
__device__ __forceinline__ float blend_value(TV v) {
  if constexpr (std::is_same_v<T, TV>) {
    return to_f(v);
  } else {
    return rnd<T>(to_f(v));
  }
}

// 8 elements as float32 / from float32; 16-byte words (two for float32)
__device__ __forceinline__ void blend_load8(const float* src, float* v) {
  const float4 a = ((const float4*)src)[0], b = ((const float4*)src)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void blend_load8(const __nv_bfloat16* src, float* v) {
  const uint4 raw = *(const uint4*)src;
  const __nv_bfloat16* h = (const __nv_bfloat16*)&raw;
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
}
__device__ __forceinline__ void blend_store8(float* dst, const float* v) {
  ((float4*)dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  ((float4*)dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void blend_store8(__nv_bfloat16* dst, const float* v) {
  uint4 raw;
  __nv_bfloat16* h = (__nv_bfloat16*)&raw;
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(v[i]);
  *(uint4*)dst = raw;
}

// The float32 sum, in slot order from 0, of the values at column col of
// the slots naming row ``row``: the first is j0, and of ``cnt`` > 1 the
// others lie after it.
template <typename T, typename TV>
__device__ __forceinline__ float blend_sum(const TV* vb, const void* index, int idx64,
                                           const bool* mask, int64_t base, int n, int c, int k,
                                           int64_t row, int cnt, int j0, int col) {
  float acc = __fadd_rn(0.f, blend_value<T>(vb[(int64_t)j0 * c + col]));
  for (int j = j0 + 1; cnt > 1 && j < k; ++j)
    if (blend_slot_row(index, idx64, mask, base + j, n) == row)
      acc = __fadd_rn(acc, blend_value<T>(vb[(int64_t)j * c + col]));
  return acc;
}

template <typename T>
__device__ __forceinline__ float blend_out(float x, int cnt, float acc) {
  return rnd<T>(__fadd_rn(__fmul_rn(x, 1.f - (float)cnt), acc));
}

// The named rows of a tile that has landed in shared memory, rewritten in
// place: items of 8 elements (16-byte words) where ``vec8``, else single
// elements, over the tile's rows and columns, the rows no slot names
// skipped.
template <typename T, typename TV>
__device__ __forceinline__ void blend_named_rows(T* tile, const TV* vb, const void* index,
                                                 int idx64, const bool* mask, int b, int n, int c,
                                                 int k, int n0, int rows, const int* count,
                                                 const int* first, bool vec8) {
  const int64_t base = (int64_t)b * k;
  const int width = vec8 ? 8 : 1, per_row = c / width;
  for (int w = threadIdx.x; w < rows * per_row; w += blockDim.x) {
    const int r = w / per_row, col = (w - r * per_row) * width;
    const int cnt = count[r];
    if (cnt == 0) continue;
    const int j0 = first[r];
    const int64_t row = n0 + r;
    T* xr = tile + (int64_t)r * c + col;
    if (!vec8) {
      *xr = from_f<T>(blend_out<T>(to_f(*xr), cnt, blend_sum<T>(vb, index, idx64, mask, base, n,
                                                                 c, k, row, cnt, j0, col)));
      continue;
    }
    float xv[8], acc[8], v[8];
    auto add = [&](int j) {
      blend_load8(vb + (int64_t)j * c + col, v);
      for (int e = 0; e < 8; ++e) acc[e] = __fadd_rn(acc[e], blend_value<T>(v[e]));
    };
    blend_load8(xr, xv);
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    add(j0);
    for (int j = j0 + 1; cnt > 1 && j < k; ++j)
      if (blend_slot_row(index, idx64, mask, base + j, n) == row) add(j);
    for (int e = 0; e < 8; ++e) xv[e] = blend_out<T>(xv[e], cnt, acc[e]);
    blend_store8(xr, xv);
  }
}

template <typename T, typename TV>
__global__ void __launch_bounds__(kBlendThreads)
scatter_blend_kernel(const T* __restrict__ x, const TV* __restrict__ values, const void* index,
                     int idx64, const bool* __restrict__ mask, T* __restrict__ out, int n, int c,
                     int k, int rows, int stages) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ int count[kBlendMaxRows], first[kBlendMaxRows];
  __shared__ __align__(8) uint64_t full[kRowCopyMaxStages];
  const int b = blockIdx.y;
  const int tiles = (n + rows - 1) / rows;
  const int mine = tiles > (int)blockIdx.x ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int row_bytes = c * (int)sizeof(T), tile_bytes = rows * row_bytes;
  const T* xb = x + (int64_t)b * n * c;
  T* ob = out + (int64_t)b * n * c;
  const TV* vb = values + (int64_t)b * k * c;
  const bool bulk = row_bytes % 16 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  const bool vec8 = c % 8 == 0 && (uintptr_t)values % 16 == 0;

  // thread 0: tile ``i`` of this block into stage s
  auto load = [&](int i, int s) {
    const int n0 = (blockIdx.x + i * gridDim.x) * rows;
    const uint32_t bytes = (uint32_t)min(rows, n - n0) * row_bytes;
    const uint32_t bar = smem_u32(&full[s]);
    mbar_expect_tx(bar, bytes);
    bulk_load(smem_u32(ring + (size_t)s * tile_bytes), xb + (int64_t)n0 * c, bytes, bar);
  };
  if (bulk && threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(smem_u32(&full[s]), 1);
    fence_mbar_init();
    for (int i = 0; i < min(stages, mine); ++i) load(i, i);
  }
  auto marks = [&](int n0, int nr) {
    if ((int)threadIdx.x < nr) {
      count[threadIdx.x] = 0;
      first[threadIdx.x] = INT_MAX;
    }
    __syncthreads();
    blend_marks(index, idx64, mask, b, k, n, n0, nr, count, first);
    __syncthreads();
  };
  __syncthreads();

  if (!bulk) {  // element by element, global to global
    for (int i = 0; i < mine; ++i) {
      const int n0 = (blockIdx.x + i * gridDim.x) * rows, nr = min(rows, n - n0);
      marks(n0, nr);
      for (int w = threadIdx.x; w < nr * c; w += blockDim.x) {
        const int r = w / c, col = w - r * c;
        const int64_t at = (int64_t)(n0 + r) * c + col;
        const int cnt = count[r];
        const float acc = cnt == 0 ? 0.f
                                   : blend_sum<T>(vb, index, idx64, mask, (int64_t)b * k, n, c,
                                                  k, n0 + r, cnt, first[r], col);
        ob[at] = from_f<T>(blend_out<T>(to_f(xb[at]), cnt, acc));
      }
      __syncthreads();
    }
    return;
  }

  for (int i = 0; i < mine; ++i) {
    const int s = i % stages;
    const int n0 = (blockIdx.x + i * gridDim.x) * rows, nr = min(rows, n - n0);
    T* tile = (T*)(ring + (size_t)s * tile_bytes);
    marks(n0, nr);
    mbar_wait(smem_u32(&full[s]), (i / stages) & 1);
    blend_named_rows<T>(tile, vb, index, idx64, mask, b, n, c, k, n0, nr, count, first, vec8);
    fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0) {
      bulk_store(ob + (int64_t)n0 * c, smem_u32(tile), (uint32_t)nr * row_bytes);
      bulk_commit();
      // the stage of tile i - 1 takes tile i - 1 + stages once its store has read it
      const int next = i - 1 + stages;
      if (i >= 1 && next < mine) {
        bulk_wait_read<1>();
        load(next, (i - 1) % stages);
      }
    }
  }
  if (threadIdx.x == 0) bulk_wait_read<0>();  // the stages stay until the stores have read them
}

template <typename T, typename TV>
int launch_scatter_blend(const void* x, const void* values, const void* index, int idx64,
                         const void* mask, void* out, int bsz, int n, int c, int k, int rows,
                         int stages, int grid, cudaStream_t stream) {
  const size_t smem = (size_t)stages * rows * c * sizeof(T);
  static size_t limit = 0;
  const int err = fit_dynamic_smem(scatter_blend_kernel<T, TV>, smem, limit);
  if (err != 0) return err;
  scatter_blend_kernel<T, TV><<<dim3(grid, bsz), kBlendThreads, smem, stream>>>(
      (const T*)x, (const TV*)values, index, idx64, (const bool*)mask, (T*)out, n, c, k, rows,
      stages);
  ETK_CHECK_LAUNCH();
  return 0;
}

}  // namespace etk

// x (bsz, n, c) in dtype, values (bsz, k, c) in values_dtype, index (bsz, k)
// int32 or (idx64) int64, mask (bsz, k) bool or null -> out (bsz, n, c);
// rows a tile, stages and the grid's tiles from ops/row_copy.py::blend_plan.
extern "C" int etk_scatter_blend(int dtype, int values_dtype, const void* x, const void* values,
                                 const void* index, int idx64, const void* mask, void* out,
                                 int bsz, int n, int c, int k, int rows, int stages, int grid,
                                 void* stream) {
  if (rows < 1 || rows > etk::kBlendMaxRows || stages < 1 || stages > etk::kRowCopyMaxStages ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  ETK_DISPATCH(dtype, {
    using TX = T;
    ETK_DISPATCH(values_dtype, {
      return etk::launch_scatter_blend<TX, T>(x, values, index, idx64, mask, out, bsz, n, c, k,
                                              rows, stages, grid, (cudaStream_t)stream);
    });
  });
}
