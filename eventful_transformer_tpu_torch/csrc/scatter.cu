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
// memory. The copies move 2 K C elements and do no arithmetic, so the
// kernels are bound by those bytes (at stgt_672's qkv buffer, B = 2, K =
// 256, C = 2304 in bfloat16: 4.7 MB, 1.4 us at 3.35 TB/s) and, at such
// sizes, by the launch and the latency of the first bytes. In the scatter
// one warp takes one slot: it reads the slot's index (and mask) itself and
// copies the row with 16-byte loads and stores, neighbouring lanes on
// neighbouring addresses; 8 slots a block of 256 threads. The gather keeps
// more bytes in flight on more SMs with the bulk copy engine
// (gather_rows_kernel below).
//
// The scatter casts values to the buffer's dtype in the kernel (rounding
// to nearest even, as the JAX wrapper's astype does, scatter.py:62); rows of
// one dtype are copied as raw bytes, so both kernels are exact copies. A
// slot whose index lies outside [0, N) writes nothing (the scatter) or a
// row of zeros (the gather); the TPU kernels leave that undefined. Distinct
// valid indices are the contract (scatter.py:9): two slots naming one row
// race, as the TPU's DMAs do.
#include <type_traits>

#include "async_copy.cuh"
#include "common.cuh"

namespace etk {

constexpr int kRowCopyThreads = 256;  // 8 warps, one slot each
constexpr int kGatherThreads = 32;  // one warp: it issues the copies and zeroes the rest
constexpr int kGatherMaxSlots = 32;  // slots of a gather group: one lane of warp 0 each

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

// The gather as a bulk row copy (row 20). A persistent grid: each block
// walks the groups of ``per`` consecutive slots blockIdx.x, blockIdx.x +
// gridDim.x, ... through a ring of ``stages`` groups in shared memory (per,
// stages and the grid from ops/row_copy.py::gather_plan). The lanes of warp
// 0 read a group's indices, one slot each, and each lane whose slot names a
// row issues one cp.async.bulk of that row into the group's stage, on the
// stage's mbarrier (expecting valid rows x row bytes); ``stages`` groups
// ahead. Once they have landed, the threads zero the rows of the slots
// that name none and one thread stores the group, whose ``per`` output
// rows are contiguous, with one bulk store. Bytes are copied as they are.
__global__ void __launch_bounds__(kGatherThreads)
gather_rows_kernel(const unsigned char* __restrict__ buffer, const void* index, int idx64,
                   unsigned char* __restrict__ rows, int slots, int n, int k, int row_bytes,
                   int per, int stages) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kRowCopyMaxStages];
  __shared__ unsigned valid[kRowCopyMaxStages];  // bit r: slot r of the stage's group names a row
  const int groups = (slots + per - 1) / per;
  const int mine =
      groups > (int)blockIdx.x ? (groups - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int group_bytes = per * row_bytes;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // warp 0, each lane its slot of this block's group i: the byte offset of
  // the row it names in the buffer, or -1
  auto source = [&](int i) -> int64_t {
    const int slot = (blockIdx.x + i * gridDim.x) * per + lane;
    if (lane >= per || slot >= slots) return -1;
    const int64_t r = slot_index(index, idx64, slot);
    return r >= 0 && r < n ? ((int64_t)(slot / k) * n + r) * row_bytes : -1;
  };
  // warp 0: those rows into stage s
  auto load = [&](int s, int64_t src) {
    const unsigned bits = __ballot_sync(0xffffffffu, src >= 0);
    const uint32_t bar = smem_u32(&full[s]);
    if (lane == 0) {
      valid[s] = bits;
      mbar_expect_tx(bar, (uint32_t)__popc(bits) * row_bytes);
    }
    __syncwarp();
    if (src >= 0)
      bulk_load(smem_u32(ring + (size_t)s * group_bytes + (size_t)lane * row_bytes),
                buffer + src, row_bytes, bar);
  };
  if (warp == 0) {
    if (lane == 0) {
      for (int s = 0; s < stages; ++s) mbar_init(smem_u32(&full[s]), 1);
      fence_mbar_init();
    }
    __syncwarp();
    for (int i = 0; i < min(stages, mine); ++i) load(i, source(i));
  }
  __syncthreads();
  const int words = row_bytes / 16;
  for (int i = 0; i < mine; ++i) {
    const int s = i % stages, g = blockIdx.x + i * gridDim.x;
    const int cnt = min(per, slots - g * per);
    unsigned char* stage = ring + (size_t)s * group_bytes;
    mbar_wait(smem_u32(&full[s]), (i / stages) & 1);
    const unsigned bits = valid[s];
    if (bits != (cnt == 32 ? 0xffffffffu : (1u << cnt) - 1u)) {
      for (int w = threadIdx.x; w < cnt * words; w += blockDim.x)
        if (!(bits >> (w / words) & 1u)) ((uint4*)stage)[w] = make_uint4(0, 0, 0, 0);
      fence_proxy_async();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      bulk_store(rows + (int64_t)g * group_bytes, smem_u32(stage), (uint32_t)cnt * row_bytes);
      bulk_commit();
    }
    // the stage of group i - 1 takes group i - 1 + stages once its store has read it
    const int next = i - 1 + stages;
    if (warp == 0 && i >= 1 && next < mine) {
      const int64_t src = source(next);
      if (lane == 0) bulk_wait_read<1>();
      __syncwarp();
      load((i - 1) % stages, src);
    }
  }
  if (threadIdx.x == 0) bulk_wait_read<0>();  // the stages stay until the stores have read them
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
// k, c); slots a group, stages and the grid from
// ops/row_copy.py::gather_plan. Rows are whole 16-byte words and the
// buffer and rows start on 16-byte boundaries (the wrapper checks).
int etk_gather_rows(int dtype, const void* buffer, const void* index, int idx64, void* rows,
                    int bsz, int n, int c, int k, int per, int stages, int grid, void* stream) {
  const int slots = bsz * k;
  if (slots == 0) return 0;
  const int size = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;  // float32, bfloat16: bytes are bytes
  if (size == 0 || per < 1 || per > etk::kGatherMaxSlots || stages < 1 ||
      stages > etk::kRowCopyMaxStages || grid < 1)
    return (int)cudaErrorInvalidValue;
  const int row_bytes = c * size;
  if (row_bytes % 16 || (uintptr_t)buffer % 16 || (uintptr_t)rows % 16)
    return (int)cudaErrorMisalignedAddress;
  const size_t smem = (size_t)stages * per * row_bytes;
  static size_t limit = 0;
  const int err = etk::fit_dynamic_smem(etk::gather_rows_kernel, smem, limit);
  if (err != 0) return err;
  etk::gather_rows_kernel<<<grid, etk::kGatherThreads, smem, (cudaStream_t)stream>>>(
      (const unsigned char*)buffer, index, idx64, (unsigned char*)rows, slots, n, k, row_bytes,
      per, stages);
  ETK_CHECK_LAUNCH();
  return 0;
}

}  // extern "C"
