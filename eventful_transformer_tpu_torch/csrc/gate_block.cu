// The blocked gate kernels of large token counts, written for Hopper.
//
// Replaces eventful_transformer_tpu/ops/pallas/gate_block.py:
//   * block_select_p: p' = where(cov, ln(x) | x, p), in place (row 10; row
//     14, gate_fused.py's ln_select, is the same function and launches the
//     same entry). The TPU kernel tiles 1024 rows of (N, C) per grid step;
//     here the warp-per-row select of row_pass.cuh (select_warp_kernel):
//     one warp a token row, 8 rows a block (1024 blocks at ViTDet-1024 with
//     2 streams). A warp reads its row's cov entry first; an unselected
//     row's warp exits there, a selected one loads x's row by 16-byte
//     loads into registers, takes the LN statistics by warp shuffles and
//     stores p' by 16-byte stores. So the call moves cov and x and p' at
//     the selected rows, 1.6 MB in bf16 at k = 256 a stream, C = 768; it
//     waits on two dependent loads (cov, then x), not on bytes. Widths or
//     operands off the rule (ops/row_pass.py::row_body) take the
//     block-per-row kernels of common.cuh.
//   * block_scatter_rows: b'[row_map[index[j]]] = h[j] on the window-major
//     qkv buffer (B, NW, F), in place (row 11); index (B, KP) in any order,
//     row-major token positions mapped through the window map (M entries,
//     the selection's marker N sent to -1) or, without a map, window-major
//     rows. The TPU kernel rebuilds each (rows, KP) one-hot in VMEM and
//     blends every row of b. Here the rows move as they are and every
//     other row of b stays untouched: the call moves 2 x KP x F elements,
//     4.7 MB at B = 2, KP = 256, F = 2304 in bfloat16, 1.4 us at 3.35 TB/s,
//     about one round trip to device memory plus a launch. So it is built
//     for latency, on the bulk copy engine (block_scatter_rows_kernel): a
//     block of one warp takes ``per`` consecutive slots, whose h rows are
//     contiguous, and lane 0 loads them with one cp.async.bulk into shared
//     memory while each lane reads its slot's index and map entry (the map
//     is read here, one more dependent load, not gathered by a launch of
//     its own); once the rows have landed, each lane whose slot names a row
//     stores it with one bulk store. ``per`` spreads the slots over the
//     132 SMs (4 slots a block and 128 blocks at 512 slots, 2 and 128 at
//     256), at most 47 KB a block. A warp-per-slot copy through registers
//     (each lane's 16-byte words all loaded before its stores) took 0.13-
//     0.19 us longer a call and was not kept. A slot writes nothing where
//     its index is -1 or lies outside [0, M) (without a map, [0, NW)) or
//     its map entry lies outside [0, NW), as the one-hot matches no row
//     there. The result is the one-hot's where valid targets are distinct,
//     which top-k selection guarantees.
//   * block_select_scatter: the gate-state select, the scatter-blend of the
//     k-row op output into the token buffer, the skip (or x) add and the
//     next gate's norms, over every row of the row-major state:
//
//       p' = where(cov, ln(x) | x, p)                       (in place)
//       b' = where(cov, h[slot(i)] (0 if i is in no slot), b) (in place)
//       y  = rnd(b' + skip | x);  norms = ||ln(y) - p_next||  (optional)
//
//     The TPU kernel tiles 512 rows per grid step and copies h's rows with
//     a (rows, KP) one-hot matmul on the MXU. Here one launch, on the
//     warp-per-row pass of row_pass.cuh: one warp a token row, 8 rows to a
//     block (1024 blocks at ViTDet-1024, B = 2, N = 4096), every row loaded
//     once with 16-byte loads into registers, the LN statistics and the
//     norms reduced by warp shuffles. A selected row's warp finds its slot
//     itself: it reads index[b, :KP] 32 entries a step, 8 steps in flight
//     (one 1 KB line set at KP = 256, which every selected row of the batch
//     row reads, so it stays in L1/L2), and takes __ballot_sync of
//     index == i; a selected row that no valid slot names gets b' = 0, and
//     an index of -1, or of N or more, matches nothing. Valid indices must
//     be distinct: with a duplicate, the row takes the lowest slot naming
//     it, which the JAX kernel's one-hot sum does not; that is undefined.
//     An unselected row of a form without a y output (the qkv group) reads
//     only its cov entry, so at ViTDet-1024 (k = 256 a batch row) the qkv
//     form moves x, p', h and b' at the 512 selected rows, 6.3 MB in
//     bfloat16 at F = 2304, not the whole buffer. The projection and MLP
//     forms (F = C = 768) read b, the skip (or x) and p_next whole and
//     write y: 50 MB a call, bound by those bytes. Widths or
//     operands the warp body does not take (ops/row_pass.py::row_body) go
//     to the block-per-row body (select_scatter_block_kernel: one
//     256-thread block a row, the slot found by the block).
#include "async_copy.cuh"
#include "row_pass.cuh"

namespace etk {

constexpr int kScatterBlocks = 132;            // row 11's grid: within the card's SMs
constexpr int kScatterStageBytes = 47 * 1024;  // ... a block's rows within 48 KB of shared memory

// Row 11 (see the header): ``per`` (<= 32) consecutive slots of the (bsz *
// kp) slots a block of one warp, rows of ``row_bytes`` bytes; row_map null
// or m int32 entries.
__global__ void __launch_bounds__(32)
block_scatter_rows_kernel(unsigned char* __restrict__ b, const int* __restrict__ index,
                          const unsigned char* __restrict__ h, const int* __restrict__ row_map,
                          int m, int slots, int nw, int kp, int row_bytes, int per) {
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ __align__(8) uint64_t full;
  const int lane = threadIdx.x;
  const int first = blockIdx.x * per;
  const int cnt = min(per, slots - first);
  const uint32_t bar = smem_u32(&full);
  if (lane == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
    mbar_expect_tx(bar, (uint32_t)cnt * row_bytes);
    bulk_load(smem_u32(stage), h + (int64_t)first * row_bytes, (uint32_t)cnt * row_bytes, bar);
  }
  int64_t dst = -1;  // the byte offset of the slot's target row in b
  if (lane < cnt) {
    const int slot = first + lane;
    int64_t i = __ldg(index + slot);
    if (row_map != nullptr) i = i >= 0 && i < m ? (int64_t)__ldg(row_map + i) : -1;
    if (i >= 0 && i < nw) dst = ((int64_t)(slot / kp) * nw + i) * row_bytes;
  }
  __syncwarp();  // the barrier's init before any lane waits on it
  mbar_wait(bar, 0);
  if (dst >= 0) {
    bulk_store(b + dst, smem_u32(stage + (size_t)lane * row_bytes), (uint32_t)row_bytes);
    bulk_commit();
    bulk_wait_read<0>();  // the stage stays until the store has read it
  }
}

// One row r of the blocked group in the block-per-row body. ``scale``
// null: the gate takes x itself (apply_ln=False). ``res``: the skip (width
// f) or x (residual_x, f == c), null without a y output; ``norms`` null
// without the next gate. Dynamic shared memory: (max(c, f) + 32) floats.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
select_scatter_block_kernel(const T* __restrict__ x, T* __restrict__ p, T* __restrict__ b,
                            const float* __restrict__ cov, const int* __restrict__ index,
                            const T* __restrict__ h, const T* __restrict__ scale,
                            const T* __restrict__ bias, const T* __restrict__ res,
                            T* __restrict__ y, const T* __restrict__ p_next,
                            const T* __restrict__ next_scale, const T* __restrict__ next_bias,
                            float* __restrict__ norms, int n, int c, int f, int kp) {
  extern __shared__ float smem[];
  __shared__ int slot;
  float* row = smem;
  float* red = smem + max(c, f);
  const int64_t r = blockIdx.x;
  const bool sel = cov[r] > 0.f;  // uniform over the block
  if (!sel && res == nullptr) return;
  if (sel) {
    if (threadIdx.x == 0) slot = -1;
    __syncthreads();
    const int i = (int)(r % n);
    const int* ir = index + (r / n) * kp;
    for (int j = threadIdx.x; j < kp; j += blockDim.x)
      if (ir[j] == i) slot = j;  // valid indices are distinct: one writer
    T* pr = p + r * c;
    if (scale != nullptr) {
      load_row(x, r, c, row);
      float mean, rstd;
      ln_stats(row, c, red, mean, rstd);
      for (int e = threadIdx.x; e < c; e += blockDim.x)
        pr[e] = from_f<T>(ln_value(row[e], mean, rstd, scale, bias, e));
    } else {
      for (int e = threadIdx.x; e < c; e += blockDim.x) pr[e] = x[r * c + e];
    }
    __syncthreads();  // row is reused below; slot is written
  }
  const int j = sel ? slot : -1;
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

// The slot j of a batch row's index list idx[0, kp) with idx[j] == i, -1 if
// none, found by one warp: 32 entries a step, kSlotSteps steps in flight,
// __ballot_sync of the matches. An invalid slot holds -1 or a value >= n,
// which matches no row i in [0, n).
constexpr int kSlotSteps = 8;

__device__ __forceinline__ int find_slot(const int* __restrict__ idx, int kp, int i, int lane) {
  for (int base = 0; base < kp; base += 32 * kSlotSteps) {
    int t[kSlotSteps];
#pragma unroll
    for (int s = 0; s < kSlotSteps; ++s) {
      const int j = base + 32 * s + lane;
      t[s] = j < kp ? __ldg(idx + j) : -1;
    }
#pragma unroll
    for (int s = 0; s < kSlotSteps; ++s) {
      const unsigned match = __ballot_sync(0xffffffffu, t[s] == i);
      if (match != 0u) return base + 32 * s + __ffs(match) - 1;
    }
  }
  return -1;
}

// The same row pass in the warp-per-row body: one warp a row, K 16-byte
// vectors a lane (row_pass.cuh), K picked by the rows it holds: x (c
// values) and, in a form with y, the F-wide b', y and p_next. A form
// without y copies h's row into b' K vectors a lane a step, so the qkv
// group (F = 3C) holds no F-wide row and keeps its registers, and with
// them its blocks an SM, at those of C. The operands as in the block body.
template <typename T, int K>
__global__ void __launch_bounds__(kRowThreads)
select_scatter_kernel(const T* __restrict__ x, T* __restrict__ p, T* __restrict__ b,
                      const float* __restrict__ cov, const int* __restrict__ index,
                      const T* __restrict__ h, const T* __restrict__ scale,
                      const T* __restrict__ bias, const T* __restrict__ res, T* __restrict__ y,
                      const T* __restrict__ p_next, const T* __restrict__ next_scale,
                      const T* __restrict__ next_bias, float* __restrict__ norms, int64_t rows,
                      int n, int c, int f, int kp) {
  constexpr int E = vec_elems<T>();
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (r >= rows) return;  // every branch below is uniform over the warp
  const bool sel = __ldg(cov + r) > 0.f;
  if (!sel && res == nullptr) return;  // the qkv group's unselected row
  const int nc = c / E, nf = f / E;
  uint4* brow = reinterpret_cast<uint4*>(b + r * f);
  uint4 bv[K];
  if (sel) {
    const int64_t batch = r / n;
    uint4 xv[K];
    load_vecs<K>(x + r * c, nc, lane, xv);
    const int slot = find_slot(index + batch * kp, kp, (int)(r - batch * n), lane);
    warp_store_select<T, K>(xv, p + r * c, nc, lane, c, scale, bias);
    // b' = h[slot], 0 where no valid slot names the row
    const uint4* hrow =
        slot >= 0 ? reinterpret_cast<const uint4*>(h + (batch * kp + slot) * (int64_t)f) : nullptr;
    if (res == nullptr) {  // no y to hold: copied K vectors a lane a step, any F
      for (int base = 0; base < nf; base += 32 * K) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int i = base + lane + 32 * j;
          bv[j] = i < nf && hrow != nullptr ? __ldg(hrow + i) : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int j = 0; j < K; ++j)
          if (base + lane + 32 * j < nf) brow[base + lane + 32 * j] = bv[j];
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int i = lane + 32 * j;
      bv[j] = i < nf && hrow != nullptr ? __ldg(hrow + i) : make_uint4(0u, 0u, 0u, 0u);
      if (i < nf) brow[i] = bv[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int i = lane + 32 * j;
      bv[j] = i < nf ? brow[i] : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (res == nullptr) return;
  // y = rnd(b' + res), kept rounded for the next gate's norms
  uint4 rv[K];
  load_vecs<K>(res + r * f, nf, lane, rv);
  uint4 pv[K];
  if (norms != nullptr) load_vecs<K>(p_next + r * f, nf, lane, pv);
  uint4* yrow = reinterpret_cast<uint4*>(y + r * f);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int i = lane + 32 * j;
    if (i < nf) {
      float v[E], w[E];
      unpack<T>(bv[j], v);
      unpack<T>(rv[j], w);
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] += w[e];
      rv[j] = pack<T>(v);
      yrow[i] = rv[j];
    }
  }
  if (norms == nullptr) return;
  const float norm = warp_ln_error_norm<T, K>(rv, pv, nf, lane, f, next_scale, next_bias);
  if (lane == 0) norms[r] = norm;
}

template <typename T>
int block_select_scatter(int body, const void* x, void* p, void* b, const float* cov,
                         const int* index, const void* h, const void* scale, const void* bias,
                         const void* skip, int residual_x, const void* p_next,
                         const void* next_scale, const void* next_bias, void* y, float* norms,
                         int bsz, int n, int c, int f, int kp, cudaStream_t stream) {
  const T* res = skip != nullptr ? (const T*)skip : (residual_x ? (const T*)x : nullptr);
  if (!warp_row_takes<T>(body, {c, f},
                         {x, p, b, h, scale, bias, res, y, p_next, next_scale, next_bias}))
    return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)bsz * n;
  if (rows == 0) return 0;
  if (body == kRowBlock) {
    select_scatter_block_kernel<T><<<(unsigned)rows, kRowThreads, row_smem_bytes(c > f ? c : f),
                                     stream>>>(
        (const T*)x, (T*)p, (T*)b, cov, index, (const T*)h, (const T*)scale, (const T*)bias, res,
        (T*)y, (const T*)p_next, (const T*)next_scale, (const T*)next_bias, norms, n, c, f, kp);
    ETK_CHECK_LAUNCH();
    return 0;
  }
  return with_row_vecs<T>(res != nullptr && f > c ? f : c, [&](auto k) {
    select_scatter_kernel<T, decltype(k)::value><<<warp_row_blocks(rows), kRowThreads, 0,
                                                   stream>>>(
        (const T*)x, (T*)p, (T*)b, cov, index, (const T*)h, (const T*)scale, (const T*)bias, res,
        (T*)y, (const T*)p_next, (const T*)next_scale, (const T*)next_bias, norms, rows, n, c,
        f, kp);
    ETK_CHECK_LAUNCH();
    return 0;
  });
}

}  // namespace etk

extern "C" {

// Rows 10 and 14: p' = where(cov, ln(x) | x, p) in place over ``rows``
// rows of width c; scale and bias null: x itself. body: the row body
// (ops/row_pass.py ROW_BODY_CODES); a warp call off its rule is refused.
int etk_block_select_p(int dtype, int body, const void* x, void* p, const void* cov,
                       const void* scale, const void* bias, long long rows, int c, void* stream) {
  if (cov == nullptr) return (int)cudaErrorInvalidValue;
  ETK_DISPATCH(dtype, return etk::launch_select<T>(body, (const T*)x, (T*)p, (const float*)cov,
                                                   (const T*)scale, (const T*)bias, rows, c,
                                                   (cudaStream_t)stream));
}

// Row 11: b (bsz, nw, f) <- h (bsz, kp, f) at rows row_map[index] (m
// entries; null: index itself), index (bsz, kp) int32; rows whole 16-byte
// words on 16-byte boundaries (cudaErrorMisalignedAddress otherwise).
int etk_block_scatter_rows(int dtype, void* b, const void* index, const void* h,
                           const void* row_map, int m, int bsz, int nw, int kp, int f,
                           void* stream) {
  const int size = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;  // float32, bfloat16: bytes are bytes
  if (size == 0 || f <= 0) return (int)cudaErrorInvalidValue;
  const int row_bytes = f * size;
  if (row_bytes % 16 || (uintptr_t)b % 16 || (uintptr_t)h % 16)
    return (int)cudaErrorMisalignedAddress;
  const int slots = bsz * kp;
  if (slots == 0) return 0;
  int per = (slots + etk::kScatterBlocks - 1) / etk::kScatterBlocks;
  per = per > 32 ? 32 : per;
  while (per > 1 && per * row_bytes > etk::kScatterStageBytes) --per;
  etk::block_scatter_rows_kernel<<<(slots + per - 1) / per, 32, (size_t)per * row_bytes,
                                   (cudaStream_t)stream>>>(
      (unsigned char*)b, (const int*)index, (const unsigned char*)h, (const int*)row_map, m,
      slots, nw, kp, row_bytes, per);
  ETK_CHECK_LAUNCH();
  return 0;
}

int etk_block_select_scatter(int dtype, int body, const void* x, void* p, void* b,
                             const void* cov, const void* index, const void* h,
                             const void* scale, const void* bias, const void* skip,
                             int residual_x, const void* p_next, const void* next_scale,
                             const void* next_bias, void* y, void* norms, int bsz, int n, int c,
                             int f, int kp, void* stream) {
  ETK_DISPATCH(dtype, return etk::block_select_scatter<T>(
                          body, x, p, b, (const float*)cov, (const int*)index, h, scale, bias,
                          skip, residual_x, p_next, next_scale, next_bias, y, (float*)norms, bsz,
                          n, c, f, kp, (cudaStream_t)stream));
}

}  // extern "C"
