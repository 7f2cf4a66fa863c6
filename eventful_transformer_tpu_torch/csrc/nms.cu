// Greedy NMS with a static output capacity, on the card with no host read.
//
// Replaces no Pallas kernel: the JAX package computes
// eventful_transformer_tpu/detection/nms.py::nms_padded in XLA, as a Jacobi
// fixpoint under one lax.while_loop (n <= 1024) or a blocked kept-set loop
// under another (n > 1024). The port's plain version
// (detection/nms.py::nms_padded_plain) reads a convergence flag back to the
// host every few steps, which a captured frame cannot do; this kernel pair
// computes the same output, index for index, with the loop on the card.
//
// The caller (ops/nms.py::nms_padded) sorts the scores (stable, descending)
// and hands over the boxes in score order as float32 (n, 4), the validity of
// each (score > -inf) and the order. Then:
//   * nms_mask_kernel: block (c, r) of 64 threads, thread t the box
//     i = 64 r + t against the 64 boxes j = 64 c + k (loaded to shared
//     memory), writes the word mask[i][c] with bit k set where j > i and
//     iou(i, j) > threshold; blocks with c < r return (the walk reads no
//     word left of a box's own). The IoU is detection/boxes.py::iou_matrix's
//     arithmetic op for op, each step rounded (__f*_rn: no contraction into
//     FMAs), union > 0 else 0, compared in float32 as torch compares a
//     float32 tensor with a Python float.
//   * nms_walk_kernel: one block walks the boxes in score order a chunk of
//     64 at a time. Thread 0 decides the chunk's boxes in order against the
//     chunk's word of the shared "removed" bitset and their own diagonal
//     words (a kept box removes the later boxes of its chunk at once), and
//     stops at max_out keeps; then the threads OR the kept boxes' mask rows
//     into the later words of "removed", one word a thread. The kept
//     positions go straight to the output through the order.
//   * the slots past the count: the plain version's small form (n <= 1024)
//     lists the boxes it did not keep, in score order, after the kept ones
//     (warp 0 ranks them with ballots); its blocked form leaves them at
//     order[0]. mask[s] = s < count.
//
// The function's bound is bytes: the boxes and scores read once, the
// indices and mask written once. The mask pass's words (the upper triangle
// of n x ceil(n / 64): 1.06 MB at n = 4096) are this design's own traffic,
// not the function's. The walk is a serial chain of ceil(n / 64) steps, each a
// dependent load and a block barrier: its time is latency, not bandwidth,
// and ends early once max_out boxes are kept.
#include <stdint.h>

#include "async_copy.cuh"
#include "common.cuh"

namespace etk {

constexpr int kNmsChunk = 64;    // boxes a mask word covers
constexpr int kNmsThreads = 256;  // threads of the walk

__device__ __forceinline__ float nms_clamp0(float x) { return x < 0.f ? 0.f : x; }
// torch.maximum / torch.minimum: NaN propagates
__device__ __forceinline__ float nms_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}
__device__ __forceinline__ float nms_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

__device__ __forceinline__ float nms_area(float4 b) {
  return __fmul_rn(nms_clamp0(__fsub_rn(b.z, b.x)), nms_clamp0(__fsub_rn(b.w, b.y)));
}

// iou_matrix(a, b)[0, 0] as torch computes it: area_a + area_b - inter,
// inter / union where union > 0, else 0
__device__ __forceinline__ float nms_iou(float4 a, float area_a, float4 b, float area_b) {
  const float w = nms_clamp0(__fsub_rn(nms_min(a.z, b.z), nms_max(a.x, b.x)));
  const float h = nms_clamp0(__fsub_rn(nms_min(a.w, b.w), nms_max(a.y, b.y)));
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

__global__ void __launch_bounds__(kNmsChunk)
nms_mask_kernel(const float4* __restrict__ boxes, int n, int words, float threshold,
                unsigned long long* __restrict__ mask) {
  const int c = blockIdx.x, r = blockIdx.y;
  if (c < r) return;
  __shared__ float4 cols[kNmsChunk];
  __shared__ float col_area[kNmsChunk];
  const int j = c * kNmsChunk + threadIdx.x;
  if (j < n) {
    cols[threadIdx.x] = boxes[j];
    col_area[threadIdx.x] = nms_area(boxes[j]);
  }
  __syncthreads();
  const int i = r * kNmsChunk + threadIdx.x;
  if (i >= n) return;
  const float4 a = boxes[i];
  const float area_a = nms_area(a);
  const int cols_here = min(kNmsChunk, n - c * kNmsChunk);
  unsigned long long bits = 0;
  for (int k = 0; k < cols_here; ++k) {
    const int jk = c * kNmsChunk + k;
    // the later box first, as iou_matrix(later, earlier); the sum is
    // commutative, so the bits do not depend on it
    if (jk > i && nms_iou(cols[k], col_area[k], a, area_a) > threshold) bits |= 1ull << k;
  }
  mask[(int64_t)i * words + c] = bits;
}

__global__ void __launch_bounds__(kNmsThreads)
nms_walk_kernel(const unsigned long long* __restrict__ mask, const bool* __restrict__ valid,
                const int64_t* __restrict__ order, int n, int words, int max_out, int out_len,
                int fill_unkept, int* __restrict__ indices, bool* __restrict__ out_mask) {
  extern __shared__ unsigned long long walk_smem[];
  unsigned long long* removed = walk_smem;       // (words,)
  unsigned long long* kept_bits = walk_smem + words;  // (words,)
  __shared__ unsigned long long diag[kNmsChunk];
  __shared__ bool alive[kNmsChunk];
  __shared__ int chunk_keep[kNmsChunk];
  __shared__ int chunk_kept, total;
  for (int w = threadIdx.x; w < words; w += blockDim.x) removed[w] = kept_bits[w] = 0;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();

  for (int c = 0; c < words; ++c) {
    if (total >= max_out) break;  // uniform: read after a barrier
    const int base = c * kNmsChunk;
    if (threadIdx.x < kNmsChunk) {
      const int i = base + threadIdx.x;
      diag[threadIdx.x] = i < n ? mask[(int64_t)i * words + c] : 0ull;
      alive[threadIdx.x] = i < n && valid[i];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long cur = removed[c], keep = 0;
      int cnt = 0;
      const int here = min(kNmsChunk, n - base);
      for (int k = 0; k < here && total + cnt < max_out; ++k) {
        if (alive[k] && !((cur >> k) & 1ull)) {
          chunk_keep[cnt++] = k;
          keep |= 1ull << k;
          cur |= diag[k];
        }
      }
      kept_bits[c] = keep;
      chunk_kept = cnt;
    }
    __syncthreads();
    const int cnt = chunk_kept;
    for (int w = c + 1 + threadIdx.x; w < words; w += blockDim.x) {
      unsigned long long acc = removed[w];
      for (int q = 0; q < cnt; ++q) acc |= mask[(int64_t)(base + chunk_keep[q]) * words + w];
      removed[w] = acc;
    }
    if ((int)threadIdx.x < cnt) {
      const int slot = total + threadIdx.x;
      if (slot < out_len) indices[slot] = (int)order[base + chunk_keep[threadIdx.x]];
    }
    __syncthreads();
    if (threadIdx.x == 0) total += cnt;
    __syncthreads();
  }

  const int count = total;
  for (int s = threadIdx.x; s < max_out; s += blockDim.x) out_mask[s] = s < count;
  if (count >= out_len) return;
  if (!fill_unkept) {  // the blocked form: unfilled slots name order[0]
    const int first = (int)order[0];
    for (int s = count + threadIdx.x; s < out_len; s += blockDim.x) indices[s] = first;
    return;
  }
  // the small form: the boxes not kept, in score order, after the kept ones
  if (threadIdx.x >= 32) return;
  const unsigned lane = threadIdx.x;
  int slot = count;
  for (int b0 = 0; b0 < n && slot < out_len; b0 += 32) {
    const int i = b0 + lane;
    const bool unkept = i < n && !((kept_bits[i / kNmsChunk] >> (i % kNmsChunk)) & 1ull);
    const unsigned ballot = __ballot_sync(0xffffffffu, unkept);
    const int s = slot + __popc(ballot & ((1u << lane) - 1u));
    if (unkept && s < out_len) indices[s] = (int)order[i];
    slot += __popc(ballot);
  }
}

}  // namespace etk

// Greedy NMS over n boxes already in score order: boxes (n, 4) float32,
// valid (n,) bool, order (n,) int64 (the sort's permutation), the
// suppression words mask (n, ceil(n / 64)) uint64 as scratch; writes indices
// (out_len,) int32 and out_mask (max_out,) bool.
// fill_unkept: 1 for the plain version's small form (n <= 1024), 0 for its
// blocked form.
extern "C" int etk_nms(const void* boxes, const void* valid, const void* order, void* mask, int n,
                       float threshold, int max_out, int out_len, int fill_unkept, void* indices,
                       void* out_mask, void* stream) {
  if (n < 1 || max_out < 1 || out_len < 1 || out_len > max_out) return (int)cudaErrorInvalidValue;
  const int words = (n + etk::kNmsChunk - 1) / etk::kNmsChunk;
  const size_t smem = 2 * (size_t)words * sizeof(unsigned long long);
  static size_t limit = 0;
  const int err = etk::fit_dynamic_smem(etk::nms_walk_kernel, smem, limit);
  if (err != 0) return err;
  cudaStream_t s = (cudaStream_t)stream;
  etk::nms_mask_kernel<<<dim3(words, words), etk::kNmsChunk, 0, s>>>(
      (const float4*)boxes, n, words, threshold, (unsigned long long*)mask);
  ETK_CHECK_LAUNCH();
  etk::nms_walk_kernel<<<1, etk::kNmsThreads, smem, s>>>(
      (const unsigned long long*)mask, (const bool*)valid, (const int64_t*)order, n, words,
      max_out, out_len, fill_unkept, (int*)indices, (bool*)out_mask);
  ETK_CHECK_LAUNCH();
  return 0;
}
