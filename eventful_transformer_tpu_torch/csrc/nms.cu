// Greedy NMS with a static output capacity: one launch of one block, no host
// read, no scratch on the model paths.
//
// Replaces no Pallas kernel: the JAX package computes
// eventful_transformer_tpu/detection/nms.py::nms_padded in XLA, as a Jacobi
// fixpoint under one lax.while_loop (n <= 1024) or a blocked kept-set loop
// under another (n > 1024). The port's plain version
// (detection/nms.py::nms_padded_plain) reads a convergence flag back to the
// host every few steps, which a captured frame cannot do; this kernel
// computes the same output, index for index, with the loop on the card.
//
// The caller (ops/nms.py::nms_padded) hands over the boxes (n, 4) and scores
// (n,) as they are (float32, bfloat16 or float16; a score of -inf marks an
// invalid box). nms_kernel, 1024 threads:
//   1. the order: each score's 32-bit key (that of -score as torch.sort
//      compares it ascending: -0.0 folded into +0.0, NaN last), the scores
//      checked in order with it and the valid boxes (key below that of
//      +inf) counted. Every model path hands over scores already in order
//      (batched_nms cut them with a stable descending sort), and then the
//      permutation is the identity. Otherwise a bitonic network sorts
//      (key << 32 | index) in shared memory (4096 keys: 32 KB; past the
//      budget of ops/nms.py, in the caller's scratch): distinct composite
//      keys, so the order is torch.sort(-scores, stable=True)'s. Its steps
//      over pairs closer than 64 stay inside a warp's keys and sync the
//      warp alone (63 of 78 steps at 4096). The valid boxes are then the
//      first nvalid positions.
//   2. the walk: the valid candidates in score order a chunk of 32 at a
//      time, lane j of every warp holding candidate base + j (its box read
//      from device memory in its original dtype, the next chunk's load in
//      flight behind this one's work). Warp w tests the chunk against kept
//      boxes w, w + 32, ... in shared memory (20 bytes a box, max_out of
//      them) and chunk box w against each later one (32 x 32 pairs, one a
//      thread), each as a ballot into a shared word. After a block barrier
//      warp 0 resolves the chunk alone: alive = valid and hit by no kept
//      box; keep = the fixpoint of alive & ~OR{row i : i in keep}, one
//      __reduce_or_sync a step (unique, reached in at most 32 steps, one or
//      two on sparse chunks); the first max_out - total survivors appended
//      to the kept set and the indices. A second barrier publishes them;
//      the walk ends at max_out keeps. No n x n matrix is built. (Every
//      warp resolving the chunk alike, with the last chunk's keeps tested
//      from registers and one barrier a chunk, measured slower on the card;
//      PERF.md section 6.)
//   3. the slots past the count: the plain version's small form (n <= 1024)
//      lists the boxes it did not keep, in score order, after the kept ones
//      (each position's slot from its chunk's keep word and the count before
//      the chunk); its blocked form leaves them at order[0].
//      mask[s] = s < count.
//
// The IoU is detection/boxes.py::iou_matrix op for op (__f*_rn: no
// contraction into FMAs; NaN propagated through max and min; 0 where the
// union is not > 0), compared in float32 with the threshold. The common
// case takes no division: with u = 2^-24, P = fl(union * t) and t a normal
// positive float, inter < fl(P * (1 - 2^-20)) proves inter / union < t, and
// inter > fl(P * (1 + 2^-20)) proves inter / union > t (1 + 14u), past the
// next float above t, so fl(inter / union) > t; between the two, or where P
// leaves [2^-100, 2^100], the division __fdiv_rn decides as before.
//
// The function's bound is bytes (boxes, scores, indices and mask once); the
// walk is a chain of dependent chunk decisions, two block barriers each: a
// chunk costs the kept-set tests of its 32 candidates (mostly the overlap
// test's early exit) and those barriers, for ceil(positions walked / 32)
// chunks, ending early at max_out keeps.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "common.cuh"

namespace etk {

constexpr int kNmsChunk = 32;  // candidates decided together: one warp's lanes
constexpr int kNmsThreads = 1024;
constexpr int kNmsWarps = kNmsThreads / 32;
constexpr int kNmsFillMax = 1024;  // the small form's n at most: 32 chunk words
constexpr unsigned kNmsFull = 0xffffffffu;
constexpr uint32_t kNmsKeyInf = 0xff800000u;  // key of -score = +inf: a score of -inf

// element i of a float32 (0), bfloat16 (1) or float16 (2) array, as float32
__device__ __forceinline__ float nms_load(const void* p, int64_t i, int dtype) {
  if (dtype == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dtype == 2) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// The key of a score: ascending keys are torch.sort(-scores)'s ascending
// order (-0.0 == +0.0, NaN after +inf); equal keys keep the index order.
__device__ __forceinline__ uint32_t nms_key(float s) {
  const float v = -s;
  if (v != v) return 0xffffffffu;
  const uint32_t b = __float_as_uint(v == 0.f ? 0.f : v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

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

// iou_matrix(a, b)[0, 0] > t as torch computes it (inter / union where
// union > 0, else 0), the division only near the threshold. fast: t is a
// normal positive float32, so only inter > 0 can suppress; boxes that do
// not overlap (most pairs) leave after the overlap's two sides, taken with
// fminf / fmaxf: with no NaN these are torch's sides, and a NaN coordinate
// makes inter NaN, which suppresses nothing either way.
__device__ __forceinline__ bool nms_suppresses(float4 a, float area_a, float4 b, float area_b,
                                               float t, bool fast) {
  if (fast && (!(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)) > 0.f) ||
               !(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)) > 0.f)))
    return false;
  const float w = nms_clamp0(__fsub_rn(nms_min(a.z, b.z), nms_max(a.x, b.x)));
  const float h = nms_clamp0(__fsub_rn(nms_min(a.w, b.w), nms_max(a.y, b.y)));
  const float inter = __fmul_rn(w, h);
  if (fast && inter == 0.f) return false;  // an IoU of 0 either way
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  if (!(uni > 0.f)) return 0.f > t;
  if (fast) {
    const float p = __fmul_rn(uni, t);
    if (p >= 0x1p-100f && p <= 0x1p100f) {
      if (inter < __fmul_rn(p, 1.f - 0x1p-20f)) return false;
      if (inter > __fmul_rn(p, 1.f + 0x1p-20f)) return true;
    }
  }
  return __fdiv_rn(inter, uni) > t;
}

__device__ __forceinline__ float4 nms_shfl(float4 v, int src) {
  return make_float4(__shfl_sync(kNmsFull, v.x, src), __shfl_sync(kNmsFull, v.y, src),
                     __shfl_sync(kNmsFull, v.z, src), __shfl_sync(kNmsFull, v.w, src));
}

// the original index of position i of the score order
__device__ __forceinline__ int nms_order(const unsigned long long* keys, bool in_order, int i) {
  return in_order ? i : (int)(uint32_t)keys[i];
}

// position c's original index (-1 past the valid ones) and its box
__device__ __forceinline__ int nms_fetch(const void* boxes, int box_dtype,
                                         const unsigned long long* keys, bool in_order, int nvalid,
                                         int c, float4& b) {
  b = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c >= nvalid) return -1;
  const int idx = nms_order(keys, in_order, c);
  b = make_float4(nms_load(boxes, 4 * (int64_t)idx, box_dtype),
                  nms_load(boxes, 4 * (int64_t)idx + 1, box_dtype),
                  nms_load(boxes, 4 * (int64_t)idx + 2, box_dtype),
                  nms_load(boxes, 4 * (int64_t)idx + 3, box_dtype));
  return idx;
}

__global__ void __launch_bounds__(kNmsThreads)
nms_kernel(const void* __restrict__ boxes, int box_dtype, const void* __restrict__ scores,
           int score_dtype, int n, float t, int max_out, int out_len, int fill_unkept,
           unsigned long long* __restrict__ key_scratch, int* __restrict__ indices,
           bool* __restrict__ out_mask) {
  extern __shared__ __align__(16) unsigned char nms_smem[];
  int np2 = 1;
  while (np2 < n) np2 <<= 1;
  float4* kept_box = reinterpret_cast<float4*>(nms_smem);  // (max_out,)
  unsigned long long* keys =
      key_scratch ? key_scratch : reinterpret_cast<unsigned long long*>(kept_box + max_out);
  float* kept_area = reinterpret_cast<float*>(key_scratch ? (void*)(kept_box + max_out)
                                                          : (void*)(keys + np2));  // (max_out,)
  __shared__ int valid_count[kNmsWarps];
  __shared__ unsigned hit_word[kNmsWarps];  // the chunk's lanes a warp's kept boxes hit
  __shared__ unsigned pair_row[kNmsChunk];  // row i: the later chunk boxes box i hits
  __shared__ unsigned keep_word[kNmsFillMax / kNmsChunk];
  __shared__ int kept_before[kNmsFillMax / kNmsChunk];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool fast = t >= 1.17549435e-38f && t <= 3.40282347e38f;

  // 1. in order already? and how many are valid
  int valid = 0, unsorted = 0;
  for (int i = tid; i < n; i += kNmsThreads) {
    const uint32_t k = nms_key(nms_load(scores, i, score_dtype));
    valid += k < kNmsKeyInf;
    if (i + 1 < n && k > nms_key(nms_load(scores, i + 1, score_dtype))) unsorted = 1;
  }
  valid = __reduce_add_sync(kNmsFull, valid);
  if (lane == 0) valid_count[warp] = valid;
  const bool in_order = !__syncthreads_or(unsorted);
  const int nvalid = __reduce_add_sync(kNmsFull, lane < kNmsWarps ? valid_count[lane] : 0);
  if (!in_order) {  // uniform: the stable sort of (key, index)
    for (int i = tid; i < np2; i += kNmsThreads)
      keys[i] = i < n ? (unsigned long long)nms_key(nms_load(scores, i, score_dtype)) << 32 | i
                      : ~0ull;
    __syncthreads();
    // a step with j <= 32 exchanges inside the 64 keys of each of its
    // warp's pairs 32 w ... 32 w + 31 (and those 1024 pairs on): __syncwarp
    // between two such steps, a block barrier around the others
    for (int k = 2; k <= np2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int p = tid; p < np2 / 2; p += kNmsThreads) {
          const int i = 2 * p - (p & (j - 1)), l = i + j;
          const unsigned long long a = keys[i], b = keys[l];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[l] = a;
          }
        }
        const int next = j > 1 ? j >> 1 : k;  // the next step's j
        if (j > 32 || next > 32)
          __syncthreads();
        else
          __syncwarp();
      }
    }
    __syncthreads();
  }

  // 2. the walk
  __shared__ int kept_total;
  int total = 0, chunks = 0;
  float4 next_box;
  int next_idx = nms_fetch(boxes, box_dtype, keys, in_order, nvalid, lane, next_box);
  for (int base = 0; base < nvalid; base += kNmsChunk) {  // uniform
    const float4 box = next_box;
    const int idx = next_idx;
    next_idx = nms_fetch(boxes, box_dtype, keys, in_order, nvalid, base + kNmsChunk + lane,
                         next_box);  // in flight behind this chunk
    const bool in = idx >= 0;
    const float area = nms_area(box);
    bool hit = false;
    if (in)
      for (int k = warp; k < total && !hit; k += kNmsWarps)
        hit = nms_suppresses(box, area, kept_box[k], kept_area[k], t, fast);
    const unsigned hits = __ballot_sync(kNmsFull, hit);
    for (int i = warp; i < kNmsChunk; i += kNmsWarps) {
      const float4 bi = nms_shfl(box, i);
      const float ai = __shfl_sync(kNmsFull, area, i);
      const unsigned row =
          __ballot_sync(kNmsFull, in && lane > i && nms_suppresses(bi, ai, box, area, t, fast));
      if (lane == 0) pair_row[i] = row;
    }
    if (lane == 0) hit_word[warp] = hits;
    __syncthreads();
    if (warp == 0) {  // resolves the chunk, appends its keeps
      const unsigned alive = __ballot_sync(kNmsFull, in) &
                             ~__reduce_or_sync(kNmsFull, lane < kNmsWarps ? hit_word[lane] : 0u);
      const unsigned row = pair_row[lane];
      unsigned keep = alive;
      for (;;) {  // the greedy keep set as the fixpoint, one step a reduction
        const unsigned step = alive & ~__reduce_or_sync(kNmsFull, (keep >> lane) & 1u ? row : 0u);
        if (step == keep) break;
        keep = step;
      }
      while (__popc(keep) > max_out - total) keep &= ~(0x80000000u >> __clz(keep));
      if ((keep >> lane) & 1u) {
        const int slot = total + __popc(keep & ((1u << lane) - 1u));
        kept_box[slot] = box;
        kept_area[slot] = area;
        indices[slot] = idx;
      }
      if (lane == 0) {
        if (chunks < kNmsFillMax / kNmsChunk) {
          keep_word[chunks] = keep;
          kept_before[chunks] = total;
        }
        kept_total = total + __popc(keep);
      }
    }
    __syncthreads();
    total = kept_total;
    ++chunks;
    if (total >= max_out) break;
  }

  // 3. the mask and the slots past the count
  const int count = total;
  for (int s = tid; s < max_out; s += kNmsThreads) out_mask[s] = s < count;
  if (count >= out_len) return;
  if (!fill_unkept) {  // the blocked form: unfilled slots name order[0]
    const int first = nms_order(keys, in_order, 0);
    for (int s = count + tid; s < out_len; s += kNmsThreads) indices[s] = first;
    return;
  }
  // the small form: the boxes not kept, in score order, after the kept ones
  for (int i = tid; i < n; i += kNmsThreads) {
    const int c = i / kNmsChunk, bit = i % kNmsChunk;
    const unsigned word = c < chunks ? keep_word[c] : 0u;
    if ((word >> bit) & 1u) continue;
    const int before = (c < chunks ? kept_before[c] : count) + __popc(word & ((1u << bit) - 1u));
    const int slot = count + i - before;
    if (slot < out_len) indices[slot] = nms_order(keys, in_order, i);
  }
}

}  // namespace etk

// Greedy NMS over boxes (n, 4) and scores (n,) in their own order, each
// float32 (0), bfloat16 (1) or float16 (2); writes indices (out_len,) int32
// and out_mask (max_out,) bool. fill_unkept: 1 for the plain version's small
// form (n <= 1024), 0 for its blocked form. key_scratch: null to sort in
// shared memory, else (next power of two >= n,) uint64 of device memory.
extern "C" int etk_nms(const void* boxes, int box_dtype, const void* scores, int score_dtype,
                       int n, float threshold, int max_out, int out_len, int fill_unkept,
                       void* key_scratch, void* indices, void* out_mask, void* stream) {
  if (n < 1 || max_out < 1 || out_len < 1 || out_len > max_out ||
      (fill_unkept && n > etk::kNmsFillMax))
    return (int)cudaErrorInvalidValue;
  size_t np2 = 1;
  while (np2 < (size_t)n) np2 <<= 1;
  const size_t smem = 20 * (size_t)max_out + (key_scratch ? 0 : 8 * np2);
  static size_t limit = 0;
  const int err = etk::fit_dynamic_smem(etk::nms_kernel, smem, limit);
  if (err != 0) return err;
  etk::nms_kernel<<<1, etk::kNmsThreads, smem, (cudaStream_t)stream>>>(
      boxes, box_dtype, scores, score_dtype, n, threshold, max_out, out_len, fill_unkept,
      (unsigned long long*)key_scratch, (int*)indices, (bool*)out_mask);
  ETK_CHECK_LAUNCH();
  return 0;
}
