// The whole-group gate kernels, written for Hopper: kernel C of the
// eventful block step (gate_group_mlp) and the gated linear group
// (gate_group_linear).
//
// gate_group_mlp replaces eventful_transformer_tpu/ops/pallas/gate_group.py::
// gate_group_mlp in its "post" and "pre" forms with the coverage given: the
// gated MLP group with the residual folded in and, optionally, the next
// gate's norms ("post" shown; "pre" below).
//
//   p' = where(cov, ln(x), p)                        (in place)
//   h  = rnd(gelu(rnd_p(p'[sel]) @ W1 + b1))         on the k selected rows
//   h2 = rnd(h @ W2 + b2)
//   b' = where(cov, scatter(h2), b)                  (in place)
//   y  = rnd(b' + x);  norms = ||ln(y) - p_next||    (optional)
//
// The TPU kernel compacts the selected rows with a one-hot (k, N) matmul
// because Mosaic has no cumsum; here a per-batch-row prefix count over cov
// gives each selected row its slot (index order, as the one-hot gives) and
// the GEMM reads the rows through that index, with identical results. Five
// launches: the select row pass (row_pass.cuh's select_warp_kernel, one warp
// a row, in the row body ``row_body`` the wrapper passes), compaction, gathered GEMM1 (+b1, GELU),
// GEMM2 (+b2), and the scatter-blend row pass with the residual and the
// next-gate norms; one more where the plan splits GEMM2's K steps (its
// 18-42 output tiles are fewer than the SMs). The two GEMMs do the k/N
// share of the dense MLP's work. In bfloat16 they run on the wgmma core of
// gemm_tc.cuh (GEMM1's rows gathered by cp.async into its swizzled tiles,
// GEMM2's by TMA): 8-40 us of device time a call at the paths' shapes,
// where the wrapper's host time (checks, allocations, the launches) is
// now the larger part of a call. In float32, and where the rule
// (ops/gemm_core.py::gemm_core) refuses the shapes, they run on gemm.cuh's
// tile. The (B, k, 4C) hidden activation makes one round trip through
// device memory (12 MB in bf16 at B=8, k=98), which later work can keep
// on chip.
//
// gate_group_linear replaces gate_group.py::gate_group_linear with the
// coverage given, in the forms ViTDet's "v2" regime runs:
//
//   p' = where(cov, ln(x) | x, p)                    (in place, rounded to p's dtype)
//   h  = rnd_b(p'[sel] @ W + wb)                     on the k selected rows
//   b' = where(cov, scatter(h), b)                   (in place)
//   y  = rnd(b' + skip);  norms = ||ln(y) - p_next||  (optional)
//
// ln_mode="post" (the global blocks' qkv group, W 768 x 2304, no skip) and
// ln_mode="none" with the skip add and the MLP gate's norms (every block's
// projection group, W 768 x 768). The TPU kernel holds one batch row's
// whole (N, C) and (N, F) blocks in VMEM (grid = (B,) = 2 programs at 672)
// and scatters h back by a one-hot matmul; here the GEMM's epilogue
// (gemm.cuh's BiasScatterEpilogue) writes rnd(acc + wb) straight into b at
// the row each compaction slot names, so b' is written only at the k
// selected rows and no (B, k, F) h exists. Three launches for the qkv
// forms: the select row pass, the compaction (which also zeroes a selected
// row beyond kcap, as the one-hot scatter leaves it), and the gathered GEMM
// (one more, the split sum, where the plan splits its K steps); a fourth
// for a form with the skip: y = rnd(b' + skip) and the next gate's norms,
// a row pass that reads b' and writes y. At 672 (B = 2, N = 1764, k = 256)
// the GEMM does the k/N share of the dense product: in bfloat16 on the
// wgmma core of gemm_tc.cuh (qkv 512 x 768 -> 2304 in 72 tiles; the
// projection 512 x 768 -> 768 in 24 tiles, its K steps split 3 ways), in
// float32 on gemm.cuh's tile.
//
// Both take ln_mode="pre" (gate_group.py:155-160, :208-209, :378-379), the
// group of a gate that sits before its LN: the select row pass copies x
// itself into p, and the k compacted rows, read back as stored (p's dtype,
// as the one-hot copy hands them over), are normalised in float32 and
// rounded to W's dtype (= x's) in one more row pass over the k rows, into
// a (B, kcap, C) scratch that the GEMM then reads densely. That pass moves
// 2 x k x C elements, a few percent of the group's bytes; an LN prologue in
// the GEMM's A-load would save it, later.
//
// With the coverage left out (cov=None in the wrappers: select_topk, the
// TPU kernels' _topk_cov, gate_group.py:94-152), the group selects its own
// rows before its body, in two more launches that write the (B, N)
// coverage the body then reads:
//   norms[r] = ||new[r] - p[r]||  (float32; new = ln(x) for "post", x for
//                                  "pre"/"none": ln_norms_kernel or
//                                  diff_norms_warp_kernel of
//                                  row_pass.cuh, in the group's row body)
//   cov[b]   = the top-kcap set of norms[b], ties at the kcap-th value to
//              the smallest index: exactly lax.top_k's set
// The TPU kernel holds a batch row's whole (N, C) block in VMEM and
// narrows the kcap-th largest norm by a radix bisection over the norms'
// bit patterns (non-negative float32 patterns order as integers), 8 bits a
// phase, with a (256, N) compare matrix and a ones-matmul row count. Here
// topk_cov_kernel does the same radix select with one block per batch row:
// a 256-bin shared-memory histogram of the candidates' next byte per phase
// (4 phases), one warp scanning it from the top for the byte where the
// count reaches kcap, then one pass that takes every norm above the kcap-th
// value and, by a block-wide prefix count of ties in index order, the first
// (kcap - count above) norms equal to it. The selection reads B x N floats
// five times from L2 (7 KB a batch row at N = 1764); the norms pass re-reads
// x and p, which the select pass then reads again: about one more pass over
// the (N, C) state than the coverage form, and no host round trip or
// torch.topk between the norms and the group.
#include "common.cuh"
#include "row_pass.cuh"
#include "gemm.cuh"
#include "gemm_tc.cuh"

namespace etk {

// pos[b, i] (null: not written): slot of row i among the selected rows of
// batch row b (index order), -1 when not selected; idx[b, j]: the token row
// b * n + i in slot j, -1 when fewer than kcap rows are selected (a row of
// all B x N, so that the GEMM's row functor and epilogue divide nothing).
// One warp per batch row scans 32 rows at a time: a ballot of the selected
// lanes and a popcount give each its slot. The scan is a chain of
// dependent steps, so the warp loads the coverage of kCompactChunks chunks
// of 32 rows before it scans them, and waits out one load's latency per
// kCompactChunks chunks instead of per chunk. With ``over`` (B, N, f)
// non-null, a selected row whose slot is beyond kcap is zeroed there, as
// the one-hot scatter leaves it (only a given coverage selects more than
// kcap rows).
constexpr int kCompactChunks = 8;

template <typename T>
__global__ void compact_kernel(const float* __restrict__ cov, int* __restrict__ pos,
                               int* __restrict__ idx, T* __restrict__ over, int n, int kcap,
                               int f) {
  const int b = blockIdx.x, lane = threadIdx.x;
  const int64_t row0 = (int64_t)b * n;
  int* idx_row = idx + (int64_t)b * kcap;
  for (int j = lane; j < kcap; j += 32) idx_row[j] = -1;
  __syncwarp();
  int count = 0;
  for (int i0 = 0; i0 < n; i0 += 32 * kCompactChunks) {
    bool sel[kCompactChunks];
#pragma unroll
    for (int u = 0; u < kCompactChunks; ++u) {
      const int i = i0 + 32 * u + lane;
      sel[u] = i < n && cov[row0 + i] > 0.f;
    }
#pragma unroll
    for (int u = 0; u < kCompactChunks; ++u) {
      const int i = i0 + 32 * u + lane;
      const unsigned ballot = __ballot_sync(0xffffffffu, sel[u]);
      const int slot = count + __popc(ballot & ((1u << lane) - 1u));
      if (pos != nullptr && i < n) pos[row0 + i] = sel[u] ? slot : -1;
      if (sel[u] && slot < kcap) idx_row[slot] = (int)(row0 + i);
      count += __popc(ballot);
      if (over == nullptr) continue;  // uniform over the warp
      for (unsigned beyond = __ballot_sync(0xffffffffu, sel[u] && slot >= kcap); beyond != 0u;
           beyond &= beyond - 1u) {
        T* row = over + (row0 + i - lane + __ffs(beyond) - 1) * f;
        for (int j = lane; j < f; j += 32) row[j] = from_f<T>(0.f);
      }
    }
  }
}

// LN modes of the C entries (ops/common.py::LN_MODES)
constexpr int kLnNone = 0, kLnPost = 1, kLnPre = 2;

constexpr int kTopkThreads = 512;

// cov[b, i] = 1 for the kcap largest norms[b, :] (non-negative float32),
// ties at the kcap-th value to the smallest indices, else 0; one block per
// batch row, 1 <= kcap <= n. A radix select over the bit patterns, most
// significant byte first: ``prefix`` holds the bytes of the kcap-th largest
// pattern found so far and ``need`` how many of the patterns that share
// them must still be taken from the top.
__global__ void __launch_bounds__(kTopkThreads)
topk_cov_kernel(const float* __restrict__ norms, float* __restrict__ cov, int n, int kcap) {
  __shared__ int hist[256];
  __shared__ int warp_counts[kTopkThreads / 32];
  __shared__ unsigned s_prefix;
  __shared__ int s_need;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* row = norms + (int64_t)blockIdx.x * n;
  float* out = cov + (int64_t)blockIdx.x * n;
  unsigned prefix = 0u, mask = 0u;
  int need = kcap;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const unsigned key = __float_as_uint(row[i]);
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1);
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bytes 255 - 8l down to 248 - 8l; an inclusive scan
      // over the lanes counts the candidates at or above each lane's range
      int cnt[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cnt[j] = hist[255 - 8 * lane - j];
        sum += cnt[j];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      int above = incl - sum;
      if (above < need && need <= incl) {  // one lane: the count reaches need here
        for (int j = 0; j < 8; ++j) {
          if (above + cnt[j] >= need) {
            s_prefix = prefix | ((unsigned)(255 - 8 * lane - j) << shift);
            s_need = need - above;
            break;
          }
          above += cnt[j];
        }
      }
    }
    __syncthreads();
    prefix = s_prefix;
    need = s_need;
    mask |= 0xffu << shift;
  }
  // prefix is the kcap-th largest pattern; take those above it and the
  // first ``need`` equal to it in index order
  int carry = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const unsigned key = i < n ? __float_as_uint(row[i]) : 0u;
    const bool eq = i < n && key == prefix;
    const unsigned ballot = __ballot_sync(0xffffffffu, eq);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int before = carry, total = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
      const int c = warp_counts[w];
      if (w < warp) before += c;
      total += c;
    }
    const int rank = before + __popc(ballot & ((1u << lane) - 1u)) + 1;  // inclusive
    if (i < n) out[i] = (key > prefix || (eq && rank <= need)) ? 1.f : 0.f;
    carry += total;
    __syncthreads();
  }
}

// The selection of a group that selects its own rows: the error norms of
// the gate's domain into ``norms``, then the top-kcap coverage into cov.
// ``row_body``: the body of the norms pass (ops/row_pass.py ROW_BODY_CODES).
template <typename T>
int select_topk(int row_body, const T* x, const T* p, const T* scale, const T* bias,
                float* norms, float* cov, int bsz, int n, int c, int kcap, int ln_mode,
                cudaStream_t stream) {
  const int rows = bsz * n;
  if (ln_mode == kLnPost) {
    const int err = launch_ln_norms<T>(row_body, x, p, scale, bias, norms, rows, c, stream);
    if (err != 0) return err;
  } else {
    const int err = launch_diff_norms<T>(row_body, x, p, norms, rows, c, stream);
    if (err != 0) return err;
  }
  topk_cov_kernel<<<bsz, kTopkThreads, 0, stream>>>(norms, cov, n, kcap);
  ETK_CHECK_LAUNCH();
  return 0;
}

// a[m] = rnd(ln(p[idx[m]]) * scale + bias) for slot m = b * kcap + j of
// batch row b, from the stored p' row; a zero row for an empty slot, which
// no token takes back. Dynamic shared memory: (c + 32) floats.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
ln_rows_kernel(const T* __restrict__ p, const int* __restrict__ idx, const T* __restrict__ scale,
               const T* __restrict__ bias, T* __restrict__ a, int c) {
  extern __shared__ float smem[];
  const int64_t m = blockIdx.x;
  const int i = idx[m];  // uniform over the block
  T* out = a + m * c;
  if (i < 0) {
    for (int j = threadIdx.x; j < c; j += blockDim.x) out[j] = from_f<T>(0.f);
    return;
  }
  float* row = smem;
  float* red = smem + c;
  load_row(p, i, c, row);
  float mean, rstd;
  ln_stats(row, c, red, mean, rstd);
  for (int j = threadIdx.x; j < c; j += blockDim.x)
    out[j] = from_f<T>(ln_value(row[j], mean, rstd, scale, bias, j));
}

// The select row pass of a group in its row body: p' = where(cov, ln(x), p)
// after the LN, where(cov, x, p) before it or without one.
template <typename T>
int select_pass(int row_body, const T* x, T* p, const float* cov, const T* scale, const T* bias,
                int rows, int c, int ln_mode, cudaStream_t stream) {
  return launch_select<T>(row_body, x, p, cov, ln_mode == kLnPost ? scale : nullptr, bias, rows, c,
                          stream);
}

// Output row m = b * kcap + j reads token row idx[m] (-1: a zero row).
struct GatherRows {
  const int* idx;
  __device__ __forceinline__ int64_t operator()(int m) const { return idx[m]; }
};

// Row r of width f: b'[r] = h2[slot] if selected (0 for a selected row
// beyond kcap, as the one-hot scatter gives), else b[r]; with a residual,
// y[r] = rnd(b'[r] + res[r]) and the next gate's norm on the rounded y
// (gate_group.py:226-238, :394-415). pos null: b already holds b' (the
// GEMM wrote it), and the pass only reads it.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
blend_kernel(const T* __restrict__ res, T* __restrict__ b, const int* __restrict__ pos,
             const T* __restrict__ h2, T* __restrict__ y, const T* __restrict__ p_next,
             const T* __restrict__ next_scale, const T* __restrict__ next_bias,
             float* __restrict__ norms, int n, int f, int kcap) {
  extern __shared__ float smem[];
  float* row = smem;
  float* red = smem + f;
  const int64_t r = blockIdx.x;
  const int slot = pos != nullptr ? pos[r] : -1;
  const T* hr = (slot >= 0 && slot < kcap) ? h2 + ((r / n) * kcap + slot) * f : nullptr;
  for (int i = threadIdx.x; i < f; i += blockDim.x) {
    const int64_t e = r * f + i;
    float bv;
    if (slot >= 0) {
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

// The GEMM of the compacted rows, out = epi(rows @ W): gathered from p'
// through idx, or, before the LN, read from the normalised scratch ``a``
// (written here first), on the core ``call`` names (the wrapper's pick).
template <typename T, typename Epi>
int compacted_gemm(const T* p, const int* idx, const T* scale, const T* bias, T* a, const T* w,
                   int bsz, int n, int c, int f, int kcap, int ln_mode, Epi epi, GemmCall call,
                   cudaStream_t stream) {
  const int m = bsz * kcap;
  if (ln_mode == kLnPre) {
    ln_rows_kernel<T><<<m, kRowThreads, row_smem_bytes(c), stream>>>(p, idx, scale, bias, a, c);
    ETK_CHECK_LAUNCH();
    return launch_gemm_core<T, false>(a, m, DenseRows{}, w, m, c, f, epi, call, stream);
  }
  return launch_gemm_core<T, true>(p, (int64_t)bsz * n, GatherRows{idx}, w, m, c, f, epi,
                                   call, stream);
}

// topk_norms non-null: the group selects its own rows, into cov.
template <typename T>
int gate_group_mlp(int row_body, const void* x, void* p, void* b, float* cov, float* topk_norms,
                   const void* ln_scale, const void* ln_bias, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* p_next, const void* next_scale,
                   const void* next_bias, void* y, float* norms, int* pos, int* idx, void* h,
                   void* h2, void* a, int bsz, int n, int c, int hidden, int kcap, int ln_mode,
                   GemmCall gemm1, GemmCall gemm2, cudaStream_t stream) {
  const int rows = bsz * n;
  if (!warp_row_takes<T>(row_body, {c}, {x, p, ln_scale, ln_bias}))
    return (int)cudaErrorInvalidValue;
  if (topk_norms != nullptr) {
    const int err = select_topk<T>(row_body, (const T*)x, (const T*)p, (const T*)ln_scale,
                                   (const T*)ln_bias, topk_norms, cov, bsz, n, c, kcap,
                                   ln_mode, stream);
    if (err != 0) return err;
  }
  int err = select_pass<T>(row_body, (const T*)x, (T*)p, cov, (const T*)ln_scale,
                           (const T*)ln_bias, rows, c, ln_mode, stream);
  if (err != 0) return err;
  compact_kernel<T><<<bsz, 32, 0, stream>>>(cov, pos, idx, nullptr, n, kcap, 0);
  ETK_CHECK_LAUNCH();
  const int m = bsz * kcap;
  err = compacted_gemm<T>((const T*)p, idx, (const T*)ln_scale, (const T*)ln_bias, (T*)a,
                          (const T*)w1, bsz, n, c, hidden, kcap, ln_mode,
                          BiasGeluEpilogue<T>{(const T*)b1, (T*)h, hidden}, gemm1, stream);
  if (err != 0) return err;
  err = launch_gemm_core<T, false>((const T*)h, m, DenseRows{}, (const T*)w2, m, hidden, c,
                                   BiasEpilogue<T>{(const T*)b2, (T*)h2, c}, gemm2, stream);
  if (err != 0) return err;
  blend_kernel<T><<<rows, kRowThreads, row_smem_bytes(c), stream>>>(
      (const T*)x, (T*)b, pos, (const T*)h2, (T*)y, (const T*)p_next, (const T*)next_scale,
      (const T*)next_bias, norms, n, c, kcap);
  ETK_CHECK_LAUNCH();
  return 0;
}

// ln_mode kLnPost: p' = where(cov, ln(x), p); else p' = where(cov, x, p),
// the compacted rows normalised for kLnPre (into the scratch ``a``); the
// GEMM writes b' at the selected rows. skip, y, p_next and norms may be
// null (the qkv group has no skip, and then no row pass follows the GEMM;
// the projection group emits the MLP gate's norms); topk_norms non-null:
// the group selects its own rows, into cov.
template <typename T>
int gate_group_linear(int row_body, const void* x, void* p, void* b, float* cov,
                      float* topk_norms,
                      const void* ln_scale, const void* ln_bias, const void* w, const void* wb,
                      const void* skip, const void* p_next, const void* next_scale,
                      const void* next_bias, void* y, float* norms, int* idx, void* a, int bsz,
                      int n, int c, int f, int kcap, int ln_mode, GemmCall call,
                      cudaStream_t stream) {
  const int rows = bsz * n;
  if (!warp_row_takes<T>(row_body, {c}, {x, p, ln_scale, ln_bias}))
    return (int)cudaErrorInvalidValue;
  if (topk_norms != nullptr) {
    const int err = select_topk<T>(row_body, (const T*)x, (const T*)p, (const T*)ln_scale,
                                   (const T*)ln_bias, topk_norms, cov, bsz, n, c, kcap,
                                   ln_mode, stream);
    if (err != 0) return err;
  }
  int err = select_pass<T>(row_body, (const T*)x, (T*)p, cov, (const T*)ln_scale,
                           (const T*)ln_bias, rows, c, ln_mode, stream);
  if (err != 0) return err;
  compact_kernel<T><<<bsz, 32, 0, stream>>>(cov, nullptr, idx, (T*)b, n, kcap, f);
  ETK_CHECK_LAUNCH();
  err = compacted_gemm<T>(
      (const T*)p, idx, (const T*)ln_scale, (const T*)ln_bias, (T*)a, (const T*)w, bsz, n, c, f,
      kcap, ln_mode, BiasScatterEpilogue<T>{(const T*)wb, idx, (T*)b, f}, call, stream);
  if (err != 0 || skip == nullptr) return err;
  blend_kernel<T><<<rows, kRowThreads, row_smem_bytes(f), stream>>>(
      (const T*)skip, (T*)b, nullptr, nullptr, (T*)y, (const T*)p_next, (const T*)next_scale,
      (const T*)next_bias, norms, n, f, kcap);
  ETK_CHECK_LAUNCH();
  return 0;
}

}  // namespace etk

// row_body: the body of the row passes of row_pass.cuh, the select and the
// norms of a group that selects its own rows (ops/row_pass.py
// ROW_BODY_CODES)
extern "C" int etk_gate_group_linear(int dtype, int row_body, const void* x, void* p, void* b,
                                     void* cov, void* topk_norms, const void* ln_scale,
                                     const void* ln_bias, const void* w, const void* wb,
                                     const void* skip, const void* p_next,
                                     const void* next_scale, const void* next_bias, void* y,
                                     void* norms, void* idx, void* a, int bsz, int n, int c,
                                     int f, int kcap, int ln_mode, int core, int split, void* ws,
                                     void* stream) {
  const etk::GemmCall gemm{core, split, (float*)ws};
  ETK_DISPATCH(dtype, return etk::gate_group_linear<T>(
                          row_body, x, p, b, (float*)cov, (float*)topk_norms, ln_scale, ln_bias,
                          w, wb, skip, p_next, next_scale, next_bias, y, (float*)norms,
                          (int*)idx, a, bsz, n, c, f, kcap, ln_mode, gemm,
                          (cudaStream_t)stream));
}

extern "C" int etk_gate_group_mlp(int dtype, int row_body, const void* x, void* p, void* b,
                                  void* cov, void* topk_norms, const void* ln_scale,
                                  const void* ln_bias, const void* w1, const void* b1,
                                  const void* w2, const void* b2, const void* p_next,
                                  const void* next_scale, const void* next_bias, void* y,
                                  void* norms, void* pos, void* idx, void* h, void* h2, void* a,
                                  int bsz, int n, int c, int hidden, int kcap, int ln_mode,
                                  int core, int split1, int split2, void* ws, void* stream) {
  const etk::GemmCall gemm1{core, split1, (float*)ws}, gemm2{core, split2, (float*)ws};
  ETK_DISPATCH(dtype, return etk::gate_group_mlp<T>(
                          row_body, x, p, b, (float*)cov, (float*)topk_norms, ln_scale, ln_bias,
                          w1, b1, w2, b2, p_next, next_scale, next_bias, y, (float*)norms,
                          (int*)pos, (int*)idx, h, h2, a, bsz, n, c, hidden, kcap, ln_mode,
                          gemm1, gemm2, (cudaStream_t)stream));
}
