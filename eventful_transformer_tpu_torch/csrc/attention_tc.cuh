// The tensor-core body of the softmax attention over packed qkv rows, for
// bfloat16 calls of rows 2, 6, 15 and 21 (kAttnRounded, kAttnGrid,
// kAttnF32Probs and kAttnBf16Probs); attention.cuh includes it after the
// types both bodies share and dispatches to it (launch_attention).
//
// Replaces, with attention.cuh's CUDA-core body, the softmax attention of
// eventful_transformer_tpu/ops/pallas/window_attention.py::window_attention
// (global, windowed with rel-pos terms, padded) and ::window_attention_grid,
// of block_fused.py::qkv_attention_group's attention stage and of
// attention.py::fused_attention. What bounds it on the card is bytes: qkv
// read once and the output written once (0.0029 ms at ViViT's 8 x 197,
// 0.0200 ms at ViTDet-1024's 50 windows), against about 6 us of
// tensor-core work at 1024. The CUDA-core body ran at about 5 TFLOP/s,
// serial float32 dot products over a float32 K and V; here both products
// run on the tensor cores, so the time goes to moving K and V into shared
// memory:
//
//   * one block of 4 warps takes 64 queries of one (batch row or window,
//     head), 16 query rows a warp: 384 blocks at ViViT's 8 x 197, 864 at
//     672's 18 windows, 2400 at 1024's 50;
//   * K and V of the head go into shared memory as bfloat16, n padded to a
//     multiple of 16 keys (the pad keys zero, their logits masked), each
//     row d + 8 elements wide: a row stride that is an odd multiple of 16
//     bytes, so the 8 rows of an ldmatrix fall in 8 distinct bank groups.
//     25 KB each at 196 x 64; a block needs 2 x 208 x 72 x 2 = 60 KB at n =
//     197. They arrive by 16-byte cp.async from the packed rows (a head's
//     slice is 2d contiguous bytes of a 3C row), K and V as two groups, so
//     q.kT starts while V is in flight; q and the terms are loaded first,
//     so that they do not queue behind the copies. Each token's row (or the
//     padded form's PadGeom bias row, read once a thread and stored from
//     registers) and each key's two term columns come from small tables
//     made once a block, so no load divides; the grid form's rows are
//     GridRows' addresses in the (B, Hp, Wp, 3C) map, its output rows too;
//   * q.kT and P.V are mma.sync.m16n8k16 bf16 x bf16 -> float32, operands
//     from ldmatrix (V transposed by ldmatrix.trans); q comes from device
//     memory straight into A fragments, scaled there;
//   * the logits of a warp's 16 rows stay in registers, 208 keys at once
//     (KC = 26 tiles of 8; 128 keys at d > 64): one pass for n <= 208, which
//     holds every window (196) and ViViT's 197. For 208 < n <= 512 (EPIC's
//     401) the keys go in chunks and q.kT runs three times, for the row max,
//     the sum and the probabilities with P.V: recomputing is cheaper than
//     the 64 x 512 x 4 B of shared memory a block would need to keep them.
//     The three stages are one rolled loop, so the kernel's code holds one
//     copy of each (unrolled, it was some 20,000 instructions, beyond the
//     instruction cache). 255 registers a thread: two blocks an SM, and
//     what is left of the time is mostly a block waiting for its K and V.
//
// The softmax is exact, not online: the row max over all n keys, exp, the
// float32 sum, then p = e / sum as a division, rounded to the form's dtype
// before P.V, as attention.cuh's body and the plain versions do. The
// division is q = e r, r = RN(1 / sum) once a row, corrected once by the
// exact remainder e - q sum (Markstein's theorem): the correctly rounded
// quotient wherever it is a normal float, without the slow-path branch of
// each compiled division. The rounding rules of the two bodies are the
// same; only the summation order differs:
//   * kAttnRounded (rows 2 and 6): q = rnd(q * rnd(inv_scale)) and the
//     probabilities rounded to bfloat16 are exact bfloat16 operands. The
//     windowed form adds term_y + term_x (summed in float32 first) to the
//     float32 logits after q.kT; at an out-of-image query row the pad terms
//     replace them;
//   * kAttnGrid (row 15, window_attention.py:78-96): q split as row 21's,
//     the probabilities rounded to bfloat16 as kAttnRounded's. Its terms
//     come from the UNSCALED q, an exact bfloat16 value, against the tables
//     (exact bfloat16) on the tensor cores (grid_terms), float32 sums; the
//     logits take (s + term_y) + term_x, one after the other, as _attend
//     adds them;
//   * kAttnF32Probs / kAttnBf16Probs (row 21, attention.py:33-58): q is
//     scaled in float32 and not rounded, so it goes in as hi = bf16(q) and
//     lo = bf16(q - hi), S = hi.kT + lo.kT (k is exactly bfloat16; the error
//     is about 2^-17 of |q||k|). Where 1/scale is a power of two (d = 16,
//     64: every path's) q * 1/scale is exact in bfloat16, lo is 0 and its
//     product is skipped: the same sums. Without the cast the float32
//     probabilities are split the same way and P.V runs twice; with it p
//     (and v, already bfloat16) are rounded to bfloat16 and P.V runs once.
// The output is rounded to bfloat16 once.
#pragma once

#include "common.cuh"
#include "warp_mma.cuh"

namespace etk {

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcQueries = kTcWarps * 16;  // query rows a block
constexpr int kTcMaxTokens = 512;          // core/blocks.py GLOBAL_ATTN_MAX_TOKENS
constexpr int kTcMaxHeadDim = 128;

// Whether the tensor-core body takes n tokens of head width d (its dtype
// and form are checked where it is instantiated); ops/window_attention.py::
// attention_body states the same rule.
inline bool attention_tc_takes(int n, int d) {
  return n >= 1 && n <= kTcMaxTokens && d >= 16 && d <= kTcMaxHeadDim && d % 16 == 0;
}

// The rows of kAttnGrid's tables a block stages in shared memory, each
// part rounded up to 16 (ldmatrix reads 16 rows at once): the y rows of
// the window rows its kTcQueries queries lie in (at most (kTcQueries - 1) /
// a1 + 2 of them, p0 rows each) and the whole x table (a1 p1 rows). a1 = 0:
// no tables.
__host__ __device__ inline int grid_y_rows(int n, int a1, int p0) {
  const int a0 = n / a1, rows = (kTcQueries - 1) / a1 + 2;
  return ((rows < a0 ? rows : a0) * p0 + 15) & ~15;
}

inline int grid_table_rows(int n, int a1, int p0, int p1) {
  return a1 > 0 ? grid_y_rows(n, a1, p0) + ((a1 * p1 + 15) & ~15) : 0;
}

inline size_t attention_tc_smem_bytes(int n, int d, int n_terms, int table_rows = 0) {
  const size_t n_pad = (size_t)((n + 15) & ~15);
  return (2 * n_pad + table_rows) * (d + 8) * sizeof(__nv_bfloat16) +
         (size_t)kTcQueries * n_terms * sizeof(float) + 2 * n_pad * sizeof(int);
}

// the low halves of x - float(bf16(x)), packed as pack_bf16 packs x
__device__ __forceinline__ uint32_t pack_bf16_rest(float lo, float hi) {
  return pack_bf16(lo - rnd<__nv_bfloat16>(lo), hi - rnd<__nv_bfloat16>(hi));
}

// kAttnGrid's rel-pos terms of one warp's 16 queries (window tokens rw ..
// rw + 15) into its rows of the float32 staging ``tw`` (16 x (p0 + p1)):
// term u < p0 of query i is q . y[i / a1, u], term p0 + u is q . x[i % a1,
// u], q the UNSCALED query, which ``qa`` still holds. On the tensor cores,
// as the JAX kernel runs them on the MXU (_attend's q . yk^T, masked): the
// warp's 16 queries against every table row its queries use, 16 rows (two
// n-tiles) a step by ldmatrix from the block's staged tables, and each
// query keeps the columns of its own block. ``ys`` holds y's rows from
// ``ybase`` on, ``xs`` the whole x table, both ``ld`` wide. A y block is a
// window row's p0 keys: 16 queries span two or three at a1 = 14; they take
// every x block unless they lie in one window row.
template <int DMax>
__device__ __forceinline__ void grid_terms(const uint32_t (&qa)[DMax / 16][4],
                                           const __nv_bfloat16* ys, int ybase,
                                           const __nv_bfloat16* xs, int a1, int ld, int d, int n,
                                           int p0, int p1, int rw, float* tw, int lane) {
  const int g = lane >> 2, qd = lane & 3, lm = lane >> 3, lr = lane & 7, nt = p0 + p1;
  for (int e = lane; e < 16 * nt; e += 32) tw[e] = 0.f;  // rows past n: zero terms
  __syncwarp();
  const int qi[2] = {rw + g, rw + g + 8};  // this lane's two query rows
  const int last = min(rw + 15, n - 1);
#pragma unroll 1
  for (int part = 0; part < 2; ++part) {
    const __nv_bfloat16* table = part == 0 ? ys : xs;
    const int base = part == 0 ? ybase : 0, p = part == 0 ? p0 : p1, col0 = part == 0 ? 0 : p0;
    int lo = 0, hi = a1 * p1;  // the table rows the warp's queries use
    if (part == 0) {
      lo = rw / a1 * p0;
      hi = (last / a1 + 1) * p0;
    } else if (rw / a1 == last / a1) {
      lo = rw % a1 * p1;
      hi = (last % a1 + 1) * p1;
    }
    int first[2];  // the first table row of each of this lane's queries
#pragma unroll
    for (int i = 0; i < 2; ++i) first[i] = part == 0 ? qi[i] / a1 * p0 : qi[i] % a1 * p1;
#pragma unroll 1
    for (int r0 = (lo - base) & ~15; base + r0 < hi; r0 += 16) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < DMax / 16; ++kk) {
        if (kk * 16 >= d) continue;
        uint32_t tb[4];
        ldmatrix_x4(tb, table + (r0 + (lm >> 1) * 8 + lr) * ld + kk * 16 + (lm & 1) * 8);
        mma_bf16(acc[0], qa[kk], tb[0], tb[1]);
        mma_bf16(acc[1], qa[kk], tb[2], tb[3]);
      }
      // acc[t][e]: query row g + 8 (e >> 1), table row base + r0 + 8 t + qd * 2 + (e & 1)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = base + r0 + 8 * t + qd * 2 + (e & 1), u = col - first[e >> 1];
          if (qi[e >> 1] < n && col < hi && u >= 0 && u < p) {
            tw[(g + 8 * (e >> 1)) * nt + col0 + u] = acc[t][e];
          }
        }
      }
    }
  }
}

// One block per (batch row or window, head, 64-query tile). DMax bounds
// the head width d (a multiple of 16), KC the 8-key tiles of logits a warp
// keeps in registers at once.
template <int Form, int DMax, int KC, typename Geom, typename Rows>
__global__ void __launch_bounds__(kTcThreads)
attention_tc_kernel(const __nv_bfloat16* __restrict__ qkv, const __nv_bfloat16* __restrict__ terms,
                    __nv_bfloat16* __restrict__ out, int n, int c, int heads, float inv_scale,
                    int p0, int p1, bool q_lo, Geom geom, Rows rows,
                    RelTables<__nv_bfloat16> tab) {
  using bf16 = __nv_bfloat16;
  constexpr bool kGrid = Form == kAttnGrid;         // terms from q and the tables, here
  constexpr bool kSplitQ = Form != kAttnRounded;  // q scaled in float32: hi + lo
  constexpr bool kSplitP = Form == kAttnF32Probs;  // float32 probabilities: hi + lo
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int d = c / heads, ld = d + 8, n_pad = (n + 15) & ~15, nt = p0 + p1;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, qd = lane & 3;  // fragment row and column pair
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix: matrix and row of this lane's address
  const int q0 = blockIdx.y * kTcQueries;
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);
  bf16* vs = ks + (size_t)n_pad * ld;
  float* ts = reinterpret_cast<float*>(vs + (size_t)n_pad * ld);  // kTcQueries x nt terms
  int* row_of = reinterpret_cast<int*>(ts + kTcQueries * nt);     // n_pad: qkv row, -1 pad
  int* term_of = row_of + n_pad;  // n_pad: key j's y term | x term << 16
  // kAttnGrid's staged tables: the y rows of the block's window rows, from
  // ybase on, then the whole x table
  const int a1 = tab.a1, ybase = kGrid && nt > 0 ? q0 / a1 * p0 : 0;
  bf16* ys = reinterpret_cast<bf16*>(term_of + n_pad);
  bf16* xs = ys + (size_t)(kGrid && nt > 0 ? grid_y_rows(n, a1, p0) : 0) * ld;

  // each token's qkv row, or -1 where the padded form substitutes the bias
  // row; each key's two term columns
  for (int j = threadIdx.x; j < n_pad; j += kTcThreads) {
    row_of[j] = j < n && geom.valid(b, j) ? (int)rows(b, j, n) : -1;
    if (nt > 0) term_of[j] = j < n ? j / p1 | (p0 + j % p1) << 16 : 0;
  }
  __syncthreads();
  // Loads in the order they are needed, so that q and the terms do not
  // queue behind the copies of K and V: this warp's q rows (g and g + 8 of
  // its 16) into registers, the block's terms (up to kTermLoads a thread at
  // once), then K and V.
  const int rw = q0 + warp * 16;
  const bool active = rw < n;
  uint32_t qa[DMax / 16][4], ql[kSplitQ ? DMax / 16 : 1][4];
  {
    const bf16* qrow[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = rw + g + 8 * i;
      const int r = qi < n ? row_of[qi] : -1;
      qrow[i] = qi < n ? (r >= 0 ? qkv + (int64_t)r * 3 * c : geom.bias) + h * d : nullptr;
    }
#pragma unroll
    for (int kk = 0; kk < DMax / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // r = half * 2 + row: a0a1, a2a3, a4a5, a6a7
        const bf16* src = qrow[r & 1];
        const int col = kk * 16 + (r >> 1) * 8 + qd * 2;
        qa[kk][r] = src != nullptr && col < d ? *reinterpret_cast<const uint32_t*>(src + col) : 0u;
      }
    }
  }
  // a group of threads a query row of terms, one column each
  constexpr int kTermLoads = 16;
  const int group = max(1, min(nt, kTcThreads)), t_stride = kTcThreads / group;
  const int u0 = threadIdx.x % group, r0 = threadIdx.x / group;
  const bool few_terms = !kGrid && nt > 0 && kTcQueries <= kTermLoads * t_stride;
  auto term_row = [&](int r) -> const bf16* {
    const int qi = q0 + r;
    if (qi >= n) return nullptr;
    return row_of[qi] >= 0 || geom.terms == nullptr
               ? terms + (((int64_t)b * heads + h) * n + qi) * nt
               : geom.terms + ((int64_t)h * n + qi) * nt;
  };
  float tv[kTermLoads];
  if (few_terms) {
#pragma unroll
    for (int k = 0; k < kTermLoads; ++k) {
      const int r = r0 + k * t_stride;
      const bf16* tr = r0 < t_stride && r < kTcQueries ? term_row(r) : nullptr;
      tv[k] = tr != nullptr ? to_f(tr[u0]) : 0.f;
    }
  }
  // kAttnGrid's tables (its first commit group), then K, then V, of head h:
  // 16-byte copies, one commit group each; a thread copies one 16-byte
  // piece of every ``stride``-th row. The padded form's bias row, which
  // every out-of-image key of every window shares, is read once a thread
  // and stored from registers (no copies of one address from every block
  // at once).
  const int pieces = d >> 3, stride = kTcThreads / pieces;
  const int piece = threadIdx.x % pieces, first = threadIdx.x / pieces;
  if constexpr (kGrid) {
    if (nt > 0) {
      const int y_end = min((min(q0 + kTcQueries, n) - 1) / a1 + 1, n / a1) * p0;
      for (int j = first; j < y_end - ybase && first < stride; j += stride) {
        cp_async16(ys + j * ld + piece * 8, tab.y + (int64_t)(ybase + j) * d + piece * 8);
      }
      for (int j = first; j < a1 * p1 && first < stride; j += stride) {
        cp_async16(xs + j * ld + piece * 8, tab.x + (int64_t)j * d + piece * 8);
      }
      cp_async_commit();
    }
  }
  for (int part = 1; part <= 2; ++part) {
    bf16* dst0 = part == 1 ? ks : vs;
    uint4 pad = make_uint4(0u, 0u, 0u, 0u);
    if (geom.bias != nullptr) {
      pad = *reinterpret_cast<const uint4*>(geom.bias + part * c + h * d + piece * 8);
    }
    for (int j = first; j < n_pad && first < stride; j += stride) {
      bf16* dst = dst0 + j * ld + piece * 8;
      const int r = row_of[j];
      if (r >= 0) {
        cp_async16(dst, qkv + (int64_t)r * 3 * c + part * c + h * d + piece * 8);
      } else {
        *reinterpret_cast<uint4*>(dst) = j < n ? pad : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  }
  // the terms into shared memory as float32: given, or (kAttnGrid) computed
  // from the unscaled q while K and V are in flight
  if constexpr (kGrid) {
    if (nt > 0) {
      cp_async_wait<2>();
      __syncthreads();  // the tables in place (K and V may still be in flight)
      if (active) {
        grid_terms<DMax>(qa, ys, ybase, xs, a1, ld, d, n, p0, p1, rw, ts + warp * 16 * nt, lane);
      }
    }
  }
  if (few_terms) {
#pragma unroll
    for (int k = 0; k < kTermLoads; ++k) {
      const int r = r0 + k * t_stride;
      if (r0 < t_stride && r < kTcQueries) ts[r * nt + u0] = tv[k];
    }
  } else if (!kGrid && nt > 0) {
    for (int r = r0; r < kTcQueries && r0 < t_stride; r += t_stride) {
      const bf16* tr = term_row(r);
      for (int u = u0; u < nt; u += group) ts[r * nt + u] = tr != nullptr ? to_f(tr[u]) : 0.f;
    }
  }
  // q scaled: kAttnRounded rnd(q * rnd(inv_scale)), else float32 q as hi + lo
  {
    const float scale = Form == kAttnRounded ? rnd<bf16>(inv_scale) : inv_scale;
#pragma unroll
    for (int kk = 0; kk < DMax / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qa[kk][r]));
        const float x0 = v.x * scale, x1 = v.y * scale;
        qa[kk][r] = pack_bf16(x0, x1);
        if constexpr (kSplitQ) ql[kk][r] = pack_bf16_rest(x0, x1);
      }
    }
  }
  cp_async_wait<1>();
  __syncthreads();  // K and the terms in place

  // Three stages over the chunks of KC tiles: the row max, the sum of exp,
  // then p = e / sum and P.V. With one chunk the logits are computed once
  // and kept; with more they are computed again in each stage.
  const int chunks = (n_pad + KC * 8 - 1) / (KC * 8);
  const float* trow[2] = {ts + (warp * 16 + g) * nt, ts + (warp * 16 + g + 8) * nt};
  float s[KC][4];
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  float o[DMax / 8][4];
#pragma unroll
  for (int u = 0; u < DMax / 8; ++u) o[u][0] = o[u][1] = o[u][2] = o[u][3] = 0.f;
  float rinv[2];  // RN(1 / sum), for the division below
#pragma unroll 1
  for (int stage = 0; stage < 3; ++stage) {
    if (stage == 2) {
      cp_async_wait<0>();
      __syncthreads();  // V in place
    }
    if (!active) continue;
#pragma unroll 1
    for (int ch = 0; ch < chunks; ++ch) {
      const int t0 = ch * KC;
      if (stage == 0 || chunks > 1) {
        // q.kT of the chunk's keys, + the terms, pad keys at -inf
#pragma unroll
        for (int t = 0; t < KC; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DMax / 16; ++kk) {
          if (kk * 16 >= d) continue;
#pragma unroll
          for (int t = 0; t < KC; t += 2) {
            const int j = (t0 + t) * 8;
            if (j >= n_pad) continue;
            uint32_t kb[4];
            ldmatrix_x4(kb, ks + (j + (lm >> 1) * 8 + lr) * ld + kk * 16 + (lm & 1) * 8);
            mma_bf16(s[t], qa[kk], kb[0], kb[1]);
            mma_bf16(s[t + 1], qa[kk], kb[2], kb[3]);
            if (kSplitQ && q_lo) {
              mma_bf16(s[t], ql[kk], kb[0], kb[1]);
              mma_bf16(s[t + 1], ql[kk], kb[2], kb[3]);
            }
          }
        }
        if (nt > 0) {
#pragma unroll
          for (int t = 0; t < KC; ++t) {
            const int j = (t0 + t) * 8 + qd * 2;  // the keys of s[t][0, 2] and s[t][1, 3]
            if (j >= n_pad) continue;
            const int2 cols = *reinterpret_cast<const int2*>(term_of + j);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = (e & 1) ? cols.y : cols.x;
              const float ty = trow[e >> 1][col & 0xffff], tx = trow[e >> 1][col >> 16];
              if constexpr (kGrid) {
                s[t][e] = (s[t][e] + ty) + tx;  // one after the other, as _attend adds them
              } else {
                s[t][e] += ty + tx;
              }
            }
          }
        }
#pragma unroll
        for (int t = 0; t < KC; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if ((t0 + t) * 8 + qd * 2 + (e & 1) >= n) s[t][e] = -INFINITY;
          }
        }
      }
      if (stage == 0) {
#pragma unroll
        for (int t = 0; t < KC; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
        }
        continue;
      }
      if (stage == 1 || chunks > 1) {
#pragma unroll
        for (int t = 0; t < KC; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[t][e] = expf(s[t][e] - mx[e >> 1]);
        }
      }
      if (stage == 1) {
#pragma unroll
        for (int t = 0; t < KC; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[e >> 1] += s[t][e];
        }
        continue;
      }
      // p = e / sum, rounded to nearest as a division: q = e r, then one
      // correction by the exact remainder e - q sum (Markstein's theorem,
      // r = RN(1 / sum); exact for every p that is a normal float, where
      // the division's slow path would not run), and P.V over the chunk's
      // 16-key slices
#pragma unroll
      for (int t = 0; t < KC; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float q = s[t][e] * rinv[e >> 1];
          s[t][e] = fmaf(fmaf(-q, sum[e >> 1], s[t][e]), rinv[e >> 1], q);
        }
      }
#pragma unroll
      for (int kk = 0; kk < KC / 2; ++kk) {
        const int j = (t0 + 2 * kk) * 8;
        if (j >= n_pad) continue;
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        uint32_t pl[4];
        if constexpr (kSplitP) {
          pl[0] = pack_bf16_rest(s[2 * kk][0], s[2 * kk][1]);
          pl[1] = pack_bf16_rest(s[2 * kk][2], s[2 * kk][3]);
          pl[2] = pack_bf16_rest(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pl[3] = pack_bf16_rest(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        }
#pragma unroll
        for (int u = 0; u < DMax / 8; u += 2) {
          if (u * 8 >= d) continue;
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vs + (j + (lm & 1) * 8 + lr) * ld + u * 8 + (lm >> 1) * 8);
          mma_bf16(o[u], pa, vb[0], vb[1]);
          mma_bf16(o[u + 1], pa, vb[2], vb[3]);
          if constexpr (kSplitP) {
            mma_bf16(o[u], pl, vb[0], vb[1]);
            mma_bf16(o[u + 1], pl, vb[2], vb[3]);
          }
        }
      }
    }
    // the four lanes of a quad hold a row's columns
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int w = 1; w < 4; w <<= 1) {
        if (stage == 0) mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], w));
        if (stage == 1) sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], w);
      }
      if (stage == 1) rinv[i] = __frcp_rn(sum[i]);
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = rw + g + 8 * i;
    if (qi >= n) continue;
    bf16* orow = out + rows(b, qi, n) * c + h * d;
#pragma unroll
    for (int u = 0; u < DMax / 8; ++u) {
      if (u * 8 >= d) continue;
      *reinterpret_cast<uint32_t*>(orow + u * 8 + qd * 2) = pack_bf16(o[u][2 * i], o[u][2 * i + 1]);
    }
  }
}

template <int Form, int DMax, int KC, typename Geom, typename Rows>
int launch_attention_tc_kernel(const __nv_bfloat16* qkv, const __nv_bfloat16* terms,
                               __nv_bfloat16* out, int bsz, int n, int c, int heads,
                               float inv_scale, int p0, int p1, cudaStream_t stream, Geom geom,
                               Rows rows, RelTables<__nv_bfloat16> tab) {
  const int table_rows = tab.y != nullptr ? grid_table_rows(n, tab.a1, p0, p1) : 0;
  const size_t smem = attention_tc_smem_bytes(n, c / heads, p0 + p1, table_rows);
  cudaError_t err = cudaFuncSetAttribute(attention_tc_kernel<Form, DMax, KC, Geom, Rows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bsz * heads, (n + kTcQueries - 1) / kTcQueries);
  int exponent;
  const bool q_lo = Form != kAttnRounded && frexpf(inv_scale, &exponent) != 0.5f;
  attention_tc_kernel<Form, DMax, KC, Geom, Rows><<<grid, kTcThreads, smem, stream>>>(
      qkv, terms, out, n, c, heads, inv_scale, p0, p1, q_lo, geom, rows, tab);
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The tensor-core body for bsz rows (or windows) of n tokens, as
// launch_attention's arguments; cudaErrorInvalidValue where it does not
// take the call (the wrappers choose the body by the same rule and do not
// send such calls).
template <int Form, typename Geom, typename Rows>
int launch_attention_tc(const __nv_bfloat16* qkv, const __nv_bfloat16* terms, __nv_bfloat16* out,
                        int bsz, int n, int c, int heads, float inv_scale, int p0, int p1,
                        cudaStream_t stream, Geom geom, Rows rows, RelTables<__nv_bfloat16> tab) {
  const int d = c / heads;
  const bool aligned =
      aligned16(qkv) && aligned16(geom.bias) && aligned16(tab.y) && aligned16(tab.x);
  if (!attention_tc_takes(n, d) || !aligned) return (int)cudaErrorInvalidValue;
  if (d <= 64) {
    return launch_attention_tc_kernel<Form, 64, 26>(qkv, terms, out, bsz, n, c, heads,
                                                    inv_scale, p0, p1, stream, geom, rows, tab);
  }
  return launch_attention_tc_kernel<Form, 128, 16>(qkv, terms, out, bsz, n, c, heads, inv_scale,
                                                   p0, p1, stream, geom, rows, tab);
}

}  // namespace etk
