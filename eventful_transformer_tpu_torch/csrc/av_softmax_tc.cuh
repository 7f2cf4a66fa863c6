// The tensor-core body of softmax_select_matmul (row 8), for its bfloat16
// calls: q, k, the terms and the A.V state (p_a, p_v, out) all bfloat16, in
// both forms (fused matmul-1, logits), with and without rel-pos terms.
// av_softmax.cu includes it and dispatches to it (body "tc" of
// ops/av_softmax.py::av_softmax_body); float32 and the matmul-2 cast keep
// the CUDA-core body there.
//
// What bounds it. At ViTDet-1024 (B = 2, H = 12, N = 4096, Np = 1024, d =
// 64) a call reads the (B, H, N, Np) state once, 201 MB, and writes its
// covered columns: the bound counts 50 MB of them at a quarter of the
// columns (kernel_check.io_bytes), 0.088 ms at 3.35 TB/s. The card writes
// 32-byte sectors, and at that coverage nearly every sector of p_a holds a
// covered column (1 - 0.75^16 = 99 %), so the write-back moves about the
// whole 201 MB again, whatever the design: some 0.12 ms of memory time.
// Under it run the products, 2 x 12.9 GFLOP, and q.kT twice more (below),
// 51.6 GFLOP: 0.052 ms at the tensor cores' peak; and the softmax's float32
// work on 100 M logits, three times over, which costs the SM's issue slots
// more than the products do. The CUDA-core body it replaces kept a 32 x
// 1044 float32 logits tile resident (134 KB: one block an SM), loaded p_a
// two bytes a lane, and took 1.36 ms.
//
// The design:
//   * a block of 8 warps (4 where 8-warp blocks would not fill the card
//     twice over) takes 16 query rows a warp of one (batch, head): two
//     warpgroups of 64 rows. Both products run on wgmma (m64n64k16), A
//     from registers (q, and P as mma.sync's A fragments), B from the
//     stage: K K-major for q.kT, V N-major (the transpose bit) for P.V. The
//     logits of a warp's rows live in registers, one 64-key chunk at a time,
//     never as a row;
//   * the softmax is exact, not online: three passes over the key chunks,
//     the row max over all Np keys, then the float32 sum of exp(l - max),
//     then p = e / sum (Markstein's division, as attention_tc.cuh: q = e r,
//     r = RN(1 / sum), corrected once by the exact remainder, the correctly
//     rounded quotient wherever it is a normal float), rounded to
//     bfloat16. Each pass computes q.kT (+ the terms) again: cheaper than
//     keeping 16 x Np float32 logits a warp (64 KB at Np = 1024). exp(l -
//     max) is exp2(l log2(e) - max log2(e)), one FFMA before exp2f: within
//     |max| 2^-24 of expf's value, far below a bfloat16 ulp of p;
//   * the rounding points are the plain version's: qs = rnd(q * rnd(
//     inv_scale)), exact bfloat16 operands of q.kT; the two terms summed in
//     float32, then added to the float32 logit; a rounded to bfloat16
//     before the select; float32 sums in both products; the output rounded
//     once;
//   * 16-byte cp.async copies feed a two-stage ring, the step after the one
//     being computed in flight while it runs, one __syncthreads a step. A
//     stage holds two 64-key tiles of 128-byte rows in the 128-byte swizzle
//     wgmma reads (pad keys zero, rows past d unread): in the first two
//     passes of the fused form two chunks of K, so that a step covers 128
//     keys and the barriers halve; in the third, K's chunk and V's. Each
//     warp copies its own rows of p_a (third pass) and of the logits
//     (logits form, every pass, two chunks a step in the first two, the
//     second in the p_a slots; there no stage is shared and the warps run
//     without a barrier);
//   * rows of p_a and of the logits are Np elements long: 2048 bytes at
//     1024, but 882 at 441 and 394 at 197, which no TMA tensor map takes.
//     Each row's chunk is therefore copied as the 16-byte granules that
//     cover it (at most 9 for 64 keys: 144 bytes) and read at the row's
//     offset into its first granule. A granule that covers bytes of a
//     neighbouring row or chunk is read, never written; it lies in the same
//     16 bytes as an element of the tensor, so it is mapped memory. Any
//     bfloat16 alignment of p_a and of the logits is taken;
//   * the terms of a warp's 16 rows are staged as float32 rows. On
//     ViTDet-1024's 32 x 32 grid (kP1 = 32) an 8-key tile lies in one
//     key-grid row at offsets fixed by the instantiation: its term_y is one
//     value a row and its term_x a float2 (rows strided 8 mod 32 words: a
//     warp's reads hit distinct banks). On other grids each key's two term
//     columns come from a table, one float each;
//   * the select merges in registers: p_a' = where(cov, a, p_a) per pair of
//     keys, from the staged old pair and a mask built once a block from the
//     coverage's ballots. p_a' is the A operand of P.V as it stands. Where
//     every chunk of a p_a row is whole granules (Np a multiple of 8,
//     kWhole: 1024) the covered pairs go into the staged rows and the chunk
//     goes back with coalesced 16-byte stores, uncovered columns rewritten with
//     the bits just read (the sectors are written whole either way);
//     elsewhere only covered columns are stored, from registers, a pair as
//     one 4-byte store where it is aligned and both keys are in the row,
//     else each covered element alone;
//   * pad keys past Np: their logits are -inf (exp 0), their p_a' 0, their
//     V rows zero; they are never stored.
// Shared memory at 1024 (8 warps, terms): 32 KB of K and V stages, 36 KB of
// p_a stages, 36 KB of float32 terms: two blocks an SM, 128 registers a
// thread at most (__launch_bounds__).
#pragma once

#include "async_copy.cuh"
#include "common.cuh"
#include "warp_mma.cuh"

namespace etk {

constexpr int kAvMaxShared = 232448;                 // dynamic shared memory a block may use
constexpr int kAvTcChunk = 64;                        // keys a step
constexpr int kAvTcTiles = kAvTcChunk / 8;            // 8-key logits tiles a warp holds
constexpr int kAvTcMaxHeadDim = 64;
constexpr int kAvTcRowBytes = 2 * kAvTcChunk + 16;    // a staged row: its chunk's granules
constexpr int kAvTcTileBytes = kAvTcChunk * 128;       // a K or V chunk: 64 rows of 128 bytes
constexpr float kAvLog2e = 1.44269504088896341f;

// Whether the tensor-core body takes head width d; ops/av_softmax.py::
// av_softmax_body states the same rule (with bfloat16 operands and k and
// p_v on 16-byte boundaries, which the launch checks).
inline bool av_softmax_tc_takes(int d) {
  return d >= 16 && d <= kAvTcMaxHeadDim && d % 16 == 0;
}

// A warp's staged terms: 16 rows of ``ld`` floats, term_y u at u and
// term_x u at xoff + u. For the tile path (``tiles``: p1 known when
// compiled) xoff is even, for float2 reads, and ld = 8 mod 32; for the
// table path ld is odd. Both keep a warp's reads on distinct banks.
struct AvTerms {
  int ld, xoff;
};

__host__ __device__ inline AvTerms av_terms(int p0, int p1, bool tiles) {
  AvTerms t;
  t.xoff = tiles ? (p0 + 1) & ~1 : p0;
  t.ld = p0 + p1 == 0 ? 0 : tiles ? ((t.xoff + p1 + 31) & ~31) + 8 : (p0 + p1) | 1;
  return t;
}

// Byte offsets of a block's shared memory, the same on host and device:
// two K/V stages, two stages of each warp's rows, each warp's terms, each
// key's term offsets (the table path), the coverage bit masks, the select
// masks of each lane's key pairs.
struct AvTcSmem {
  size_t kv_stage, warp_stage, kv, warp, terms, term_of, bits, masks, total;
};

__host__ __device__ inline AvTcSmem av_tc_smem(int warps, int np, int p0, int p1, bool tiles,
                                                bool logits) {
  AvTcSmem s;
  const int chunks = (np + kAvTcChunk - 1) / kAvTcChunk;
  const AvTerms tt = av_terms(p0, p1, tiles);
  s.kv_stage = (size_t)kAvTcTileBytes * (logits ? 1 : 2);
  s.warp_stage = (size_t)16 * kAvTcRowBytes * (logits ? 2 : 1);
  size_t off = 0;
  s.kv = off;
  off += 2 * s.kv_stage;
  s.warp = off;
  off += (size_t)warps * 2 * s.warp_stage;
  s.terms = off;
  off += (size_t)warps * 16 * tt.ld * sizeof(float);
  off = (off + 15) & ~(size_t)15;
  s.term_of = off;
  off += (size_t)(tt.ld > 0 && !tiles ? chunks * kAvTcChunk : 0) * sizeof(int2);
  s.bits = off;
  off += (size_t)chunks * 4 * sizeof(uint32_t);  // select words, then store words
  s.masks = off;
  off += (size_t)chunks * kAvTcTiles * 4 * sizeof(uint32_t);
  s.total = off + 1024;  // slack: the K and V stages start on a 1024-byte boundary
  return s;
}

// The max (kMax) or the float32 sum of this lane's 16 values of row half i
// (rows g, g + 8) of a chunk's logits, as a balanced tree: no chain of
// dependent operations 16 long.
template <bool kMax>
__device__ __forceinline__ float av_chunk_reduce(const float (&sc)[kAvTcTiles][4], int i) {
  float v[kAvTcTiles];
#pragma unroll
  for (int t = 0; t < kAvTcTiles; ++t) {
    v[t] = kMax ? fmaxf(sc[t][2 * i], sc[t][2 * i + 1]) : sc[t][2 * i] + sc[t][2 * i + 1];
  }
#pragma unroll
  for (int w = kAvTcTiles / 2; w > 0; w >>= 1) {
#pragma unroll
    for (int t = 0; t < w; ++t) v[t] = kMax ? fmaxf(v[t], v[t + w]) : v[t] + v[t + w];
  }
  return v[0];
}

// d (64 x 64 float32, this warp's 16 rows as mma.sync's accumulator tiles)
// = (accumulate ? d : 0) + a . b: a (64 x 16 bfloat16) from registers, this
// warp's 16 rows as mma.sync's A fragment; b (16 x 64) in shared memory
// with the 128-byte swizzle, K-major (kTransB 0) or N-major (1).
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t (&a)[4],
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(kTransB));
}

// Until every wgmma this warpgroup issued has completed; ``d`` (n floats)
// and ``a`` (m words) kept in their registers until then.
template <int N, int M>
__device__ __forceinline__ void wgmma_settle(float* d, uint32_t* a) {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// The bfloat16 pair at p as one 32-bit word, the first in the low half: p
// 4-byte aligned (kAligned), else 2-byte aligned: then the two words that
// hold it, funnel-shifted, with no branch.
template <bool kAligned>
__device__ __forceinline__ uint32_t av_load_pair(const unsigned char* p) {
  if constexpr (kAligned) {
    return *reinterpret_cast<const uint32_t*>(p);
  } else {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
    return __funnelshift_r(w[0], w[1], (uint32_t)(a & 2) * 8);
  }
}

// The chunk [j0, j0 + 64) of the row of a (.., Np) bfloat16 matrix that
// starts at ``row``, as the 16-byte granules that cover it, by cp.async
// into ``dst``.
__device__ __forceinline__ void av_copy_row(unsigned char* dst, const __nv_bfloat16* row, int np,
                                            int j0) {
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(row + j0);
  const uintptr_t from = a0 & ~(uintptr_t)15, end = a0 + 2 * min(kAvTcChunk, np - j0);
#pragma unroll
  for (int gi = 0; gi < kAvTcRowBytes / 16; ++gi) {
    if (from + 16 * gi < end) {
      cp_async16(dst + 16 * gi, reinterpret_cast<const void*>(from + 16 * gi));
    }
  }
}

// One block per (batch x head, 16 x warps query rows). kLogits: the logits
// form (logits given in place of q and k); kD: the head width; kWhole:
// every 64-key chunk of a p_a (and logits) row is whole 16-byte granules
// (Np a multiple of 8, both on 16-byte boundaries); kP1: the key grid's p1
// where it is known when compiled (32: ViTDet-1024's 32 x 32), so that a
// tile's term columns are fixed offsets, else 0 (each key's columns from a
// table).
template <bool kLogits, int kD, bool kWhole, int kP1>
__global__ void __launch_bounds__(256, 2)
av_softmax_tc_kernel(__nv_bfloat16* __restrict__ p_a, const float* __restrict__ cov,
                     const __nv_bfloat16* __restrict__ p_v, const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ logits,
                     const __nv_bfloat16* __restrict__ terms, __nv_bfloat16* __restrict__ out,
                     int heads, int n, int np, int p0, int p1, float inv_scale) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char av_tc_mem[];
  // the stages on a 1024-byte boundary (the swizzle's period), reached as an
  // offset into the shared array so that every access stays a shared one
  unsigned char* av_tc_raw = av_tc_mem + ((1024u - (smem_u32(av_tc_mem) & 1023u)) & 1023u);
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, qd = lane & 3;   // fragment row and column pair
  const int nt = terms != nullptr ? p0 + p1 : 0;
  const int tp0 = nt > 0 ? p0 : 0, tp1 = nt > 0 ? p1 : 0;
  const AvTerms tt = av_terms(tp0, tp1, kP1 > 0);
  const int chunks = (np + kAvTcChunk - 1) / kAvTcChunk;
  const AvTcSmem lay = av_tc_smem(warps, np, tp0, tp1, kP1 > 0, kLogits);
  const int bh = blockIdx.x, batch = bh / heads;
  const int rw = (blockIdx.y * warps + warp) * 16;  // the warp's first query row
  // a warpgroup runs while any of its rows does: its four warps issue each
  // wgmma together, on rows past n too
  const bool active = (blockIdx.y * warps + (warp & ~3)) * 16 < n;
  const int64_t head_row = (int64_t)bh * n;  // row 0 of this head in q, p_a, logits, out
  unsigned char* wstage = av_tc_raw + lay.warp + (size_t)warp * 2 * lay.warp_stage;
  float* ts = reinterpret_cast<float*>(av_tc_raw + lay.terms) + warp * 16 * tt.ld;
  int2* term_of = reinterpret_cast<int2*>(av_tc_raw + lay.term_of);
  uint32_t* bits = reinterpret_cast<uint32_t*>(av_tc_raw + lay.bits);
  uint32_t* masks = reinterpret_cast<uint32_t*>(av_tc_raw + lay.masks);
  const bf16* pa_head = p_a + head_row * np;
  const bf16* lg_head = kLogits ? logits + head_row * np : nullptr;
  const bf16* kh = kLogits ? nullptr : k + (int64_t)bh * np * kD;
  const bf16* vh = p_v + (int64_t)bh * np * kD;
  const uint32_t kv_base = smem_u32(av_tc_raw + lay.kv);

  // the K and V pieces this thread copies: 16 bytes from column kc of rows
  // kr, kr + krs, ..., into the 128-byte swizzle (piece kc / 8 of row r at
  // piece kc / 8 ^ r % 8; krs is a multiple of 8, so the same for each);
  // the row its lane stages: row rw + lane % 16 of p_a (lanes 0-15, third
  // pass) or of the logits (lanes 16-31; in the logits form's first two
  // passes lanes 0-15 too, the next chunk)
  const int kc = (threadIdx.x & 7) * 8, kr = threadIdx.x >> 3, krs = blockDim.x >> 3;
  const int kswz = (((kc >> 3) ^ (kr & 7)) << 4) + kr * 128;
  const int srow = rw + (lane & 15);
  const bool copies_row = active && srow < n && (kLogits || lane < 16);

  // Keys a step of pass ``pass`` covers: two chunks in the first two passes
  // (the fused form's second chunk of K in the stage's V tile, the logits
  // form's second chunk of logits rows in the warp's p_a slots), else one.
  auto span = [&](int pass) { return pass < 2 ? 2 : 1; };
  // The block's copies of step s (pass ``pass`` from chunk c0) into stage s
  // & 1: K's chunks (fused form), V's (third pass), pad keys zero.
  auto issue_kv = [&](int s, int pass, int c0) {
    const int stage = s & 1;
#pragma unroll
    for (int part = kLogits ? 1 : 0; part < 2; ++part) {
      if (part == 1 && pass != 2 && (kLogits || c0 + 1 >= chunks)) break;
      const int j0 = (pass == 2 ? c0 : c0 + part) * kAvTcChunk;
      unsigned char* tile = av_tc_raw + lay.kv + stage * lay.kv_stage +
                            (kLogits ? 0 : part * kAvTcTileBytes) + kswz;
      const bf16* src = (part == 1 && pass == 2 ? vh : kLogits ? vh : kh) +
                        (int64_t)(j0 + kr) * kD + kc;
      for (int r = 0; kr + r < kAvTcChunk && kc < kD; r += krs) {
        if (j0 + kr + r < np) {
          cp_async16(tile + r * 128, src + (int64_t)r * kD);
        } else {
          *reinterpret_cast<uint4*>(tile + r * 128) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
  };
  // The warp's copies of step s: its p_a rows (third pass) and logits rows
  // (logits form).
  auto issue_rows = [&](int s, int pass, int c0) {
    const int c = kLogits && pass < 2 && lane < 16 ? c0 + 1 : c0;
    if (copies_row && c < chunks && (pass == 2 || (kLogits && pass < 2) || lane >= 16)) {
      const bf16* head = pass == 2 && lane < 16 ? pa_head : lg_head;
      av_copy_row(wstage + (s & 1) * lay.warp_stage + lane * kAvTcRowBytes,
                  head + (int64_t)srow * np, np, c * kAvTcChunk);
    }
    cp_async_commit();
  };
  issue_kv(0, 0, 0);
  issue_rows(0, 0, 0);

  // Each key's two term offsets (the table path); the coverage as bit
  // masks, a select word (covered or pad: take the new value) and a store
  // word (covered) per 32 keys; this warp's terms as float32.
  if (nt > 0 && kP1 == 0) {
    for (int j = threadIdx.x; j < chunks * kAvTcChunk; j += blockDim.x) {
      term_of[j] = j < np ? make_int2(j / p1, tt.xoff + j % p1) : make_int2(0, 0);
    }
  }
  for (int w = warp; w < chunks * 2; w += warps) {
    const int j = w * 32 + lane;
    const bool hit = j < np && cov[(int64_t)batch * np + j] > 0.f;
    const unsigned covered = __ballot_sync(0xffffffffu, hit);
    const unsigned valid = __ballot_sync(0xffffffffu, j < np);
    if (lane == 0) {
      bits[w] = covered | ~valid;
      bits[chunks * 2 + w] = covered;
    }
  }
  __syncthreads();
  // the merge mask of each (chunk, 8-key tile, lane pair column): the halves
  // of a bfloat16 pair that take the new value
  for (int e = threadIdx.x; e < chunks * kAvTcTiles * 4; e += blockDim.x) {
    const int ct = e >> 2, t = ct % kAvTcTiles;
    const uint32_t sb = bits[2 * (ct / kAvTcTiles) + (t >> 2)] >> ((t & 3) * 8 + (e & 3) * 2) & 3u;
    masks[e] = (sb & 1u ? 0x0000ffffu : 0u) | (sb & 2u ? 0xffff0000u : 0u);
  }
  for (int e = lane; e < 16 * nt; e += 32) {
    const int r = e / nt, u = e - r * nt;
    ts[r * tt.ld + (u < p0 ? u : tt.xoff + u - p0)] =
        rw + r < n ? to_f(terms[(head_row + rw + r) * nt + u]) : 0.f;
  }
  // q of this lane's rows g and g + 8 straight into A fragments, scaled:
  // rnd(q * rnd(inv_scale)); two-byte loads, so q may lie anywhere
  uint32_t qa[kD / 16][4];
  if constexpr (!kLogits) {
    const float scale = rnd<bf16>(inv_scale);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // r = half * 2 + row: a0a1, a2a3, a4a5, a6a7
        const int row = rw + g + 8 * (r & 1), col = kk * 16 + (r >> 1) * 8 + qd * 2;
        float x0 = 0.f, x1 = 0.f;
        if (row < n) {
          const bf16* src = q + (head_row + row) * kD + col;
          x0 = to_f(src[0]) * scale;
          x1 = to_f(src[1]) * scale;
        }
        qa[kk][r] = pack_bf16(x0, x1);
      }
    }
  }
  // this lane's rows' byte offsets in a warp stage: the row's slot and its
  // offset into its first granule (the same for every chunk: a chunk starts
  // 128 bytes after the last)
  int pa_off[2], lg_off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = rw + g + 8 * i;
    pa_off[i] = (int)(reinterpret_cast<uintptr_t>(pa_head + row * np) & 15) +
                (g + 8 * i) * kAvTcRowBytes;
    lg_off[i] = kLogits ? (int)(reinterpret_cast<uintptr_t>(lg_head + row * np) & 15) +
                              (16 + g + 8 * i) * kAvTcRowBytes
                        : 0;
  }
  const float* trow = ts + g * tt.ld;  // row g; row g + 8 lies tld8 floats on
  const int tld8 = 8 * tt.ld;
  const bool row_in[2] = {rw + g < n, rw + g + 8 < n};
  // this lane's rows' pairs on 4-byte boundaries (rows g and g + 8 start 16
  // Np bytes apart: both or neither)
  const bool pair_al = (pa_off[0] & 3) == 0;

  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, rinv[2] = {0.f, 0.f};
  float mlog[2] = {0.f, 0.f};  // max log2(e)
  float o[32];  // out's 64 columns as wgmma's accumulator: the first kD are out
#pragma unroll
  for (int u = 0; u < 32; ++u) o[u] = 0.f;

  int pass = 0, c0 = 0;
#pragma unroll 1
  for (int s = 0; pass < 3; ++s) {
    const int stage = s & 1;
    int next_pass = pass, next_c0 = c0 + span(pass);
    if (next_c0 >= chunks) {
      ++next_pass;
      next_c0 = 0;
    }
    cp_async_wait<0>();
    fence_proxy_async();  // this thread's copies in place, for wgmma's reads
    // step s in place; stage (s + 1) & 1 read by every warp. The logits
    // form's first two passes share no stage: its warps run apart there
    if (!kLogits || pass == 2) {
      __syncthreads();
    } else {
      __syncwarp();
    }
    if (next_pass < 3) {
      issue_kv(s + 1, next_pass, next_c0);
      issue_rows(s + 1, next_pass, next_c0);
    }
    if (!active) {
      pass = next_pass;
      c0 = next_c0;
      continue;
    }
    const uint32_t kv = kv_base + stage * (uint32_t)lay.kv_stage;
    const unsigned char* ws = wstage + stage * lay.warp_stage;
    for (int sub = 0; sub < span(pass) && c0 + sub < chunks; ++sub) {
      const int c = c0 + sub, j0 = c * kAvTcChunk;

      // the chunk's logits: q.kT on the tensor cores, or the staged logits
      float sc[kAvTcTiles][4];
      if constexpr (kLogits) {
#pragma unroll
        for (int t = 0; t < kAvTcTiles; ++t) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const uint32_t pr = av_load_pair<kWhole>(ws + lg_off[i] - sub * 16 * kAvTcRowBytes +
                                                     2 * (t * 8 + qd * 2));
            sc[t][2 * i] = __uint_as_float(pr << 16);
            sc[t][2 * i + 1] = __uint_as_float(pr & 0xffff0000u);
          }
        }
      } else {
        // K-major B: 16 columns of d are 32 bytes on in the swizzled rows
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          wgmma_m64n64k16_rs<0>(&sc[0][0], qa[kk],
                                wgmma_desc(kv + sub * kAvTcTileBytes + kk * 32, 16, 1024), kk > 0);
        }
        wgmma_settle<32, 0>(&sc[0][0], nullptr);
      }
      // + (term_y + term_x), summed in float32 first
      if (nt > 0) {
        if constexpr (kP1 > 0) {
          // p1 divides the chunk: tile t's key-grid row is c * 64 / p1 + 8 t /
          // p1 and its first column 8 t % p1, fixed offsets from two bases
          static_assert(kAvTcChunk % kP1 == 0 && kP1 % 8 == 0, "tiles of one key-grid row");
          const float* ty_row = trow + c * (kAvTcChunk / kP1);
          const float* tx_row = trow + tt.xoff + qd * 2;
#pragma unroll
          for (int t = 0; t < kAvTcTiles; ++t) {
            const int yo = 8 * t / kP1, xo = 8 * t % kP1;
            const float ty0 = ty_row[yo], ty1 = ty_row[tld8 + yo];
            const float2 tx0 = *reinterpret_cast<const float2*>(tx_row + xo);
            const float2 tx1 = *reinterpret_cast<const float2*>(tx_row + tld8 + xo);
            sc[t][0] += ty0 + tx0.x;
            sc[t][1] += ty0 + tx0.y;
            sc[t][2] += ty1 + tx1.x;
            sc[t][3] += ty1 + tx1.y;
          }
        } else {
#pragma unroll
          for (int t = 0; t < kAvTcTiles; ++t) {
            const int4 cols = *reinterpret_cast<const int4*>(term_of + j0 + t * 8 + qd * 2);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int cy = (e & 1) ? cols.z : cols.x, cx = (e & 1) ? cols.w : cols.y;
              const float* tr = trow + (e >> 1) * tld8;
              sc[t][e] += tr[cy] + tr[cx];
            }
          }
        }
      }
      if (j0 + kAvTcChunk > np) {  // pad keys at -inf
#pragma unroll
        for (int t = 0; t < kAvTcTiles; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (j0 + t * 8 + qd * 2 + (e & 1) >= np) sc[t][e] = -INFINITY;
          }
        }
      }
      const bool last = c == chunks - 1;
      if (pass == 0) {  // the row max, as a tree over the chunk
#pragma unroll
        for (int i = 0; i < 2; ++i) mx[i] = fmaxf(mx[i], av_chunk_reduce<true>(sc, i));
        if (last) {  // the four lanes of a quad hold a row's keys
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
            mlog[i] = mx[i] * kAvLog2e;
          }
        }
        continue;
      }
#pragma unroll
      for (int t = 0; t < kAvTcTiles; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[t][e] = exp2f(fmaf(sc[t][e], kAvLog2e, -mlog[e >> 1]));
      }
      if (pass == 1) {  // the float32 sum of exp, a tree over the chunk
#pragma unroll
        for (int i = 0; i < 2; ++i) sum[i] += av_chunk_reduce<false>(sc, i);
        if (last) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
            sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
            rinv[i] = __frcp_rn(sum[i]);
          }
        }
        continue;
      }
      // a = e / sum rounded to bfloat16, merged with the old p_a, the covered
      // columns stored, then P.V over the chunk's 16-key slices
      const uint32_t put[2] = {bits[2 * chunks + 2 * c], bits[2 * chunks + 2 * c + 1]};
      const uint32_t vs = kv + (kLogits ? 0 : kAvTcTileBytes);
      unsigned char* pa_stage = wstage + stage * lay.warp_stage;
      const bool changed = (put[0] | put[1]) != 0u;
      uint32_t a[kAvTcChunk / 16][4];
#pragma unroll
      for (int kk = 0; kk < kAvTcChunk / 16; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = 2 * kk + h, jj = t * 8 + qd * 2, shift = (t & 3) * 8 + qd * 2;
          const uint32_t mask = masks[(c * kAvTcTiles + t) * 4 + qd];
          // covered keys of the pair (kWhole: the stage's pad keys are never written back)
          const uint32_t pb = kWhole ? mask : put[t >> 2] >> shift & 3u;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float pv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float ev = sc[t][2 * i + e], qv = ev * rinv[i];
              pv[e] = fmaf(fmaf(-qv, sum[i], ev), rinv[i], qv);
            }
            const uint32_t fresh = pack_bf16(pv[0], pv[1]);
            const uint32_t old = av_load_pair<kWhole>(ws + pa_off[i] + 2 * jj);
            const uint32_t merged = (fresh & mask) | (old & ~mask);
            a[kk][2 * h + i] = merged;  // a0 a1: rows g, g + 8 of tile 2kk; a2 a3: of 2kk + 1
            if constexpr (kWhole) {  // into the staged row, which goes back below
              if (pb != 0u && row_in[i]) {
                *reinterpret_cast<uint32_t*>(pa_stage + pa_off[i] + 2 * jj) = merged;
              }
            } else if (pb != 0u && row_in[i]) {  // the covered keys, from registers
              bf16* dst = p_a + (head_row + rw + g + 8 * i) * np + j0 + jj;
              if (pair_al && j0 + jj + 1 < np) {
                *reinterpret_cast<uint32_t*>(dst) = merged;
              } else {
                if (pb & 1u) *reinterpret_cast<uint16_t*>(dst) = (uint16_t)(merged & 0xffffu);
                if (pb & 2u) *reinterpret_cast<uint16_t*>(dst + 1) = (uint16_t)(merged >> 16);
              }
            }
          }
        }
      }
      if (kWhole && changed) {
        // the updated chunk back from the stage in whole 16-byte granules,
        // four rows of 128 bytes a warp-wide store, uncovered columns
        // rewritten with the bits just read
        __syncwarp();
        const int bytes = 2 * min(kAvTcChunk, np - j0), off = (lane & 7) * 16;
#pragma unroll
        for (int it = 0; it < 4; ++it) {
          const int r = it * 4 + (lane >> 3);
          if (rw + r < n && off < bytes) {
            unsigned char* row =
                reinterpret_cast<unsigned char*>(p_a + (head_row + rw + r) * np + j0);
            *reinterpret_cast<uint4*>(row + off) =
                *reinterpret_cast<const uint4*>(pa_stage + r * kAvTcRowBytes + off);
          }
        }
      }
      // N-major B (the transpose bit): 16 keys are 16 rows of 128 bytes on
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kAvTcChunk / 16; ++kk) {
        wgmma_m64n64k16_rs<1>(o, a[kk], wgmma_desc(vs + kk * 16 * 128, 8192, 1024), 1);
      }
      wgmma_settle<32, 4 * (kAvTcChunk / 16)>(o, &a[0][0]);
    }
    pass = next_pass;
    c0 = next_c0;
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_in[i]) continue;
    bf16* orow = out + (head_row + rw + g + 8 * i) * kD;
#pragma unroll
    for (int u = 0; u < kD / 8; ++u) {
      *reinterpret_cast<uint32_t*>(orow + u * 8 + qd * 2) =
          pack_bf16(o[4 * u + 2 * i], o[4 * u + 2 * i + 1]);
    }
  }
}

template <bool kLogits, int kD, bool kWhole, int kP1>
int launch_av_softmax_tc_kernel(void* p_a, const float* cov, const void* p_v, const void* q,
                                const void* k, const void* logits, const void* terms, void* out,
                                int bsz, int heads, int n, int np, int p0, int p1,
                                float inv_scale, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return (int)err;
  const int tp0 = terms != nullptr ? p0 : 0, tp1 = terms != nullptr ? p1 : 0;
  int warps = (int64_t)bsz * heads * ((n + 127) / 128) >= 2 * sms ? 8 : 4;
  AvTcSmem lay = av_tc_smem(warps, np, tp0, tp1, kP1 > 0, kLogits);
  if (lay.total > (size_t)kAvMaxShared && warps == 8) {
    warps = 4;
    lay = av_tc_smem(warps, np, tp0, tp1, kP1 > 0, kLogits);
  }
  if (lay.total > (size_t)kAvMaxShared) return (int)cudaErrorInvalidConfiguration;
  auto kernel = av_softmax_tc_kernel<kLogits, kD, kWhole, kP1>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bsz * heads, (n + warps * 16 - 1) / (warps * 16));
  kernel<<<grid, warps * 32, lay.total, stream>>>(
      (__nv_bfloat16*)p_a, cov, (const __nv_bfloat16*)p_v, (const __nv_bfloat16*)q,
      (const __nv_bfloat16*)k, (const __nv_bfloat16*)logits, (const __nv_bfloat16*)terms,
      (__nv_bfloat16*)out, heads, n, np, p0, p1, inv_scale);
  return (int)cudaGetLastError();
}

// Launch the tensor-core body; cudaErrorInvalidValue where it does not take
// the call (the wrappers choose the body by the same rule and do not send
// such calls). 8-warp blocks where they fill every SM twice over, else
// 4-warp blocks; the instantiation by head width, the alignment class of
// p_a's rows (and the logits') and, for ViTDet-1024's 32 x 32 key grid with
// terms, p1.
template <bool kLogits>
int launch_av_softmax_tc(void* p_a, const float* cov, const void* p_v, const void* q,
                         const void* k, const void* logits, const void* terms, void* out,
                         int bsz, int heads, int n, int np, int d, int p0, int p1,
                         float inv_scale, cudaStream_t stream) {
  const auto aligned = [](const void* p, uintptr_t m) {
    return (reinterpret_cast<uintptr_t>(p) & m) == 0;
  };
  if (!av_softmax_tc_takes(d) || !aligned(p_v, 15) || (!kLogits && !aligned(k, 15))) {
    return (int)cudaErrorInvalidValue;
  }
  const bool whole = np % 8 == 0 && aligned(p_a, 15) && (!kLogits || aligned(logits, 15));
  if (d == 64 && whole && terms != nullptr && p1 == 32) {
    return launch_av_softmax_tc_kernel<kLogits, 64, true, 32>(p_a, cov, p_v, q, k, logits, terms,
                                                             out, bsz, heads, n, np, p0, p1,
                                                             inv_scale, stream);
  }
#define ETK_AV_TC(D)                                                                          \
  return whole ? launch_av_softmax_tc_kernel<kLogits, D, true, 0>(p_a, cov, p_v, q, k, logits, \
                                                                 terms, out, bsz, heads, n, np, \
                                                                 p0, p1, inv_scale, stream)     \
               : launch_av_softmax_tc_kernel<kLogits, D, false, 0>(p_a, cov, p_v, q, k, logits, \
                                                                  terms, out, bsz, heads, n,    \
                                                                  np, p0, p1, inv_scale, stream)
  switch (d) {
    case 16: ETK_AV_TC(16);
    case 32: ETK_AV_TC(32);
    case 48: ETK_AV_TC(48);
    default: ETK_AV_TC(64);
  }
#undef ETK_AV_TC
}

}  // namespace etk
