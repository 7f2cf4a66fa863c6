// The tiled body of the rel-pos bias add (rows 16 and 17), for its bfloat16
// calls: x, q and the tables bfloat16, c a multiple of 8, q and the tables
// 16-byte aligned. relpos.cu includes it and dispatches to it (body "tile"
// of ops/relpos.py::relpos_body); float32 calls and misaligned operands keep
// the CUDA-core body there ("simt").
//
// What bounds it: the logits, one read of x and one write of out (805 MB
// in bf16 at ViTDet-1024's dense global blocks over two streams, 0.48 ms at
// 3.35 TB/s; 37 MB at the e2e path's pooled flush). The terms are 2 B H N
// (p0 + p1) c operations (1.6 GFLOP at 1024). The CUDA-core body of
// relpos.cu spends 45-80 % of a bfloat16 call in its terms phase, which
// moves no logits: each token re-reads its x_rel slice, a lane sums one
// 64-long product through a chain of dependent loads, and the stream has
// one 16-byte load a thread in flight.
// The design:
//   * a block takes a 2-D tile of query tokens, r query rows x s query
//     columns of the (a0, a1) grid of one (batch, head), r and s dividing
//     a0 and a1 (ops/relpos.py::relpos_plan: no ragged tile, each side at
//     most 16);
//   * its operands arrive in one round: the r rows of y_rel and the s rows
//     of x_rel it needs by 16-byte cp.async copies, each table row once a
//     tile (not once a token), as bfloat16 rows padded by 16 bytes; the
//     tile's q rows through registers into float32 meanwhile;
//   * the terms are the tile's products with shared operands: for each
//     tile row, ty = (s x c) . (c x p0) against y_rel[row]; for each tile
//     column, tx = (r x c) . (c x p1) against x_rel[col]. A thread takes 16
//     sums of one product, 8 tokens x 2 keys (4 x 4 where a product has at
//     most 4 tokens), q as float32 and the table rows as bfloat16 from
//     shared memory, 4 k a step. Each sum runs k = 0 .. c - 1 by fmaf(q, t,
//     acc) from 0: the order of the CUDA-core body and of the plain version
//     on the card, so the terms are bit for bit theirs. (The tensor cores
//     sum 16 products at a time in their own order: their terms differ in
//     the last bits, a bfloat16 term of 8 or more then flips its rounding by
//     0.0625 now and then, and kernel_check's bounds fail such calls at the
//     paths' shapes.) The terms are rounded by the form's rule (kRoundEach:
//     each to bfloat16; row 16: float32 kept) into shared memory as
//     float32, ty' and tx' flat over the tile's tokens (token-major);
//   * the stream: the s tokens of a tile row are one contiguous segment of
//     s Np elements. The block walks the 16-byte vectors that cover the
//     tile's r segments, 8 vectors a thread in flight (evict-first loads and
//     stores), 32-bit offsets in the tile, divisions through multiply-high
//     magic numbers;
//   * kWholeRows (p1 a multiple of 8: ViTDet-1024's 64 and 32): every
//     segment starts on 16 bytes and every vector lies in one key row, so a
//     vector adds one ty' and 8 consecutive tx' (two 16-byte shared loads,
//     tx' padded so that a quarter-warp's lie in distinct banks), and a
//     second batch of 8 loads is in flight while the first is added;
//   * otherwise (672's 42 and 21, and any p1) a vector may straddle key
//     rows and tokens, and a segment is off 16 bytes. So once the terms are
//     in, each segment's bias row, rnd(ty' + tx') in bfloat16, is built in
//     shared memory at its logits' 16-byte phase, a key row a thread, in
//     the staged operands' place; then a vector adds the 16 bytes of bias
//     at its own offset. A segment's ragged head and tail vectors (two at
//     most; their other elements are another tile's) are loaded whole and
//     stored an element at a time;
//   * the rounding points are the JAX kernels': bias = rnd(ty' + tx') by a
//     conversion of the float32 sum, out = rnd(x + bias) by one bf16x2 add
//     (a correctly rounded sum of two bfloat16 values, as the float32 add
//     rounded once);
//   * a tile's terms phase moves no logits: two blocks are resident on an
//     SM where every vector lies in one key row (at most 113 KB of shared
//     memory each), three elsewhere (at most 75 KB, where the terms and
//     bias rows weigh more against the logits), so the others stream
//     meanwhile. That costs no code, where a persistent loop overlapping one
//     tile's terms with another's stream would need warp specialisation and
//     a second set of buffers.
#pragma once

#include "common.cuh"
#include "warp_mma.cuh"

namespace etk {

constexpr int kRelposTileThreads = 256;
// Where every vector lies in one key row, two blocks an SM, each with two
// batches of loads in flight; elsewhere three blocks an SM with one batch
// each (fewer registers), so that more tiles overlap their terms with the
// others' streams.
template <bool kWholeRows>
struct RelposTileShape {
  static constexpr int kBlocksPerSm = kWholeRows ? 2 : 3;
  static constexpr int kBatches = kWholeRows ? 2 : 1;
  static constexpr int kMaxShared = kWholeRows ? 113 * 1024 : 75 * 1024;
};
constexpr int kRelposTileUnroll = 8;   // 16-byte vectors a batch
constexpr int kRelposTileMaxSide = 16;  // a tile side

// n / d for 0 <= n < 2^31 by one multiply-high (CUTLASS's FastDivmod):
// m = ceil(2^p / d), p = 31 + ceil(log2 d); d = 1 is m = 0
struct FastDiv {
  uint32_t m, shift;
};

inline FastDiv fast_div(int d) {
  FastDiv f{0u, 0u};
  if (d > 1) {
    int l = 0;
    while ((1 << l) < d) ++l;
    const unsigned p = 31u + (unsigned)l;
    f.m = (uint32_t)(((1ull << p) + (unsigned)d - 1u) / (unsigned)d);
    f.shift = p - 32u;
  }
  return f;
}

__device__ __forceinline__ int div_of(const FastDiv& f, int n) {
  return f.m ? (int)(__umulhi((uint32_t)n, f.m) >> f.shift) : n;
}

struct RelposTileArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* q;
  const __nv_bfloat16* y_rel;
  const __nv_bfloat16* x_rel;
  __nv_bfloat16* out;
  int a0, a1, p0, p1, c, rows, cols;
  int np, seg_len, seg_vecs;  // Np, s Np, the 16-byte vector slots a segment
  FastDiv by_np, by_p1, by_seg_vecs;
};

// floats of ty', rounded up to 16 bytes
__host__ __device__ inline int relpos_tile_ty_len(int tokens, int p0) {
  return (tokens * p0 + 3) & ~3;
}

// tx' element j of the flat table sits at tx_at(j). Where a lane reads 8
// consecutive tx' as two 16-byte loads (kWholeRows), 4 words of padding
// after every 32 put the 8 lanes of a quarter-warp, 8 elements apart, in
// distinct banks; elsewhere tx' is read a key row at a time, unpadded.
template <bool kWholeRows>
__host__ __device__ __forceinline__ int tx_at(int j) {
  return kWholeRows ? j + ((j >> 5) << 2) : j;
}

// floats of tx' (with its padding), rounded up to 16 bytes
__host__ __device__ inline int relpos_tile_tx_len(int tokens, int p1) {
  const int n = tokens * p1;
  return (n + ((n >> 5) << 2) + 3) & ~3;
}

// elements of a segment's bias row: s Np from its 16-byte phase, rounded
// up to 16 bytes
__host__ __device__ inline int relpos_tile_bias_stride(int s, int np) {
  return (s * np + 15) & ~7;
}

// ty' and tx' (float32), then the staged operands: the table rows
// (bfloat16, c + 8 elements each: the 8 rows a quarter-warp reads lie in
// distinct banks) and the tile's q rows (float32, c + 4 each); without
// whole key rows the bias rows take the operands' place once the terms are
// in, so the region is the larger of the two
__host__ __device__ inline size_t relpos_tile_smem(int r, int s, int p0, int p1, int c) {
  const size_t terms = (size_t)relpos_tile_ty_len(r * s, p0) + relpos_tile_tx_len(r * s, p1);
  const size_t staged = ((size_t)r * p0 + (size_t)s * p1) * (c + 8) * sizeof(__nv_bfloat16) +
                        (size_t)r * s * (c + 4) * sizeof(float);
  const size_t bias = p1 % 8 ? (size_t)r * relpos_tile_bias_stride(s, p0 * p1) *
                                   sizeof(__nv_bfloat16)
                             : 0;
  return terms * sizeof(float) + (staged > bias ? staged : bias);
}

// 8 bfloat16 values as float32 (exact)
__device__ __forceinline__ void unpack8(const uint4& w, float (&f)[8]) {
  const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    f[2 * h] = __uint_as_float(v[h] << 16);
    f[2 * h + 1] = __uint_as_float(v[h] & 0xffff0000u);
  }
}

// The products of one kind in a tile: m_count tokens each against p keys,
// in units of mt tokens x (16 / mt) keys
struct TermsGroup {
  int m_count, p, mt;
  __device__ int nbk() const { return (p * mt + 15) / 16; }  // key blocks: keys nb + b nbk
  __device__ int per() const { return ((m_count + mt - 1) / mt) * nbk(); }
};

// one product: token m's float32 q row at q + m q_step, key n's staged row
// at tab + n ld, the term of (m, n) to dst at index m dst_step + n (dst_at:
// its offset, which tx' maps through tx_at)
struct TermsUnit {
  const float* q;
  int q_step;
  const __nv_bfloat16* tab;
  float* dst;
  int dst_step, dst_at;
};

// unit ``rest`` of a product: MT tokens x NT keys (keys nbk apart, so that
// consecutive threads read consecutive table rows), each sum k = 0 .. c - 1
// by fmaf(q, t, acc) from 0, 4 k a step
template <int MT, int NT, bool kRoundEach, bool kTxSwizzle>
__device__ __forceinline__ void terms_unit(const TermsUnit& u, const TermsGroup& grp, int rest,
                                           int ld, int c) {
  const int nbk = grp.nbk(), mb = rest / nbk, nb = rest - mb * nbk;
  const float* qrow[MT];
  const __nv_bfloat16* trow[NT];
  bool tok_in[MT], key_in[NT];
#pragma unroll
  for (int a = 0; a < MT; ++a) {
    const int m = MT * mb + a;
    tok_in[a] = m < grp.m_count;
    qrow[a] = u.q + (tok_in[a] ? m : 0) * u.q_step;
  }
#pragma unroll
  for (int b = 0; b < NT; ++b) {
    const int key = nb + b * nbk;
    key_in[b] = key < grp.p;
    trow[b] = u.tab + (key_in[b] ? key : 0) * ld;
  }
  float acc[MT][NT];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < NT; ++b) acc[a][b] = 0.f;
  for (int k0 = 0; k0 < c; k0 += 4) {
    float4 qf[MT];
    float tf[NT][4];
#pragma unroll
    for (int a = 0; a < MT; ++a) qf[a] = *reinterpret_cast<const float4*>(qrow[a] + k0);
#pragma unroll
    for (int b = 0; b < NT; ++b) {
      const uint2 w = *reinterpret_cast<const uint2*>(trow[b] + k0);
      tf[b][0] = __uint_as_float(w.x << 16), tf[b][1] = __uint_as_float(w.x & 0xffff0000u);
      tf[b][2] = __uint_as_float(w.y << 16), tf[b][3] = __uint_as_float(w.y & 0xffff0000u);
    }
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
      for (int b = 0; b < NT; ++b) {
        acc[a][b] = fmaf(qf[a].x, tf[b][0], acc[a][b]);
        acc[a][b] = fmaf(qf[a].y, tf[b][1], acc[a][b]);
        acc[a][b] = fmaf(qf[a].z, tf[b][2], acc[a][b]);
        acc[a][b] = fmaf(qf[a].w, tf[b][3], acc[a][b]);
      }
  }
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < NT; ++b) {
      if (!tok_in[a] || !key_in[b]) continue;
      const int at = (MT * mb + a) * u.dst_step + u.dst_at + nb + b * nbk;
      u.dst[kTxSwizzle ? tx_at<true>(at) : at] =
          kRoundEach ? rnd<__nv_bfloat16>(acc[a][b]) : acc[a][b];
    }
}

template <bool kRoundEach, bool kWholeRows>
__global__ void __launch_bounds__(kRelposTileThreads,
                                  RelposTileShape<kWholeRows>::kBlocksPerSm)
relpos_bias_add_tile_kernel(const RelposTileArgs g) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int r = g.rows, s = g.cols, p0 = g.p0, p1 = g.p1, c = g.c;
  const int tiles_x = g.a1 / s;
  const int ti = blockIdx.x / tiles_x, tj = blockIdx.x - ti * tiles_x;
  const int i0 = ti * r, j0 = tj * s, bh = blockIdx.y, n = g.a0 * g.a1;
  const int tokens = r * s, ld = c + 8, qld = c + 4;
  float* ty = reinterpret_cast<float*>(tile_smem);
  float* tx = ty + relpos_tile_ty_len(tokens, p0);
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(tx + relpos_tile_tx_len(tokens, p1));
  __nv_bfloat16* xs = ys + r * p0 * ld;
  float* qs = reinterpret_cast<float*>(xs + s * p1 * ld);
  __nv_bfloat16* bias = ys;  // without whole key rows, once the terms are in
  const int tid = threadIdx.x;

  // the operands: y_rel's rows i0 .. i0 + r - 1 and x_rel's j0 .. j0 + s - 1
  // (each r p0 and s p1 contiguous rows) by 16-byte cp.async copies; the
  // tile's q rows (tile row i's s tokens are contiguous in q) through
  // registers into float32 meanwhile
  const int grains = c >> 3;
  const __nv_bfloat16* yt = g.y_rel + (int64_t)i0 * p0 * c;
  for (int e = tid; e < r * p0 * grains; e += kRelposTileThreads) {
    const int row = e / grains, k = (e - row * grains) * 8;
    cp_async16(ys + row * ld + k, yt + (int64_t)row * c + k);
  }
  const __nv_bfloat16* xt = g.x_rel + (int64_t)j0 * p1 * c;
  for (int e = tid; e < s * p1 * grains; e += kRelposTileThreads) {
    const int row = e / grains, k = (e - row * grains) * 8;
    cp_async16(xs + row * ld + k, xt + (int64_t)row * c + k);
  }
  cp_async_commit();
  const __nv_bfloat16* qt = g.q + ((int64_t)bh * n + (int64_t)i0 * g.a1 + j0) * c;
  for (int e = tid; e < tokens * grains; e += kRelposTileThreads) {
    const int row = e / grains, k = (e - row * grains) * 8, i = row / s;
    float f[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(qt + ((int64_t)i * g.a1 + (row - i * s)) * c + k)),
            f);
    float4* dst = reinterpret_cast<float4*>(qs + row * qld + k);
    dst[0] = make_float4(f[0], f[1], f[2], f[3]);
    dst[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the terms: r products (a tile row's s tokens . y_rel[row], p0 keys) and
  // s products (a tile column's r tokens . x_rel[col], p1 keys), in units
  // of 8 tokens x 2 keys a thread where a product has more than 4 tokens,
  // else 4 x 4 (16 sums either way)
  {
    const TermsGroup gy{s, p0, s > 4 ? 8 : 4}, gx{r, p1, r > 4 ? 8 : 4};
    const int units_y = r * gy.per(), units = units_y + s * gx.per();
    for (int unit = tid; unit < units; unit += kRelposTileThreads) {
      if (unit < units_y) {
        const int prod = unit / gy.per(), rest = unit - prod * gy.per();
        // tile row prod: token m is prod s + m, table rows y_rel[i0 + prod]
        const TermsUnit u{qs + prod * s * qld, qld, ys + prod * p0 * ld, ty + prod * s * p0, p0, 0};
        if (gy.mt == 8)
          terms_unit<8, 2, kRoundEach, false>(u, gy, rest, ld, c);
        else
          terms_unit<4, 4, kRoundEach, false>(u, gy, rest, ld, c);
      } else {
        const int t = unit - units_y, prod = t / gx.per(), rest = t - prod * gx.per();
        // tile column prod: token m is m s + prod, table rows x_rel[j0 + prod]
        const TermsUnit u{qs + prod * qld, s * qld, xs + prod * p1 * ld, tx, s * p1, prod * p1};
        if (gx.mt == 8)
          terms_unit<8, 2, kRoundEach, kWholeRows>(u, gx, rest, ld, c);
        else
          terms_unit<4, 4, kRoundEach, kWholeRows>(u, gx, rest, ld, c);
      }
    }
  }
  __syncthreads();

  // the stream: segment i (tile row i) starts at element g0 + i a1 Np; the
  // tile's vectors are counted from G = g0 rounded down to 8 elements
  const int64_t g0 = ((int64_t)bh * n + (int64_t)i0 * g.a1 + j0) * g.np;
  const int64_t gbase = g0 & ~(int64_t)7;
  const int head = (int)(g0 - gbase), row_elems = g.a1 * g.np;
  const uint4* xv = reinterpret_cast<const uint4*>(g.x + gbase);
  uint4* ov = reinterpret_cast<uint4*>(g.out + gbase);
  const int slots = r * g.seg_vecs, len = g.seg_len, np = g.np;
  const int bstride = relpos_tile_bias_stride(s, np);

  if (!kWholeRows) {
    // each segment's bias row, rnd(ty' + tx'), in bfloat16 at the phase of
    // its logits (element e at (rel & 7) + e), a key row a thread
    for (int row = tid; row < tokens * p0; row += kRelposTileThreads) {
      const int tt = row / p0, ky = row - tt * p0, i = tt / s;
      const int rel = head + i * row_elems;
      __nv_bfloat16* dst = bias + i * bstride + (rel & 7) + (tt - i * s) * np + ky * p1;
      const float ty0 = ty[row];
      const float* txr = tx + tt * p1;
      for (int kx = 0; kx < p1; ++kx) dst[kx] = __float2bfloat16_rn(ty0 + txr[kx]);
    }
    __syncthreads();
  }

  auto load = [&](uint4 (&v)[kRelposTileUnroll], int f0) {
#pragma unroll
    for (int u = 0; u < kRelposTileUnroll; ++u) {
      const int f = f0 + u * kRelposTileThreads;
      const int i = div_of(g.by_seg_vecs, f), vs = f - i * g.seg_vecs;
      const int rel = head + i * row_elems, e = 8 * vs - (rel & 7);
      // a ragged vector too: its 16 bytes hold an element of x
      if (f < slots && (kWholeRows || e < len)) v[u] = __ldcs(xv + (rel >> 3) + vs);
    }
  };
  auto add = [&](uint4 (&v)[kRelposTileUnroll], int f0) {
#pragma unroll
    for (int u = 0; u < kRelposTileUnroll; ++u) {
      const int f = f0 + u * kRelposTileThreads;
      if (f >= slots) break;
      const int i = div_of(g.by_seg_vecs, f), vs = f - i * g.seg_vecs;
      const int rel = head + i * row_elems, e = 8 * vs - (rel & 7);
      __nv_bfloat162* pair = reinterpret_cast<__nv_bfloat162*>(&v[u]);
      if (kWholeRows) {  // head 0, e = 8 vs: one key row, kx a multiple of 8
        const int t = div_of(g.by_np, e), k = e - t * np;
        const int ky = div_of(g.by_p1, k), kx = k - ky * p1;
        const int tt = i * s + t;
        const float ty0 = ty[tt * p0 + ky];
        const float* txr = tx + tx_at<true>(tt * p1 + kx);  // 8 in one 32-word group
        const float4 lo = *reinterpret_cast<const float4*>(txr);
        const float4 hi = *reinterpret_cast<const float4*>(txr + 4);
        pair[0] = __hadd2(pair[0], __floats2bfloat162_rn(ty0 + lo.x, ty0 + lo.y));
        pair[1] = __hadd2(pair[1], __floats2bfloat162_rn(ty0 + lo.z, ty0 + lo.w));
        pair[2] = __hadd2(pair[2], __floats2bfloat162_rn(ty0 + hi.x, ty0 + hi.y));
        pair[3] = __hadd2(pair[3], __floats2bfloat162_rn(ty0 + hi.z, ty0 + hi.w));
        __stcs(ov + (rel >> 3) + vs, v[u]);
        continue;
      }
      if (e >= len) continue;
      const __nv_bfloat16* brow = bias + i * bstride;  // element e at (rel & 7) + e
      if (e >= 0 && e + 8 <= len) {
        const uint4 b = *reinterpret_cast<const uint4*>(brow + 8 * vs);
        const __nv_bfloat162* bp = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int h = 0; h < 4; ++h) pair[h] = __hadd2(pair[h], bp[h]);
        __stcs(ov + (rel >> 3) + vs, v[u]);
      } else {
        // a segment's ragged head or tail: its own elements, one at a time
        const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&v[u]);
        __nv_bfloat16* oe = g.out + gbase + rel + e;
#pragma unroll
        for (int w = 0; w < 8; ++w)
          if (e + w >= 0 && e + w < len) oe[w] = __hadd(xe[w], brow[8 * vs + w]);
      }
    }
  };

  // one batch loads while the other is added and stored
  constexpr int kStep = kRelposTileThreads * kRelposTileUnroll;
  if (RelposTileShape<kWholeRows>::kBatches == 1) {
    for (int f0 = tid; f0 < slots; f0 += kStep) {
      uint4 v[kRelposTileUnroll];
      load(v, f0);
      add(v, f0);
    }
    return;
  }
  uint4 va[kRelposTileUnroll], vb[kRelposTileUnroll];
  load(va, tid);
  for (int f0 = tid; f0 < slots; f0 += 2 * kStep) {
    if (f0 + kStep < slots) load(vb, f0 + kStep);
    add(va, f0);
    if (f0 + 2 * kStep < slots) load(va, f0 + 2 * kStep);
    if (f0 + kStep < slots) add(vb, f0 + kStep);
  }
}

// 0 or the CUDA error; cudaErrorInvalidValue for a call off the body's
// rule: c a multiple of 8, q and the tables (and x, out) 16-byte aligned,
// tile sides dividing the grid, at most 16 each, the tile's shared memory
// within RelposTileShape's kMaxShared
template <bool kRoundEach>
int launch_relpos_tile(const void* x, const void* q, const void* y_rel, const void* x_rel,
                       void* out, int bh, int a0, int a1, int p0, int p1, int c, int rows,
                       int cols, cudaStream_t stream) {
  const auto off16 = [](const void* p) { return ((uintptr_t)p & 15u) != 0; };
  if (c % 8 || c < 8 || off16(x) || off16(q) || off16(y_rel) || off16(x_rel) || off16(out) ||
      rows < 1 || cols < 1 || rows > kRelposTileMaxSide || cols > kRelposTileMaxSide ||
      a0 % rows || a1 % cols)
    return (int)cudaErrorInvalidValue;
  const size_t smem = relpos_tile_smem(rows, cols, p0, p1, c);
  const bool whole = p1 % 8 == 0;  // then every segment starts on 16 bytes
  const size_t max_shared = whole ? RelposTileShape<true>::kMaxShared
                                  : RelposTileShape<false>::kMaxShared;
  // the shared memory of its block shape, 32-bit offsets within a tile
  if (smem > max_shared ||
      (int64_t)rows * a1 * p0 * p1 + 16 > ((int64_t)1 << 30))
    return (int)cudaErrorInvalidValue;
  RelposTileArgs g;
  g.x = (const __nv_bfloat16*)x;
  g.q = (const __nv_bfloat16*)q;
  g.y_rel = (const __nv_bfloat16*)y_rel;
  g.x_rel = (const __nv_bfloat16*)x_rel;
  g.out = (__nv_bfloat16*)out;
  g.a0 = a0, g.a1 = a1, g.p0 = p0, g.p1 = p1, g.c = c, g.rows = rows, g.cols = cols;
  g.np = p0 * p1;
  g.seg_len = cols * g.np;
  // the vectors one segment can touch, at any alignment
  g.seg_vecs = whole ? g.seg_len / 8 : (g.seg_len + 14) / 8;
  g.by_np = fast_div(g.np);
  g.by_p1 = fast_div(p1);
  g.by_seg_vecs = fast_div(g.seg_vecs);
  auto kernel = whole ? relpos_bias_add_tile_kernel<kRoundEach, true>
                      : relpos_bias_add_tile_kernel<kRoundEach, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a0 / rows) * (a1 / cols), bh);
  kernel<<<grid, kRelposTileThreads, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace etk
