// softmax_select_matmul, the fused A.V step of EventfulBlock, written for
// Hopper.
//
// Replaces eventful_transformer_tpu/ops/pallas/av_softmax.py::
// softmax_select_matmul in its two forms, each with and without rel-pos
// terms: the fused matmul-1 form (q, k and inv_scale given, no logits
// tensor) and the logits form (a logits tensor in S, as the cached product
// or an unfused matmul-1 leaves it after the matmul-2 cast):
//
//   qs     = rnd_W(q * rnd_W(inv_scale))
//   l[i,j] = qs[i] . k[j]   (fused)  |  logits[i, j]   (logits form)
//   l[i,j] = l[i,j] + (term[i, j / p1] + term[i, p0 + j % p1])  (float32)
//   a      = softmax_j(l) (float32, max-subtracted), rounded to S
//   p_a'   = where(cov[b, j], a, p_a)                               (in place)
//   out    = rnd_S(p_a' . p_v)                                      (float32 sums)
//
// W is the working dtype of q, k and the terms, S the dtype of the A.V state
// (p_a, p_v, out): both float32, both bfloat16, or float32 with the
// bfloat16 matmul-2 cast. At ViTDet-1024 (B = 2, H = 12, N = 4096, Np = 32 x
// 32 = 1024, d = 64) one call reads the (B, H, N, Np) state once (201 MB in
// bf16), writes its selected columns back, and does 2 x 6.4 G multiply-adds;
// the logits and the softmax never leave the SM.
//
// Two bodies, picked by ops/av_softmax.py::av_softmax_body and refused by
// the C entries where the rule does not send them:
//   * "tc" (av_softmax_tc.cuh), every bfloat16 call (W = S = bfloat16, d a
//     multiple of 16 up to 64, k and p_v on 16-byte boundaries): wgmma
//     products, the logits in registers a 64-key chunk at a time over three
//     exact passes, K, V, p_a and the logits streamed by cp.async; what
//     bounds it and how it meets that is its header's;
//   * "simt" (below), float32 and the matmul-2 cast (float32 W, bfloat16
//     S), so that the float32 card-vs-CPU checks keep their meaning: the
//     products stay float32 on the CUDA cores, no TF32.

#include "av_softmax_tc.cuh"
#include "common.cuh"

namespace etk {

// The CUDA-core body. What bounds it: at threshold_1024's unpooled global
// blocks (1 x 12 heads x 4096 queries over 4096 keys, d = 64) the three
// passes below compute q.kT three times and A.V once, 4 x 12.9 G
// multiply-adds, 1.5 ms at the card's 67 TFLOP/s of float32 FMA; the state
// is 805 MB of float32 p_a read and its covered columns written, 0.24 ms at
// 3.35 TB/s. So it is bound by the CUDA cores' FMA rate, which a body
// reaches only where each shared-memory load feeds several FMAs and the
// loads are in flight while the FMAs run. The body it replaces kept each
// row's float32 logits resident in shared memory (8 rows in 131 KB at 4096
// keys: one block an SM), took both operands of each multiply-add from
// shared memory and copied float32 one element at a time (2.6 % of the
// bound). This one is av_softmax_tc.cuh's structure on the CUDA cores:
//   * a warp takes 16 query rows of one (batch, head), a block 2, 4 or 8
//     warps (the most whose blocks still fill the SMs: 8 at the paths' large
//     calls, so that each chunk of K and V is staged once for 128 rows); the
//     scaled q tile stays in shared memory;
//   * K and V come 64 keys at a time by 16-byte cp.async through a ring of
//     two stages, the next step's copies in flight during this step's
//     products (4-byte copies where k or p_v is off a 16-byte boundary);
//   * a thread holds a 4 x 8 register tile of the chunk's logits (rows q +
//     4 i of its warp's 16, keys c + 8 u): per 4 of d it reads its 4 q rows
//     and its 8 K rows as 16-byte vectors (12 loads for 128 FMAs), the next
//     4's loads issued before this 4's FMAs; each logit one fmaf chain over
//     d from 0, the order of the body it replaces. The logits never leave
//     the registers, so shared memory no longer grows with Np (only the
//     terms, p0 + p1 a row, and the coverage bits do);
//   * the softmax is exact, not online: three passes over the chunks, the
//     row max, then the float32 sum of exp(l - max), then a = rnd_S(e / sum)
//     (exp(l - max) as exp2f(l log2(e) - max log2(e)) and e / sum by
//     Markstein's correction of e * RN(1 / sum), as av_softmax_tc.cuh),
//     merged with the old p_a by the coverage (read from device memory
//     before the chunk's products; the covered columns stored back), written
//     over the chunk's K stage as float32 P, and A.V summed into a 4 x (d /
//     8) register tile a thread: per 4 keys 4 P vectors and d / 32 V vectors
//     a key, an fmaf chain over the keys in order. Under the matmul-2 cast
//     (bfloat16 P and V) P goes over the stage as bfloat16 and A.V runs on
//     the tensor cores, mma.sync m16n8k16 with float32 sums, as the WMMA of
//     the body it replaces did;
//   * where they fit beside the rest in blocks of at least half the warps
//     (ViViT's 197 keys, ViTDet-672's 441; not 1024 or 4096), the fused form
//     keeps the first pass's logits (terms added, pads at -inf) resident in
//     shared memory, and the later two passes read them instead of
//     computing q.kT again, as the body it replaced did at every Np;
//   * the logits form reads its chunk's logits from device memory, the next
//     step's in flight during this one; the K stage then holds only P;
//   * pad keys past Np: logits -inf, P 0, V rows zero; never stored.
constexpr int kAvSimtChunk = 64;    // keys a step
constexpr int kAvSimtLdp = kAvSimtChunk + 4;   // float32 P: a row's floats
constexpr int kAvSimtLdpb = kAvSimtChunk + 8;  // bfloat16 P (the cast): a row's elements
constexpr int kAvSimtMaxWarps = 8;

__host__ __device__ inline size_t av_align16(size_t a) { return (a + 15) / 16 * 16; }

// Byte offsets of a block's shared memory, the same on host and device: the
// scaled q tile (fused form), the two stages (K's chunk, P over it in the
// third pass; V's chunk), each row's terms, the coverage bits, the resident
// logits (where the launch keeps them).
struct AvSimtSmem {
  int ldq, ldk, ldv, ldt, ldr;
  size_t qs, ring, stage, v, ts, bits, res, total;
};

template <typename S>
__host__ __device__ inline AvSimtSmem av_simt_smem(int warps, int np, int d, int nt,
                                                   bool logits, bool resident) {
  AvSimtSmem s;
  const int rows = 16 * warps;
  s.ldq = d + 4;
  s.ldk = d + 4;
  s.ldv = d + (int)(16 / sizeof(S));
  s.ldt = ((nt + 31) & ~31) + 8;  // rows 8 banks apart: a warp's 4 rows x 8 keys on distinct banks
  size_t off = 0;
  s.qs = off;
  off += logits ? 0 : av_align16((size_t)rows * s.ldq * sizeof(float));
  const size_t k_bytes = logits ? 0 : (size_t)kAvSimtChunk * s.ldk * sizeof(float);
  const size_t p_bytes = (size_t)rows * kAvSimtLdp * sizeof(float);
  s.v = av_align16(k_bytes > p_bytes ? k_bytes : p_bytes);
  // V's chunk, and 128 columns past its last row: the A.V loop reads whole
  // vectors of its kD columns and drops those past d
  s.stage = av_align16(s.v + ((size_t)kAvSimtChunk * s.ldv + 128) * sizeof(S));
  s.ring = off;
  off += 2 * s.stage;
  s.ts = off;
  off += av_align16((size_t)rows * (nt > 0 ? s.ldt : 0) * sizeof(float));
  s.bits = off;
  off += av_align16((size_t)((np + 31) / 32) * sizeof(uint32_t));
  // the resident logits: rows of whole chunks, 8 banks apart
  s.ldr = resident ? (np + kAvSimtChunk - 1) / kAvSimtChunk * kAvSimtChunk + 8 : 0;
  s.res = off;
  off += (size_t)rows * s.ldr * sizeof(float);
  s.total = off;
  return s;
}

// Values of rows r + 4 i, keys j0 + c + 8 u of a (.., Np) matrix in S whose
// row 0 is ``src``, as float32; 0 off the matrix.
template <typename S>
__device__ __forceinline__ void av_simt_load(float (&v)[4][8], const S* src, int r, int c,
                                             int j0, int valid_rows, int np) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r + 4 * i;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = j0 + c + 8 * u;
      v[i][u] = row < valid_rows && j < np ? to_f(src[(int64_t)row * np + j]) : 0.f;
    }
  }
}

// l += q . k over 4 of d: the thread's 4 q rows against its 8 K rows
__device__ __forceinline__ void av_simt_fma4(float (&l)[4][8], const float4 (&q)[4],
                                             const float4 (&k)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float a = l[i][u];
      a = fmaf(q[i].x, k[u].x, a);
      a = fmaf(q[i].y, k[u].y, a);
      a = fmaf(q[i].z, k[u].z, a);
      a = fmaf(q[i].w, k[u].w, a);
      l[i][u] = a;
    }
}

// One block per (batch x head, 16 x warps query rows); W = float32 (q, k,
// terms), S the state's dtype (float32, or bfloat16 under the matmul-2
// cast). kD: the widest head the instantiation takes (d <= kD, d a multiple
// of 16): the A.V tile's columns.
template <typename S, bool kLogits, int kD>
__global__ void __launch_bounds__(32 * kAvSimtMaxWarps, 1)
av_simt_kernel(S* __restrict__ p_a, const float* __restrict__ cov, const S* __restrict__ p_v,
               const float* __restrict__ q, const float* __restrict__ k,
               const S* __restrict__ logits, const float* __restrict__ terms,
               S* __restrict__ out, int heads, int n, int np, int d, int p0, int p1,
               float inv_scale, bool resident, bool vec_q, bool vec_k, bool vec_v) {
  extern __shared__ __align__(16) unsigned char av_simt_mem[];
  const int warps = blockDim.x / 32, rows = 16 * warps;
  const int nt = terms != nullptr ? p0 + p1 : 0;
  const AvSimtSmem lay = av_simt_smem<S>(warps, np, d, nt, kLogits, resident);
  const int tid = threadIdx.x, lane = tid & 31, tc = lane & 7;
  const int rt = (tid >> 5) * 16 + (lane >> 3);        // the thread's rows: rt + 4 i
  const int bh = blockIdx.x, batch = bh / heads, row0 = blockIdx.y * rows;
  const int valid = min(rows, n - row0);                // rows of the tile inside n
  const int64_t head_row = (int64_t)bh * n + row0;      // the tile's row 0 in q, p_a, out
  const int chunks = (np + kAvSimtChunk - 1) / kAvSimtChunk, steps = 3 * chunks;
  float* qs = reinterpret_cast<float*>(av_simt_mem + lay.qs);
  float* ts = reinterpret_cast<float*>(av_simt_mem + lay.ts);
  uint32_t* bits = reinterpret_cast<uint32_t*>(av_simt_mem + lay.bits);
  float* res = reinterpret_cast<float*>(av_simt_mem + lay.res);
  const float* kh = kLogits ? nullptr : k + (int64_t)bh * np * d;
  const S* vh = p_v + (int64_t)bh * np * d;
  S* pa_tile = p_a + head_row * np;

  // The copies of step s (pass ``pass``, chunk c) into stage s & 1: K's
  // chunk (fused form; with resident logits the first pass only), V's
  // (third pass); pad keys zero.
  auto copies = [&](int pass) { return (!kLogits && (!resident || pass == 0)) || pass == 2; };
  auto issue = [&](int s, int pass, int c) {
    unsigned char* st = av_simt_mem + lay.ring + (size_t)(s & 1) * lay.stage;
    const int j0 = c * kAvSimtChunk;
    if (!kLogits && (!resident || pass == 0)) {
      float* dst = reinterpret_cast<float*>(st);
      const int pieces = d / 4;
      for (int e = tid; e < kAvSimtChunk * pieces; e += blockDim.x) {
        const int r = e / pieces, pc = e - r * pieces;
        const bool ok = j0 + r < np;
        const float* src = ok ? kh + (int64_t)(j0 + r) * d + 4 * pc : kh;
        const uint32_t to = smem_u32(dst + r * lay.ldk + 4 * pc);
        if (vec_k) {
          cp_async_16(to, src, ok ? 16 : 0);
        } else {
#pragma unroll
          for (int x = 0; x < 4; ++x) cp_async_4(to + 4 * x, ok ? src + x : kh, ok ? 4 : 0);
        }
      }
    }
    if (pass == 2) {
      S* dst = reinterpret_cast<S*>(st + lay.v);
      constexpr int per = 16 / sizeof(S);  // elements a 16-byte piece
      const int pieces = d / per;
      for (int e = tid; e < kAvSimtChunk * pieces; e += blockDim.x) {
        const int r = e / pieces, pc = e - r * pieces;
        const bool ok = j0 + r < np;
        const S* src = ok ? vh + (int64_t)(j0 + r) * d + per * pc : vh;
        const uint32_t to = smem_u32(dst + r * lay.ldv + per * pc);
        if (vec_v) {
          cp_async_16(to, src, ok ? 16 : 0);
        } else {  // float32 only: the wrappers refuse bfloat16 p_v off 16 bytes
#pragma unroll
          for (int x = 0; x < 4; ++x) cp_async_4(to + 4 * x, ok ? src + x : vh, ok ? 4 : 0);
        }
      }
    }
  };
  if (!kLogits) issue(0, 0, 0);
  cp_async_commit();

  // the coverage as bits (a ballot a word), q scaled (rnd(q * rnd(
  // inv_scale)): float32), the terms as float32 rows
#pragma unroll 4
  for (int w = tid >> 5; w < (np + 31) / 32; w += warps) {
    const int j = 32 * w + lane;
    const unsigned word =
        __ballot_sync(0xffffffffu, j < np && cov[(int64_t)batch * np + j] > 0.f);
    if (lane == 0) bits[w] = word;
  }
  if constexpr (!kLogits) {  // q's rows are d floats, d a multiple of 16
    if (vec_q) {
#pragma unroll 8
      for (int e = tid; e < rows * d / 4; e += blockDim.x) {
        const int i = 4 * e / d, t = 4 * e - i * d;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < valid) v = *reinterpret_cast<const float4*>(q + (head_row + i) * d + t);
        *reinterpret_cast<float4*>(qs + i * lay.ldq + t) =
            make_float4(v.x * inv_scale, v.y * inv_scale, v.z * inv_scale, v.w * inv_scale);
      }
    } else {
#pragma unroll 8
      for (int e = tid; e < rows * d; e += blockDim.x) {
        const int i = e / d, t = e - i * d;
        qs[i * lay.ldq + t] = i < valid ? q[(head_row + i) * d + t] * inv_scale : 0.f;
      }
    }
  }
#pragma unroll 8
  for (int e = tid; e < rows * nt; e += blockDim.x) {
    const int i = e / nt, u = e - i * nt;
    ts[i * lay.ldt + u] = i < valid ? terms[(head_row + i) * nt + u] : 0.f;
  }

  // mlog: the row max times log2(e); o: A.V on the CUDA cores (float32
  // state), rows rt + 4 i, columns 4 tc + 32 h + x; oc: A.V on the tensor
  // cores (the cast), mma.sync's accumulator tiles of the warp's 16 rows
  float mlog[4], sum[4], rinv[4], o[4][kD / 8], oc[kD / 8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mlog[i] = -INFINITY;
    sum[i] = 0.f;
    rinv[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kD / 8; ++c) o[i][c] = oc[c][i] = 0.f;
  }
  float next[4][8];  // the logits form: the next step's logits, in flight
  if constexpr (kLogits) av_simt_load(next, logits + head_row * np, rt, tc, 0, valid, np);
  __syncthreads();  // the coverage, q and the terms in place

#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const int pass = s / chunks, c = s - pass * chunks, j0 = c * kAvSimtChunk;
    cp_async_wait<0>();
    if (copies(pass)) __syncthreads();  // step s in place; the other stage free
    if (s + 1 < steps && copies((s + 1) / chunks))
      issue(s + 1, (s + 1) / chunks, (s + 1) % chunks);
    cp_async_commit();
    unsigned char* st = av_simt_mem + lay.ring + (size_t)(s & 1) * lay.stage;

    float old[4][8];  // p_a before the select (third pass)
    if (pass == 2) av_simt_load(old, pa_tile, rt, tc, j0, valid, np);
    float l[4][8];
    float* lr = res + rt * lay.ldr + j0 + tc;  // the resident logits of rows rt + 4 i
    if (!kLogits && resident && pass > 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 8; ++u) l[i][u] = lr[4 * i * lay.ldr + 8 * u];
    } else if constexpr (kLogits) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 8; ++u) l[i][u] = next[i][u];
      if (s + 1 < steps) {
        av_simt_load(next, logits + head_row * np, rt, tc, ((s + 1) % chunks) * kAvSimtChunk,
                     valid, np);
      }
    } else {
      // q.kT: per 4 of d, 4 q and 8 K vectors for 128 FMAs, the next 4's
      // vectors loaded before this 4's FMAs (d is a multiple of 16)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 8; ++u) l[i][u] = 0.f;
      const float* ks = reinterpret_cast<const float*>(st) + tc * lay.ldk;
      const float* qr = qs + rt * lay.ldq;
      float4 qa[4], ka[8], qb[4], kb[8];
      auto load = [&](float4 (&qv)[4], float4 (&kv)[8], int t) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qr + 4 * i * lay.ldq + t);
#pragma unroll
        for (int u = 0; u < 8; ++u)
          kv[u] = *reinterpret_cast<const float4*>(ks + 8 * u * lay.ldk + t);
      };
      load(qa, ka, 0);
#pragma unroll 1
      for (int t = 0; t < d; t += 8) {
        load(qb, kb, t + 4);
        av_simt_fma4(l, qa, ka);
        if (t + 8 < d) load(qa, ka, t + 8);
        av_simt_fma4(l, qb, kb);
      }
    }
    // + (term_y + term_x), summed in float32 first; pad keys at -inf (the
    // resident logits hold both)
    const bool fresh = kLogits || !resident || pass == 0;
    if (fresh && nt > 0 && p1 % kAvSimtChunk == 0) {
      // the chunk lies in one key-grid row (threshold_1024's 64 x 64 grid):
      // one term_y a row, term_x at fixed offsets from the chunk's column
      const int y = j0 / p1, x0 = j0 - y * p1 + tc;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* tr = ts + (rt + 4 * i) * lay.ldt;
        const float ty = tr[y];
#pragma unroll
        for (int u = 0; u < 8; ++u) l[i][u] += ty + tr[p0 + x0 + 8 * u];
      }
    } else if (fresh && nt > 0) {
      // key j0 + tc + 8 u at (y, x) of the grid: one division a step, then
      // steps of 8 (a wrap a step where p1 >= 8)
      int y = (j0 + tc) / p1, x = j0 + tc - y * p1;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* tr = ts + (rt + 4 * i) * lay.ldt;
          l[i][u] += tr[y] + tr[p0 + x];
        }
        if (p1 >= 8) {
          x += 8;
          const bool wrap = x >= p1;
          x -= wrap ? p1 : 0;
          y += wrap;
        } else {
          y = (j0 + tc + 8 * (u + 1)) / p1;
          x = j0 + tc + 8 * (u + 1) - y * p1;
        }
      }
    }
    if (fresh && j0 + kAvSimtChunk > np) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (j0 + tc + 8 * u < np) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) l[i][u] = -INFINITY;
      }
    }
    if (resident && pass == 0) {  // the chunk's logits, terms and pads, for the later passes
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 8; ++u) lr[4 * i * lay.ldr + 8 * u] = l[i][u];
    }
    const bool last = c == chunks - 1;
    if (pass == 0) {  // the row max; the 8 lanes of a row reduce it at the end
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float m = l[i][0];
#pragma unroll
        for (int u = 1; u < 8; ++u) m = fmaxf(m, l[i][u]);
        mlog[i] = fmaxf(mlog[i], m);
        if (last) {
#pragma unroll
          for (int o8 = 1; o8 < 8; o8 <<= 1)
            mlog[i] = fmaxf(mlog[i], __shfl_xor_sync(0xffffffffu, mlog[i], o8));
          mlog[i] *= kAvLog2e;
        }
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 8; ++u) l[i][u] = exp2f(fmaf(l[i][u], kAvLog2e, -mlog[i]));
    if (pass == 1) {  // the float32 sum of exp(l - max)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int u = 0; u < 8; ++u) sum[i] += l[i][u];
        if (last) {
#pragma unroll
          for (int o8 = 1; o8 < 8; o8 <<= 1) sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], o8);
          rinv[i] = __frcp_rn(sum[i]);
        }
      }
      continue;
    }
    // a = rnd_S(e / sum), merged with the old p_a, the covered columns stored
    const uint32_t word[2] = {bits[j0 / 32], j0 + 32 < np ? bits[j0 / 32 + 1] : 0u};
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int jj = tc + 8 * u, j = j0 + jj;
      const bool covered = j < np && (word[u >> 2] >> (jj & 31) & 1u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = l[i][u], qv = e * rinv[i];
        const S a = from_f<S>(fmaf(fmaf(-qv, sum[i], e), rinv[i], qv));
        if (covered && rt + 4 * i < valid) pa_tile[(int64_t)(rt + 4 * i) * np + j] = a;
        l[i][u] = covered ? to_f(a) : j < np ? old[i][u] : 0.f;
      }
    }
    __syncthreads();  // every product of the chunk done: P goes over K's stage
    if constexpr (sizeof(S) == 2) {
      // the cast: P' (bfloat16 values) as bfloat16 rows, A.V by mma.sync
      // m16n8k16 with float32 sums (A from P's rows by ldmatrix, B from V's
      // K-major rows by ldmatrix.trans), as the body it replaces ran WMMA
      __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(st);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 8; ++u)
          pb[(rt + 4 * i) * kAvSimtLdpb + tc + 8 * u] = __float2bfloat16_rn(l[i][u]);
      __syncwarp();  // a warp reads only its own 16 rows of P
      const int lm = lane >> 3, lr = lane & 7, wrow = (tid >> 5) * 16;
      const __nv_bfloat16* vb = reinterpret_cast<const __nv_bfloat16*>(st + lay.v);
#pragma unroll
      for (int kk = 0; kk < kAvSimtChunk / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, pb + (wrow + (lm & 1) * 8 + lr) * kAvSimtLdpb + kk * 16 + (lm >> 1) * 8);
#pragma unroll
        for (int u = 0; u < kD / 8; u += 2) {
          if (u * 8 >= d) continue;
          uint32_t v4[4];
          ldmatrix_x4_trans(v4, vb + (kk * 16 + (lm & 1) * 8 + lr) * lay.ldv + u * 8 + (lm >> 1) * 8);
          mma_bf16(oc[u], a, v4[0], v4[1]);
          mma_bf16(oc[u + 1], a, v4[2], v4[3]);
        }
      }
      continue;
    }
    float* ps = reinterpret_cast<float*>(st);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 8; ++u) ps[(rt + 4 * i) * kAvSimtLdp + tc + 8 * u] = l[i][u];
    __syncthreads();
    // A.V over the chunk: per 4 keys, the 4 rows' P as vectors, then each
    // key's V columns 4 tc + 32 h (those inside d) as vectors of 4
    const float* vs = reinterpret_cast<const float*>(st + lay.v) + 4 * tc;
#pragma unroll 2
    for (int j4 = 0; j4 < kAvSimtChunk; j4 += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (rt + 4 * i) * kAvSimtLdp + j4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vr = vs + (j4 + e) * lay.ldv;
#pragma unroll
        for (int h = 0; h < kD / 32; ++h) {  // columns past d: computed, never stored
          const float4 f = *reinterpret_cast<const float4*>(vr + 32 * h);
          const float vv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pe = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
#pragma unroll
            for (int x = 0; x < 4; ++x) o[i][4 * h + x] = fmaf(pe, vv[x], o[i][4 * h + x]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (sizeof(S) == 2) {  // mma.sync's tiles: rows g, g + 8, columns 2 q, 2 q + 1
    const int g = lane >> 2, qd = lane & 3, wrow = (tid >> 5) * 16;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (wrow + g + 8 * h >= valid) continue;
      S* orow = out + (head_row + wrow + g + 8 * h) * d + 2 * qd;
#pragma unroll
      for (int u = 0; u < kD / 8; ++u) {
        if (u * 8 >= d) continue;
        *reinterpret_cast<uint32_t*>(orow + 8 * u) = pack_bf16(oc[u][2 * h], oc[u][2 * h + 1]);
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (rt + 4 * i >= valid) continue;
    S* orow = out + (head_row + rt + 4 * i) * d + 4 * tc;
#pragma unroll
    for (int h = 0; h < kD / 32; ++h) {
      if (4 * tc + 32 * h >= d) continue;
#pragma unroll
      for (int x = 0; x < 4; ++x) orow[32 * h + x] = from_f<S>(o[i][4 * h + x]);
    }
  }
}

// Launch the CUDA-core body: blocks of the most warps (8, 4, 2) whose
// blocks still number at least the SMs and whose shared memory fits, else
// 2; the fused form keeps its logits resident after the first pass (the
// later two read them, q.kT once) where they fit beside the rest at that
// block size or at half of it; the instantiation by head width (d <= 64,
// else <= 128).
template <typename S, bool kLogits>
int launch_av_simt(void* p_a, const float* cov, const void* p_v, const void* q, const void* k,
                   const void* logits, const void* terms, void* out, int bsz, int heads, int n,
                   int np, int d, int p0, int p1, float inv_scale, cudaStream_t stream) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (d % 16 != 0 || d < 16 || d > 128 || np < 1 || n < 1 ||
      (sizeof(S) == 2 && !aligned(p_v))) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int nt = terms != nullptr ? p0 + p1 : 0;
  int warps = kAvSimtMaxWarps;
  AvSimtSmem lay = av_simt_smem<S>(warps, np, d, nt, kLogits, false);
  while (warps > 2 && (lay.total > (size_t)kAvMaxShared ||
                       (int64_t)bsz * heads * ((n + 16 * warps - 1) / (16 * warps)) < sms)) {
    warps /= 2;
    lay = av_simt_smem<S>(warps, np, d, nt, kLogits, false);
  }
  if (lay.total > (size_t)kAvMaxShared) return (int)cudaErrorInvalidConfiguration;
  bool resident = false;
  for (int w = warps; !kLogits && !resident && w >= warps / 2 && w >= 2; w /= 2) {
    const AvSimtSmem held = av_simt_smem<S>(w, np, d, nt, kLogits, true);
    if (held.total <= (size_t)kAvMaxShared) {
      resident = true;
      warps = w;
      lay = held;
    }
  }
  auto kernel = d <= 64 ? av_simt_kernel<S, kLogits, 64> : av_simt_kernel<S, kLogits, 128>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bsz * heads, (n + 16 * warps - 1) / (16 * warps));
  kernel<<<grid, 32 * warps, lay.total, stream>>>(
      (S*)p_a, cov, (const S*)p_v, (const float*)q, (const float*)k, (const S*)logits,
      (const float*)terms, (S*)out, heads, n, np, d, p0, p1, inv_scale, resident, aligned(q),
      aligned(k), aligned(p_v));
  return (int)cudaGetLastError();
}

}  // namespace etk

// body: 1 the tensor-core body (wdtype = sdtype = 1 only), 0 the CUDA-core
// body; wdtype: q, k and terms (0 = float32, 1 = bfloat16); sdtype: p_a,
// p_v and out. The CUDA-core body takes (0, 0) and (0, 1), the matmul-2
// cast of a float32 model. d a multiple of 16, at most 128 (64 on the
// tensor cores); bfloat16 k and p_v 16-byte aligned.
extern "C" int etk_softmax_select_matmul(int body, int wdtype, int sdtype, void* p_a,
                                         const void* cov, const void* p_v, const void* q,
                                         const void* k, const void* terms, void* out, int bsz,
                                         int heads, int n, int np, int d, int p0, int p1,
                                         float inv_scale, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const float* c = (const float*)cov;
  if (body == 1 && wdtype == 1 && sdtype == 1)
    return etk::launch_av_softmax_tc<false>(p_a, c, p_v, q, k, nullptr, terms, out, bsz, heads,
                                            n, np, d, p0, p1, inv_scale, s);
  if (body != 0) return (int)cudaErrorInvalidValue;
  if (wdtype == 0 && sdtype == 0)
    return etk::launch_av_simt<float, false>(p_a, c, p_v, q, k, nullptr, terms, out, bsz, heads,
                                             n, np, d, p0, p1, inv_scale, s);
  if (wdtype == 0 && sdtype == 1)
    return etk::launch_av_simt<__nv_bfloat16, false>(p_a, c, p_v, q, k, nullptr, terms, out, bsz,
                                                     heads, n, np, d, p0, p1, inv_scale, s);
  return (int)cudaErrorInvalidValue;
}

// The logits form: logits (B, H, N, Np) in sdtype; wdtype is the terms'
// (the same combinations; without terms pass wdtype = sdtype).
extern "C" int etk_softmax_select_matmul_logits(int body, int wdtype, int sdtype, void* p_a,
                                                const void* cov, const void* p_v,
                                                const void* logits, const void* terms, void* out,
                                                int bsz, int heads, int n, int np, int d, int p0,
                                                int p1, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const float* c = (const float*)cov;
  if (body == 1 && wdtype == 1 && sdtype == 1)
    return etk::launch_av_softmax_tc<true>(p_a, c, p_v, nullptr, nullptr, logits, terms, out,
                                           bsz, heads, n, np, d, p0, p1, 1.f, s);
  if (body != 0) return (int)cudaErrorInvalidValue;
  if (wdtype == 0 && sdtype == 0)
    return etk::launch_av_simt<float, true>(p_a, c, p_v, nullptr, nullptr, logits, terms, out,
                                            bsz, heads, n, np, d, p0, p1, 1.f, s);
  if (wdtype == 0 && sdtype == 1)
    return etk::launch_av_simt<__nv_bfloat16, true>(p_a, c, p_v, nullptr, nullptr, logits, terms,
                                                    out, bsz, heads, n, np, d, p0, p1, 1.f, s);
  return (int)cudaErrorInvalidValue;
}
