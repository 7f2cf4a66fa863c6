// relpos_bias_add and relpos_bias_add_v2, the decomposed rel-pos bias add
// of ViTDet's global blocks, written for Hopper.
//
// Replaces eventful_transformer_tpu/ops/pallas/relpos.py::relpos_bias_add
// and ::relpos_bias_add_v2. For logits x (B, H, N, Np), N = a0 * a1 query
// tokens on an (a0, a1) grid and Np = p0 * p1 keys on a (p0, p1) grid,
// unscaled q (B, H, N, c) and the resized, pooled tables y_rel (a0, p0, c)
// and x_rel (a1, p1, c), all in the working dtype T:
//
//   ty[n, i] = q[n] . y_rel[n / a1, i]      tx[n, j] = q[n] . x_rel[n % a1, j]
//   out[n, k] = rnd(x[n, k] + rnd(ty'[n, k / p1] + tx'[n, k % p1]))
//
// with the dot products summed in float32. The two TPU kernels differ only
// in where they round (kRoundEach): relpos_bias_add keeps ty' = ty and
// tx' = tx in float32 and rounds their sum once; relpos_bias_add_v2 rounds
// each term to T first (ty' = rnd(ty), tx' = rnd(tx)), then their sum.
//
// What bounds it: the logits. One read of x and one write of out (75 MB in
// bf16 at ViTDet-672's dense global blocks at batch 1, 805 MB at 1024 and
// two streams) against 2 * B * H * N * (p0 + p1) * c term operations
// (1.6 GFLOP at 1024), so the card's memory rate. The TPU kernels expand
// the terms onto the key axis with 0/1 matmuls in VMEM; here one block of
// 256 threads takes 16 query tokens of one query row (one n / a1) of one
// (batch, head): it stages their q rows and the row's y_rel slice in shared
// memory as float32, each warp computes one token's p0 + p1 dot products
// (one lane per output; x_rel[n % a1] is read through L1/L2, it is at most
// a few hundred KB), rounds them by the form's rule and keeps them in
// shared memory; then the block streams the 16 tokens' logits rows, which
// lie next to each other in memory, with 16-byte loads and stores, adding
// the two terms of each key. The bias never reaches device memory.
//
// That body ("simt") takes the float32 calls and the bfloat16 ones with q or
// a table off 16 bytes; every other bfloat16 call takes relpos_tile.cuh's
// ("tile": 2-D tiles of query tokens, the tables staged once a tile, the
// terms in this body's summation order, the logits streamed with 8 or 16
// 16-byte loads a thread in flight). ops/relpos.py::relpos_body picks the
// body.
#include "common.cuh"
#include "relpos_tile.cuh"

namespace etk {

constexpr int kRelposThreads = 256;
constexpr int kRelposTokens = 16;  // query tokens of one block

struct RelposSmem {
  int ys_ld;  // row stride of the staged y_rel slice, float4-aligned
  size_t q_off, ys_off, terms_off, total;
};

__host__ __device__ inline RelposSmem relpos_smem(int c, int p0, int p1) {
  RelposSmem s;
  s.ys_ld = c + 4;  // a float4 row offset of 16 bytes mod 128: no bank conflicts
  s.q_off = 0;
  s.ys_off = s.q_off + (size_t)kRelposTokens * c;
  s.terms_off = s.ys_off + (size_t)p0 * s.ys_ld;
  s.total = (s.terms_off + (size_t)kRelposTokens * (p0 + p1)) * sizeof(float);
  return s;
}

// 16 bytes of T as float32 values
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* dst) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int u = 0; u < (int)(16 / sizeof(T)); ++u) dst[u] = to_f(v[u]);
}

template <typename T, bool kRoundEach>
__global__ void __launch_bounds__(kRelposThreads)
relpos_bias_add_kernel(const T* __restrict__ x, const T* __restrict__ q,
                       const T* __restrict__ y_rel, const T* __restrict__ x_rel,
                       T* __restrict__ out, int a0, int a1, int p0, int p1, int c) {
  extern __shared__ __align__(16) float smem[];
  const RelposSmem lay = relpos_smem(c, p0, p1);
  float* qs = smem + lay.q_off;
  float* ys = smem + lay.ys_off;
  float* terms = smem + lay.terms_off;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = blockIdx.x * kRelposTokens, row = blockIdx.y;
  const int nt = min(kRelposTokens, a1 - x0);
  const int np = p0 * p1, pt = p0 + p1, n = a0 * a1;
  const int64_t token0 = (int64_t)blockIdx.z * n + (int64_t)row * a1 + x0;

  for (int e = tid; e < nt * c; e += blockDim.x) qs[e] = to_f(q[token0 * c + e]);
  const T* yr = y_rel + (int64_t)row * p0 * c;
  for (int e = tid; e < p0 * c; e += blockDim.x) ys[(e / c) * lay.ys_ld + e % c] = to_f(yr[e]);
  __syncthreads();

  // the terms: one warp per token, one lane per output
  constexpr int kVec = 16 / sizeof(T);
  const bool xr_vectors = ((uintptr_t)x_rel & 15u) == 0;
  for (int t = warp; t < nt; t += blockDim.x / 32) {
    const float* qt = qs + t * c;
    const T* xr = x_rel + (int64_t)(x0 + t) * p1 * c;
    for (int j = lane; j < pt; j += 32) {
      float acc = 0.f;
      if (j < p0) {
        const float* yt = ys + j * lay.ys_ld;
        for (int i = 0; i < c; i += 4) {
          const float4 a = *reinterpret_cast<const float4*>(qt + i);
          const float4 b = *reinterpret_cast<const float4*>(yt + i);
          acc = fmaf(a.x, b.x, acc);
          acc = fmaf(a.y, b.y, acc);
          acc = fmaf(a.z, b.z, acc);
          acc = fmaf(a.w, b.w, acc);
        }
      } else {
        const T* xt = xr + (int64_t)(j - p0) * c;
        for (int i = 0; i < c; i += kVec) {
          float b[kVec];
          if (xr_vectors) {
            load16(xt + i, b);
          } else {
#pragma unroll
            for (int u = 0; u < kVec; ++u) b[u] = to_f(xt[i + u]);
          }
#pragma unroll
          for (int u = 0; u < kVec; ++u) acc = fmaf(qt[i + u], b[u], acc);
        }
      }
      terms[t * pt + j] = kRoundEach ? rnd<T>(acc) : acc;
    }
  }
  __syncthreads();

  // the nt logits rows, contiguous: a scalar head up to 16-byte alignment,
  // 16-byte vectors, a scalar tail
  const int64_t base = token0 * np, len = (int64_t)nt * np;
  const int64_t to_aligned = ((16 - (base * (int64_t)sizeof(T)) % 16) % 16) / (int64_t)sizeof(T);
  const int64_t head = to_aligned < len ? to_aligned : len;
  auto one = [&](int64_t e) {
    const int t = (int)(e / np), k = (int)(e - (int64_t)t * np);
    const int ky = k / p1, kx = k - ky * p1;
    const float bias = rnd<T>(terms[t * pt + ky] + terms[t * pt + p0 + kx]);
    out[base + e] = from_f<T>(to_f(x[base + e]) + bias);
  };
  for (int64_t e = tid; e < head; e += blockDim.x) one(e);
  const int64_t vecs = (len - head) / kVec;
  const uint4* xv = reinterpret_cast<const uint4*>(x + base + head);
  uint4* ov = reinterpret_cast<uint4*>(out + base + head);
  for (int64_t v = tid; v < vecs; v += blockDim.x) {
    uint4 raw = __ldg(xv + v);
    T* vals = reinterpret_cast<T*>(&raw);
    const int64_t e = head + v * kVec;
    const int t = (int)(e / np), k = (int)(e - (int64_t)t * np);
    int ky = k / p1, kx = k - ky * p1;
    const float* tr = terms + t * pt;
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const float bias = rnd<T>(tr[ky] + tr[p0 + kx]);
      vals[u] = from_f<T>(to_f(vals[u]) + bias);
      if (++kx == p1) {
        kx = 0;
        if (++ky == p0) {
          ky = 0;
          tr += pt;
        }
      }
    }
    ov[v] = raw;
  }
  for (int64_t e = head + vecs * kVec + tid; e < len; e += blockDim.x) one(e);
}

template <typename T, bool kRoundEach>
int relpos_bias_add(const void* x, const void* q, const void* y_rel, const void* x_rel, void* out,
                    int bh, int a0, int a1, int p0, int p1, int c, cudaStream_t stream) {
  const RelposSmem lay = relpos_smem(c, p0, p1);
  auto kernel = relpos_bias_add_kernel<T, kRoundEach>;
  // fails (invalid argument) where the layout needs more shared memory than
  // one block may have
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a1 + kRelposTokens - 1) / kRelposTokens, a0, bh);
  kernel<<<grid, kRelposThreads, lay.total, stream>>>((const T*)x, (const T*)q, (const T*)y_rel,
                                                      (const T*)x_rel, (T*)out, a0, a1, p0, p1, c);
  return (int)cudaGetLastError();
}

}  // namespace etk

// body: 1 the tiled body (bfloat16 only, q and the tables 16-byte aligned,
// a tile of rows x cols query tokens that divides the (a0, a1) grid, each
// side at most 16), 0 the CUDA-core body (rows and cols unread);
// round_each: 0 = relpos_bias_add (the terms' sum rounded once), 1 =
// relpos_bias_add_v2 (each term rounded, then the sum). c a multiple of 8;
// x and out 16-byte aligned; every operand contiguous.
// cudaErrorInvalidValue for a call off its body's rule.
extern "C" int etk_relpos_bias_add(int body, int dtype, int round_each, const void* x,
                                   const void* q, const void* y_rel, const void* x_rel,
                                   void* out, int bh, int a0, int a1, int p0, int p1, int c,
                                   int rows, int cols, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (body == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (round_each)
      return etk::launch_relpos_tile<true>(x, q, y_rel, x_rel, out, bh, a0, a1, p0, p1, c,
                                           rows, cols, s);
    return etk::launch_relpos_tile<false>(x, q, y_rel, x_rel, out, bh, a0, a1, p0, p1, c, rows,
                                          cols, s);
  }
  if (body != 0 || c % 8 || ((uintptr_t)x & 15u) || ((uintptr_t)out & 15u))
    return (int)cudaErrorInvalidValue;
  ETK_DISPATCH(dtype, {
    if (round_each)
      return etk::relpos_bias_add<T, true>(x, q, y_rel, x_rel, out, bh, a0, a1, p0, p1, c, s);
    return etk::relpos_bias_add<T, false>(x, q, y_rel, x_rel, out, bh, a0, a1, p0, p1, c, s);
  });
}
