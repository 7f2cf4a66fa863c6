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
//     S), so that the float32 card-vs-CPU checks keep their meaning.
//
// The CUDA-core body, as it was first written: one block of 16 warps per
// (batch x head, 32 query rows); the tile's float32 logits stay resident in
// shared memory (32 x 1044 floats, 134 KB at Np = 1024; 16 rows when 32 do
// not fit, 8 when 16 do not, as at Np = 4096), built chunk by chunk over
// 128 keys of k staged in shared
// memory, float32 products on the CUDA cores. Each warp then takes whole
// rows for the softmax and the select: the old p_a values are loaded eight
// per lane at a time, p' goes back over the row's logits as float32, and a
// last shared-memory pass packs it to S in place (each 32-column chunk is
// read before any lane writes it, so the packing is safe). The block then
// streams p_v through shared memory in 128-key chunks for the A.V product:
// WMMA 16x16x16 with float32 accumulators where S is bfloat16 (the cast)
// and the tile has 16 rows, the CUDA cores otherwise. Np need not be a multiple of anything (441 at
// 672): the chunks are zero-filled past Np and the products cover Np
// rounded up to 16. The logits form loads the tile's logits from device
// memory (tm x Np values of S) in place of step 1 and is otherwise the same
// kernel (template flag kLogits).
#include <mma.h>

#include <type_traits>

#include "av_softmax_tc.cuh"
#include "common.cuh"

namespace etk {

constexpr int kAvThreads = 512;  // 16 warps
constexpr int kAvChunk = 128;    // keys per staged chunk of k or p_v

__host__ __device__ inline int round_up(int a, int m) { return (a + m - 1) / m * m; }
__host__ __device__ inline size_t align128(size_t a) { return (a + 127) / 128 * 128; }

// Byte offsets of a block's shared memory, the same on host and device:
// logits (tm, ldl) floats at 0, the scaled q tile, the k / p_v chunk (also
// the output staging), the terms, the coverage.
struct AvSmem {
  int ldl;
  size_t qs, kv, ts, cs, total;
};

__host__ __device__ inline AvSmem av_smem(int tm, int np, int d, int nt) {
  AvSmem s;
  s.ldl = round_up(np, 16) + 4;
  size_t off = align128((size_t)tm * s.ldl * sizeof(float));
  s.qs = off;
  off += align128((size_t)tm * (d + 8) * sizeof(float));
  s.kv = off;
  off += align128((size_t)kAvChunk * (d + 8) * sizeof(float));
  s.ts = off;
  off += align128((size_t)tm * nt * sizeof(float));
  s.cs = off;
  off += align128((size_t)round_up(np, 16) * sizeof(float));
  s.total = off;
  return s;
}

// dst (kAvChunk, ld) <- rows [0, valid) of the (.., d) matrix src, zero
// beyond: 16-byte vectors for bfloat16 (d and ld multiples of 8, src 16-byte
// aligned), single elements for float32.
template <typename T>
__device__ __forceinline__ void load_chunk(T* dst, int ld, const T* src, int valid, int d) {
  if constexpr (sizeof(T) == 2) {
    const int vec = d / 8;
    for (int e = threadIdx.x; e < kAvChunk * vec; e += blockDim.x) {
      const int r = e / vec, c = (e % vec) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid) v = *reinterpret_cast<const uint4*>(src + (int64_t)r * d + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
    }
  } else {
    for (int e = threadIdx.x; e < kAvChunk * d; e += blockDim.x) {
      const int r = e / d, t = e % d;
      dst[r * ld + t] = r < valid ? src[(int64_t)r * d + t] : from_f<T>(0.f);
    }
  }
}

template <typename W, typename S, bool kLogits>
__global__ void __launch_bounds__(kAvThreads)
softmax_select_matmul_kernel(S* __restrict__ p_a, const float* __restrict__ cov,
                             const S* __restrict__ p_v, const W* __restrict__ q,
                             const W* __restrict__ k, const S* __restrict__ logits,
                             const W* __restrict__ terms, S* __restrict__ out, int heads, int n,
                             int np, int d, int p0, int p1, float inv_scale, int tm) {
  using namespace nvcuda;
  constexpr bool kTensorAV = std::is_same<S, __nv_bfloat16>::value;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int nt = terms != nullptr ? p0 + p1 : 0;
  const AvSmem lay = av_smem(tm, np, d, nt);
  const int ldl = lay.ldl, np16 = round_up(np, 16);
  const int ldq = d + 8, ldk = d + 1, ldv = d + 8;
  float* lg = (float*)smem_raw;
  W* qs = (W*)(smem_raw + lay.qs);
  float* ts = (float*)(smem_raw + lay.ts);
  float* cs = (float*)(smem_raw + lay.cs);
  const int bh = blockIdx.x, batch = bh / heads;
  const int row0 = blockIdx.y * tm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int kWarps = kAvThreads / 32;
  const int64_t head_row = (int64_t)bh * n;  // row 0 of this head in q, p_a, out

  if constexpr (!kLogits) {
    const float scale = rnd<W>(inv_scale);
    for (int e = tid; e < tm * d; e += kAvThreads) {
      const int i = e / d, t = e % d, row = row0 + i;
      const float v = row < n ? rnd<W>(to_f(q[(head_row + row) * d + t]) * scale) : 0.f;
      qs[i * ldq + t] = from_f<W>(v);
    }
  }
  for (int e = tid; e < tm * nt; e += kAvThreads) {
    const int row = row0 + e / nt;
    ts[e] = row < n ? to_f(terms[(head_row + row) * nt + e % nt]) : 0.f;
  }
  for (int j = tid; j < np16; j += kAvThreads)
    cs[j] = j < np ? cov[(int64_t)batch * np + j] : 0.f;

  // 1. logits of the tile: loaded (the logits form), or computed 128 keys
  // at a time
  if constexpr (kLogits) {
    const S* lh = logits + (head_row + row0) * np;
    const int rows = min(tm, n - row0);
    for (int e = tid; e < rows * np; e += kAvThreads) lg[(e / np) * ldl + e % np] = to_f(lh[e]);
  }
  W* ks = (W*)(smem_raw + lay.kv);
  const W* kh = kLogits ? nullptr : k + (int64_t)bh * np * d;
  for (int j0 = 0; j0 < (kLogits ? 0 : np); j0 += kAvChunk) {
    __syncthreads();  // the previous chunk is consumed
    load_chunk(ks, ldk, kh + (int64_t)j0 * d, np - j0, d);
    __syncthreads();
    for (int e = tid; e < tm * kAvChunk; e += kAvThreads) {
      const int i = e / kAvChunk, jj = e % kAvChunk;
      if (j0 + jj >= np) continue;
      const W* qr = qs + i * ldq;
      const W* kr = ks + jj * ldk;
      float s = 0.f;
      for (int t = 0; t < d; ++t) s = fmaf(to_f(qr[t]), to_f(kr[t]), s);
      lg[i * ldl + j0 + jj] = s;
    }
  }
  __syncthreads();

  // 2. per row: bias, softmax, select; p' overwrites the row's logits in S
  S* packed = (S*)lg;
  const int ldp = ldl * (int)(sizeof(float) / sizeof(S));
  for (int i = warp; i < tm; i += kWarps) {
    const int row = row0 + i;
    float* lr = lg + i * ldl;
    S* pr = packed + i * ldp;
    if (row >= n) {
      for (int j = lane; j < np16; j += 32) pr[j] = from_f<S>(0.f);
      continue;
    }
    const float* tr = ts + i * nt;
    float mx = -INFINITY;
    for (int j = lane; j < np; j += 32) {
      float v = lr[j];
      if (nt > 0) v += tr[j / p1] + tr[p0 + j % p1];
      lr[j] = v;
      mx = fmaxf(mx, v);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < np; j += 32) {
      const float e = expf(lr[j] - mx);
      lr[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    S* pa = p_a + (head_row + row) * np;
    constexpr int kAhead = 8;  // old p_a values in flight per lane
    for (int j0 = lane; j0 < np; j0 += 32 * kAhead) {
      S old[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int j = j0 + 32 * u;
        old[u] = j < np ? pa[j] : from_f<S>(0.f);
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int j = j0 + 32 * u;
        if (j < np) {
          float v = to_f(old[u]);
          if (cs[j] > 0.f) {
            const S a = from_f<S>(lr[j] / sum);
            pa[j] = a;
            v = to_f(a);
          }
          lr[j] = v;
        }
      }
    }
    __syncwarp();
    for (int j0 = 0; j0 < np16; j0 += 32) {
      const int j = j0 + lane;
      const float v = j < np ? lr[j] : 0.f;
      __syncwarp();  // the chunk is read before any lane packs into it
      if (j < np16) pr[j] = from_f<S>(v);
      __syncwarp();
    }
  }

  // 3. out = p' . p_v, 64 keys at a time
  S* vs = (S*)(smem_raw + lay.kv);
  float* staged = (float*)(smem_raw + lay.kv);  // (tm, d + 4) after the loop
  const S* vh = p_v + (int64_t)bh * np * d;
  S* oh = out + head_row * d;
  // WMMA needs 16-row tiles: a tile of 8 rows (the widest key grids) takes
  // the CUDA-core product below, the same float32 sums of bfloat16 products
  const bool tensor_av = kTensorAV && tm >= 16;
  if constexpr (kTensorAV) if (tensor_av) {
    const int cols = d / 16, frags = (tm / 16) * cols;  // <= 2 per warp
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    for (int j0 = 0; j0 < np; j0 += kAvChunk) {
      __syncthreads();
      load_chunk(vs, ldv, vh + (int64_t)j0 * d, np - j0, d);
      __syncthreads();
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int fi = warp + u * kWarps;
        if (fi >= frags) continue;
        const int fr = fi / cols, fc = fi % cols;
        for (int kk = 0; kk < kAvChunk && j0 + kk < np16; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, S, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, S, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, packed + 16 * fr * ldp + j0 + kk, ldp);
          wmma::load_matrix_sync(fb, vs + kk * ldv + 16 * fc, ldv);
          wmma::mma_sync(acc[u], fa, fb, acc[u]);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int fi = warp + u * kWarps;
      if (fi >= frags) continue;
      wmma::store_matrix_sync(staged + 16 * (fi / cols) * (d + 4) + 16 * (fi % cols), acc[u],
                              d + 4, wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = tid; e < tm * d; e += kAvThreads) {
      const int i = e / d, t = e % d;
      if (row0 + i < n) oh[(int64_t)(row0 + i) * d + t] = from_f<S>(staged[i * (d + 4) + t]);
    }
  }
  if (!tensor_av) {
    constexpr int kMaxPer = 8;  // outputs per thread: tm * d <= 4096
    const int per = (tm * d + kAvThreads - 1) / kAvThreads;
    float acc[kMaxPer];
#pragma unroll
    for (int m = 0; m < kMaxPer; ++m) acc[m] = 0.f;
    for (int j0 = 0; j0 < np; j0 += kAvChunk) {
      __syncthreads();
      load_chunk(vs, ldv, vh + (int64_t)j0 * d, np - j0, d);
      __syncthreads();
      const int jn = min(kAvChunk, np - j0);
#pragma unroll
      for (int m = 0; m < kMaxPer; ++m) {
        const int e = tid + m * kAvThreads;
        if (m < per && e < tm * d) {
          const int i = e / d, t = e % d;
          const S* prow = packed + i * ldp + j0;
          float a = acc[m];
          for (int jj = 0; jj < jn; ++jj) a = fmaf(to_f(prow[jj]), to_f(vs[jj * ldv + t]), a);
          acc[m] = a;
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kMaxPer; ++m) {
      const int e = tid + m * kAvThreads;
      if (m < per && e < tm * d && row0 + e / d < n)
        oh[(int64_t)(row0 + e / d) * d + e % d] = from_f<S>(acc[m]);
    }
  }
}

template <typename W, typename S, bool kLogits = false>
int softmax_select_matmul(void* p_a, const float* cov, const void* p_v, const void* q,
                          const void* k, const void* logits, const void* terms, void* out,
                          int bsz, int heads, int n, int np, int d, int p0, int p1,
                          float inv_scale, cudaStream_t stream) {
  const int nt = terms != nullptr ? p0 + p1 : 0;
  int tm = 32;
  AvSmem lay = av_smem(tm, np, d, nt);
  // fewer rows a tile where the tile's logits rows do not fit: 16 rows up
  // to about 2900 keys, 8 rows beyond (4096 at ViTDet-1024 without pooling)
  for (const int rows : {16, 8}) {
    if (lay.total <= (size_t)kAvMaxShared) break;
    tm = rows;
    lay = av_smem(tm, np, d, nt);
  }
  if (lay.total > (size_t)kAvMaxShared) return (int)cudaErrorInvalidConfiguration;
  auto kernel = softmax_select_matmul_kernel<W, S, kLogits>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bsz * heads, (n + tm - 1) / tm);
  kernel<<<grid, kAvThreads, lay.total, stream>>>(
      (S*)p_a, cov, (const S*)p_v, (const W*)q, (const W*)k, (const S*)logits, (const W*)terms,
      (S*)out, heads, n, np, d, p0, p1, inv_scale, tm);
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
    return etk::softmax_select_matmul<float, float>(p_a, c, p_v, q, k, nullptr, terms, out, bsz,
                                                    heads, n, np, d, p0, p1, inv_scale, s);
  if (wdtype == 0 && sdtype == 1)
    return etk::softmax_select_matmul<float, __nv_bfloat16>(p_a, c, p_v, q, k, nullptr, terms,
                                                            out, bsz, heads, n, np, d, p0, p1,
                                                            inv_scale, s);
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
    return etk::softmax_select_matmul<float, float, true>(
        p_a, c, p_v, nullptr, nullptr, logits, terms, out, bsz, heads, n, np, d, p0, p1, 1.f, s);
  if (wdtype == 0 && sdtype == 1)
    return etk::softmax_select_matmul<float, __nv_bfloat16, true>(
        p_a, c, p_v, nullptr, nullptr, logits, terms, out, bsz, heads, n, np, d, p0, p1, 1.f, s);
  return (int)cudaErrorInvalidValue;
}
