// Softmax attention over packed qkv rows, shared by kernel A
// (block_fused.cu) and both forms of window_attention (window_attention.cu).
//
//   out[b, i, h] = rnd(sum_j rnd(softmax_j(rnd(q_i * inv_scale) . k_j
//                                          + bias[b, h, i, j])) v_j)
//
// for qkv (B, N, 3C) laid out [q | k | v], each C = H x d wide; B is the
// batch (global mode) or the windows (windowed form). This is the rounding
// of block_fused.py:97-102 and of window_attention.py's _attend_terms: q
// scaled in the working dtype, logits and softmax in float32, probabilities
// rounded to the working dtype before A.V, the output rounded to it.
//
// The windowed form's rel-pos bias comes as per-axis terms (B, H, N,
// p0 + p1) in the working dtype (window_attention.py:244-260); key j of a
// p0 x p1 grid takes bias = term[j / p1] + term[p0 + j % p1], summed in
// float32 and added to the logit, as the TPU kernel's exact 0/1 expander
// matmul adds it (window_attention.py:133-141). Without terms (p0 = 0) no
// bias is added.
//
// The padded form (window_attention.py:155-192) reads windows partitioned
// from a zero-padded token map: a PadGeom gives the qkv-bias row, the pad
// rows' terms (H, N, p0 + p1) and the window grid, and a token whose image
// position (from the window index b and its place in the window) lies
// outside the vh x vw map takes the bias row for its q, k and v and the pad
// terms for its bias, as the TPU kernel substitutes them in VMEM.
//
// One block per (batch, head, 32-query tile); K (n x (d+1), padded against
// bank conflicts) and V (n x d) of the head sit in shared memory in float32,
// and each warp keeps its query's n probabilities, the scaled query and its
// p0 + p1 terms. The logits and A.V run on the CUDA cores in float32: the
// simple first version, bound by shared-memory reads (about 5 TFLOP/s at
// N = 197).
#pragma once

#include "common.cuh"

namespace etk {

constexpr int kAttnThreads = 256;  // 8 warps, one query at a time each
constexpr int kAttnQueries = 32;   // queries per block

// Window geometry of the padded form; ``bias`` null: no pad rows.
template <typename T>
struct PadGeom {
  const T* bias = nullptr;   // (3C,) the qkv-bias row
  const T* terms = nullptr;  // (H, N, p0 + p1) the pad rows' terms, or null
  int nh = 1, nw = 1, vh = 0, vw = 0, a0 = 1, a1 = 1;

  // whether token ``idx`` of window ``win`` lies inside the image
  __device__ __forceinline__ bool valid(int win, int idx) const {
    if (bias == nullptr) return true;
    const int wy = (win % (nh * nw)) / nw, wx = win % nw;
    return idx / a1 + wy * a0 < vh && idx % a1 + wx * a1 < vw;
  }
};

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
attention_kernel(const T* __restrict__ qkv, const T* __restrict__ terms, T* __restrict__ out,
                 int n, int c, int heads, float inv_scale, int p0, int p1, PadGeom<T> geom) {
  extern __shared__ float smem[];
  const int d = c / heads;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ks = smem;                       // n * (d + 1)
  float* vs = ks + (size_t)n * (d + 1);   // n * d
  const int nt = p0 + p1;
  float* pw = vs + (size_t)n * d + (size_t)warp * (n + d + nt);
  float* qs = pw + n;
  float* ts = qs + d;  // this query's terms
  const T* base = qkv + (int64_t)b * n * 3 * c;
  for (int e = threadIdx.x; e < n * d; e += blockDim.x) {
    const int j = e / d, t = e % d;
    const T* row = geom.valid(b, j) ? base + (int64_t)j * 3 * c : geom.bias;
    ks[j * (d + 1) + t] = to_f(row[c + h * d + t]);
    vs[j * d + t] = to_f(row[2 * c + h * d + t]);
  }
  __syncthreads();
  const float scale = rnd<T>(inv_scale);
  const int q_end = min(n, (int)(blockIdx.y + 1) * kAttnQueries);
  for (int qi = blockIdx.y * kAttnQueries + warp; qi < q_end; qi += kAttnThreads / 32) {
    const bool inside = geom.valid(b, qi);
    const T* qrow = inside ? base + (int64_t)qi * 3 * c : geom.bias;
    for (int t = lane; t < d; t += 32) qs[t] = rnd<T>(to_f(qrow[h * d + t]) * scale);
    if (nt > 0) {
      const T* tr = inside || geom.terms == nullptr
                        ? terms + (((int64_t)b * heads + h) * n + qi) * nt
                        : geom.terms + ((int64_t)h * n + qi) * nt;
      for (int t = lane; t < nt; t += 32) ts[t] = to_f(tr[t]);
    }
    __syncwarp();
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float* kr = ks + j * (d + 1);
      float s = 0.f;
      for (int t = 0; t < d; ++t) s = fmaf(qs[t], kr[t], s);
      if (nt > 0) s += ts[j / p1] + ts[p0 + j % p1];
      pw[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(pw[j] - mx);
      pw[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += 32) pw[j] = rnd<T>(pw[j] / sum);
    __syncwarp();
    T* orow = out + ((int64_t)b * n + qi) * c + h * d;
    for (int t = lane; t < d; t += 32) {
      float o = 0.f;
      for (int j = 0; j < n; ++j) o = fmaf(pw[j], vs[j * d + t], o);
      orow[t] = from_f<T>(o);
    }
    __syncwarp();
  }
}

inline size_t attention_smem_bytes(int n, int d, int n_terms) {
  return ((size_t)n * (2 * d + 1) + (size_t)(kAttnThreads / 32) * (n + d + n_terms)) *
         sizeof(float);
}

// qkv (bsz, n, 3c) -> out (bsz, n, c), with rel-pos terms (bsz, heads, n,
// p0 + p1) when ``terms`` is not null (then n == p0 * p1) and pad rows
// substituted where ``geom`` has a bias row; returns the CUDA error, if any.
template <typename T>
int launch_attention(const T* qkv, const T* terms, T* out, int bsz, int n, int c, int heads,
                     float inv_scale, int p0, int p1, cudaStream_t stream,
                     PadGeom<T> geom = PadGeom<T>{}) {
  if (terms == nullptr) p0 = p1 = 0;
  const size_t smem = attention_smem_bytes(n, c / heads, p0 + p1);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bsz * heads, (n + kAttnQueries - 1) / kAttnQueries);
  attention_kernel<T><<<grid, kAttnThreads, smem, stream>>>(qkv, terms, out, n, c, heads,
                                                            inv_scale, p0, p1, geom);
  return (int)cudaGetLastError();
}

}  // namespace etk
