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
// Two more kernels take this body through the template parameter ``Form``,
// which keeps their own rounding points (kAttnRounded above is rows 2 and
// 6's):
//   * kAttnGrid, window_attention_grid (window_attention.py:78-96,
//     _attend): q taken to float32 and scaled there, no rounding; the
//     rel-pos terms computed in the kernel from the UNSCALED float32 q
//     against the tables (y (a0, p0, d), x (a1, p1, d), in the working
//     dtype), term_y[py] = q . y[i / a1, py] and term_x[px] = q . x[i % a1,
//     px] for query i, added to the logit one after the other; the
//     probabilities rounded to the working dtype. Its windows are read in
//     place from the (B, Hp, Wp, 3C) map through GridRows;
//   * kAttnF32Probs and kAttnBf16Probs, fused_attention (attention.py:33-
//     58): q scaled in float32, the probabilities kept in float32, or with
//     the matmul-2 cast rounded to bfloat16 together with v.
//
// Two bodies run these kernels, and launch_attention picks one by the
// ``body`` its caller passes (ops/window_attention.py::attention_body states
// the rule and the wrappers count launches by body):
//   * the tensor-core body (attention_tc.cuh): bfloat16 in every form,
//     packed rows or GridRows, head width a multiple of 16 up to 128, n <=
//     512, 16-byte aligned operands;
//   * the CUDA-core body below: every float32 call, and what the
//     tensor-core body does not take. One block per (batch, head,
//     32-query tile); K (n x (d+1), padded against bank conflicts) and V
//     (n x d) of the head sit in shared memory in float32, and each warp
//     keeps its query's n probabilities, the scaled query and its p0 + p1
//     terms. The logits and A.V run on the CUDA cores in float32, bound by
//     shared-memory reads (about 5 TFLOP/s at N = 197).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace etk {

constexpr int kAttnThreads = 256;  // 8 warps, one query at a time each
constexpr int kAttnQueries = 32;   // queries per block
constexpr int kMaxHeadDim = 256;   // kAttnGrid holds a query's d values in registers

// Rounding points of the kernels that share the body (see above).
enum AttnForm : int { kAttnRounded = 0, kAttnGrid = 1, kAttnF32Probs = 2, kAttnBf16Probs = 3 };

// Where token ``tok`` of window ``win`` lies, as a row of the qkv (3C
// wide) and output (C wide) arrays: packed windows of n rows each ...
struct PackedRows {
  __device__ __forceinline__ int64_t operator()(int win, int tok, int n) const {
    return (int64_t)win * n + tok;
  }
};

// ... or the (B, nh * a0, nw * a1) token map that window_attention_grid
// reads: window win is (batch win / (nh nw), grid row, grid column) in
// row-major order, and its token tok sits at map row ((wy a0 + tok / a1) Wp
// + wx a1 + tok % a1) of its batch row.
struct GridRows {
  int nh = 1, nw = 1, a0 = 1, a1 = 1;
  __device__ __forceinline__ int64_t operator()(int win, int tok, int) const {
    const int bi = win / (nh * nw), r = win % (nh * nw);
    const int y = r / nw * a0 + tok / a1, x = r % nw * a1 + tok % a1;
    return ((int64_t)bi * nh * a0 + y) * ((int64_t)nw * a1) + x;
  }
};

// The rel-pos tables of kAttnGrid, in the working dtype; ``y`` null: none.
template <typename T>
struct RelTables {
  const T* y = nullptr;  // (a0, p0, d)
  const T* x = nullptr;  // (a1, p1, d)
  int a1 = 1;
};

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

template <typename T, int Form, typename Rows>
__global__ void __launch_bounds__(kAttnThreads)
attention_kernel(const T* __restrict__ qkv, const T* __restrict__ terms, T* __restrict__ out,
                 int n, int c, int heads, float inv_scale, int p0, int p1, PadGeom<T> geom,
                 Rows rows, RelTables<T> tab) {
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
  for (int e = threadIdx.x; e < n * d; e += blockDim.x) {
    const int j = e / d, t = e % d;
    const T* row = geom.valid(b, j) ? qkv + rows(b, j, n) * 3 * c : geom.bias;
    ks[j * (d + 1) + t] = to_f(row[c + h * d + t]);
    const float v = to_f(row[2 * c + h * d + t]);
    vs[j * d + t] = Form == kAttnBf16Probs ? rnd<__nv_bfloat16>(v) : v;
  }
  __syncthreads();
  const float scale = Form == kAttnRounded ? rnd<T>(inv_scale) : inv_scale;
  const int q_end = min(n, (int)(blockIdx.y + 1) * kAttnQueries);
  for (int qi = blockIdx.y * kAttnQueries + warp; qi < q_end; qi += kAttnThreads / 32) {
    const bool inside = geom.valid(b, qi);
    const T* qrow = inside ? qkv + rows(b, qi, n) * 3 * c : geom.bias;
    if constexpr (Form == kAttnGrid) {
      // the terms of the unscaled q: one warp-wide dot product a term,
      // each lane reading its own elements of q and of the table row
      float qv[kMaxHeadDim / 32];
#pragma unroll
      for (int i = 0; i < kMaxHeadDim / 32; ++i) {
        const int t = lane + 32 * i;
        qv[i] = t < d ? to_f(qrow[h * d + t]) : 0.f;
      }
      for (int u = 0; u < nt; ++u) {
        const T* tr = u < p0 ? tab.y + ((int64_t)(qi / tab.a1) * p0 + u) * d
                             : tab.x + ((int64_t)(qi % tab.a1) * p1 + u - p0) * d;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxHeadDim / 32; ++i) {
          const int t = lane + 32 * i;
          if (t < d) s = fmaf(qv[i], to_f(tr[t]), s);
        }
        s = warp_sum(s);
        if (lane == (u & 31)) ts[u] = s;
      }
#pragma unroll
      for (int i = 0; i < kMaxHeadDim / 32; ++i) {
        const int t = lane + 32 * i;
        if (t < d) qs[t] = qv[i] * scale;
      }
    } else {
      for (int t = lane; t < d; t += 32) {
        const float q = to_f(qrow[h * d + t]) * scale;
        qs[t] = Form == kAttnRounded ? rnd<T>(q) : q;
      }
      if (nt > 0) {
        const T* tr = inside || geom.terms == nullptr
                          ? terms + (((int64_t)b * heads + h) * n + qi) * nt
                          : geom.terms + ((int64_t)h * n + qi) * nt;
        for (int t = lane; t < nt; t += 32) ts[t] = to_f(tr[t]);
      }
    }
    __syncwarp();
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float* kr = ks + j * (d + 1);
      float s = 0.f;
      for (int t = 0; t < d; ++t) s = fmaf(qs[t], kr[t], s);
      if (nt > 0) {
        if constexpr (Form == kAttnGrid) {
          s = (s + ts[j / p1]) + ts[p0 + j % p1];
        } else {
          s += ts[j / p1] + ts[p0 + j % p1];
        }
      }
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
    for (int j = lane; j < n; j += 32) {
      const float p = pw[j] / sum;
      if constexpr (Form == kAttnF32Probs) {
        pw[j] = p;
      } else if constexpr (Form == kAttnBf16Probs) {
        pw[j] = rnd<__nv_bfloat16>(p);
      } else {
        pw[j] = rnd<T>(p);
      }
    }
    __syncwarp();
    T* orow = out + rows(b, qi, n) * c + h * d;
    for (int t = lane; t < d; t += 32) {
      float o = 0.f;
      for (int j = 0; j < n; ++j) o = fmaf(pw[j], vs[j * d + t], o);
      orow[t] = from_f<T>(o);
    }
    __syncwarp();
  }
}

// The two bodies, as the wrappers name them ("simt", "tc").
enum AttnBody : int { kBodySimt = 0, kBodyTc = 1 };

}  // namespace etk

#include "attention_tc.cuh"

namespace etk {

// a1 > 0: kAttnGrid with tables over a (n_terms - p1) x p1 key grid, whose
// staged rows the tensor-core body adds
inline size_t attention_smem_bytes(int body, int n, int d, int n_terms, int a1 = 0, int p1 = 0) {
  if (body == kBodyTc) {
    return attention_tc_smem_bytes(n, d, n_terms, grid_table_rows(n, a1, n_terms - p1, p1));
  }
  return ((size_t)n * (2 * d + 1) + (size_t)(kAttnThreads / 32) * (n + d + n_terms)) *
         sizeof(float);
}

// qkv (bsz, n, 3c) -> out (bsz, n, c), with rel-pos terms (bsz, heads, n,
// p0 + p1) when ``terms`` is not null (then n == p0 * p1) and pad rows
// substituted where ``geom`` has a bias row; kAttnGrid computes its terms
// from ``tab`` instead, and takes its bsz windows through ``rows``. ``body``
// kBodyTc runs the tensor-core body, which takes bfloat16 in every form
// (cudaErrorInvalidValue otherwise); kBodySimt the CUDA-core body. Returns
// the CUDA error, if any.
template <typename T, int Form = kAttnRounded, typename Rows = PackedRows>
int launch_attention(int body, const T* qkv, const T* terms, T* out, int bsz, int n, int c,
                     int heads, float inv_scale, int p0, int p1, cudaStream_t stream,
                     PadGeom<T> geom = PadGeom<T>{}, Rows rows = Rows{},
                     RelTables<T> tab = RelTables<T>{}) {
  if (terms == nullptr && tab.y == nullptr) p0 = p1 = 0;
  if (body == kBodyTc) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      return launch_attention_tc<Form>(qkv, terms, out, bsz, n, c, heads, inv_scale, p0, p1,
                                       stream, geom, rows, tab);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (body != kBodySimt) return (int)cudaErrorInvalidValue;
  const size_t smem = attention_smem_bytes(kBodySimt, n, c / heads, p0 + p1);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T, Form, Rows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bsz * heads, (n + kAttnQueries - 1) / kAttnQueries);
  attention_kernel<T, Form, Rows><<<grid, kAttnThreads, smem, stream>>>(
      qkv, terms, out, n, c, heads, inv_scale, p0, p1, geom, rows, tab);
  return (int)cudaGetLastError();
}

}  // namespace etk
