// The warp-per-row pass of the row kernels, written for Hopper: the body of
// row 1 (ln_norms_kernel, also a stage of kernel B, of the groups that
// select their own rows and of select_linear_skip_norms), of row 9
// (select_scatter_kernel, gate_block.cu), of rows 10 and 14
// (select_warp_kernel, through gate_block.cu's etk_block_select_p) and of
// the select, LN and difference-norm stages of rows 2-5, 7, 12 and 13
// (launch_select, launch_diff_norms).
//
// At C = 768 a token row is 1.5 KB in bfloat16, which one warp holds in
// registers: 24 values a lane as three 16-byte vectors. So one warp owns one
// row, 8 rows to a 256-thread block; it loads the row once with 16-byte
// loads (8 bfloat16 or 4 float32 values a lane a step, neighbouring lanes on
// neighbouring addresses), keeps it as raw vectors in registers and
// reduces the LayerNorm statistics and the row norm by __shfl_xor_sync:
// no shared memory and no __syncthreads. These kernels are bound by the
// latency of their loads, not by their bytes (a few MB a call), so every
// load of a row is issued before the first reduction waits on it. The
// statistics keep the two-pass float32 form of jnp.mean and
// jnp.mean(square(x - mean)), and the rounding points of the block-per-row
// body (common.cuh) stay where they are. A select reads its row's coverage
// first: the warp of an unselected row loads nothing else and exits, so a
// call moves x and p' at the selected rows only.
//
// The count of vectors a lane holds, K, is a template constant picked from
// kRowVecSteps by the widest row the call holds (3 at C = 768 in bfloat16,
// 6 in float32, 9 and 18 at 2304); a lane's vectors past the row's end are
// masked. The rule, ops/row_pass.py::row_body, sends a call here where every
// row width is a whole number of 16-byte vectors, within 32 x kMaxRowVecs of
// them, and every row operand starts on a 16-byte boundary; other calls take
// the block-per-row body ("block"), and the wrappers count both. The C
// entries refuse a warp call that breaks the rule (warp_row_takes).
#pragma once

#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace etk {

constexpr int kWarpRows = kRowThreads / 32;  // token rows a block: one a warp
constexpr int kMaxRowVecs = 18;              // 16-byte vectors a lane holds at most
// the row pass's two bodies, as ops/row_pass.py ROW_BODY_CODES names them
constexpr int kRowBlock = 0, kRowWarp = 1;

template <typename T> __host__ __device__ constexpr int vec_elems() {
  return 16 / (int)sizeof(T);
}

// The eight float32 values of eight bfloat16 (or the four of four float32)
// in a 16-byte vector; the element at the lower address first.
template <typename T> __device__ __forceinline__ void unpack(const uint4& v, float* f);
template <> __device__ __forceinline__ void unpack<float>(const uint4& v, float* f) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The vector of the values f rounded to T.
template <typename T> __device__ __forceinline__ uint4 pack(const float* f);
template <> __device__ __forceinline__ uint4 pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
template <> __device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i]));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1]));
    w[i] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Lane ``lane``'s vectors of a row of ``nv`` vectors: vector lane + 32 j in
// v[j], zero past the row's end.
template <int K>
__device__ __forceinline__ void load_vecs(const void* row, int nv, int lane, uint4 (&v)[K]) {
  const uint4* src = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int i = lane + 32 * j;
    v[j] = i < nv ? __ldg(src + i) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Two-pass float32 mean and 1/sqrt(var + eps) of a warp's row of ``width``
// values (nv vectors), reduced over the warp.
template <typename T, int K>
__device__ __forceinline__ void warp_ln_stats(const uint4 (&v)[K], int nv, int lane, int width,
                                              float& mean, float& rstd) {
  constexpr int E = vec_elems<T>();
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (lane + 32 * j < nv) {
      float f[E];
      unpack<T>(v[j], f);
#pragma unroll
      for (int e = 0; e < E; ++e) s += f[e];
    }
  }
  mean = warp_sum(s) / (float)width;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (lane + 32 * j < nv) {
      float f[E];
      unpack<T>(v[j], f);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = f[e] - mean;
        q += d * d;
      }
    }
  }
  rstd = rsqrtf(warp_sum(q) / (float)width + kLnEps);
}

// p' = ln(x) * scale + bias (x itself where ``scale`` is null) of a warp's
// row held in ``xv`` (nv vectors of ``width`` values), stored into ``prow``
// with 16-byte stores, rounded to T once. The select of rows 9, 10 and 14
// and of the select and LN stages. Where a lane holds few vectors, scale's
// and bias's are loaded before the statistics, so that their latency
// overlaps the reductions.
template <typename T, int K>
__device__ __forceinline__ void warp_store_select(const uint4 (&xv)[K], T* prow, int nv, int lane,
                                                  int width, const T* scale, const T* bias) {
  constexpr int E = vec_elems<T>();
  uint4* out = reinterpret_cast<uint4*>(prow);
  if (scale == nullptr) {
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (lane + 32 * j < nv) out[lane + 32 * j] = xv[j];
    return;
  }
  const uint4* sv = reinterpret_cast<const uint4*>(scale);
  const uint4* bv = reinterpret_cast<const uint4*>(bias);
  constexpr bool kEarly = K <= 6;  // 2K more vectors in registers
  uint4 s_early[kEarly ? K : 1], b_early[kEarly ? K : 1];
  if constexpr (kEarly) {
    load_vecs<K>(scale, nv, lane, s_early);
    load_vecs<K>(bias, nv, lane, b_early);
  }
  float mean, rstd;
  warp_ln_stats<T, K>(xv, nv, lane, width, mean, rstd);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int i = lane + 32 * j;
    if (i < nv) {
      float v[E], sf[E], bf[E];
      unpack<T>(xv[j], v);
      if constexpr (kEarly) {
        unpack<T>(s_early[j], sf);
        unpack<T>(b_early[j], bf);
      } else {
        unpack<T>(__ldg(sv + i), sf);
        unpack<T>(__ldg(bv + i), bf);
      }
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = (v[e] - mean) * rstd * sf[e] + bf[e];
      out[i] = pack<T>(v);
    }
  }
}

// ||ln(row) * scale + bias - p||_2 of a warp's row held in ``v``, p's row in
// ``pv``; every lane gets it.
template <typename T, int K>
__device__ __forceinline__ float warp_ln_error_norm(const uint4 (&v)[K], const uint4 (&pv)[K],
                                                    int nv, int lane, int width, const T* scale,
                                                    const T* bias) {
  constexpr int E = vec_elems<T>();
  float mean, rstd;
  warp_ln_stats<T, K>(v, nv, lane, width, mean, rstd);
  const uint4* sv = reinterpret_cast<const uint4*>(scale);
  const uint4* bv = reinterpret_cast<const uint4*>(bias);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int i = lane + 32 * j;
    if (i < nv) {
      float f[E], pf[E], sf[E], bf[E];
      unpack<T>(v[j], f);
      unpack<T>(pv[j], pf);
      unpack<T>(__ldg(sv + i), sf);
      unpack<T>(__ldg(bv + i), bf);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = (f[e] - mean) * rstd * sf[e] + bf[e] - pf[e];
        acc += d * d;
      }
    }
  }
  return sqrtf(warp_sum(acc));
}

// out[r] = ||ln(x[r]) * scale + bias - p[r]||_2, one warp a row.
template <typename T, int K>
__global__ void __launch_bounds__(kRowThreads)
ln_norms_kernel(const T* __restrict__ x, const T* __restrict__ p, const T* __restrict__ scale,
                const T* __restrict__ bias, float* __restrict__ out, int64_t rows, int c) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (r >= rows) return;  // uniform over the warp
  const int nv = c / vec_elems<T>();
  uint4 xv[K], pv[K];
  load_vecs<K>(x + r * c, nv, lane, xv);
  load_vecs<K>(p + r * c, nv, lane, pv);
  const float norm = warp_ln_error_norm<T, K>(xv, pv, nv, lane, c, scale, bias);
  if (lane == 0) out[r] = norm;
}

// p[r] = ln(x[r]) * scale + bias (x[r] where scale is null) where cov[r] >
// 0, in place, one warp a row; every row where cov is null (the LN pass
// of rows 5 and 12 "pre" into a scratch). An unselected row's warp reads
// its cov entry alone.
template <typename T, int K>
__global__ void __launch_bounds__(kRowThreads)
select_warp_kernel(const T* __restrict__ x, T* __restrict__ p, const float* __restrict__ cov,
                   const T* __restrict__ scale, const T* __restrict__ bias, int64_t rows, int c) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (r >= rows) return;  // uniform over the warp, as the cov test below
  if (cov != nullptr && !(__ldg(cov + r) > 0.f)) return;
  const int nv = c / vec_elems<T>();
  uint4 xv[K];
  load_vecs<K>(x + r * c, nv, lane, xv);
  warp_store_select<T, K>(xv, p + r * c, nv, lane, c, scale, bias);
}

// out[r] = ||a[r] - p[r]||_2, one warp a row.
template <typename T, int K>
__global__ void __launch_bounds__(kRowThreads)
diff_norms_warp_kernel(const T* __restrict__ a, const T* __restrict__ p, float* __restrict__ out,
                       int64_t rows, int c) {
  constexpr int E = vec_elems<T>();
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int nv = c / E;
  uint4 av[K], pv[K];
  load_vecs<K>(a + r * c, nv, lane, av);
  load_vecs<K>(p + r * c, nv, lane, pv);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (lane + 32 * j < nv) {
      float fa[E], fp[E];
      unpack<T>(av[j], fa);
      unpack<T>(pv[j], fp);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float d = fa[e] - fp[e];
        acc += d * d;
      }
    }
  }
  const float norm = sqrtf(warp_sum(acc));
  if (lane == 0) out[r] = norm;
}

// Whether the warp body takes rows of ``width`` values of T.
template <typename T> inline bool warp_row_width(int width) {
  return width > 0 && width % vec_elems<T>() == 0 &&
         width / vec_elems<T>() <= 32 * kMaxRowVecs;
}

// Whether every operand given (null skipped) starts on a 16-byte boundary.
inline bool all_aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// Whether a call may take ``body``: the block body takes any; the warp body
// rows of the widths given and operands on 16-byte boundaries.
template <typename T>
inline bool warp_row_takes(int body, std::initializer_list<int> widths,
                           std::initializer_list<const void*> ptrs) {
  if (body == kRowBlock) return true;
  if (body != kRowWarp) return false;
  for (int w : widths)
    if (!warp_row_width<T>(w)) return false;
  return all_aligned16(ptrs);
}

// fn(std::integral_constant<int, K>) with K the smallest of kRowVecSteps
// (1, 2, 3, 6, 9, 18) that holds a row of ``width`` values of T.
template <typename T, typename Fn>
int with_row_vecs(int width, Fn&& fn) {
  const int need = (width / vec_elems<T>() + 31) / 32;
  if (need <= 1) return fn(std::integral_constant<int, 1>{});
  if (need <= 2) return fn(std::integral_constant<int, 2>{});
  if (need <= 3) return fn(std::integral_constant<int, 3>{});
  if (need <= 6) return fn(std::integral_constant<int, 6>{});
  if (need <= 9) return fn(std::integral_constant<int, 9>{});
  if (need <= kMaxRowVecs) return fn(std::integral_constant<int, kMaxRowVecs>{});
  return (int)cudaErrorInvalidValue;
}

inline unsigned warp_row_blocks(int64_t rows) {
  return (unsigned)((rows + kWarpRows - 1) / kWarpRows);
}

// Row 1 and the stages of rows 3, 4, 7 and 13 that take the next gate's
// norms: ln_norms over ``rows`` rows of width c in the body ``body``.
template <typename T>
int launch_ln_norms(int body, const T* x, const T* p, const T* scale, const T* bias, float* out,
                    int64_t rows, int c, cudaStream_t stream) {
  if (!warp_row_takes<T>(body, {c}, {x, p, scale, bias})) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  if (body == kRowBlock) {
    ln_norms_block_kernel<T><<<(unsigned)rows, kRowThreads, row_smem_bytes(c), stream>>>(
        x, p, scale, bias, out, c);
    ETK_CHECK_LAUNCH();
    return 0;
  }
  return with_row_vecs<T>(c, [&](auto k) {
    ln_norms_kernel<T, decltype(k)::value><<<warp_row_blocks(rows), kRowThreads, 0, stream>>>(
        x, p, scale, bias, out, rows, c);
    ETK_CHECK_LAUNCH();
    return 0;
  });
}

// Rows 10 and 14 and the select and LN stages of rows 2-5, 7 and 12:
// p' = where(cov, ln(x) | x, p) over ``rows`` rows of width c in the body
// ``body`` (scale null: x itself; cov null: every row, LN only).
template <typename T>
int launch_select(int body, const T* x, T* p, const float* cov, const T* scale, const T* bias,
                  int64_t rows, int c, cudaStream_t stream) {
  if (!warp_row_takes<T>(body, {c}, {x, p, scale, bias}) || (cov == nullptr && scale == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  if (body == kRowBlock) {
    if (scale != nullptr) {
      ln_select_kernel<T><<<(unsigned)rows, kRowThreads, row_smem_bytes(c), stream>>>(
          x, p, cov, scale, bias, c);
    } else {
      select_rows_kernel<T><<<(unsigned)rows, kRowThreads, 0, stream>>>(x, p, cov, c);
    }
    ETK_CHECK_LAUNCH();
    return 0;
  }
  return with_row_vecs<T>(c, [&](auto k) {
    select_warp_kernel<T, decltype(k)::value><<<warp_row_blocks(rows), kRowThreads, 0, stream>>>(
        x, p, cov, scale, bias, rows, c);
    ETK_CHECK_LAUNCH();
    return 0;
  });
}

// The difference-norm stages of rows 2, 4, 7 and 13: out[r] = ||a[r] -
// p[r]||_2 over ``rows`` rows of width c in the body ``body``.
template <typename T>
int launch_diff_norms(int body, const T* a, const T* p, float* out, int64_t rows, int c,
                      cudaStream_t stream) {
  if (!warp_row_takes<T>(body, {c}, {a, p})) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  if (body == kRowBlock) {
    diff_norms_kernel<T><<<(unsigned)rows, kRowThreads, 32 * sizeof(float), stream>>>(a, p, out,
                                                                                      c);
    ETK_CHECK_LAUNCH();
    return 0;
  }
  return with_row_vecs<T>(c, [&](auto k) {
    diff_norms_warp_kernel<T, decltype(k)::value><<<warp_row_blocks(rows), kRowThreads, 0,
                                                    stream>>>(a, p, out, rows, c);
    ETK_CHECK_LAUNCH();
    return 0;
  });
}

}  // namespace etk
