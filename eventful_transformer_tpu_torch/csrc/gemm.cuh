// Tiled shared-memory GEMM with a per-element epilogue: the matrix product
// of rows 2 and 3 (kernels A and B), 4 (kernel C's MLP), 5 (the dense MLP),
// 7 (gate_group_linear), 12 and 13 (gate_fused.cu) in float32 and wherever
// ops/gemm_core.py::gemm_core does not send them to the wgmma core of
// gemm_tc.cuh (which keeps this file's contract and epilogues).
//
//   out(m, n) = epi(m, n, sum_k A[arow(m), k] * W[k, n])   (float32 sum)
//
// A is a row-major (rows, K) T matrix whose row for output row m is given
// by the ARows functor (-1 reads a zero row: the ragged edge, or an empty
// compaction slot); W is the row-major (K, Nout) kernel in the JAX (in, out)
// layout. One 128-thread block computes a 64 x 64 output tile, stepping K
// by 32 through shared memory:
//   * float32: each thread keeps a 4 x 8 register tile (CUDA cores; TF32
//     would drop the float32 parity the tests hold);
//   * bfloat16: each warp runs a 32 x 32 tile on the tensor cores through
//     WMMA 16x16x16 fragments with float32 accumulators.
// This is the simple first version: no TMA, wgmma or pipelining, so it is
// bound by shared-memory traffic and latency, far below the card's
// tensor-core peak; in bfloat16 it runs only the shapes gemm_tc.cuh
// refuses (K off 64, N off 128, an operand off a 16-byte boundary).
#pragma once

#include <mma.h>
#include <type_traits>

#include "common.cuh"

namespace etk {

constexpr int kBM = 64, kBN = 64, kBK = 32, kGemmThreads = 128;

// Output row m reads input row m (dense operand).
struct DenseRows {
  __device__ __forceinline__ int64_t operator()(int m) const { return m; }
};

template <typename T, typename ARows, typename Epi>
__global__ void __launch_bounds__(kGemmThreads)
gemm_kernel(const T* __restrict__ A, ARows arows, const T* __restrict__ W, int M, int K,
            int Nout, Epi epi) {
  __shared__ int64_t a_row[kBM];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  if (tid < kBM) a_row[tid] = (m0 + tid < M) ? arows(m0 + tid) : -1;
  __syncthreads();
  // tile loaders: A tile 64 x 32 (thread: row tid/2, 16 columns), W tile
  // 32 x 64 (thread: row tid/4, 16 columns); zero outside the matrices
  const int la_r = tid >> 1, la_c = (tid & 1) * 16;
  const int lb_r = tid >> 2, lb_c = (tid & 3) * 16;
  const T zero = from_f<T>(0.f);

  if constexpr (std::is_same<T, float>::value) {
    __shared__ float As[kBM][kBK + 1];
    __shared__ float Bs[kBK][kBN];
    const int ty = tid >> 3, tx = tid & 7;  // rows ty + 16i, cols tx + 8j
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kBK) {
      const int64_t ar = a_row[la_r];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int k = k0 + la_c + i;
        As[la_r][la_c + i] = (ar >= 0 && k < K) ? A[ar * K + k] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int k = k0 + lb_r, n = n0 + lb_c + i;
        Bs[lb_r][lb_c + i] = (k < K && n < Nout) ? W[(int64_t)k * Nout + n] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][k];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = Bs[k][tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int m = m0 + ty + 16 * i, n = n0 + tx + 8 * j;
        if (m < M && n < Nout) epi(m, n, acc[i][j]);
      }
  } else {
    using namespace nvcuda;
    constexpr int kLdA = kBK + 8, kLdB = kBN + 8, kLdC = kBN + 4;
    __shared__ __align__(128) T As[kBM * kLdA];
    __shared__ __align__(128) T Bs[kBK * kLdB];
    __shared__ __align__(128) float Cs[kBM * kLdC];
    const int warp = tid >> 5;
    const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    for (int k0 = 0; k0 < K; k0 += kBK) {
      const int64_t ar = a_row[la_r];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int k = k0 + la_c + i;
        As[la_r * kLdA + la_c + i] = (ar >= 0 && k < K) ? A[ar * K + k] : zero;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int k = k0 + lb_r, n = n0 + lb_c + i;
        Bs[lb_r * kLdB + lb_c + i] = (k < K && n < Nout) ? W[(int64_t)k * Nout + n] : zero;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> af[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> bf[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], As + (wr + 16 * i) * kLdA + kk, kLdA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(bf[j], Bs + kk * kLdB + wc + 16 * j, kLdB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wr + 16 * i) * kLdC + wc + 16 * j, acc[i][j], kLdC,
                                wmma::mem_row_major);
    __syncthreads();
    for (int e = tid; e < kBM * kBN; e += kGemmThreads) {
      const int r = e / kBN, cc = e % kBN;
      const int m = m0 + r, n = n0 + cc;
      if (m < M && n < Nout) epi(m, n, Cs[r * kLdC + cc]);
    }
  }
}

template <typename T, typename ARows, typename Epi>
inline void launch_gemm(const T* A, ARows arows, const T* W, int M, int K, int Nout, Epi epi,
                        cudaStream_t stream) {
  const dim3 grid((Nout + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<T, ARows, Epi><<<grid, kGemmThreads, 0, stream>>>(A, arows, W, M, K, Nout, epi);
}

// The epilogues of the MLPs' GEMMs. Each reads its operands in load() and
// writes in store(), so that gemm_tc.cuh can issue the loads of several
// elements before their stores (a store may alias a later load, so the
// compiler keeps them in order otherwise); operator() is the two in turn.

// out[m, f] = rnd(gelu(acc + bias[f])): the hidden layer of the MLP
// (gate_group.py:380-387, dense_mlp.py:32-37)
template <typename T>
struct BiasGeluEpilogue {
  const T* bias;
  T* out;
  int ld;
  using Loaded = float;
  __device__ __forceinline__ float load(int, int n) const { return to_f(bias[n]); }
  __device__ __forceinline__ void store(int m, int n, float acc, float b) const {
    out[(int64_t)m * ld + n] = from_f<T>(gelu_exact(acc + b));
  }
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    store(m, n, acc, load(m, n));
  }
};

// out[m, n] = rnd(acc + bias[n]): the MLP's second layer (gate_group.py:
// 388-393) and the dense recompute of ln_select_matmul (gate_fused.py:
// 86-92)
template <typename T>
struct BiasEpilogue {
  const T* bias;
  T* out;
  int ld;
  using Loaded = float;
  __device__ __forceinline__ float load(int, int n) const { return to_f(bias[n]); }
  __device__ __forceinline__ void store(int m, int n, float acc, float b) const {
    out[(int64_t)m * ld + n] = from_f<T>(acc + b);
  }
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    store(m, n, acc, load(m, n));
  }
};

// The gated linear's h written straight into the token buffer
// (gate_group.py:210-225: h = rnd(acc + bias), scattered to its row):
// out[idx[m], f] = rnd(acc + bias[f]) for compaction slot m, idx[m] the
// token row (of B x N) the slot holds; an empty slot (-1) writes nothing.
// The rounding is BiasEpilogue's, so b' is the one-hot scatter's bit for
// bit. load() reads the bias and the slot's row, so that a thread's loads
// go out before its stores.
template <typename T>
struct BiasScatterEpilogue {
  const T* bias;
  const int* idx;
  T* out;
  int ld;
  struct Loaded {
    float bias;
    int row;  // -1: an empty slot
  };
  __device__ __forceinline__ Loaded load(int m, int f) const { return {to_f(bias[f]), idx[m]}; }
  __device__ __forceinline__ void store(int, int f, float acc, Loaded l) const {
    if (l.row >= 0) out[(int64_t)l.row * ld + f] = from_f<T>(acc + l.bias);
  }
  __device__ __forceinline__ void operator()(int m, int f, float acc) const {
    store(m, f, acc, load(m, f));
  }
};

}  // namespace etk
