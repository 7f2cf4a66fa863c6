// The GEMM of rows 2 and 3 (kernels A and B), 4 (kernel C's MLP), 5 (the
// dense MLP), 7 (gate_group_linear), 12 and 13 (gate_fused.cu) wherever
// ops/gemm_core.py::gemm_core does not send them to the wgmma core of
// gemm_tc.cuh (which keeps this file's contract and epilogues): every
// float32 call ("simt"), and the bfloat16 calls that core refuses ("wmma").
// Replaces the matrix products inside the Pallas kernels of those rows
// (eventful_transformer_tpu/ops/pallas/block_fused.py, gate_group.py,
// dense_mlp.py, gate_fused.py), which the TPU runs on its matrix unit.
//
//   out(m, n) = epi(m, n, sum_k A[arow(m), k] * W[k, n])   (float32 sum)
//
// A is a row-major (rows, K) matrix whose row for output row m is given by
// the ARows functor (-1 reads a zero row: the ragged edge, or an empty
// compaction slot); W is the row-major (K, N) kernel in the JAX (in, out)
// layout.
//
// float32 ("simt"). The sums stay in float32 on the CUDA cores, no TF32, so
// that the float32 card-vs-CPU checks keep their meaning. The card bounds
// these GEMMs by its 67 TFLOP/s of float32 FMA, which a tile reaches only
// where each shared-memory load feeds several FMAs and the next K step's
// loads are in flight while this one's products run. The 64 x 64 tile it
// replaces (4 x 8 outputs a thread, operands loaded one element at a time,
// one buffer and two __syncthreads a K step of 32) ran at a fifth of that
// rate or less at the paths' shapes. The body:
//   * a block computes a BM x BN output tile, each thread a TM x 8 register
//     tile: rows 4 ty + i and BM / 2 + 4 ty + i (TM = 8) or 4 ty + i (TM =
//     4), columns 4 tx + j and BN / 2 + 4 tx + j, a warp 4 ty x 8 tx. The
//     tiles, by code: 128 x 128 with TM = 8 (256 threads, two blocks an SM)
//     and 64 x 64 with TM = 4 (128 threads, four blocks an SM);
//     ops/gemm_core.py::simt_plan picks one per shape, the one whose
//     busiest SM computes the fewest outputs (the 64 x 64 tile weighed for
//     its fewer FMAs a load), so that shapes whose 128 x 128 tiles do not
//     fill the 132 SMs evenly (the 288- and 512-row gathers, N = 768 at
//     1764 or 3264 rows) run on more, smaller tiles;
//   * K steps of kSimtBK = 32 in a ring of two stages, one __syncthreads a
//     step. W's step comes by 16-byte cp.async, the next step's in flight
//     during this one's products. cp.async cannot transpose, so A is made
//     K-major through registers: a thread loads the next step's A as
//     16-byte vectors (a row's 4 K; a gathered row is contiguous along K, so
//     it loads as a dense one) before this step's products and stores them
//     after, K 4 c + x of row r at column r ^ 4 c, so that a warp's stores
//     and each thread's 16-byte reads of its 4-row groups lie on distinct
//     banks. Per K a thread reads its 8 A and 8 W values as four 16-byte
//     vectors for 64 FMAs (TM = 8). Edges (rows past M or -1, K past its
//     end, columns past N) are zero-filled. Where K or N is not a multiple
//     of 4, or A or W is not on a 16-byte boundary, the same body loads
//     that operand by predicated scalar loads (A) or 4-byte cp.async (W);
//   * each output is one fmaf chain in k order from 0, with no split of K,
//     and the step's zero-filled tail adds fmaf(0, 0, acc): the chain of the
//     tile this body replaced, so its outputs are the same bits;
//   * more than 48 KB of dynamic shared memory for the 128 x 128 tile (64
//     KB), set with cudaFuncSetAttribute; a refusal raises.
// The epilogue functor runs on each output from the thread's registers.
//
// bfloat16 ("wmma"), for the shapes gemm_tc.cuh refuses (K off 64, N off
// 128, an operand off a 16-byte boundary): one 128-thread block computes a
// 64 x 64 tile, each warp a 32 x 32 tile on the tensor cores through WMMA
// 16x16x16 fragments with float32 accumulators, stepping K by 32 through
// shared memory with synchronous loads.
#pragma once

#include <mma.h>
#include <type_traits>

#include "async_copy.cuh"
#include "common.cuh"
#include "warp_mma.cuh"

namespace etk {

constexpr int kBM = 64, kBN = 64, kBK = 32, kGemmThreads = 128;  // the wmma tile
constexpr int kSimtBK = 32, kSimtStages = 2;                     // the float32 tile's K step, ring
// the float32 tiles' codes (ops/gemm_core.py SIMT_TILES)
constexpr int kSimtTileLarge = 0, kSimtTileSmall = 1;

// Output row m reads input row m (dense operand).
struct DenseRows {
  __device__ __forceinline__ int64_t operator()(int m) const { return m; }
};

// The float32 tile: BM x BN outputs, TM x 8 a thread (TM 8: rows 4 ty + i
// and BM / 2 + 4 ty + i; TM 4: rows 4 ty + i; columns 4 tx + j and BN / 2 +
// 4 tx + j), 16 ty x BN / 8 tx threads.
template <int BM, int BN, int TM>
struct SimtTile {
  static constexpr int kThreads = (BM / TM) * (BN / 8);
  static constexpr int kStageFloats = kSimtBK * BM + kSimtBK * BN;  // A's K step, then W's
  static constexpr size_t kSmem = (size_t)kSimtStages * kStageFloats * sizeof(float);
  static constexpr int kMinBlocks = 512 / kThreads;  // blocks an SM: 128 registers a thread at most
  static constexpr int kPieces = BM * kSimtBK / 4 / kThreads;  // A's 16-byte pieces a thread
  static_assert(BM / TM == 16 && BN % 64 == 0 && (TM == 4 || TM == 8), "16 ty x BN / 8 tx");
  static_assert(kSimtStages == 2, "the K steps alternate between two stages (t & 1)");
  static_assert(BM * kSimtBK / 4 % kThreads == 0 && kSimtBK * BN / 4 % kThreads == 0,
                "whole copies");
};

template <int BM, int BN, int TM, typename ARows, typename Epi>
__global__ void __launch_bounds__(SimtTile<BM, BN, TM>::kThreads, SimtTile<BM, BN, TM>::kMinBlocks)
gemm_simt_kernel(const float* __restrict__ A, ARows arows, const float* __restrict__ W, int M,
                 int K, int N, bool vec_a, bool vec_w, Epi epi) {
  using Tile = SimtTile<BM, BN, TM>;
  constexpr int kThreads = Tile::kThreads, kPieces = Tile::kPieces;
  extern __shared__ __align__(16) float simt_smem[];
  __shared__ int64_t a_row[BM];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  for (int r = tid; r < BM; r += kThreads) a_row[r] = m0 + r < M ? arows(m0 + r) : -1;
  __syncthreads();

  // A's K step t into registers: piece (r, c), 4 K from 4 c of row r (zero
  // off the matrix), for e = tid + u kThreads, r = e / 8, c = e % 8; into
  // stage s K-major: K 4 c + x of row r at column r ^ 4 c, so that a warp's
  // stores and each thread's 16-byte reads of 4 rows lie on distinct banks
  const int k_steps = (K + kSimtBK - 1) / kSimtBK;
  float4 pa[kPieces];
  auto load_a = [&](int t) {
    const int k0 = t * kSimtBK;
#pragma unroll
    for (int u = 0; u < kPieces; ++u) {
      const int e = tid + u * kThreads, r = e >> 3, k = k0 + 4 * (e & 7);
      const int64_t ar = a_row[r];
      const float* src = A + (ar < 0 ? 0 : ar * K + k);
      if (vec_a) {
        pa[u] = ar >= 0 && k < K ? *reinterpret_cast<const float4*>(src)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        pa[u].x = ar >= 0 && k < K ? src[0] : 0.f;
        pa[u].y = ar >= 0 && k + 1 < K ? src[1] : 0.f;
        pa[u].z = ar >= 0 && k + 2 < K ? src[2] : 0.f;
        pa[u].w = ar >= 0 && k + 3 < K ? src[3] : 0.f;
      }
    }
  };
  auto store_a = [&](int s) {
    float* as = simt_smem + s * Tile::kStageFloats;
#pragma unroll
    for (int u = 0; u < kPieces; ++u) {
      const int e = tid + u * kThreads, r = e >> 3, c = e & 7;
      float* col = as + 4 * c * BM + (r ^ (c << 2));
      col[0] = pa[u].x;
      col[BM] = pa[u].y;
      col[2 * BM] = pa[u].z;
      col[3 * BM] = pa[u].w;
    }
  };
  // W's K step t into stage s by cp.async: 32 rows of BN / 4 pieces
  auto issue_w = [&](int s, int t) {
    float* ws = simt_smem + s * Tile::kStageFloats + kSimtBK * BM;
    const int k0 = t * kSimtBK;
#pragma unroll
    for (int u = 0; u < kSimtBK * BN / 4 / kThreads; ++u) {
      const int e = tid + u * kThreads, kr = e / (BN / 4), c = e % (BN / 4);
      const int k = k0 + kr, n = n0 + 4 * c;
      float* dst = ws + kr * BN + 4 * c;
      const float* src = W + (int64_t)k * N + n;
      if (vec_w) {
        cp_async_16(smem_u32(dst), k < K && n < N ? src : W, k < K && n < N ? 16 : 0);
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const bool ok = k < K && n + x < N;
          cp_async_4(smem_u32(dst + x), ok ? src + x : W, ok ? 4 : 0);
        }
      }
    }
  };
  load_a(0);
  issue_w(0, 0);
  cp_async_commit();
  store_a(0);
  if (k_steps > 1) {
    load_a(1);
    issue_w(1, 1);
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int wm = warp / (BN / 64), wn = warp % (BN / 64);
  const int ty = wm * 4 + (lane >> 3), tx = wn * 8 + (lane & 7);
  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < k_steps; ++t) {
    const float* as = simt_smem + (t & 1) * Tile::kStageFloats;
    const float* ws = as + kSimtBK * BM + 4 * tx;
#pragma unroll 8
    for (int k = 0; k < kSimtBK; ++k) {
      const float* ak = as + k * BM + ((4 * ty) ^ ((k >> 2) << 2));
      const float4 a0 = *reinterpret_cast<const float4*>(ak);
      const float4 a1 = TM == 8 ? *reinterpret_cast<const float4*>(ak + BM / 2) : a0;
      const float4 b0 = *reinterpret_cast<const float4*>(ws + k * BN);
      const float4 b1 = *reinterpret_cast<const float4*>(ws + k * BN + BN / 2);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (t + 1 < k_steps) store_a((t + 1) & 1);  // K step t + 1 from the registers
    if (t + 2 < k_steps) load_a(t + 2);         // in flight during the next step
    cp_async_wait<0>();                          // W's K step t + 1 landed
    __syncthreads();  // stage t & 1 read by every warp; stage (t + 1) & 1 whole
    if (t + 2 < k_steps) issue_w(t & 1, t + 2);
    cp_async_commit();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i >> 2) * (BM / 2) + 4 * ty + (i & 3);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j >> 2) * (BN / 2) + 4 * tx + (j & 3);
      if (n < N) epi(m, n, acc[i][j]);
    }
  }
}

template <int BM, int BN, int TM, typename ARows, typename Epi>
int launch_gemm_simt_tile(const float* A, ARows arows, const float* W, int M, int K, int N,
                          Epi epi, cudaStream_t stream) {
  using Tile = SimtTile<BM, BN, TM>;
  auto kernel = gemm_simt_kernel<BM, BN, TM, ARows, Epi>;
  static size_t limit = 0;
  const int err = fit_dynamic_smem(kernel, Tile::kSmem, limit);
  if (err != 0) return err;
  const bool vec_a = K % 4 == 0 && ((uintptr_t)A & 15) == 0;
  const bool vec_w = N % 4 == 0 && ((uintptr_t)W & 15) == 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, Tile::kThreads, Tile::kSmem, stream>>>(A, arows, W, M, K, N, vec_a, vec_w, epi);
  return (int)cudaGetLastError();
}

// The float32 GEMM in the tile ``tile`` names (ops/gemm_core.py::
// simt_plan); cudaErrorInvalidValue for an unknown code.
template <typename ARows, typename Epi>
int launch_gemm_simt(const float* A, ARows arows, const float* W, int M, int K, int N, Epi epi,
                     int tile, cudaStream_t stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  switch (tile) {
    case kSimtTileLarge:
      return launch_gemm_simt_tile<128, 128, 8>(A, arows, W, M, K, N, epi, stream);
    case kSimtTileSmall:
      return launch_gemm_simt_tile<64, 64, 4>(A, arows, W, M, K, N, epi, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename ARows, typename Epi>
__global__ void __launch_bounds__(kGemmThreads)
gemm_wmma_kernel(const __nv_bfloat16* __restrict__ A, ARows arows,
                 const __nv_bfloat16* __restrict__ W, int M, int K, int Nout, Epi epi) {
  using T = __nv_bfloat16;
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
  {
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

// One GEMM off the wgmma core: float32 in the tile ``tile`` names
// ("simt"), bfloat16 on the WMMA tile ("wmma", ``tile`` unused).
template <typename T, typename ARows, typename Epi>
inline int launch_gemm(const T* A, ARows arows, const T* W, int M, int K, int Nout, Epi epi,
                       int tile, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    return launch_gemm_simt(A, arows, W, M, K, Nout, epi, tile, stream);
  } else {
    const dim3 grid((Nout + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    gemm_wmma_kernel<ARows, Epi><<<grid, kGemmThreads, 0, stream>>>(A, arows, W, M, K, Nout, epi);
    return (int)cudaGetLastError();
  }
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
