// The Hopper GEMM core: wgmma fed by TMA, bfloat16 operands, float32 sums,
// the matrix product of rows 2 (kernel A's qkv), 3 (kernel B's projection),
// 4 (gate_group_mlp), 5 (dense_mlp_residual), 7 (gate_group_linear, its
// epilogue writing the token buffer at the selected rows), 12
// (ln_select_matmul) and 13 (select_linear_skip_norms) in bfloat16.
// gemm.cuh's contract, so the epilogues and the rounding points do not
// move:
//
//   out(m, n) = epi(m, n, sum_k A[arow(m), k] * W[k, n])   (float32 sum)
//
// A is row-major (rows, K), its rows named by the ARows functor (DenseRows,
// or gate_group.cu's GatherRows, where -1 reads a zero row); W is row-major
// (K, N), the JAX (in, out) layout. The card bounds a GEMM of these shapes
// by its tensor-core rate (989 TFLOP/s bf16 dense); gemm.cuh's WMMA tile
// reaches 2-3 % of it, held back by synchronous one-element loads and a
// __syncthreads around every K step of 32. This core:
//   * one block of 320 threads computes a 128 x 128 output tile: two
//     consumer warpgroups, 64 rows each, run wgmma.mma_async m64n128k16
//     with both operands in shared memory; two producer warps keep the loads
//     of a ring of kGemmTcStages K steps of 64 in flight, each stage
//     guarded by a "full" and an "empty" mbarrier. Two blocks share an SM
//     (97 KB of shared memory each), so that one block's epilogue runs
//     under the other's products: at K = 768 (GEMM1) the epilogue, GELU
//     included, takes about as long as the products;
//   * W's tiles come by TMA (cp.async.bulk.tensor) as two 64 x 64 boxes
//     with the 128-byte swizzle; W is N-major, so wgmma reads B with the
//     transpose bit set (leading byte offset: the 8 KB between the two
//     64-column boxes; stride byte offset: 1 KB between 8-row groups);
//   * A's tiles come by TMA for DenseRows (zero rows past M); for gathered
//     rows, which TMA cannot fetch, the producer warps copy each row's
//     128 bytes by 16-byte cp.async into the same swizzled layout (a -1 row
//     is zero-filled, src-size 0) and the copies arrive on the stage's
//     mbarrier themselves (cp.async.mbarrier.arrive.noinc);
//   * the consumers keep one wgmma group in flight and release a stage
//     when the group after it has been issued; the accumulators then go
//     through shared memory (over the ring, which is idle by then), so
//     that the epilogue functor runs on each element in row order and its
//     stores coalesce; each thread loads the epilogue's operands (bias,
//     residual) of kGemmTcLoads elements before it stores any (the
//     functors' load()/store()), which would otherwise wait out one
//     global load's latency per element;
//   * where the tiles are fewer than the SMs (row 4's second GEMM: 18-42
//     tiles; row 7's projection: 12-24), the K steps are split over
//     blockIdx.z: each split writes its float32 partial tile to a
//     workspace the wrapper allocates, and one more launch sums the splits
//     in order and runs the epilogue once, so rnd(acc + b) keeps its order
//     and only the float32 summation order moves. The split comes from the
//     wrapper (ops/gemm_core.py::gemm_plan).
// ops/gemm_core.py::gemm_core is the rule that sends a call here: bfloat16,
// K a multiple of 64, N of 128, 16-byte aligned operands; launch_gemm_tc
// refuses anything else. The TMA descriptors are encoded through the
// driver's cuTensorMapEncodeTiled, reached by the runtime's
// cudaGetDriverEntryPoint(ByVersion) (no -lcuda at build time), and cached
// by (address, shape, box) (tensor_map_2d).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "async_copy.cuh"
#include "common.cuh"
#include "gemm.cuh"
#include "warp_mma.cuh"

namespace etk {

constexpr int kGemmTcBM = 128, kGemmTcBN = 128, kGemmTcBK = 64, kGemmTcStages = 3;
constexpr int kGemmTcThreads = 320;  // consumer warpgroups 0, 1; producer warps 8, 9
constexpr int kGemmTcLdc = kGemmTcBN + 4;  // float stride of the staged accumulators
constexpr int kGemmTcLoads = 8;  // epilogue elements a thread loads ahead of their stores
constexpr int kGemmTcABytes = kGemmTcBM * kGemmTcBK * 2;  // 16 KB
constexpr int kGemmTcBBytes = kGemmTcBK * kGemmTcBN * 2;  // 16 KB: two 64 x 64 boxes
constexpr int kGemmTcBoxBytes = kGemmTcBK * 64 * 2;       // 8 KB
constexpr int kGemmTcRingBytes = kGemmTcStages * (kGemmTcABytes + kGemmTcBBytes);
static_assert(kGemmTcBM * kGemmTcLdc * 4 <= kGemmTcRingBytes, "the staged tile reuses the ring");
// the ring (the accumulators staged over it at the end) and the barriers;
// two blocks fit an SM
constexpr size_t kGemmTcSmem =
    1024 /* alignment slack */ + kGemmTcRingBytes + 2 * kGemmTcStages * sizeof(uint64_t);

// -- PTX wrappers --------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// 16 bytes from global to shared; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// The barrier counts one arrival of this thread when its earlier cp.asyncs land.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d += A (64 x 16, K-major) * B (16 x 128, N-major: the transpose bit)
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Keep the compiler from moving accumulator accesses across the async wgmma.
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// -- the kernel -----------------------------------------------------------------

// Split-K partial: the float32 tile of split blockIdx.z into the workspace.
struct PartialSum {
  float* ws;
  int m_total, n_total;
  using Loaded = int;  // nothing
  __device__ __forceinline__ int load(int, int) const { return 0; }
  __device__ __forceinline__ void store(int m, int n, float acc, int) const {
    ws[((int64_t)blockIdx.z * m_total + m) * n_total + n] = acc;
  }
};

// grid (N / 128, ceil(M / 128), splits); each block runs ``steps`` K steps
// of 64 from K step blockIdx.z * steps. kGather: A's rows through arows by
// cp.async (tma_a unused), else A by TMA with arows the identity.
template <bool kGather, typename ARows, typename Epi>
__global__ void __launch_bounds__(kGemmTcThreads, 2)
gemm_tc_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_w,
               const __nv_bfloat16* __restrict__ A, ARows arows, int M, int K, int steps,
               Epi epi) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* s_a = smem;                                  // stages x 16 KB
  uint8_t* s_b = smem + kGemmTcStages * kGemmTcABytes;  // stages x 16 KB
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kGemmTcRingBytes);
  uint64_t* empty = full + kGemmTcStages;

  const int m0 = blockIdx.y * kGemmTcBM, n0 = blockIdx.x * kGemmTcBN;
  const int k_step0 = blockIdx.z * steps;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmTcStages; ++s) {
      mbar_init(smem_u32(&full[s]), kGather ? 1 + 64 : 1);
      mbar_init(smem_u32(&empty[s]), 8);  // the consumers' 8 warps
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {
    // -- producer warps -----------------------------------------------------
    const int ptid = threadIdx.x - 256;  // 0 .. 63
    if (kGather) {
      // thread: 16-byte chunk c of rows ptid / 8 + 8 j, so that 8 neighbouring
      // threads copy one row's 128 bytes; the rows' offsets (-1: a zero row)
      // kept in registers
      const int c = ptid & 7, r0 = ptid >> 3;
      int64_t src[kGemmTcBM / 8];
#pragma unroll
      for (int j = 0; j < kGemmTcBM / 8; ++j) {
        const int m = m0 + r0 + 8 * j;
        const int64_t ar = m < M ? arows(m) : -1;
        src[j] = ar < 0 ? -1 : ar * K + c * 8;
      }
      const uint32_t swz = (uint32_t)((c ^ (r0 & 7)) << 4);  // (r0 + 8 j) & 7 == r0 & 7
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < steps; ++it) {
        mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
        const int k0 = (k_step0 + it) * kGemmTcBK;
        const uint32_t dst = smem_u32(s_a + stage * kGemmTcABytes) + (uint32_t)r0 * 128 + swz;
#pragma unroll
        for (int j = 0; j < kGemmTcBM / 8; ++j) {
          const bool ok = src[j] >= 0;
          cp_async_16(dst + (uint32_t)j * 8 * 128, ok ? A + src[j] + k0 : A, ok ? 16 : 0);
        }
        cp_async_arrive(smem_u32(&full[stage]));
        if (ptid == 0) {
          const uint32_t bar = smem_u32(&full[stage]);
          const uint32_t b = smem_u32(s_b + stage * kGemmTcBBytes);
          mbar_expect_tx(bar, kGemmTcBBytes);
          tma_load_2d(b, &tma_w, bar, n0, k0);
          tma_load_2d(b + kGemmTcBoxBytes, &tma_w, bar, n0 + 64, k0);
        }
        if (++stage == kGemmTcStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    } else if (ptid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < steps; ++it) {
        mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
        const int k0 = (k_step0 + it) * kGemmTcBK;
        const uint32_t bar = smem_u32(&full[stage]);
        const uint32_t b = smem_u32(s_b + stage * kGemmTcBBytes);
        mbar_expect_tx(bar, kGemmTcABytes + kGemmTcBBytes);
        tma_load_2d(smem_u32(s_a + stage * kGemmTcABytes), &tma_a, bar, k0, m0);
        tma_load_2d(b, &tma_w, bar, n0, k0);
        tma_load_2d(b + kGemmTcBoxBytes, &tma_w, bar, n0 + 64, k0);
        if (++stage == kGemmTcStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // -- consumers: warpgroup wg computes rows wg * 64 .. + 63 of the tile -----
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_acc(acc);
  const int warp = tid >> 5;
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int it = 0; it < steps; ++it) {
    mbar_wait(smem_u32(&full[stage]), phase);
    // cp.async wrote A through the generic proxy; wgmma reads through the async one
    if (kGather) fence_proxy_async();
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint32_t a = smem_u32(s_a + stage * kGemmTcABytes) + wg * 64 * 128;
    const uint32_t b = smem_u32(s_b + stage * kGemmTcBBytes);
#pragma unroll
    for (int kk = 0; kk < kGemmTcBK / 16; ++kk) {
      // A: +32 bytes per 16 K inside the swizzled 128-byte rows; B: +16 rows of 128 bytes
      wgmma_m64n128k16(acc, wgmma_desc(a + kk * 32, 16, 1024),
                       wgmma_desc(b + kk * 16 * 128, kGemmTcBoxBytes, 1024));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc);
    if (it > 0 && lane == 0) mbar_arrive(smem_u32(&empty[prev]));
    prev = stage;
    if (++stage == kGemmTcStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);

  // Both warpgroups are done with the ring (every load it was given has
  // landed and been read) before the accumulators are staged over it.
  named_sync(1, 256);
  fence_proxy_async();
  // accumulator (j, i, e) of thread (warp, lane): row 16 warp + lane / 4 + 8 i,
  // column 8 j + 2 (lane % 4) + e
  float* c_rows = reinterpret_cast<float*>(smem) + (wg * 64) * kGemmTcLdc;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = warp * 16 + (lane >> 2) + 8 * i, col = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<float2*>(c_rows + row * kGemmTcLdc + col) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  named_sync(2 + wg, 128);
  // kGemmTcLoads elements a thread at a time: their operands loaded first,
  // then the stores
  const int m_wg = m0 + wg * 64;
  for (int e0 = tid; e0 < 64 * kGemmTcBN; e0 += 128 * kGemmTcLoads) {
    typename Epi::Loaded in[kGemmTcLoads];
#pragma unroll
    for (int u = 0; u < kGemmTcLoads; ++u) {
      const int e = e0 + 128 * u, r = e / kGemmTcBN;
      if (m_wg + r < M) in[u] = epi.load(m_wg + r, n0 + e % kGemmTcBN);
    }
#pragma unroll
    for (int u = 0; u < kGemmTcLoads; ++u) {
      const int e = e0 + 128 * u, r = e / kGemmTcBN, col = e % kGemmTcBN;
      if (m_wg + r < M) epi.store(m_wg + r, n0 + col, c_rows[r * kGemmTcLdc + col], in[u]);
    }
  }
}

// out = epi(sum of the splits' partials), summed in split order
template <typename Epi>
__global__ void __launch_bounds__(256)
splitk_epilogue_kernel(const float* __restrict__ ws, int splits, int M, int N, Epi epi) {
  const int64_t total = (int64_t)M * N;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    float s = ws[e];
    for (int i = 1; i < splits; ++i) s += ws[i * total + e];
    const int m = (int)(e / N), n = (int)(e % N);
    epi.store(m, n, s, epi.load(m, n));
  }
}

// -- host side -------------------------------------------------------------------

inline bool gemm_tc_aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

// A (rows, cols) row-major bfloat16 matrix in boxes of box_rows x 64 with
// the 128-byte swizzle, from a cache keyed by (address, shape, box): the
// weights, the gate states and the allocator's scratch blocks come back
// call after call. The cache keeps the kGemmTcMaps most recently used
// maps (least recently used out), far more than one forward of any path
// names, so that a warm forward encodes none (a forward whose scratch the
// allocator places anew encodes that scratch's maps once);
// tensor_map_encodes() counts the encodes. Defined in gemm_tc.cu, one
// cache for the library. false: refused.
constexpr int kGemmTcMaps = 4096;
bool tensor_map_2d(CUtensorMap* out, const void* ptr, int64_t rows, int64_t cols, int box_rows);
long long tensor_map_encodes();

template <bool kGather, typename ARows, typename Epi>
int launch_gemm_tc_kernel(const CUtensorMap& tma_a, const CUtensorMap& tma_w,
                          const __nv_bfloat16* A, ARows arows, int M, int K, int N, int splits,
                          Epi epi, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_tc_kernel<kGather, ARows, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kGemmTcSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(N / kGemmTcBN, (M + kGemmTcBM - 1) / kGemmTcBM, splits);
  gemm_tc_kernel<kGather, ARows, Epi><<<grid, kGemmTcThreads, kGemmTcSmem, stream>>>(
      tma_a, tma_w, A, arows, M, K, K / kGemmTcBK / splits, epi);
  return (int)cudaGetLastError();
}

// The launch of one GEMM on this core: a_rows is A's row count (M for
// DenseRows), splits the split of the K steps (ops/gemm_core.py::
// gemm_plan), ws a float32 workspace of splits x M x N when splits > 1.
// Refuses (cudaErrorInvalidValue) what gemm_core would not send here.
template <bool kGather, typename ARows, typename Epi>
int launch_gemm_tc(const __nv_bfloat16* A, int64_t a_rows, ARows arows, const __nv_bfloat16* W,
                   int M, int K, int N, int splits, float* ws, Epi epi, cudaStream_t stream) {
  const int k_steps = K / kGemmTcBK;
  if (M < 1 || K % kGemmTcBK != 0 || N % kGemmTcBN != 0 || splits < 1 || k_steps % splits != 0 ||
      (splits > 1 && ws == nullptr) || !gemm_tc_aligned(A) || !gemm_tc_aligned(W) ||
      (splits > 1 && !gemm_tc_aligned(ws)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tma_a, tma_w;
  if (!tensor_map_2d(&tma_w, W, K, N, kGemmTcBK)) return (int)cudaErrorInvalidValue;
  if (kGather) {
    tma_a = tma_w;  // unused
  } else if (!tensor_map_2d(&tma_a, A, a_rows, K, kGemmTcBM)) {
    return (int)cudaErrorInvalidValue;
  }
  if (splits == 1)
    return launch_gemm_tc_kernel<kGather>(tma_a, tma_w, A, arows, M, K, N, 1, epi, stream);
  const int err = launch_gemm_tc_kernel<kGather>(tma_a, tma_w, A, arows, M, K, N, splits,
                                                 PartialSum{ws, M, N}, stream);
  if (err != 0) return err;
  const int64_t total = (int64_t)M * N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  splitk_epilogue_kernel<<<blocks, 256, 0, stream>>>(ws, splits, M, N, epi);
  return (int)cudaGetLastError();
}

// The GEMM core a call takes (ops/gemm_core.py CORE_CODES): kCoreOld, the
// SIMT/WMMA tile of gemm.cuh; kCoreTc, this one, bfloat16 only.
constexpr int kCoreOld = 0, kCoreTc = 1;

struct GemmCall {
  int core = kCoreOld;
  int splits = 1;
  float* ws = nullptr;  // splits x M x N float32 when splits > 1
};

// One GEMM on the core ``call`` names; a_rows as for launch_gemm_tc.
template <typename T, bool kGather, typename ARows, typename Epi>
int launch_gemm_core(const T* A, int64_t a_rows, ARows arows, const T* W, int M, int K, int N,
                     Epi epi, GemmCall call, cudaStream_t stream) {
  if (call.core == kCoreOld) {
    launch_gemm<T>(A, arows, W, M, K, N, epi, stream);
    return (int)cudaGetLastError();
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (call.core == kCoreTc)
      return launch_gemm_tc<kGather>(A, a_rows, arows, W, M, K, N, call.splits, call.ws, epi,
                                     stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace etk
