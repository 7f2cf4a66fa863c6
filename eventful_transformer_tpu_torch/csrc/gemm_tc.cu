// The wgmma core of gemm_tc.cuh on its own, for its tests: out = a[rows] @ w
// in float32, no epilogue beyond the store. Rows 4 and 5 reach the core
// through their own entries (gate_group.cu, dense_mlp.cu).
#include "gemm_tc.cuh"

namespace etk {

// Output row m reads row idx[m] of A (-1: a zero row).
struct IndexRows {
  const int* idx;
  __device__ __forceinline__ int64_t operator()(int m) const { return idx[m]; }
};

struct StoreEpilogue {
  float* out;
  int ld;
  using Loaded = int;  // nothing
  __device__ __forceinline__ int load(int, int) const { return 0; }
  __device__ __forceinline__ void store(int m, int n, float acc, int) const {
    out[(int64_t)m * ld + n] = acc;
  }
};

}  // namespace etk

// a (a_rows, k) and w (k, n) bfloat16; idx null (a dense, m == a_rows) or
// m int32 row indices; out (m, n) float32; ws: splits x m x n float32 when
// splits > 1.
extern "C" int etk_gemm_tc(const void* a, const void* idx, const void* w, void* out, void* ws,
                           int a_rows, int m, int k, int n, int splits, void* stream) {
  using etk::launch_gemm_tc;
  const auto* A = (const __nv_bfloat16*)a;
  const auto* W = (const __nv_bfloat16*)w;
  const etk::StoreEpilogue epi{(float*)out, n};
  if (idx == nullptr)
    return launch_gemm_tc<false>(A, a_rows, etk::DenseRows{}, W, m, k, n, splits, (float*)ws, epi,
                                 (cudaStream_t)stream);
  return launch_gemm_tc<true>(A, a_rows, etk::IndexRows{(const int*)idx}, W, m, k, n, splits,
                              (float*)ws, epi, (cudaStream_t)stream);
}
