// The wgmma core of gemm_tc.cuh and gemm.cuh's float32 tile on their own,
// for their tests: out = a[rows] @ w in float32, no epilogue beyond the store. Rows 2-5 reach the core through
// their own entries (block_fused.cu, gate_group.cu, dense_mlp.cu). Also the
// core's one TMA descriptor cache (tensor_map_2d) and its encode count.
#include <functional>
#include <iterator>
#include <list>
#include <mutex>
#include <unordered_map>
#include <utility>

#include "gemm_tc.cuh"

namespace etk {

namespace {

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

struct MapKey {
  const void* ptr;
  int64_t rows, cols;
  int box_rows;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && rows == o.rows && cols == o.cols && box_rows == o.box_rows;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.ptr);
    for (int64_t v : {k.rows, k.cols, (int64_t)k.box_rows})
      h ^= std::hash<int64_t>()(v) + 0x9e3779b97f4a7c15ull + (h << 6) + (h >> 2);
    return h;
  }
};

// least recently used first; the map points into the list
struct MapCache {
  std::list<std::pair<MapKey, CUtensorMap>> order;
  std::unordered_map<MapKey, std::list<std::pair<MapKey, CUtensorMap>>::iterator, MapKeyHash> at;
  long long encodes = 0;
  std::mutex lock;
};

MapCache& map_cache() {
  static MapCache cache;
  return cache;
}

}  // namespace

bool tensor_map_2d(CUtensorMap* out, const void* ptr, int64_t rows, int64_t cols, int box_rows) {
  MapCache& cache = map_cache();
  const MapKey key{ptr, rows, cols, box_rows};
  std::lock_guard<std::mutex> guard(cache.lock);
  const auto hit = cache.at.find(key);
  if (hit != cache.at.end()) {
    cache.order.splice(cache.order.end(), cache.order, hit->second);
    *out = hit->second->second;
    return true;
  }
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  CUtensorMap map;
  const CUresult res = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                              dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return false;
  ++cache.encodes;
  if ((int)cache.order.size() == kGemmTcMaps) {
    cache.at.erase(cache.order.front().first);
    cache.order.pop_front();
  }
  cache.order.emplace_back(key, map);
  cache.at.emplace(key, std::prev(cache.order.end()));
  *out = map;
  return true;
}

long long tensor_map_encodes() {
  MapCache& cache = map_cache();
  std::lock_guard<std::mutex> guard(cache.lock);
  return cache.encodes;
}

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
  __device__ __forceinline__ void operator()(int m, int n, float acc) const { store(m, n, acc, 0); }
};

}  // namespace etk

// The TMA descriptors encoded since the library was loaded.
extern "C" long long etk_tensor_map_encodes() { return etk::tensor_map_encodes(); }

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

// a (a_rows, k) and w (k, n) float32; idx null (a dense) or m int32 row
// indices; out (m, n) float32; tile: gemm.cuh's float32 tile code.
extern "C" int etk_gemm_simt(const void* a, const void* idx, const void* w, void* out, int m,
                             int k, int n, int tile, void* stream) {
  const auto* A = (const float*)a;
  const auto* W = (const float*)w;
  const etk::StoreEpilogue epi{(float*)out, n};
  if (idx == nullptr)
    return etk::launch_gemm_simt(A, etk::DenseRows{}, W, m, k, n, epi, tile, (cudaStream_t)stream);
  return etk::launch_gemm_simt(A, etk::IndexRows{(const int*)idx}, W, m, k, n, epi, tile,
                               (cudaStream_t)stream);
}
