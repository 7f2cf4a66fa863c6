// window_attention in its global mode, written for Hopper.
//
// Replaces eventful_transformer_tpu/ops/pallas/window_attention.py::
// window_attention called with no window geometry and no rel-pos terms:
// the whole sequence of each batch row is one "window". It serves the dense
// block, the eventful block's flush step and the temporal model.
//
// The TPU kernel runs one grid step per batch row with its whole (N, 3C)
// qkv block in VMEM; at N = 197, C = 768 that is 0.9 MB in bf16, beyond the
// 227 KB of shared memory a block may use, and 8 to 128 batch rows would
// leave most of the 132 SMs idle. The attention kernel of attention.cuh
// instead takes one (batch, head, 32-query tile) per block with K and V of
// one head in shared memory: 8 x 12 x 7 = 672 blocks at the flagship's
// spatial shape. It is the same kernel as kernel A's attention stage, whose
// rounding (block_fused.py:97-102) matches window_attention.py's
// _attend_terms.
#include "attention.cuh"

extern "C" {

int etk_attention_smem_bytes(int n, int d) { return (int)etk::attention_smem_bytes(n, d); }

int etk_window_attention(int dtype, const void* qkv, void* out, int bsz, int n, int c,
                         int heads, float inv_scale, void* stream) {
  ETK_DISPATCH(dtype, return etk::launch_attention<T>((const T*)qkv, (T*)out, bsz, n, c, heads,
                                                      inv_scale, (cudaStream_t)stream));
}

}  // extern "C"
