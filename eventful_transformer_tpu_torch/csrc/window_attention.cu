// window_attention, global mode and the windowed forms, written for Hopper.
//
// Replaces eventful_transformer_tpu/ops/pallas/window_attention.py::
// window_attention:
//   * global mode, no rel-pos terms: the whole sequence of each batch row
//     is one "window". It serves the dense block, the eventful flush step
//     and ViViT's temporal model;
//   * windowed form with rel-pos terms: one window of T = 196 tokens per
//     batch row (ViTDet's 14 x 14 windows, Bw = 18 at 672 with 2 streams),
//     the per-axis terms (Bw, H, T, 28) expanded onto the float32 logits.
//     It serves ViTDet's 8 windowed blocks, dense and eventful;
//   * the padded windowed form (``geom``): the windows of a zero-padded
//     token map, with the qkv-bias row and the pad rows' terms substituted
//     at out-of-image tokens (window_attention.py:155-192). At ViTDet-1024
//     the 64 x 64 grid pads to 5 x 5 windows of 14 x 14 (Bw = 50 with 2
//     streams, 4900 rows, 804 of them pad rows); the dense twin's windowed
//     blocks run it. The substitution is a compare per row load, so the
//     form costs what the unpadded one does.
//
// The TPU kernel runs one grid step per batch row with its whole (N, 3C)
// qkv block in VMEM; at N = 197, C = 768 that is 0.9 MB in bf16, beyond the
// 227 KB of shared memory a block may use, and 8 to 128 batch rows would
// leave most of the 132 SMs idle. The attention kernel of attention.cuh
// instead takes one (batch, head, query tile) per block with K and V of one
// head in shared memory. It is the same kernel as kernel A's attention
// stage, whose rounding (block_fused.py:97-102) matches window_attention.
// py's _attend_terms. Its bound is the bytes of qkv, the terms and the
// output. In bfloat16 the tensor-core body of attention_tc.cuh runs it (64
// queries a block: 8 x 12 x 4 = 384 blocks at the flagship's spatial shape,
// 18 x 12 x 4 = 864 at ViTDet-672's windows), with the terms of the block's
// queries staged in shared memory as float32 and added to the tensor-core
// logits; in float32 the CUDA-core body (32 queries a block), bound by its
// float32 shared-memory dot products.
//
// Also replaces window_attention.py::window_attention_grid
// (etk_window_attention_grid): the same windows read in place from the
// padded (B, Hp, Wp, 3C) qkv map and written back to a (B, Hp, Wp, C) map
// through attention.cuh's GridRows, so that no partition exists in memory,
// with the rounding of window_attention.py's _attend (kAttnGrid: q scaled
// in float32, the rel-pos terms computed in the kernel from the unscaled
// q against the two (a, p, d) tables). The TPU kernel walks one stripe of
// a0 map rows per grid step and slices its windows in VMEM; here the
// blocks are the partitioned form's, (window, head, query tile), and only
// the row addresses change (the row table each block builds), so the grid
// form is bound like the partitioned one. In bfloat16 it takes the
// tensor-core body, as the other forms do: q as float32 hi + lo parts, the
// terms on the tensor cores (each warp's 16 queries against the table rows
// they use) from the y rows of the block's window rows and the whole x
// table, both staged in shared memory by cp.async beside K and V, into the
// float32 staging of the windowed form, added to the logits one after the
// other. In float32 the CUDA-core body runs it: one warp-wide dot
// product a term, each lane reading its own elements of the table row.
#include "attention.cuh"

extern "C" {

// a1 > 0: the grid form with tables over an (n_terms - p1) x p1 key grid
int etk_attention_smem_bytes(int body, int n, int d, int n_terms, int a1, int p1) {
  return (int)etk::attention_smem_bytes(body, n, d, n_terms, a1, p1);
}

// pad_bias null: no pad rows; else geom = (nh, nw, vh, vw) and the window
// (a0, a1), and pad_terms the pad rows' terms when terms is not null. body:
// attention.cuh's AttnBody, chosen by the wrapper.
int etk_window_attention(int dtype, int body, const void* qkv, const void* terms, void* out,
                         int bsz, int n, int c, int heads, float inv_scale, int p0, int p1,
                         const void* pad_bias, const void* pad_terms, int nh, int nw, int vh,
                         int vw, int a0, int a1, void* stream) {
  ETK_DISPATCH(dtype, {
    etk::PadGeom<T> geom;
    geom.bias = (const T*)pad_bias;
    geom.terms = (const T*)pad_terms;
    geom.nh = nh;
    geom.nw = nw;
    geom.vh = vh;
    geom.vw = vw;
    geom.a0 = a0;
    geom.a1 = a1;
    return etk::launch_attention<T>(body, (const T*)qkv, (const T*)terms, (T*)out, bsz, n, c,
                                    heads, inv_scale, p0, p1, (cudaStream_t)stream, geom);
  });
}

// x (b, nh * a0, nw * a1, 3c) -> out (b, nh * a0, nw * a1, c); y_rel null:
// no rel-pos terms, else the tables y_rel (a0, p0, d) and x_rel (a1, p1,
// d) with p0 * p1 == a0 * a1. body: attention.cuh's AttnBody, chosen by the
// wrapper.
int etk_window_attention_grid(int dtype, int body, const void* x, const void* y_rel,
                              const void* x_rel, void* out, int b, int nh, int nw, int a0, int a1,
                              int c, int heads, float inv_scale, int p0, int p1, void* stream) {
  ETK_DISPATCH(dtype, {
    etk::GridRows rows;
    rows.nh = nh;
    rows.nw = nw;
    rows.a0 = a0;
    rows.a1 = a1;
    etk::RelTables<T> tab;
    tab.y = (const T*)y_rel;
    tab.x = (const T*)x_rel;
    tab.a1 = a1;
    return etk::launch_attention<T, etk::kAttnGrid>(
        body, (const T*)x, nullptr, (T*)out, b * nh * nw, a0 * a1, c, heads, inv_scale, p0, p1,
        (cudaStream_t)stream, etk::PadGeom<T>{}, rows, tab);
  });
}

}  // extern "C"
