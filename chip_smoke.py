"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths through the entry points a user calls, and
checks them: eventful ViViT-B inference on Kinetics-400 shaped clips
through ``FactorizedViViT.apply_views``, in the bench's configuration
(``EventfulTokenwiseBlock``, k = 98), with it every gate before its LN,
with the gate-group kernels selecting their own rows (in_kernel_topk),
and in the paper's (``EventfulBlock``, k = 24, a raw clip through
``FactorizedViViT.apply``); the eventful ViTDet-B backbone at 672 x 672
(spatiotemporal_672, k = 256, the "v2" regime) and at 1024 x 1024
(spatiotemporal_1024, k = 256, the "blocked" regime) through
``ViTDet.pre_backbone`` and ``apply_backbone``, and so the block options
of compare_ln_1024 (gates before LN, k = 512), its 672 twin, stgt_672 (STGT
gates, also with put_rows as the scatter-blend kernel) and ablate_av_672
(EventfulMatmul1Block), and spatiotemporal_672 with the gate-group kernels
selecting their own rows; and ViTDet-B detection end
to end at 672 through ``ViTDet.apply`` (backbone, SimplePyramid, RPN,
ROIAlign, NMS, the standard ROI heads); each with its dense twin; ViTDet-B
COCO at 1024 through ViTDet.apply (the cascade and mask heads); the temporal
fine-tune (configs/train/vivit_kinetics400/final_24.yml) through its entry
point and its train step; and the evaluation harness on the
card: run_evaluations over temporal_24 (ViViT-B K400) and threshold_1024
(ViTDet-B VID at 1024, the capacity-bucketed threshold sweep), and the
ViViT entry point as a user runs it; and ViViT's remaining serving
surface: ATS at EPIC-Kitchens ViViT-B's full size (ats.yml,
temporal_ats_200.yml), the spatial cache (configs/spatial/
vivit_kinetics400/24.yml, spatial_only, read back, temporal_only) and the
time entry points as a user runs them; and multi-process evaluation on
torch.distributed (NCCL, one rank): Ulysses sequence parallelism on
ulysses_smoke_672 and data parallelism on spatiotemporal_672 and through
the ViViT entry point; and in that rank the training half of parallel/:
ViViT-B's eventful spatial stack pipelined, the dense ViViT-B tensor-parallel
in inference and in two train steps, and the multi-chip dry run; and the
detector's training losses on ViTDet-B at 672; and tensor parallelism of
the eventful and ATS blocks, tp = 2 in two processes on the card over
gloo, with the threshold ladder's bucket script.
Phases, one JSON line each, with the seconds the phase took:

  1. env:            torch, CUDA and nvcc versions and the card (nvidia-smi).
  2. build:          nvcc builds the kernels from eventful_transformer_tpu_torch/csrc,
                     one process per source.
  3. kernels:        each kernel against its plain PyTorch version at ViViT's
                     shapes, float32 and bfloat16, each output within the
                     bounds stated in ops/kernel_check.py, and both timed;
                     rows 1 (ln_norms), 9 (block_select_scatter), 10
                     (block_select_p), 14 (ln_select) and 11
                     (block_scatter_rows, through the window map) with
                     the readings of 23 (device microseconds, share of the
                     bound, kernels and allocations a call: one launch of
                     ln_norms_kernel, select_scatter_kernel or
                     select_warp_kernel, the warp-per-row body, and its new
                     outputs alone; row 11 one of block_scatter_rows_kernel,
                     the bulk row copy, and none), here and in every
                     kernels phase below; every checked call of a row pass (rows 1, 9,
                     10, 14 and the select, LN and norms stages of kernels
                     A and B and rows 4, 5, 7, 12 and 13) on the
                     warp-per-row body (ops/row_pass.py::row_body),
                     checked;
                     the GEMM rows beside their yardstick, cuBLAS on the
                     operands of their GEMMs (kernel_check.library_call:
                     kernels A and B, gate_group_linear, ln_select_matmul,
                     select_linear_skip_norms; the MLP rows gate_group_mlp
                     and dense_mlp_residual its two GEMMs), rows 2-5, 7, 12
                     and 13 with their launches by GEMM core, each on the core
                     ops/gemm_core.py's rule gives it (so in every kernels
                     phase below).
     gemm_core:      each GEMM launch of rows 2-5, 7, 12 and 13 at every path's
                     shape in bfloat16 (kernels A and B at ViViT's; the MLP
                     rows at ViViT, its temporal model, ViTDet-672, e2e and
                     1024 dense; kernel C at k = 98, 24 and 256, "pre" and
                     cov=None; row 7's qkv ("post", "pre") and projection
                     ("none") at ViTDet-672's k = 256 and, "post" and
                     "none", at the e2e path's one stream; rows 12 and 13 at the paper's ViViT's 12
                     views and, "pre" and next_ln=False, at ViViT's 8 with
                     gates before LN): its plan on the wgmma core (tiles, split of
                     the K steps), its device microseconds from
                     torch.profiler's events (with the split sum) and its
                     TFLOP/s, beside the card's name and power limit.
  4. slice:          eventful ViViT-B (k=98 of 197 tokens) on the bench's
                     input in bfloat16, with the kernels' launch counts (and
                     the dense twin's); the TMA descriptors each model's
                     first forward and its warm forwards encode (those run
                     until one reserves no new device memory; the one after
                     it must encode none); one clip in float32 on the card against
                     the same model on the CPU (plain versions); counted
                     GFLOPs/clip against the JAX package's counts.
  5. time:           ViViT's dense twin against eventful, ms/clip.
  6. vitdet_kernels: the kernels of the ViTDet path at its shapes (N = 1764,
                     2 streams, 18 windows of 196 tokens; the rel-pos bias
                     add over 1764 keys (dense) and 441 (pooled)), and of
                     the end-to-end path at one stream, as in 3; the A.V
                     kernel (softmax_select_matmul, row 8) with the body
                     each call took (av_softmax.av_softmax_body: bfloat16
                     on the tensor cores, float32 on the CUDA cores,
                     checked) and its device microseconds a call (CUDA
                     events around calls queued behind a sleeping kernel)
                     beside its bound, in every kernels phase it runs in.
  7. vitdet_slice:   eventful spatiotemporal_672 and dense base_672, 2
                     streams x 16 frames in bfloat16, with launch counts and
                     counted GFLOPs per frame against the JAX package's; one
                     stream x 3 frames in float32 (matmul-2 cast off) of the
                     backbone cut to two windowed blocks and one global on
                     the card against the CPU (cut from 12 blocks when row
                     11's readings came in).
  8. vitdet_time:    dense against eventful, ms/frame, alternated.
  9-11. vitdet1024_kernels, vitdet1024_slice, vitdet1024_time: as 6-8 for
                     spatiotemporal_1024 and base_1024 (N = 4096, 50 windows
                     of 196 tokens with pad rows, 1024 pooled keys, the
                     rel-pos bias add over 4096 and 1024 keys); the kernels
                     phase also holds softmax_select_matmul at 441 pooled
                     keys, the shape the 672 float32 check runs it at,
                     each with its body and device microseconds, as in 6.
  12. vitdet_e2e:    spatiotemporal_672 and base_672 through ViTDet.apply, one
                     stream, a flush frame then 8 frames, bfloat16: launch
                     counts, counted GFLOPs per frame against the JAX
                     package's, the detections kept per frame, row 22's
                     launches (2 a frame) and the NMS host reads (0 on the
                     card); phase 43 on this model; the eventful call
                     again with the rel-pos bias add in its relpos_bias_add
                     form (use_kernel = True), counted; 3 frames of the
                     eventful model in float32 on the card (the rel-pos bias
                     add in its relpos_bias_add form) against the CPU:
                     tokens and detections; then dense against eventful,
                     ms/frame, alternated.
  13. vivit_evblock_kernels: the kernels of the paper's eventful ViViT-B K400
                     configuration (EventfulBlock, k = 24, bf16 A.V cast) at its
                     shapes (12 views, N = 197; the temporal model's N = 17),
                     ln_select_matmul in its "post" and "none" forms,
                     select_linear_skip_norms, ln_select and the A.V kernel's
                     logits form (197 keys; with rel-pos terms at
                     ViTDet-1024's pooled shape, 4096 x 1024), as in 3,
                     the A.V kernel with its body and device microseconds
                     as in 6.
  14. vivit_evblock_slice: one raw uint8 clip (10 s, 25 fps, 224 x 398) through
                     FactorizedViViT.apply in bfloat16 under "auto" ("v2mlp"),
                     the forced "v1", "v1v2" and "v3", the cached q.kT product
                     (the logits form) and the delta-accumulated A.V product,
                     and the dense twin: launches and counted GFLOPs per clip
                     against the JAX package's; the TMA descriptors the
                     forced runs' warm forwards encode, as in 4; one clip in float32 (cast off)
                     of the model cut to 2 spatial blocks on the card against
                     the CPU (cut from 12 when the phases of 22-23 came in),
                     and on the card alone under "v1" and "v3", counted, so
                     that rows 12 and 13 run on the float32 core too.
  15. vivit_evblock_time: ms/clip of the dense twin and every run, alternated.
  16. option_kernels: the forms of gates before their LN at compare_ln_1024's
                     shapes (N = 4096, k = 512) and at 672 (N = 1764, k = 256),
                     as in 3.
  17-20. compare_ln_1024, compare_ln_672, stgt_672, ablate_av_672: 2 streams
                     x 16 frames in bfloat16 with launches by wrapper and by
                     form and counted GFLOPs per frame against the JAX
                     package's; one stream x 3 frames in float32 (cast off)
                     of the model cut to one windowed and one global block
                     on the card against the CPU; the eventful ms/frame
                     twice (not ablate_av_672) beside the dense twin's from
                     phase 8 or 11.
  21. vivit_pre_ln_kernels, vivit_pre_ln: ViViT-B of phase 4 with every gate
                     before its LN: the forms at its shapes, as in 3; under
                     "auto" ("v2mlp"), "v1", "v1v2" and "v3", launches by
                     wrapper and form and counted GFLOPs per clip; the TMA
                     descriptors the forced runs' warm forwards encode, as
                     in 14 ("pre"'s scratch of ln(p') among them); one clip
                     in float32 of the model cut to 2 spatial blocks on the
                     card against the CPU; "auto" and the dense twin ms/clip,
                     alternated.
  22. topk_kernels, topk_slice_vivit, topk_slice_vitdet: the groups that
                     select their own rows (in_kernel_topk, cov=None): the
                     forms at ViViT's and 672's shapes, as in 3, with exact
                     ties planted at the k-th norm in one case of each, each
                     beside its two-phase form (norms, coverage_from_norms,
                     the coverage form); path A, ViViT-B of phase 4 forced
                     to "v2mlp", and path B, spatiotemporal_672 with sharing
                     off and on and, counted only, tokenwise_672 and
                     compare_ln_672: launches by wrapper and form and counted
                     GFLOPs with the switch on (A also off); float32 with the
                     switch off and on (selections, probabilities, tokens);
                     ms/clip and ms/frame off and on, alternated.
  23. blend_kernels, blend_slice: put_rows as the scatter-blend kernel
                     (USE_PALLAS_BLEND) at stgt_672's buffer widths and at
                     ViViT's, with and without a mask and with a duplicated
                     index, bit for bit against its plain version, beside
                     Tensor.scatter, each with its device microseconds a call
                     (torch.profiler; where it catches no device event,
                     CUDA events around calls queued behind a sleeping
                     kernel), the share of the bound they reach,
                     the kernels a call launches, its allocations and the
                     host microseconds of one call and of the library call's
                     (row_copy_readings; a call that is not one launch of
                     scatter_blend_kernel and one allocation fails the
                     phase); stgt_672 with the switch on: launches,
                     counted GFLOPs, tokens bit-identical to the switch-off
                     run in float32 and bfloat16, ms/frame off and on.
  24. unwired_kernels, unwired_path: the four kernels no path of the JAX
                     package calls, at the shapes of the paths whose work
                     each does, as in 3 (the row scatter and gather bit for
                     bit): scatter_rows_inplace and gather_rows at
                     stgt_672's buffers (C and 3C, k = 256; with and
                     without a mask; float32 values into the buffer) and
                     the paper's ViViT's qkv buffer (12 views, k = 24);
                     the row scatter and gather with the readings of 23
                     (row 19, the control, one launch of scatter_rows_kernel
                     and no allocation; row 20 one of gather_rows_kernel and
                     one); fused_attention at ViViT's spatial and temporal
                     shapes, without and with the matmul-2 cast;
                     window_attention_grid at 672 (with and without the
                     rel-pos tables) and on 1024's padded map; the host
                     microseconds of one bfloat16 call of the grid form at
                     each shape, and of its library call (unwired_host).
                     Then the phase's own path,
                     counted, twice: each wrapper on those inputs in float32
                     (TF32 off) against the ported kernel that does its
                     work on the model paths: the row kernels against
                     put_rows and take_rows bit for bit (the cast also into
                     a bfloat16 buffer), fused_attention against the global
                     window_attention (its cast form beside it), the grid
                     form against the windowed window_attention at 672 and
                     the padded one at 1024 over the partition of the same
                     map, each within 1e-5 scaled at the image's rows;
                     fused_attention also on a batch slice of a larger
                     tensor (the same result) and a slice of its last axis
                     (refused, or else the same result); then each entry
                     in bfloat16 against its plain version. The attention
                     launches of each run are read by body.
  25. attention_bodies: the launches of window_attention, fused_attention,
                     window_attention_grid and kernel A
                     (qkv_attention_group), of the A.V kernel's two
                     forms (softmax_select_matmul and its logits form) and
                     of the rel-pos bias add's two (relpos_bias_add,
                     relpos_bias_add_v2), by body, of every counted run
                     above; each run was checked as it was read: in
                     bfloat16 only the tensor-core bodies
                     (csrc/attention_tc.cuh, csrc/av_softmax_tc.cuh) and
                     the rel-pos add's tiled one (csrc/relpos_tile.cuh),
                     in float32 (the A.V kernel's matmul-2 cast included)
                     only the CUDA-core ones (window_attention.
                     attention_body's, av_softmax.av_softmax_body's and
                     relpos.relpos_body's rules); both rel-pos wrappers ran
                     the tiled body in some bfloat16 run and the CUDA-core
                     one in some float32 run.
  26. row_bodies:     the launches of the row passes (ln_norms, block_select_scatter,
                     block_select_p, ln_select, and the select, LN and
                     norms stages of qkv_attention_group, proj_group,
                     dense_mlp_residual, gate_group_mlp, gate_group_linear,
                     ln_select_matmul and select_linear_skip_norms) by
                     body, of every counted run above, each checked as it
                     was read: the warp-per-row body (csrc/row_pass.cuh)
                     only, at every path's shapes in both dtypes; each of
                     them launched on it in bfloat16 and in float32.
  27. gemm_cores:     the GEMM rows' launches (kernels A and B, the MLP
                     rows, rows 12 and 13) by core of every counted run
                     above, each checked
                     as it was read: in bfloat16 only the wgmma core
                     (csrc/gemm_tc.cuh), in float32 only the CUDA-core tile
                     of csrc/gemm.cuh, each row in both; the TMA
                     descriptors encoded in all, the cache's size, and the
                     timed runs of every path that encoded any after their
                     warm-up (their scratch at new addresses).
  28. threshold_kernels: the forms a threshold policy (TokenNormThreshold)
                     gives the kernels (kernel_check.THRESHOLD), as in 3:
                     gate_group_mlp on a coverage of fewer than kcap rows
                     at the paper's ViViT's shape and k = N = 197 (path
                     A's), beside the top-k form at k = N; gate_group_linear's
                     "none" and "post" forms at 672, rows 9, 10 and 11
                     with masked-off slots keyed to the marker N at 1024
                     (k = 512; rows 9 qkv and 11 also at k = N = 4096,
                     beside row 9's qkv top-k form), and the A.V kernel over ViTDet-1024's 4096
                     unpooled keys with a batch row that covers none.
  29. harness_vivit: path A, the evaluation harness: the port's
                     run_evaluations on configs/evaluate/vivit_kinetics400/
                     temporal_24.yml as its utils/config.py composes it
                     (12 EventfulBlocks, k = 24, 3 x 4 views), one
                     generated 64-frame clip (the synthetic override),
                     float32, swept with top-k 24 and a threshold at full
                     capacity: each entry's launches (counts set to 0
                     before and read after), finite probabilities,
                     top-1/top-5, counts and ms per clip.
  30. harness_vitdet: path B: run_evaluations with evaluate_vitdet_metrics on
                     threshold_1024.yml (thresholds 0.2, 1.0, 5.0; buckets
                     512-4096; the ladder captured, one frame step for
                     every capacity) at full width and depth, float32, one
                     generated video of 5 raw 720 x 1280 frames through the
                     port's VIDResize (long edge 1024): per threshold the
                     launches (rows 1, 9, 10, 11 and 8 per incremental run,
                     escalated runs included), finite detections, mAP,
                     counts, ms per frame, escalations and frames per
                     bucket level; then 3 frames of the backbone cut to
                     VITDET_CHECK_DEPTH blocks through the bucketed dispatch
                     at threshold 0.2, card against CPU: the same
                     escalations and levels, valid selections differing in
                     at most 0.1 %, counts within 1e-6 and tokens within
                     1e-3 where every selection agrees.
  31. harness_cli:    path C: python -m eventful_transformer_tpu_torch.scripts.
                     evaluate.vivit_kinetics400 synthetic_smoke as a
                     subprocess on the card (its output.txt names the card)
                     against the same config in this process with
                     model.device=cpu: the same metrics.csv, counts.csv
                     within 1e-6.
  32. ats_kernels, ats_path: row 5 (dense_mlp_residual) against its plain
                     version at 12 views of the token counts ATS 0.9
                     leaves the MLPs of EPIC-Kitchens ViViT-B's first,
                     third and last spatial block (361, 292, 111), as in
                     3; run_evaluations over configs/evaluate/
                     vivit_epic_kitchens/ats.yml (vanilla: ATS in every
                     spatial Block) and temporal_ats_200.yml
                     (EventfulBlock, bf16 cast, ATS 0.9, top fraction 0.5)
                     at full width and depth (12 views, 32 frames of 320 x
                     320, 401 tokens falling to 111), one generated clip,
                     float32: launches (ATS blocks run unfused: the
                     vanilla model's dense MLP kernel in every spatial
                     block and step, the temporal model's two dense
                     kernels), finite probabilities, GFLOPs per clip
                     against the JAX package's, ms per clip (the
                     evaluation and a warm apply_views); each model cut to
                     3 spatial blocks and 1 x 2 views, the cast off, in
                     float32 on the card against the CPU: probabilities
                     within 1e-5, the ATS and gate selections differing in
                     at most 0.1 %; temporal_ats_200's model again with
                     the bf16 cast on: each ATS scoring on the card made
                     again on the CPU from the same cast a and ||v||, its
                     selections differing in at most 0.1 % (the two whole
                     runs' drift reported).
  33. spatial_cache_path: configs/spatial/vivit_kinetics400/24.yml through
                     utils/spatial.py::compute_vivit_spatial on the card
                     over 2 generated clips into a temporary directory
                     (launches: the "v2mlp" MLP group's ln_norms and
                     gate_group_mlp), read back by ViViTSpatial; a
                     temporal_only model over the cache (rows 5 and 6)
                     against the full model's apply_views on the same
                     clips, within 1e-6; one utils/profiling.trace around
                     a temporal_only forward: a non-empty Chrome trace with
                     the card's kernels in it.
  34. time_entry_points: python -m eventful_transformer_tpu_torch.scripts.
                     time.vivit_epic_kitchens temporal and .vitdet_vid
                     spatiotemporal_672 as python -m runs them (runpy),
                     one after the other in one subprocess on the card,
                     n_items=1 over a generated clip and a generated VID
                     video (the ViTDet entry's pre, mid and post segments
                     each a captured step): each times.csv entry positive,
                     output.txt naming the card.
  35. coco_kernels, coco_path: rows 5 (dense_mlp_residual), 6 (window_attention,
                     windowed and padded) and 17 (relpos_bias_add_v2) at
                     ViTDet-B COCO's shapes (one stream, N = 4096, 25 windows,
                     4096 x 4096 logits), as in 3; configs/models/
                     vitdet_b_coco.yml (dense, the 3-stage cascade and its
                     mask head, 80 classes) at full width and depth through
                     ViTDet.apply, bfloat16, 2 generated 1024 x 1024 frames:
                     launches, detections and 28 x 28 masks, GFLOPs per frame
                     against the JAX package's, ms per frame, the peak of
                     allocated memory; check 1, the model cut to
                     VITDET_CHECK_DEPTH blocks in float32 on the card
                     against the CPU (tokens, detections, masks); check 2,
                     the card's full-depth pyramid through float32 copies of
                     the RPN and the cascade and mask heads on both devices.
  36. train_kernels, train_path: rows 5 and 6 at the fine-tune's validation
                     shape (192 x 17), as in 3; configs/train/
                     vivit_kinetics400/final_24.yml over a generated cache
                     (32 train, 16 validation clips): the train entry point
                     as python -m runs it, one epoch from a seed .npz the
                     port wrote (its printed losses, its output weights read
                     back: frozen weights unchanged, the last validation loss
                     recomputed); one batch in float32 on the card against
                     the CPU (loss, gradients, the parameters after one
                     AdamW step); timed steps (loss and ms a step, the peak
                     of allocated memory, no kernel launched); a validation
                     batch (rows 5 and 6); the grad guard; a save_params /
                     load_params round trip.
  37. parallel_kernels, parallel_paths: the kernels of the three multi-process
                     paths at their shapes in float32 (the harness's dtype),
                     as in 3; then one rank under torchrun (python -m
                     torch.distributed.run --standalone --nproc_per_node=1
                     chip_smoke.py --parallel-rank <out>, NCCL at world size
                     1) runs (a) ulysses_smoke_672 through
                     evaluate_vitdet_metrics_sp, (b) spatiotemporal_672 at
                     k = 512 through evaluate_vitdet_metrics_dp, each over one
                     generated 3-frame video whose ground truth the plain
                     run's detections give, and (c) the vivit_kinetics400
                     entry point with data_parallel=true on temporal_24,
                     each against the same configuration run in that
                     process without the option: metrics, counts and
                     launches by wrapper equal, (a) dense_mlp_residual 12
                     times a frame; the backend, world size and seconds of
                     each run.
  38. detection_losses: ViTDet-B VID at 672 (vitdet_b_vid.yml's standard
                     heads on base_672's dense backbone), float32, one
                     generated frame: the RPN head's logits and deltas over
                     all 112,818 anchors, propose(training=True), rpn_losses,
                     sample_proposals and fast_rcnn_losses on the box head's
                     outputs for the sampled proposals, on the card and
                     again on the CPU from the card's head outputs with the
                     same uniforms: the samples equal, the four losses and
                     their gradients (logits, deltas, class scores, predicted
                     boxes) within 1e-5 relative; the valid proposals of the
                     training pair's 1000.
  39. pipeline_path: in the rank of 37, the ViViT-B K400 spatial stack of
                     phase 4 (12 EventfulTokenwiseBlocks, k = 98, "v4",
                     bf16) over one clip's 16 tubelet steps (the bench's 2
                     x 4 views) through make_pipelined_backbone at P = the
                     world size, against ViTBackbone.run_blocks in that
                     process: outputs and every state tensor equal
                     (torch.equal), launches by wrapper too (ln_norms once
                     a step, kernels A, B and C once a block and step, the
                     global window_attention on the flush).
  40. tp_paths:      in the same rank, ViViT-B K400 with dense blocks (3 x 4
                     views of 32 frames at 224, float32) on
                     best_dp_tp_mesh(max_tp=2), 1 x 1 at world size 1:
                     apply_views against the model unsharded, equal and
                     launching rows 5 and 6; two make_sharded_train_step
                     steps (SGD, momentum 0.9) against two plain autograd
                     steps from the same generators, losses and parameters
                     equal, no kernel launched; ms a step and the peak of
                     allocated memory.
  41. dryrun:        in the same rank, dryrun_multichip at the world size:
                     the dp x tp train step, the pipelined eventful stack,
                     Ulysses and DP ViTDet evaluation at tiny shapes.
  42. tp_eventful_kernels, tp_eventful_paths: rows 6 (global, spatial and
                     temporal) and 8 at a tp = 2 rank's width (C = 384, 6
                     heads), float32, as in 3; then two processes under
                     torchrun (EVT_DIST_BACKEND=gloo, chip_smoke.py
                     --tp-eventful-rank <out>) on the one card, tp = 2:
                     temporal_24 (EventfulBlock, k = 24, av_kernel on, its
                     bf16 cast off; the cast-on run reported), the tokenwise
                     k = 98 model and EPIC-Kitchens ats.yml, ViViT-B at full
                     width and depth, one clip of 1 x 4 views, float32,
                     each against its unsharded unfused run on that rank:
                     probabilities within 1e-4, every selection equal,
                     launches per rank by wrapper (row 8 180 and row 6 4;
                     row 6 196; row 6 4); two SGD steps at 2 spatial blocks
                     against plain autograd steps, no kernel launched; and
                     scripts/misc/measure_vivit_buckets.py at one capacity,
                     one clip, one timed call.
  43. nms_kernel:     (inside 12) row 22, csrc/nms.cu, on the inputs the
                     e2e eventful model's flush frame gives its two NMS
                     calls (the RPN's 4096 candidates, max_out 300 at IoU
                     0.7; the ROI heads' 4096, max_out 100 at 0.5) and on
                     the contract cases of kernel_check.nms_inputs (clusters
                     with tied scores, ties, IoUs at the float32 threshold
                     and one ulp either side, chains 12 deep, all -inf,
                     fewer valid than max_out) at those shapes and at 900
                     boxes: indices and mask equal to the plain version's,
                     ms of both, device microseconds a call and of its one
                     kernel, the kernels a call as the profiler names them
                     (1), the bound (the larger of the bytes of boxes,
                     scores, indices and mask and 15 float32 steps for each
                     IoU the greedy walk needs), and the kernel's shared
                     memory and scratch bytes (the design's own, outside
                     the bound); 12 itself counts 2 launches a frame and 0
                     NMS host reads.
  44. graph_paths:   each captured step against its eager step (graph_sides:
                     eager, graph, graph, eager; outputs, final state,
                     counts and launches bit for bit; ms, busy share, peak
                     memory): A, the flagship ViViT (after 4); B, temporal_24
                     and its bucketed threshold (after 14); C, ViTDet-B's
                     whole frame at 1024 and 672, eventful and dense, the
                     tokens, the detections and 0 NMS host reads (after 8
                     and 11); the time entry point's pre, mid and post
                     segments at 672, each tokens, detections and state
                     (after 8); COCO, the cascade and mask heads' frame (after
                     35); D, threshold_1024's bucketed ladder in float32, one
                     frame step for every capacity over one static state,
                     the kept detections, counts, escalations and frames
                     per level (after 31).
The times are a record, not a claim.

Phases 25-27 run last, after 28-37, and read their runs too (the
multi-process paths' runs are in their own process and not among them). Then the
whole run's seconds, the card's name and power limit, one JSON
line with every kernel's numbers, and last ``{"ok": true, "device":
{...}}``. Any failed check
raises, and the script exits non-zero; without a CUDA device it raises
before printing any result. Imports nothing of JAX.
"""

import contextlib
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

# Weights come from this seed; the input is the bench's: rng seed 0,
# standard normal, 2 clips x 4 views x 32 frames x 3 x 224 x 224.
SEED = 0
CLIPS, VIEWS, FRAMES, SIZE = 2, 4, 32, 224
N_TOKENS, K = 197, 98
STEPS = FRAMES // 2  # tubelet [2, 16, 16]: 16 steps, step 0 a flush
DEPTH, TEMPORAL_DEPTH = 12, 4
# The JAX package's counted GFLOPs/clip at this point (BENCH_r05.json)
GFLOPS_DENSE, GFLOPS_EVENTFUL = 1119.86, 615.18
# One clip in float32, card against CPU: the sums run in other orders, so
# norms differ in their last bits and a near tie at the k-th norm can
# select another token; each such flip moves one token's update.
PROB_TOL = 1e-5  # max |probability difference|, probabilities ~ 1/400
MAX_FLIP_SHARE = 1e-3  # of all gate selections made in the clip

# ViTDet-B (configs/evaluate/vitdet_vid/spatiotemporal_{672,1024}.yml and
# base_{672,1024}.yml; bench.py:121-259): 2 streams, 16 frames per call,
# frame 0 a flush, k = 256 tokens, 8 windowed and 4 global blocks.
VITDET_STREAMS, VITDET_FRAMES, VITDET_K = 2, 16, 256
VITDET_WINDOWED, VITDET_GLOBAL = 8, 4
VITDET_DEPTH = VITDET_WINDOWED + VITDET_GLOBAL
# Per size: the token count; the launches of an eventful incremental frame
# beyond those both regimes make (ln_norms once, block_select_p and
# block_scatter_rows in each windowed qkv group, and the global blocks' A.V
# kernel or rel-pos bias add); the kernel checks' inputs (the unpadded
# windows of the resident qkv buffer, the pooled key grid), the rel-pos
# bias add's key grids (the dense twin's, the pooled) and the kernels of
# the path; and the JAX package's counted FLOPs per
# stream, from ``python scripts/misc/count_vitdet_672.py --size <size>``
# (the JAX package on the CPU, one block of each kind at full width): a
# global EventfulBlock's incremental count is base + per_valid_share * f, f
# the valid share of its pooled, deduplicated index slots.
VITDET = {
    672: dict(
        n=42 * 42,
        step_launches=dict(gate_group_linear=VITDET_GLOBAL + VITDET_DEPTH,
                           gate_group_mlp=VITDET_DEPTH),
        inputs=dict(window=(14, 14), pool=(21, 21)),
        keys=dict(dense=(42, 42), pooled=(21, 21)),
        kernels=("ln_norms", "gate_group_mlp", "dense_mlp_residual", "window_attention_windowed",
                 "gate_group_linear", "gate_group_linear_post", "block_select_p",
                 "block_scatter_rows"),
        flops=dict(
            position_add=1354752.0, dense_windowed=13077590400.0,
            dense_global=17468341632.0, windowed_flush=13077590400.0,
            windowed_incremental=2397776256.0, global_flush=13770757728.0,
            global_incremental_base=1995139728.0,
            global_incremental_per_valid_share=1040646144.0, windowed_once_per_forward=0.0,
        ),
    ),
    1024: dict(
        n=64 * 64,
        step_launches=dict(block_select_scatter=VITDET_GLOBAL + 2 * VITDET_DEPTH),
        inputs=dict(window=(14, 14), windows=50, pool=(32, 32), pad_window=(14, 14)),
        keys=dict(dense=(64, 64), pooled=(32, 32)),
        kernels=("ln_norms", "block_select_p", "block_scatter_rows", "block_select_scatter_qkv",
                 "block_select_scatter_proj", "block_select_scatter_mlp",
                 "softmax_select_matmul", "softmax_select_matmul_noterms",
                 "window_attention_windowed", "window_attention_padded", "dense_mlp_residual"),
        flops=dict(
            position_add=3145728.0, dense_windowed=30629228160.0,
            dense_global=55600742400.0, windowed_flush=30629228160.0,
            windowed_incremental=3433033344.0, global_flush=35770073088.0,
            global_incremental_base=2390163456.0,
            global_incremental_per_valid_share=2416115712.0, windowed_once_per_forward=2304.0,
        ),
    ),
}
RELPOS_KERNELS = ("relpos_bias_add", "relpos_bias_add_v2")
# ViTDet-B end to end (bench.py:262-370 bench_vitdet_e2e): spatiotemporal_672
# and base_672 through ViTDet.apply, one stream (RPN.propose takes batch
# 1), a flush frame then E2E_FRAMES frames per call; the kernels of that
# path at one stream, the A.V kernel's 441 pooled keys included.
E2E_SIZE, E2E_FRAMES = 672, 8
# NMS launches a frame (row 22): the RPN's batched_nms and the ROI heads'
# (the standard heads and the COCO cascade alike: the cascade runs its NMS
# once, after the last stage)
HEAD_NMS_PER_FRAME = 2
E2E_KERNELS = VITDET[672]["kernels"] + ("softmax_select_matmul",) + RELPOS_KERNELS
# The ROI heads' class scorer is initialised as in the JAX package (a
# truncated normal, std 0.01, detectron2's): every class probability of a
# random model then lies near 1/31, below the 0.05 score threshold, and no
# detection is kept. The seeded kernel is scaled by this gain (std 0.3),
# so that the run keeps detections as a trained model does.
CLS_SCORE_GAIN = 30.0
# One ViTDet clip in float32, card against CPU, without the matmul-2 cast:
# with it, the global blocks' A.V product runs in bfloat16 on both sides,
# and where cuBLAS and the CPU sum it in other orders an element rounds to
# a neighbouring bfloat16 value (0.4 % relative); that moved 92 of 16,384
# gate selections and the tokens by 1.4e-2 (scaled) in one run. In float32
# the tokens differ by summation order and by the rare flips bounded above.
VITDET_TOKEN_TOL = 1e-3
# One frame's detections in float32, card against CPU: each kept detection
# of the CPU run must have a kept detection of the card run with the same
# label, every box coordinate within DET_BOX_TOL pixels and the score
# within DET_SCORE_TOL, on at least DET_MATCH_SHARE of the larger kept
# count. Tokens that differ by summation order move boxes by about 1e-4
# pixels; a near tie at a discrete choice (the RPN's top-k, an NMS IoU at
# its threshold, the score threshold) may swap a detection, hence the
# share. The box head's flatten in (H, W, C) order, planted on the CPU,
# fails it (tests/test_torch_detection.py).
DET_BOX_TOL, DET_SCORE_TOL, DET_MATCH_SHARE = 1e-2, 1e-4, 0.95


def match_detections(got, want, pairs=None):
    """Match the kept detections of ``want`` one to one with those of
    ``got`` (dicts of boxes, scores, labels, mask, on any device) by
    label, box and score within the bounds above; ``pairs``, a list, gets
    the (got slot, want slot) of each match."""
    def kept(d):
        m = d["mask"].cpu()
        slots = torch.nonzero(m).flatten()
        return (d["boxes"].cpu().float()[m], d["scores"].cpu().float()[m], d["labels"].cpu()[m],
                slots)

    (gb, gs, gl, g_slots), (wb, ws, wl, w_slots) = kept(got), kept(want)
    free = torch.ones(len(gb), dtype=torch.bool)
    matched, box_err, score_err = 0, 0.0, 0.0
    for b, s, label, w_slot in zip(wb, ws, wl, w_slots):
        d_box = (gb - b).abs().amax(dim=-1) if len(gb) else gb.new_zeros(0)
        d_score = (gs - s).abs()
        ok = free & (gl == label) & (d_box <= DET_BOX_TOL) & (d_score <= DET_SCORE_TOL)
        if ok.any():
            j = int(torch.nonzero(ok)[0])
            free[j] = False
            matched += 1
            box_err, score_err = max(box_err, float(d_box[j])), max(score_err, float(d_score[j]))
            if pairs is not None:
                pairs.append((int(g_slots[j]), int(w_slot)))
    larger = max(len(gb), len(wb))
    return dict(kept_card=len(gb), kept_cpu=len(wb), matched=matched, max_box_diff=box_err,
                max_score_diff=score_err, ok=larger > 0 and matched >= DET_MATCH_SHARE * larger)


def match_masks(got, want):
    """match_detections, and the largest difference between the masks of
    the matched detections; ``ok`` also holds it within MASK_TOL."""
    pairs = []
    out = match_detections(got, want, pairs)
    diff = max((float((got["masks"][i].cpu().float() - want["masks"][j].cpu().float()).abs().max())
                for i, j in pairs), default=0.0)
    return dict(out, max_mask_diff=diff, ok=out["ok"] and diff <= MASK_TOL)


_START = time.perf_counter()
_LAST_EMIT = [_START, None]  # the time and the phase of the last line


# each phase's seconds (summed where a phase emits more than once); the
# phases the float32 bodies run in, whose seconds the total line repeats
# beside the script's total before those bodies were redesigned (one NVIDIA
# H100 80GB HBM3 at 700 W, PERF.md section 6)
PHASE_SECONDS = {}
F32_PHASES = ("f32_bodies", "threshold_kernels", "harness_vivit", "harness_vitdet",
              "harness_cli", "ats_kernels", "ats_path", "spatial_cache_path", "train_kernels",
              "train_path", "parallel_kernels", "parallel_paths", "tp_paths",
              "tp_eventful_kernels", "tp_eventful_paths")
EARLIER_TOTAL_S = 782.5


def emit(phase, **fields):
    """One JSON line; ``phase_s``: the seconds since the previous line, the
    phase's own time."""
    now = time.perf_counter()
    fields["phase_s"] = round(now - _LAST_EMIT[0], 3)
    PHASE_SECONDS[phase] = round(PHASE_SECONDS.get(phase, 0.0) + fields["phase_s"], 3)
    _LAST_EMIT[:] = [now, phase]
    print(json.dumps({"phase": phase, **fields}), flush=True)


def vivit_config(eventful):
    block = dict(dim=768, heads=12, mlp_ratio=4)
    return dict(
        classes=400, input_shape=[FRAMES, 3, SIZE, SIZE], normalize_mean=0.45,
        normalize_std=0.225, spatial_views=1, temporal_stride=2, temporal_views=VIEWS,
        tubelet_shape=[2, 16, 16],
        spatial_config=dict(
            depth=DEPTH, position_encoding_size=[14, 14],
            block_class="EventfulTokenwiseBlock" if eventful else "Block",
            block_config=block,
        ),
        temporal_config=dict(
            depth=TEMPORAL_DEPTH, position_encoding_size=[16], block_config=block
        ),
    )


def phase_env():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's main path needs one")
    import eventful_transformer_tpu_torch
    from eventful_transformer_tpu_torch.ops import _build

    package = Path(eventful_transformer_tpu_torch.__file__).resolve().parent
    if package.parent != REPO:
        raise RuntimeError(f"imported the port from {package}, not from this checkout")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    nvcc = subprocess.run(
        [_build.nvcc_path(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit(
        "env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=nvcc, nvidia_smi=smi,
        device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
    )
    return smi


def phase_build():
    from eventful_transformer_tpu_torch.ops import _build

    start = time.perf_counter()
    _build.load_library()
    seconds = time.perf_counter() - start
    log = _build.library_path().with_suffix(".log").read_text()
    spills = sorted({
        line.strip() for line in log.splitlines()
        if "spill" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill")
    })
    emit("build", seconds=round(seconds, 3), library=_build.library_path().name,
         spill_lines=spills, gemm_tc_ptxas=gemm_tc_ptxas(log), f32_ptxas=f32_ptxas(log))


def f32_ptxas(log):
    """ptxas's registers and spills of every instantiation of the two
    float32 bodies (gemm.cuh's gemm_simt_kernel, av_softmax.cu's
    av_simt_kernel), each once."""
    out, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            entry = name if "gemm_simt_kernel" in name or "av_simt_kernel" in name else None
            if entry is not None:
                out.setdefault(entry, dict(kernel=entry))
        elif entry is not None and "spill stores" in line:
            words = line.split()
            out[entry]["spill_bytes"] = int(words[4]) + int(words[8])
        elif entry is not None and "Used" in line and "registers" in line:
            words = line.split()
            out[entry]["registers"] = int(words[words.index("Used") + 1])
            entry = None
    return list(out.values())


# the epilogue functors of the wgmma core's instantiations, as in their names
EPILOGUES = ("BiasGeluEpilogue", "ResidualEpilogue", "BiasEpilogue", "BiasScatterEpilogue",
             "BiasSkipEpilogue", "QkvEpilogue", "ProjEpilogue", "PartialSum", "StoreEpilogue")


def gemm_tc_ptxas(log):
    """ptxas's report (-Xptxas=-v) of every instantiation of the wgmma core
    and its split sum in the build log: registers, spills, barriers, each
    once."""
    out, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            entry = name if ("gemm_tc_kernel" in name or "splitk_epilogue_kernel" in name) \
                else None
            if entry is not None and entry not in out:
                kind = "gemm_tc_kernel" if "gemm_tc_kernel" in entry else "splitk_epilogue"
                epi = next((e for e in EPILOGUES if e in entry), "?")
                out[entry] = dict(kernel=kind, gather="ILb1" in entry, epilogue=epi)
        elif entry is not None and "spill stores" in line:
            words = line.split()
            out[entry]["spill_bytes"] = int(words[4]) + int(words[8])
        elif entry is not None and "Used" in line and "registers" in line:
            words = line.split()
            out[entry]["registers"] = int(words[words.index("Used") + 1])
            entry = None
    return list(out.values())


def check_kernels(phase, device, cases, dtypes=(torch.float32, torch.bfloat16), width=(768, 12)):
    """Each kernel of ``cases`` [(tag, batch, N, k, names, make_inputs
    keywords)] at ``width`` (C, heads) against its plain version, in each
    of ``dtypes``, with both
    timed, the bound of the card for the same work, and the one PyTorch
    call that computes it where there is one; a group that selects its own
    rows also beside its two-phase form (``two_phase_ms``); the MLP rows
    with their launches by GEMM core in the row's checks and times, each on
    the core ``gemm_core.gemm_core`` gives it. Rows keyed (name, dtype,
    tag)."""
    from eventful_transformer_tpu_torch.ops import kernel_check

    results = {}
    for dtype in dtypes:
        for tag, bsz, n, k, names, inputs in cases:
            d = kernel_check.make_inputs(bsz, n, *width, k, dtype, device, seed=SEED, **inputs)
            for name in names:
                bound_ms, bound_by = kernel_check.bound(name, d)
                library = kernel_check.library_call(name, d)
                two_phase = kernel_check.two_phase_call(name, d)
                kernel_check.reset_launches()
                outputs = kernel_check.errors(name, d)
                wrapper = kernel_check.KERNELS[name][0]
                launched = wrapper.launches
                bodies = dict(getattr(wrapper, "body_launches", {}))
                row_bodies = getattr(wrapper, "row_body_launches", None)
                row_bodies = None if row_bodies is None else dict(row_bodies)
                row = results[(name, dtype, tag)] = dict(
                    kernel=name, dtype=str(dtype).split(".")[-1], tag=tag, batch=bsz, n=n,
                    outputs=outputs,
                    ms=kernel_check.time_ms(name, d),
                    plain_ms=kernel_check.time_ms(name, d, plain=True),
                    bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=None if library is None else kernel_check.time_call(library),
                )
                if two_phase is not None:
                    row["two_phase_ms"] = kernel_check.time_call(two_phase)
                if row_bodies is not None:
                    row["row_body_launches"] = row_bodies
                    kernel_check.check_row_bodies({wrapper.__name__: row_bodies},
                                                  f"{phase} {name} {tag}")
                if (wrapper.__name__ in kernel_check.ROW_COPY_KERNELS
                        or wrapper.__name__ in kernel_check.ROW_PASS_KERNELS):
                    row.update(row_copy_readings(name, d, bound_ms, library, launched))
                if name.startswith(("softmax_select_matmul", "relpos_bias_add")):
                    row.update(body_readings(name, d, bound_ms, bodies, dtype,
                                             f"{phase} {name} {tag}"))
                if hasattr(wrapper, "core_launches"):
                    row["core_launches"] = dict(wrapper.core_launches)
                    kernel_check.check_cores({wrapper.__name__: row["core_launches"]}, dtype,
                                             f"{phase} {name} {tag}")
            del d
            torch.cuda.empty_cache()
    emit(phase, bounds=dict(float32_scaled=kernel_check.F32_SCALED, **kernel_check.BF16_BOUNDS),
         rows=list(results.values()))
    for (name, dtype, tag), row in results.items():
        for out in row["outputs"]:
            if not out["ok"]:
                raise AssertionError(f"{name} {dtype} {tag} output {out['output']}: {out}")
        if not row.get("one_launch", True):
            raise AssertionError(f"{name} {dtype} {tag}: not one launch of its kernel and "
                                 f"its outputs' allocations a call: {row}")
    return results


def body_readings(name, d, bound_ms, bodies, dtype, where):
    """Row 8 (the A.V kernel) and rows 16-17 (the rel-pos bias add) beside
    their ``ms``: ``bodies``, the launches by body of the checked call
    (checked: by ``av_softmax.av_softmax_body`` and ``relpos.relpos_body``
    at the paths' shapes, bfloat16 only the tensor-core body, or the tiled
    one of rows 16-17, float32 and row 8's matmul-2 cast only the CUDA-core
    one), and its device
    microseconds a call from CUDA events around calls queued behind a
    sleeping kernel (``kernel_check.queued_device_us``), with the share of
    the bound they reach."""
    from eventful_transformer_tpu_torch.ops import kernel_check

    wrapper = kernel_check.KERNELS[name][0]
    relpos = name.startswith("relpos")
    state = d["rp_x"] if relpos else d["p_a"]
    fast = "tile" if relpos else "tc"
    want = fast if dtype == torch.bfloat16 and state.dtype == torch.bfloat16 else "simt"
    if bodies[want] != 1 or sum(bodies.values()) != 1:
        raise AssertionError(f"{where}: body launches {bodies}, expected one {want} launch")
    dd = {key: v.clone() if torch.is_tensor(v) else v for key, v in d.items()}
    us = kernel_check.queued_device_us(lambda: kernel_check._invoke(name, wrapper, dd))
    return dict(body_launches=bodies, device_us=us, device_us_by="events behind a sleep",
                bound_share=bound_ms * 1e3 / us)


# the allocations a call of each row-copy wrapper makes: its output (rows 18
# and 20), none for the scatters in place (rows 11 and 19)
ROW_COPY_ALLOCATIONS = {"scatter_blend": 1, "gather_rows": 1, "scatter_rows_inplace": 0,
                        "block_scatter_rows": 0}


def expected_allocations(name):
    """The allocations one call of entry ``name`` of rows 11, 18-20, 1, 9,
    10 or 14 makes: ROW_COPY_ALLOCATIONS for rows 11 and 18-20; its new outputs for
    rows 1 (the norms) and 9 (y and the norms where the form has them; p
    and b are updated in place, and the slot is found in the kernel); none
    for rows 10 and 14 (p in place)."""
    from eventful_transformer_tpu_torch.ops import kernel_check

    wrapper, outputs = kernel_check.KERNELS[name][0].__name__, kernel_check.KERNELS[name][4]
    if wrapper in ROW_COPY_ALLOCATIONS:
        return ROW_COPY_ALLOCATIONS[wrapper]
    return len([out for out in outputs if out not in ("p", "b")])


def row_copy_readings(name, d, bound_ms, library, launched):
    """Rows 11 and 18-20 (the row-copy kernels) and rows 1, 9, 10 and 14
    (the warp-per-row pass) beside their ``ms``: device microseconds a
    call (torch.profiler, or CUDA events around calls queued behind a
    sleep where the profiler caught no device event:
    ``kernel_check.row_copy_profile``) and the share of the bound they
    reach, the kernels one call launches, its allocations, the host
    microseconds of one call and of the library call's; ``one_launch``
    false unless the call counted one launch (``launched``), allocated
    what :func:`expected_allocations` says and, where the profiler caught
    its kernels, launched its own kernel once."""
    from eventful_transformer_tpu_torch.ops import kernel_check

    row = kernel_check.row_copy_profile(name, d, bound_ms)
    row["one_launch"] = (row["one_launch"] is not False and launched == 1
                         and row["allocations_per_call"] == expected_allocations(name))
    row["host_us"] = kernel_check.kernel_host_us(name, d)
    row["library_host_us"] = None if library is None else kernel_check.host_us(library)
    return row


# The wrappers whose GEMMs take a core by ops/gemm_core.py::gemm_core (rows
# 2-5, 7, 12, 13), and the entries and shapes of their GEMM launches' profile
# (phase gemm_core): (entry, path, batch, N, k).
GEMM_ROWS = ("qkv_attention_group", "proj_group", "gate_group_mlp", "dense_mlp_residual",
             "gate_group_linear", "ln_select_matmul", "select_linear_skip_norms")
GEMM_PROFILE = (
    ("qkv_attention_group", "vivit", 8, 197, 98),
    ("proj_group", "vivit", 8, 197, 98),
    ("dense_mlp_residual", "vivit", 8, 197, 98),
    ("gate_group_mlp", "vivit", 8, 197, 98),
    ("gate_group_mlp_topk", "topk_slice_vivit", 8, 197, 98),
    ("ln_select_matmul_pre", "vivit_pre_ln", 8, 197, 98),
    ("select_linear_skip_norms_noln", "vivit_pre_ln", 8, 197, 98),
    ("dense_mlp_residual", "temporal", 8, 17, 17),
    ("gate_group_mlp", "vivit_evblock", 12, 197, 24),
    ("ln_select_matmul_post", "vivit_evblock", 12, 197, 24),
    ("ln_select_matmul_none", "vivit_evblock", 12, 197, 24),
    ("select_linear_skip_norms", "vivit_evblock", 12, 197, 24),
    ("dense_mlp_residual", "vitdet_672", 2, 1764, 256),
    ("gate_group_mlp", "vitdet_672", 2, 1764, 256),
    ("gate_group_mlp_pre", "compare_ln_672", 2, 1764, 256),
    ("gate_group_mlp_topk", "topk_slice_vitdet", 2, 1764, 256),
    ("gate_group_linear_post", "vitdet_672", 2, 1764, 256),
    ("gate_group_linear", "vitdet_672", 2, 1764, 256),
    ("gate_group_linear_pre", "compare_ln_672", 2, 1764, 256),
    ("dense_mlp_residual", "vitdet_e2e", 1, 1764, 256),
    ("gate_group_linear_post", "vitdet_e2e", 1, 1764, 256),
    ("gate_group_linear", "vitdet_e2e", 1, 1764, 256),
    ("dense_mlp_residual", "vitdet_1024", 2, 4096, 256),
)


def gemm_shapes(name, d):
    """(M, K, N) of each GEMM one call of entry ``name`` makes on ``d``, in
    launch order: kernel A's qkv and kernel B's projection over the B.N
    rows, rows 12 and 13's linear over the B.N rows too (qkv for row 12's
    "post" and "pre", else the projection), row 7's over the k rows (qkv
    for "post" and "pre"), the MLP's two (over the k rows for kernel C)."""
    bsz, n, c = d["x"].shape
    if name.startswith("gate_group_linear"):
        qkv = name.startswith(("gate_group_linear_post", "gate_group_linear_pre"))
        return [(bsz * d["k"], c, 3 * c if qkv else c)]
    if name in ("qkv_attention_group", "ln_select_matmul_post", "ln_select_matmul_pre"):
        return [(bsz * n, c, 3 * c)]
    if name in ("proj_group", "ln_select_matmul_none") or name.startswith(
            "select_linear_skip_norms"):
        return [(bsz * n, c, c)]
    hidden = d["w1"].shape[-1]
    m = bsz * n if name == "dense_mlp_residual" else bsz * d["k"]
    return [(m, c, hidden), (m, hidden, c)]


def gemm_launches(entries, calls=5):
    """Each GEMM of one bfloat16 call of each entry, from ``torch.profiler``'s
    device events over one warm-up call and ``calls`` calls of every entry,
    all in one profiler session: ``entries`` yields (name, d) in turn. For
    each entry, [(GEMM 1, 2.., (M, K, N), its plan, device us a call: its
    wgmma launch and, where the plan splits K, the split sum)]."""
    from torch.profiler import ProfilerActivity, profile

    from eventful_transformer_tpu_torch.ops import gemm_core, kernel_check

    order = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for name, d in entries:
            shapes = gemm_shapes(name, d)
            plans = [gemm_core.gemm_plan(*shape) for shape in shapes]
            order.append((name, shapes, plans))
            for _ in range(calls + 1):
                kernel_check.call(name, d)
            torch.cuda.synchronize()
    events = sorted(
        (e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")
         and ("gemm_tc_kernel" in e.name or "splitk_epilogue_kernel" in e.name)),
        key=lambda e: e.time_range.start,
    )
    out, at = [], 0
    for name, shapes, plans in order:
        # a call's launches: each GEMM's wgmma kernel, then its split sum
        owner, split_sum = [], []
        for g, plan in enumerate(plans):
            owner += [g] * (1 + (plan.split > 1))
            split_sum += [False] + [True] * (plan.split > 1)
        mine = events[at + len(owner):at + (calls + 1) * len(owner)]  # past the warm-up call
        at += (calls + 1) * len(owner)
        if len(mine) != calls * len(owner) or any(
                ("splitk" in e.name) != split_sum[i % len(owner)] for i, e in enumerate(mine)):
            raise AssertionError(f"gemm_core {name}: GEMM launches out of order, expected "
                                 f"{split_sum} a call")
        us = [0.0] * len(shapes)
        for i, e in enumerate(mine):
            us[owner[i % len(owner)]] += e.time_range.elapsed_us() / calls
        out.append([(g + 1, shapes[g], plans[g], us[g]) for g in range(len(shapes))])
    if at != len(events):
        raise AssertionError(f"gemm_core: {len(events)} GEMM launches, expected {at}")
    return out


def phase_gemm_core(device, smi):
    """Each GEMM launch of rows 2-5, 7, 12 and 13 at the paths' shapes in
    bfloat16: its plan on the wgmma core, its device microseconds
    (profiler) and its TFLOP/s."""
    from eventful_transformer_tpu_torch.ops import kernel_check

    def entries():
        inputs = {}
        for name, _, bsz, n, k in GEMM_PROFILE:
            if (bsz, n, k) not in inputs:  # one set of inputs per shape, in turn
                inputs.clear()
                torch.cuda.empty_cache()
                inputs[bsz, n, k] = kernel_check.make_inputs(bsz, n, 768, 12, k, torch.bfloat16,
                                                            device, seed=SEED)
            yield name, inputs[bsz, n, k]
        inputs.clear()
        torch.cuda.empty_cache()

    rows = []
    for (name, path, *_), gemms in zip(GEMM_PROFILE, gemm_launches(entries())):
        for gemm, (m, kk, nn), plan, us in gemms:
            rows.append(dict(
                kernel=name, path=path, gemm=gemm, m=m, k=kk, n=nn, tiles=[plan.tiles_m, plan.tiles_n],
                split=plan.split, blocks=plan.blocks, device_us=us,
                tflops=2.0 * m * kk * nn / us / 1e6,
            ))
    emit("gemm_core", card=smi, peak_tflops=989.0, rows=rows)
    return rows


# The float32 GEMM rows and row 8's float32 forms at their paths' shapes
# (PERF.md section 6's rows 4t, 5m, 5a, 5t, 5s, 4v, 5p, 4p, 7p; 8t, 8p, 8e and
# the 197-key logits form): (entry, row, batch, N, k, make_inputs keywords,
# (C, heads)), profiled by phase f32_bodies.
F32_P672 = dict(window=(14, 14), pool=(21, 21))
F32_GEMM_PROFILE = (
    ("gate_group_mlp_threshold", "4t", 12, 197, 197, {}, (768, 12)),
    ("dense_mlp_residual", "5m", 12, 197, 197, {}, (768, 12)),
    ("dense_mlp_residual", "5a", 12, 361, 361, {}, (768, 12)),
    ("dense_mlp_residual", "5t", 192, 17, 17, {}, (768, 12)),
    ("dense_mlp_residual", "5s", 12, 17, 17, {}, (768, 12)),
    ("gate_group_mlp", "4v", 12, 197, 24, dict(pool=(1, 197)), (768, 12)),
    ("dense_mlp_residual", "5p", 1, 1764, 512, F32_P672, (768, 12)),
    ("gate_group_mlp", "4p", 1, 1764, 512, F32_P672, (768, 12)),
    ("gate_group_linear", "7p", 1, 1764, 512, F32_P672, (768, 12)),
    ("gate_group_linear_post", "7p", 1, 1764, 512, F32_P672, (768, 12)),
)
F32_AV_PROFILE = (
    ("softmax_select_matmul_threshold", "8t", 1, 4096, 512,
     dict(window=(14, 14), windows=50, pool=(64, 64), pad_window=(14, 14), relpos_keys=(8, 8)),
     (768, 12)),
    ("softmax_select_matmul", "8p", 1, 1764, 512, F32_P672, (768, 12)),
    ("softmax_select_matmul_noterms", "8e", 4, 197, 24, dict(window=(4, 6), pool=(1, 197)),
     (384, 6)),
    ("softmax_select_matmul_logits_noterms", "8l", 12, 197, 24,
     dict(window=(4, 6), pool=(1, 197)), (768, 12)),
)
F32_PEAK_TFLOPS = 67.0  # float32 FMA on the CUDA cores, H100 SXM peak


def simt_launches(entries, calls=5):
    """Each float32 GEMM launch of one call of each entry, from
    ``torch.profiler``'s device events over one warm-up call and ``calls``
    calls of every entry in one profiler session: ``entries`` yields (name, d). For
    each entry [(GEMM 1, 2.., (M, K, N), its plan, device us a call)]."""
    from torch.profiler import ProfilerActivity, profile

    from eventful_transformer_tpu_torch.ops import gemm_core, kernel_check

    order = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for name, d in entries:
            shapes = gemm_shapes(name, d)
            order.append((name, shapes, [gemm_core.simt_plan(*shape) for shape in shapes]))
            for _ in range(calls + 1):
                kernel_check.call(name, d)
            torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")
                     and "gemm_simt_kernel" in e.name), key=lambda e: e.time_range.start)
    out, at = [], 0
    for name, shapes, plans in order:
        mine = events[at + len(shapes):at + (calls + 1) * len(shapes)]  # past the warm-up call
        at += (calls + 1) * len(shapes)
        if len(mine) != calls * len(shapes):
            raise AssertionError(f"f32_bodies {name}: {len(mine)} float32 GEMM launches, "
                                 f"expected {calls * len(shapes)}")
        us = [0.0] * len(shapes)
        for i, e in enumerate(mine):
            us[i % len(shapes)] += e.time_range.elapsed_us() / calls
        out.append([(g + 1, shapes[g], plans[g], us[g]) for g in range(len(shapes))])
    if at != len(events):
        raise AssertionError(f"f32_bodies: {len(events)} float32 GEMM launches, expected {at}")
    return out


def phase_f32_bodies(device, smi):
    """The two float32 bodies at their paths' shapes: each float32 GEMM
    launch of rows 4, 5 and 7 (its tile, device microseconds from the
    profiler, TFLOP/s against the CUDA cores' 67), and row 8's float32
    forms, each also under the matmul-2 cast (its device microseconds from
    CUDA events behind a sleep, one "simt" launch a call, the share of the
    bound); every call checked against its plain version."""
    from eventful_transformer_tpu_torch.ops import kernel_check

    def inputs(bsz, n, k, extra, width):
        torch.cuda.empty_cache()
        return kernel_check.make_inputs(bsz, n, *width, k, torch.float32, device, seed=SEED,
                                        **extra)

    gemm_rows, failures = [], []
    entries = [(name, inputs(bsz, n, k, extra, width))
               for name, _, bsz, n, k, extra, width in F32_GEMM_PROFILE]
    for (name, d), (_, row, *_) in zip(entries, F32_GEMM_PROFILE):
        if not all(out["ok"] for out in kernel_check.errors(name, d)):
            failures.append((name, row))
    for (name, row, *_), gemms in zip(F32_GEMM_PROFILE, simt_launches(entries)):
        for gemm, (m, kk, nn), plan, us in gemms:
            gemm_rows.append(dict(kernel=name, row=row, gemm=gemm, m=m, k=kk, n=nn,
                                  tile=plan.shape[:2], blocks=plan.blocks, device_us=us,
                                  tflops=2.0 * m * kk * nn / us / 1e6,
                                  of_peak=2.0 * m * kk * nn / us / 1e6 / F32_PEAK_TFLOPS))
    del entries
    av_rows = []
    for name, row, bsz, n, k, extra, width in F32_AV_PROFILE:
        d = inputs(bsz, n, k, extra, width)
        for cast in (False, True):
            dd = dict(d)
            if cast:  # the matmul-2 cast: float32 q, k and terms over bfloat16 state
                for key in ("p_a", "p_v", "av_logits"):
                    dd[key] = dd[key].to(torch.bfloat16)
            if cast and name.startswith("softmax_select_matmul_logits"):
                continue  # bfloat16 logits without terms: the tensor-core body
            wrapper = kernel_check.KERNELS[name][0]
            before = dict(wrapper.body_launches)
            ok = all(out["ok"] for out in kernel_check.errors(name, dd))
            simt = wrapper.body_launches == dict(before, simt=before["simt"] + 1)
            if not (ok and simt):
                failures.append((name, row, "cast" if cast else "float32"))
            bound_ms = kernel_check.bound(name, dd)[0]
            clone = {key: v.clone() if torch.is_tensor(v) else v for key, v in dd.items()}
            us = kernel_check.queued_device_us(lambda: kernel_check._invoke(name, wrapper, clone))
            av_rows.append(dict(kernel=name, row=row, state=str(dd["p_a"].dtype).split(".")[-1],
                                keys=dd["p_a"].shape[-1], device_us=us,
                                bound_us=bound_ms * 1e3, bound_share=bound_ms * 1e3 / us))
        del d
    torch.cuda.empty_cache()
    emit("f32_bodies", card=smi, peak_tflops=F32_PEAK_TFLOPS, gemm=gemm_rows, av=av_rows)
    if failures:
        raise AssertionError(f"f32_bodies: off their plain versions or bodies: {failures}")
    return gemm_rows, av_rows


def phase_kernels(device):
    """Every kernel of ViViT's path at the spatial stack's shapes (N = 197);
    the two dense kernels also at the temporal model's (N = 17)."""
    return check_kernels("kernels", device, [
        ("vivit", 8, N_TOKENS, K, VIVIT_KERNELS, dict(window=(4, 6))),
        ("temporal", 8, STEPS + 1, STEPS + 1, DENSE_KERNELS, dict(window=(4, 6))),
    ])


def run_model(model, views, count=False):
    from eventful_transformer_tpu_torch.core.counting import Ctx

    ctx = Ctx(count_mode=count)
    with torch.no_grad():
        out = model.apply_views(ctx, views)
    if views.is_cuda:
        torch.cuda.synchronize()
    return out, ctx.counts


def gflops(counts):
    return sum(v for k, v in counts.items() if k != "policy_saturated") / 1e9


# the kernels of the dense blocks (the eventful flush step, the temporal
# model and the whole dense twin)
DENSE_KERNELS = ("window_attention", "dense_mlp_residual")
VIVIT_KERNELS = (
    "ln_norms", "qkv_attention_group", "proj_group", "gate_group_mlp", "dense_mlp_residual",
    "window_attention",
)


def wrappers():
    """Every kernel wrapper by name; two forms of one kernel share it."""
    from eventful_transformer_tpu_torch.ops import kernel_check

    return {entry[0].__name__: entry[0] for entry in kernel_check.KERNELS.values()}


def expected_launches(eventful):
    """Launches per forward. Eventful: 15 incremental steps, ln_norms once
    per step (the first block) and kernels A, B and C once per block and
    step; the flush step's 12 blocks and the 4 temporal blocks run the
    global attention, the temporal blocks the dense MLP. The dense twin
    runs both dense kernels in every block at every step."""
    want = dict.fromkeys(wrappers(), 0)
    if eventful:
        want.update(dict.fromkeys(("qkv_attention_group", "proj_group", "gate_group_mlp"),
                                  DEPTH * (STEPS - 1)))
        want["ln_norms"] = STEPS - 1
        want["window_attention"] = DEPTH + TEMPORAL_DEPTH
        want["dense_mlp_residual"] = TEMPORAL_DEPTH
    else:
        want.update(dict.fromkeys(DENSE_KERNELS, DEPTH * STEPS + TEMPORAL_DEPTH))
    return want


def reset_launches():
    from eventful_transformer_tpu_torch.ops import kernel_check

    kernel_check.reset_launches()


def read_launches():
    return {name: fn.launches for name, fn in wrappers().items()}


def read_form_launches():
    """Each form-counting wrapper's launches by form."""
    return {name: dict(fn.form_launches) for name, fn in wrappers().items()
            if hasattr(fn, "form_launches")}


# The launches of each counted run by wrapper and body (the wrappers that
# reach csrc/attention.cuh: window_attention, fused_attention and kernel A's
# qkv_attention_group; the A.V kernel's two wrappers, csrc/av_softmax.cu;
# the rel-pos bias add's two, csrc/relpos.cu), emitted by phase
# attention_bodies;
# the GEMM rows' launches (GEMM_ROWS) by GEMM core, emitted by phase
# gemm_cores.
BODIES = []
CORES = []
# the row passes' launches by body (rows 1, 9, 10 and 14, and the select, LN
# and norms stages of rows 2-5, 7, 12 and 13), emitted by phase row_bodies
ROW_BODIES = []


def read_routes(dtype, where):
    """The launches of the run just made by route, checked: the attention,
    A.V and rel-pos kernels' by body, in bfloat16 every one on the
    tensor-core body (the rel-pos add's: its tiled body), in float32 on the
    CUDA-core body (``window_attention.attention_body``,
    ``av_softmax.av_softmax_body`` and ``relpos.relpos_body`` at the paths'
    shapes); the GEMM rows' by GEMM core, in bfloat16 every one on
    the wgmma core, in float32 on the CUDA-core tile
    (``gemm_core.gemm_core``); the row passes of rows 1, 9, 10 and 14 and
    the select, LN and norms stages by row body, every one on the
    warp-per-row body (``row_pass.row_body``). Kept in BODIES, CORES and ROW_BODIES; returns
    the body counts."""
    from eventful_transformer_tpu_torch.ops import kernel_check

    counts = kernel_check.body_launches()
    kernel_check.check_bodies(counts, dtype, where)
    cores = kernel_check.core_launches()
    kernel_check.check_cores(cores, dtype, where)
    rows = kernel_check.row_body_launches()
    kernel_check.check_row_bodies(rows, where)
    key = str(dtype).split(".")[-1]
    ROW_BODIES.append(dict(run=where, dtype=key,
                           launches={name: c for name, c in rows.items() if any(c.values())}))
    BODIES.append(dict(run=where, dtype=key,
                       launches={name: c for name, c in counts.items() if any(c.values())}))
    CORES.append(dict(run=where, dtype=key,
                      launches={name: c for name, c in cores.items() if any(c.values())}))
    return counts


def model_dtype(model):
    return next(model.parameters()).dtype


def phase_attention_bodies():
    """Every counted run's attention, A.V and rel-pos launches by body (each
    checked as it was read); both rel-pos wrappers ran the tiled body in
    some bfloat16 run and the CUDA-core body in some float32 one."""
    tc, simt = (sum(c.get(body, 0) for row in BODIES for c in row["launches"].values())
                for body in ("tc", "simt"))
    relpos = {f"{dtype}.{name}": sum(row["launches"].get(name, {}).get(body, 0)
                                     for row in BODIES if row["dtype"] == dtype)
              for dtype, body in (("bfloat16", "tile"), ("float32", "simt"))
              for name in RELPOS_KERNELS}
    emit("attention_bodies", runs=BODIES, tc_launches=tc, simt_launches=simt,
         relpos_launches=relpos)
    if not tc or not simt:
        raise AssertionError(f"attention bodies: tc {tc}, simt {simt} launches in all")
    if not all(relpos.values()):
        raise AssertionError(f"rel-pos bodies: a wrapper missed its body in a dtype: {relpos}")


# rows 1, 9, 10 and 14, and the wrappers with a select, LN or norms stage
# that the paths run
ROW_PASS_ROWS = ("ln_norms", "block_select_scatter", "block_select_p", "ln_select")
ROW_PASS_WRAPPERS = ROW_PASS_ROWS + ("qkv_attention_group", "proj_group", "dense_mlp_residual",
                                     "gate_group_mlp", "gate_group_linear", "ln_select_matmul",
                                     "select_linear_skip_norms")


def phase_row_bodies():
    """Every counted run's row-pass launches by body (each checked as it
    was read: the warp-per-row body only); every ROW_PASS_WRAPPERS wrapper
    launched on the warp body in bfloat16 and in float32."""
    totals = {}
    for row in ROW_BODIES:
        by_wrapper = totals.setdefault(row["dtype"], {})
        for name, counts in row["launches"].items():
            total = by_wrapper.setdefault(name, dict.fromkeys(counts, 0))
            for body, n in counts.items():
                total[body] += n
    emit("row_bodies", runs=ROW_BODIES, totals=totals)
    idle = [f"{dtype}.{name}" for dtype in ("bfloat16", "float32")
            for name in ROW_PASS_WRAPPERS
            if not totals.get(dtype, {}).get(name, {}).get("warp")]
    if idle:
        raise AssertionError(f"row bodies: no warp-body launch of {idle}: {totals}")


def phase_gemm_cores():
    """Every counted run's GEMM launches by core (each checked as it was
    read); every GEMM row launched in both dtypes. Returns the totals by
    dtype and wrapper."""
    totals = {}
    for row in CORES:
        by_wrapper = totals.setdefault(row["dtype"], {})
        for name, counts in row["launches"].items():
            total = by_wrapper.setdefault(name, dict.fromkeys(counts, 0))
            for core, n in counts.items():
                total[core] += n
    from eventful_transformer_tpu_torch.ops import gemm_core

    encoded = {}
    for where, n in TIMED_ENCODES:
        encoded.setdefault(where, []).append(n)
    emit("gemm_cores", runs=CORES, totals=totals, tma_encodes=tma_encodes(),
         tma_cache_maps=gemm_core.TMA_MAPS, timed_runs=len(TIMED_ENCODES),
         timed_runs_encoding={where: ns for where, ns in encoded.items() if any(ns)})
    for dtype, core in (("bfloat16", "tc"), ("float32", "simt")):
        idle = [name for name in GEMM_ROWS if not totals.get(dtype, {}).get(name, {}).get(core)]
        if idle:
            raise AssertionError(f"gemm cores: no {dtype} launch of {idle} on {core}: {totals}")
    return totals


def expected_forms(step_forms, steps):
    """Every form count 0 but ``step_forms`` ({wrapper: {form: per step}})
    times ``steps``."""
    want = {name: dict.fromkeys(forms, 0) for name, forms in read_form_launches().items()}
    for name, forms in step_forms.items():
        for form, count in forms.items():
            want[name][form] = count * steps
    return want


def counted_run(model, views, eventful):
    """One forward with every launch count set to 0 just before and read
    just after; checks the counts and the class probabilities."""
    reset_launches()
    probs, _ = run_model(model, views)
    launches = read_launches()
    read_routes(views.dtype, f"vivit {'eventful' if eventful else 'dense'}")
    want = expected_launches(eventful)
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    probs = probs.float()
    if probs.shape != (views.shape[0], 400) or not torch.isfinite(probs).all():
        raise AssertionError(f"bad output: shape {tuple(probs.shape)}")
    sums = probs.sum(-1)
    if not torch.allclose(sums, torch.ones_like(sums), atol=1e-2):
        raise AssertionError(f"probabilities sum to {sums.tolist()}")
    return launches, sums.tolist()


@contextlib.contextmanager
def recorded_selections(log):
    """Every top-k coverage a run selects, appended to ``log`` (on the CPU):
    recorded around ``coverage_from_norms`` where the blocks, the gates and
    the policies call it, and as the group kernels that select their own
    rows hand it over (``gate_group.record_selection``)."""
    from eventful_transformer_tpu_torch.core import blocks, gating, indexing, policies
    from eventful_transformer_tpu_torch.ops import gate_group

    def recorded(norms, k):
        cov = indexing.coverage_from_norms(norms, k)
        log.append(cov.cpu())
        return cov

    modules = (blocks, gating, policies)
    for module in modules:
        module.coverage_from_norms = recorded
    gate_group.record_selection = lambda cov: log.append(cov.cpu())
    try:
        yield log
    finally:
        for module in modules:
            module.coverage_from_norms = indexing.coverage_from_norms
        gate_group.record_selection = None


def selection_flips(logs, other):
    """(selections, flips) of two runs' recorded coverages, gate by gate: a
    flip swaps one token for another. Raises unless both selected at the
    same number of gates."""
    if not logs or len(logs) != len(other):
        raise AssertionError("the two runs selected at different numbers of gates")
    selections = sum(int(b.sum()) for b in other)
    flips = sum(int((a != b).sum()) // 2 for a, b in zip(logs, other))
    return selections, flips


def card_vs_cpu(cpu_model, clip, device, run=None, prob_tol=None, hold=True):
    """One clip in float32 on the card against the same model on the CPU,
    where every kernel wrapper runs its plain version, through ``run(model,
    clip, count=True)`` (``run_model`` by default); the coverages each run
    selects recorded. With ``hold=False`` the numbers are only reported.
    Returns the numbers compared and the card run's counts."""
    run, prob_tol = run or run_model, prob_tol or PROB_TOL
    card_model = copy.deepcopy(cpu_model).to(device)
    logs = {"card": [], "cpu": []}
    runs = {}
    for tag, model, views in (("card", card_model, clip.to(device)), ("cpu", cpu_model, clip)):
        with recorded_selections(logs[tag]):
            reset_launches()
            start = time.perf_counter()
            runs[tag] = run(model, views, count=True)
            runs[tag + "_s"] = time.perf_counter() - start
        if tag == "card":
            read_routes(model_dtype(card_model), "vivit card vs cpu")
    selections, flips = selection_flips(logs["card"], logs["cpu"])
    prob_diff = float((runs["card"][0].cpu() - runs["cpu"][0]).abs().max())
    numbers = dict(
        f32_card_vs_cpu_max_prob_diff=prob_diff, prob_tol=prob_tol,
        gate_selections=selections, selections_differing=flips,
        max_flip_share=MAX_FLIP_SHARE, f32_card_s=runs["card_s"], f32_cpu_s=runs["cpu_s"],
    )
    if hold and (prob_diff > prob_tol or flips > MAX_FLIP_SHARE * selections):
        raise AssertionError(f"float32 card run disagrees with the CPU run: {numbers}")
    return numbers, runs["card"][1]


# the warm forwards a model is given for its caching allocator to settle
MAX_WARM_FORWARDS = 5


def warm_encodes(model, views, before, run=None):
    """{"cold": the TMA descriptors encoded since ``before`` (the count before
    the model's first forward), "warm": those each warm forward
    (``run(model, views)``, run_model by default) encodes, "grew": the bytes
    each added to what the caching allocator reserves}. A forward frees all
    its scratch, so one that reserves nothing new leaves the allocator's
    blocks as it found them, and the next forward is handed the same
    addresses. Warm forwards run until one has reserved nothing (two at
    least, MAX_WARM_FORWARDS at most), then one more: the first warm
    forward after the cold one places the scratch anew, and where it had to
    reserve more (the blocks cached before the cold forward decide that)
    the second places it anew again."""
    run = run or run_model
    cold = tma_encodes() - before
    warm, grew = [], []
    while len(warm) < 2 or (grew[-2] and len(warm) < MAX_WARM_FORWARDS):
        reserved, before = torch.cuda.memory_reserved(), tma_encodes()
        run(model, views)
        warm.append(tma_encodes() - before)
        grew.append(torch.cuda.memory_reserved() - reserved)
    return dict(cold=cold, warm=warm, grew=grew)


def check_warm_encodes(encodes, where):
    """Raise unless, for every model in ``encodes`` (:func:`warm_encodes` by
    model or run), a warm forward reserved nothing new and the forward after
    it encoded no TMA descriptor."""
    if any(e["grew"][-2] or e["warm"][-1] for e in encodes.values()):
        raise AssertionError(f"{where}: a warm forward encoded TMA descriptors: {encodes}")


def phase_slice(device):
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.models import FactorizedViViT
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    views = np.random.default_rng(0).standard_normal(
        (CLIPS, VIEWS, FRAMES, 3, SIZE, SIZE)
    ).astype(np.float32)
    views = torch.from_numpy(views)
    cpu_model = FactorizedViViT(**vivit_config(True), device="cpu", seed=SEED)
    set_policies(cpu_model, TokenNormTopK, k=K)
    dense_cpu = FactorizedViViT(**vivit_config(False), device="cpu", seed=SEED)

    eventful = copy.deepcopy(cpu_model).to(device, torch.bfloat16)
    dense = copy.deepcopy(dense_cpu).to(device, torch.bfloat16)
    views_bf16 = views.to(device, torch.bfloat16)
    encodes = {}
    before = tma_encodes()
    launches, sums = counted_run(eventful, views_bf16, eventful=True)
    encodes["eventful"] = warm_encodes(eventful, views_bf16, before)
    before = tma_encodes()
    dense_launches, _ = counted_run(dense, views_bf16, eventful=False)
    encodes["dense"] = warm_encodes(dense, views_bf16, before)
    numbers, counts = card_vs_cpu(cpu_model, views[:1], device)
    dense_counts = run_model(copy.deepcopy(dense_cpu).to(device), views[:1].to(device), True)[1]
    g_dense, g_eventful = gflops(dense_counts), gflops(counts)
    emit(
        "slice", launches=launches, dense_twin_launches=dense_launches,
        bf16_probs_sum=sums, tma_encodes=encodes, **numbers,
        gflops_per_clip_dense=g_dense, gflops_per_clip_eventful=g_eventful,
    )
    for got, target in ((g_dense, GFLOPS_DENSE), (g_eventful, GFLOPS_EVENTFUL)):
        if abs(round(got, 2) - target) > 1e-6:
            raise AssertionError(f"counted {got} GFLOPs/clip, expected {target}")
    check_warm_encodes(encodes, "slice")
    return eventful, dense, views_bf16, launches


def tma_encodes():
    """The TMA descriptors the kernels' library has encoded so far."""
    from eventful_transformer_tpu_torch.ops import gemm_core

    return gemm_core.tensor_map_encodes()


# The TMA descriptors each timed run (time_model, time_vitdet) encoded
# after its warm-up, by the phase before it, read by phase gemm_cores.
TIMED_ENCODES = []


def timed_encodes(before):
    """Record the descriptors encoded since ``before``."""
    TIMED_ENCODES.append((f"after {_LAST_EMIT[1]}", tma_encodes() - before))


def time_model(model, views, warmup=1, iters=2, run=None):
    """ms per clip of ``run(model, views)`` (run_model by default)."""
    run = run or run_model
    for _ in range(warmup):
        run(model, views)
    encodes = tma_encodes()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run(model, views)
    end.record()
    torch.cuda.synchronize()
    timed_encodes(encodes)
    return start.elapsed_time(end) / iters / views.shape[0]


def phase_time(eventful, dense, views, smi):
    # alternate the two so that drift of clocks and power hits both alike
    times = {"dense": [], "eventful": []}
    for name in ("dense", "eventful", "eventful", "dense"):
        times[name].append(time_model(eventful if name == "eventful" else dense, views))
    emit(
        "time", card=smi, clips=views.shape[0], views=VIEWS, frames=FRAMES, k=K,
        dtype="bfloat16", dense_ms_per_clip=times["dense"],
        eventful_ms_per_clip=times["eventful"],
    )


# The ViTDet float32 card-vs-CPU check's backbone: two windowed blocks and
# one global (cut from 12 to keep the script's time: at 1024 the CPU side
# took 14-17 s at full depth)
VITDET_CHECK_DEPTH, VITDET_CHECK_WINDOWS = 3, (0, 1)


def vitdet_config(eventful, size, matmul_2_cast="bfloat16", depth=VITDET_DEPTH,
                  window_indices=(0, 1, 3, 4, 6, 7, 9, 10)):
    block = dict(dim=768, heads=12, mlp_ratio=4, window_size=[14, 14],
                 relative_embedding_size=[64, 64])
    backbone = dict(depth=depth, position_encoding_size=[14, 14],
                    window_indices=list(window_indices), block_config=block)
    if eventful:
        block.update(pool_size=2, matmul_2_cast=matmul_2_cast)
        backbone.update(block_class="EventfulBlock", windowed_class="EventfulTokenwiseBlock",
                        windowed_overrides=dict(pool_size=None, matmul_2_cast=None))
    return dict(
        backbone_config=backbone, classes=30, input_shape=[3, size, size],
        normalize_mean=[123.675, 116.28, 103.53], normalize_std=[58.395, 57.12, 57.375],
        output_channels=256, patch_size=[16, 16], scale_factors=[4.0, 2.0, 1.0, 0.5],
    )


def phase_vitdet_kernels(device, size):
    """The kernels of the ViTDet path at its shapes: 2 streams of N tokens,
    k = 256, windows of 14 x 14, the rel-pos bias add over the dense twin's
    N keys and the pooled keys of EventfulBlock; at 672 also every kernel of
    the end-to-end path at one stream; at 1024 also softmax_select_matmul
    at the 672 float32 check's shape (one stream, 1764 queries, 441 pooled
    keys)."""
    cfg = VITDET[size]
    n, streams = cfg["n"], VITDET_STREAMS
    cases = [(str(size), streams, n, VITDET_K, cfg["kernels"], cfg["inputs"])]
    for kind, keys in cfg["keys"].items():
        cases.append((f"{size}_{kind}", streams, n, VITDET_K, RELPOS_KERNELS,
                      dict(cfg["inputs"], relpos_keys=keys)))
    if size == 672:
        cases += [
            ("e2e", 1, n, VITDET_K, E2E_KERNELS, dict(cfg["inputs"], relpos_keys=cfg["keys"]["pooled"])),
            ("e2e_dense", 1, n, VITDET_K, RELPOS_KERNELS,
             dict(cfg["inputs"], relpos_keys=cfg["keys"]["dense"])),
        ]
    else:
        cases.append(("672_one_stream", 1, VITDET[672]["n"], VITDET_K, ("softmax_select_matmul",),
                      VITDET[672]["inputs"]))
    return check_kernels("vitdet_kernels" if size == 672 else f"vitdet{size}_kernels", device,
                         cases)


def vitdet_frames(frames, streams, device, dtype, size, seed=SEED):
    """[0, 1] frames (frames, streams, 3, size, size): one random image per
    stream, each frame that image plus a little noise, made on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (streams, 3, size, size)
    base = torch.rand(shape, generator=g, device=device)
    noise = torch.randn((frames,) + shape, generator=g, device=device)
    return (base + 0.05 * noise).clamp(0.0, 1.0).to(dtype)


def run_vitdet(model, frames, count=False, frame_events=None, keep=False):
    """One call: every frame of every stream through pre_backbone and
    apply_backbone, frame 0 a flush. Returns (last tokens, counts, every
    frame's tokens when ``keep``)."""
    from eventful_transformer_tpu_torch.core.counting import Ctx

    ctx = Ctx(count_mode=count)
    state = model.init_state(frames.shape[1], frames.dtype, frames.device)
    aux = model.precompute()
    eventful = "qkv_gate" in state["blocks"][0]
    outs = []
    for t in range(frames.shape[0]):
        if frame_events is not None:
            frame_events[t].record()
        mode = ("flush" if t == 0 else "incremental") if eventful else None
        tokens = model.pre_backbone(ctx, frames[t])
        tokens, state = model.apply_backbone(ctx, state, tokens, aux, mode=mode)
        if keep:
            outs.append(tokens)
    if frame_events is not None:
        frame_events[-1].record()
    if frames.is_cuda:
        torch.cuda.synchronize()
    return tokens, ctx.counts, outs


def vitdet_expected_launches(eventful, size, frames=VITDET_FRAMES, streams=VITDET_STREAMS):
    """Launches per call. Eventful: in each incremental frame ln_norms once
    (block 0; every later block gets its norms from the block before),
    block_select_p and block_scatter_rows for the 8 windowed qkv groups,
    and the size's own kernels: at 672 ("v2") gate_group_linear for the 4
    global qkv groups and the 12 projection groups and gate_group_mlp in
    every block; at 1024 ("blocked") block_select_scatter for the 4 global
    qkv, 12 projection and 12 MLP groups; in the 4 global blocks
    softmax_select_matmul where the A.V kernel runs (>= 512 pooled keys or
    one stream), else relpos_bias_add_v2 on the logits; relpos_bias_add_v2
    in the 4 global blocks of the flush frame; window_attention in the 8
    windowed blocks of every frame. Dense: window_attention in the
    windowed blocks, relpos_bias_add_v2 in the global blocks and
    dense_mlp_residual in every block, every frame."""
    want = dict.fromkeys(wrappers(), 0)
    want["window_attention"] = VITDET_WINDOWED * frames
    if eventful:
        steps = frames - 1
        av_kernel = size == 1024 or streams == 1
        per_step = dict(ln_norms=1, block_select_p=VITDET_WINDOWED,
                        block_scatter_rows=VITDET_WINDOWED, **VITDET[size]["step_launches"])
        per_step["softmax_select_matmul" if av_kernel else "relpos_bias_add_v2"] = VITDET_GLOBAL
        want.update({name: count * steps for name, count in per_step.items()})
        want["relpos_bias_add_v2"] += VITDET_GLOBAL
    else:
        want["dense_mlp_residual"] = VITDET_DEPTH * frames
        want["relpos_bias_add_v2"] = VITDET_GLOBAL * frames
    return want


def vitdet_jax_flops(eventful, valid_shares, size, frames=VITDET_FRAMES, streams=VITDET_STREAMS,
                     flops=None):
    """The JAX package's count of one call (all streams and frames) from
    ``flops`` (by default VITDET[size]["flops"]); ``valid_shares``: the
    pooled valid share of every global block's incremental step (a mean
    over the streams), which a count with no per-share term ignores. The
    per-stream counts hold one windowed term that a forward counts once,
    whatever the number of streams."""
    f = flops or VITDET[size]["flops"]
    steps = frames - 1
    once = (streams - 1) * frames * VITDET_WINDOWED * f["windowed_once_per_forward"]
    if not eventful:
        per_frame = f["position_add"] + VITDET_WINDOWED * f["dense_windowed"] + (
            VITDET_GLOBAL * f["dense_global"])
        return streams * frames * per_frame - once
    fixed = frames * f["position_add"] + VITDET_WINDOWED * (
        f["windowed_flush"] + steps * f["windowed_incremental"]
    ) + VITDET_GLOBAL * (f["global_flush"] + steps * f["global_incremental_base"])
    if not f["global_incremental_per_valid_share"]:
        return streams * fixed - once
    if len(valid_shares) != VITDET_GLOBAL * steps:
        raise AssertionError(f"{len(valid_shares)} pooled selections, expected {VITDET_GLOBAL * steps}")
    shares = f["global_incremental_per_valid_share"] * sum(valid_shares)
    return streams * (fixed + shares) - once


@contextlib.contextmanager
def pooled_shares():
    """The pooled valid share of every global block's incremental step
    (a mean over the streams), recorded around ``_pool_index``."""
    from eventful_transformer_tpu_torch.core import blocks

    pool_index = blocks.EventfulMatmul1Block._pool_index
    shares = []

    def recorded(self, index, mask):
        out = pool_index(self, index, mask)
        shares.append(1.0 if out[1] is None else float(out[1].float().mean()))
        return out

    blocks.EventfulMatmul1Block._pool_index = recorded
    try:
        yield shares
    finally:
        blocks.EventfulMatmul1Block._pool_index = pool_index


def vitdet_counted_call(model, frames, eventful, size):
    """One call with the launch counts set to 0 just before and read just
    after, counting FLOPs; checks launches, the output and the count
    against the JAX package's. Returns (launches, the port's and the JAX
    package's GFLOPs per frame, the mean pooled valid share)."""
    with pooled_shares() as shares:
        reset_launches()
        tokens, counts, _ = run_vitdet(model, frames, count=True)
        launches = read_launches()
        read_routes(frames.dtype, f"vitdet{size} {'eventful' if eventful else 'dense'}")
    want = vitdet_expected_launches(eventful, size)
    if launches != want:
        raise AssertionError(f"ViTDet-{size} launch counts {launches}, expected {want}")
    n = VITDET[size]["n"]
    if tokens.shape != (VITDET_STREAMS, n, 768) or not torch.isfinite(tokens).all():
        raise AssertionError(f"bad ViTDet-{size} output: shape {tuple(tokens.shape)}")
    got = sum(v for k, v in counts.items() if k != "policy_saturated")
    ref = vitdet_jax_flops(eventful, shares, size)
    if abs(got - ref) > 1e-6 * ref:
        raise AssertionError(f"counted {got} FLOPs per call, the JAX package's count is {ref}")
    mean_share = sum(shares) / len(shares) if shares else None
    return launches, got / VITDET_FRAMES / 1e9, ref / VITDET_FRAMES / 1e9, mean_share


def card_and_cpu(cpu_model, frames, device, run, card_model=None):
    """``run(model, frames)`` (returning a list of per-frame token tensors
    and anything else) on the card, with the launch counts set to 0 just
    before and read just after, and on the CPU (plain versions), both in
    float32; the gate selections of each run recorded around the blocks'
    coverage_from_norms. Checks the tokens of every frame within
    VITDET_TOKEN_TOL (scaled) and the selections that differ. Returns (the
    numbers compared, the card run's launches, both runs' outputs)."""
    card_model = card_model or copy.deepcopy(cpu_model).to(device)
    logs = {"card": [], "cpu": []}
    outs, seconds = {}, {}
    for tag, model, clip in (("card", card_model, frames.to(device)), ("cpu", cpu_model, frames)):
        with recorded_selections(logs[tag]):
            reset_launches()
            start = time.perf_counter()
            outs[tag] = run(model, clip)
            seconds[tag] = time.perf_counter() - start
            if tag == "card":
                launches = read_launches()
                read_routes(model_dtype(card_model), "vitdet card vs cpu")
    selections, flips = selection_flips(logs["card"], logs["cpu"])
    scaled = max(
        float(((a.cpu() - b).abs() / b.abs().clamp(min=1.0)).max())
        for a, b in zip(outs["card"][0], outs["cpu"][0])
    )
    numbers = dict(
        f32_card_vs_cpu_max_scaled_token_err=scaled, token_tol=VITDET_TOKEN_TOL,
        gate_selections=selections, selections_differing=flips,
        max_flip_share=MAX_FLIP_SHARE, f32_card_s=seconds["card"], f32_cpu_s=seconds["cpu"],
        f32_card_launches={k: v for k, v in launches.items() if v},
    )
    if scaled > VITDET_TOKEN_TOL or flips > MAX_FLIP_SHARE * selections:
        raise AssertionError(f"float32 ViTDet card run disagrees with the CPU run: {numbers}")
    return numbers, launches, outs


def vitdet_card_vs_cpu(cpu_model, frames, device):
    """One stream x 3 frames of the backbone cut to VITDET_CHECK_DEPTH
    blocks in float32 on the card against the same model on the CPU. One
    stream takes the A.V kernel at every size (the batch-1 rule)."""
    numbers, launches, _ = card_and_cpu(
        cpu_model, frames, device, lambda m, clip: (run_vitdet(m, clip, keep=True)[2],)
    )
    av_launches = launches["softmax_select_matmul"]
    global_blocks = VITDET_CHECK_DEPTH - len(VITDET_CHECK_WINDOWS)
    if av_launches != global_blocks * (frames.shape[0] - 1):
        raise AssertionError(f"one stream ran the A.V kernel {av_launches} times")
    return numbers


def phase_vitdet_slice(device, size):
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.models import ViTDet
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    eventful = ViTDet(**vitdet_config(True, size), device=device, seed=SEED)
    set_policies(eventful, TokenNormTopK, k=VITDET_K)
    eventful = eventful.to(torch.bfloat16)
    dense = ViTDet(**vitdet_config(False, size), device=device, seed=SEED).to(torch.bfloat16)
    frames = vitdet_frames(VITDET_FRAMES, VITDET_STREAMS, device, torch.bfloat16, size)
    launches, g_eventful, g_eventful_jax, share = vitdet_counted_call(eventful, frames, True, size)
    dense_launches, g_dense, g_dense_jax, _ = vitdet_counted_call(dense, frames, False, size)
    cpu_model = ViTDet(**vitdet_config(True, size, None, VITDET_CHECK_DEPTH, VITDET_CHECK_WINDOWS),
                       device="cpu", seed=SEED)
    set_policies(cpu_model, TokenNormTopK, k=VITDET_K)
    clip = vitdet_frames(3, 1, "cpu", torch.float32, size, seed=SEED + 1)
    numbers = vitdet_card_vs_cpu(cpu_model, clip, device)
    emit(
        "vitdet_slice" if size == 672 else f"vitdet{size}_slice", launches=launches,
        dense_launches=dense_launches,
        gflops_per_frame_eventful=g_eventful, jax_gflops_per_frame_eventful=g_eventful_jax,
        gflops_per_frame_dense=g_dense, jax_gflops_per_frame_dense=g_dense_jax,
        mean_pooled_valid_share=share, f32_depth=VITDET_CHECK_DEPTH, **numbers,
    )
    return eventful, dense, frames, launches, dense_launches


def time_vitdet(model, frames, warmup=1, iters=2, run=None):
    """ms per frame of a call of ``run`` (run_vitdet by default): [flush
    frame, mean of the incremental frames, mean of all frames], each a
    mean over ``iters`` calls."""
    run = run or run_vitdet
    events = [torch.cuda.Event(enable_timing=True) for _ in range(frames.shape[0] + 1)]
    for _ in range(warmup):
        run(model, frames)
    encodes = tma_encodes()
    per_frame = []
    for _ in range(iters):
        run(model, frames, frame_events=events)
        per_frame.append([a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])])
    timed_encodes(encodes)
    flush = sum(ms[0] for ms in per_frame) / iters
    steady = sum(sum(ms[1:]) / (len(ms) - 1) for ms in per_frame) / iters
    whole = sum(sum(ms) / len(ms) for ms in per_frame) / iters
    return [flush, steady, whole]


def phase_vitdet_time(eventful, dense, frames, smi, size):
    times = {"dense": [], "eventful": []}
    for name in ("dense", "eventful", "eventful", "dense"):
        times[name].append(time_vitdet(eventful if name == "eventful" else dense, frames))
    emit(
        "vitdet_time" if size == 672 else f"vitdet{size}_time", card=smi,
        streams=VITDET_STREAMS, frames=VITDET_FRAMES, k=VITDET_K, dtype="bfloat16",
        columns=["flush_frame_ms", "incremental_frame_ms", "mean_frame_ms"],
        dense_ms=times["dense"], eventful_ms=times["eventful"],
    )
    return times["dense"]


def vitdet_path(device, smi, size):
    """The kernels, the slice and the times of one ViTDet size. Returns the
    kernel rows of the final line, the kernel check rows and the dense
    twin's ms/frame."""
    rows = phase_vitdet_kernels(device, size)
    eventful, dense, frames, launches, dense_launches = phase_vitdet_slice(device, size)
    dense_ms = phase_vitdet_time(eventful, dense, frames, smi, size)
    del frames
    graph_path_c(eventful, dense, smi, size)
    del eventful, dense
    torch.cuda.empty_cache()
    # launches: the eventful model's counted run; dense_mlp_residual runs in
    # the dense twin only. Forms of one kernel share its wrapper's count.
    # The rel-pos bias add: over the pooled keys in the eventful model, over
    # N keys in the dense twin.
    counts = {k: v or dense_launches[k] for k, v in launches.items()}
    path = f"vitdet_{size}"
    out = [kernel_row(name, rows[(name, torch.bfloat16, str(size))], counts, path)
           for name in VITDET[size]["kernels"]]
    out.append(kernel_row("relpos_bias_add_v2", rows[("relpos_bias_add_v2", torch.bfloat16, f"{size}_pooled")],
                          launches, path))
    out.append(kernel_row("relpos_bias_add_v2", rows[("relpos_bias_add_v2", torch.bfloat16, f"{size}_dense")],
                          dense_launches, path))
    return out, rows, dense_ms


def kernel_row(name, row, launches, path):
    """The final line's entry of kernel ``name``: ``launches`` the count
    itself, or a run's launches by wrapper."""
    from eventful_transformer_tpu_torch.ops import kernel_check

    wrapper, _, source, replaces, _ = kernel_check.KERNELS[name]
    if not isinstance(launches, int):
        launches = launches[wrapper.__name__]
    out = dict(
        name=name, route="cuda", source=source, replaces=replaces, path=path,
        shape=[row["batch"], row["n"]], inputs=row["tag"], launches=launches,
        max_abs_err=max(out["max_abs_err"] for out in row["outputs"]),
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row["library_ms"],
    )
    for key in ("two_phase_ms", "device_us", "device_us_by", "bound_share", "host_us",
                "library_host_us", "body_launches", "kernels_per_call", "allocations_per_call",
                "row_body_launches"):
        if key in row:
            out[key] = row[key]
    return out


# -- ViTDet end to end ------------------------------------------------------------


def e2e_model(eventful, device, dtype, matmul_2_cast="bfloat16", size=E2E_SIZE):
    """spatiotemporal_<size> (k = 256) or base_<size> on ``device`` in
    ``dtype``, weights from the seed, the class scorer scaled by
    CLS_SCORE_GAIN."""
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.models import ViTDet
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    model = ViTDet(**vitdet_config(eventful, size, matmul_2_cast), device=device, seed=SEED)
    with torch.no_grad():
        model.roi_heads.cls_score.kernel.mul_(CLS_SCORE_GAIN)
    if eventful:
        set_policies(model, TokenNormTopK, k=VITDET_K)
    return model.to(dtype)


def run_e2e(model, frames, count=False, frame_events=None):
    """One call through ViTDet.apply, one stream (frames (T, 1, 3, H, W)),
    frame 0 a flush. Returns (every frame's detections, counts)."""
    from eventful_transformer_tpu_torch.core.counting import Ctx

    ctx = Ctx(count_mode=count)
    state = model.init_state(1, frames.dtype, frames.device)
    aux = model.precompute()
    eventful = "qkv_gate" in state["blocks"][0]
    detections = []
    for t in range(frames.shape[0]):
        if frame_events is not None:
            frame_events[t].record()
        mode = ("flush" if t == 0 else "incremental") if eventful else None
        det, state = model.apply(ctx, state, frames[t], aux, mode=mode)
        detections.append(det)
    if frame_events is not None:
        frame_events[-1].record()
    if frames.is_cuda:
        torch.cuda.synchronize()
    return detections, ctx.counts


def check_detections(dets, classes=30, size=E2E_SIZE):
    """Every frame's detections: the JAX dict's keys and fixed shapes
    (K = 100, the ROI heads' test_topk_per_image), finite boxes in the
    ``size`` x ``size`` image, labels of the classes, scores in (0, 1]
    where kept (above the 0.05 threshold in the working dtype) and 0 where
    masked; with a mask head, (K, 28, 28) finite masks in [0, 1]. Returns
    the kept count of each frame."""
    kept = []
    for det in dets:
        boxes, scores, labels, mask = (det[k] for k in ("boxes", "scores", "labels", "mask"))
        if (boxes.shape, scores.shape, labels.shape, mask.shape) != ((100, 4), (100,), (100,), (100,)):
            raise AssertionError(f"detections of shapes {[tuple(v.shape) for v in det.values()]}")
        if "masks" in det:
            m = det["masks"].float()
            if m.shape != (100, 28, 28) or not torch.isfinite(m).all() or m.min() < 0 or m.max() > 1:
                raise AssertionError(f"masks of shape {tuple(m.shape)} out of range")
        b, s = boxes.float(), scores.float()
        bad = (not torch.isfinite(b).all() or b.min() < 0 or b.max() > size
               or labels.min() < 0 or labels.max() >= classes
               or (s[mask] <= 0).any() or (s[mask] > 1).any() or (s[~mask] != 0).any())
        if bad:
            raise AssertionError("detections out of range")
        kept.append(int(mask.sum()))
    if not sum(kept):
        raise AssertionError("no detection kept in any frame")
    return kept


def set_relpos_form(model, use_kernel):
    """Set ``use_kernel`` on every RelativePositionEmbedding of ``model``:
    True for the relpos_bias_add form (row 16's rounding), "auto" for the
    default relpos_bias_add_v2 form."""
    from eventful_transformer_tpu_torch.core.embeddings import RelativePositionEmbedding

    for module in model.modules():
        if isinstance(module, RelativePositionEmbedding):
            module.use_kernel = use_kernel


def e2e_counted_call(model, frames, eventful, row16=False):
    """One call through ViTDet.apply with the launch counts set to 0 just
    before and read just after, counting FLOPs; checks launches, the
    detections and the backbone's count against the JAX package's (the
    head adds none, as in the JAX package). ``row16``: the model's rel-pos
    bias add runs in its relpos_bias_add form (``use_kernel = True``, the
    JAX package's ``use_pallas_kernel = True``), which takes the launches
    of the default form. Returns (launches, kept detections per frame, NMS
    host synchronisations per frame, the port's and the JAX package's
    GFLOPs per frame, the mean pooled valid share)."""
    from eventful_transformer_tpu_torch.detection import nms

    frames_n = frames.shape[0]
    with pooled_shares() as shares:
        syncs = nms.host_syncs
        reset_launches()
        dets, counts = run_e2e(model, frames, count=True)
        launches = read_launches()
        read_routes(model_dtype(model), f"vitdet_e2e {'eventful' if eventful else 'dense'}")
        syncs = nms.host_syncs - syncs
    want = vitdet_expected_launches(eventful, E2E_SIZE, frames=frames_n, streams=1)
    want["nms_padded"] = HEAD_NMS_PER_FRAME * frames_n
    if row16:
        want["relpos_bias_add"], want["relpos_bias_add_v2"] = want["relpos_bias_add_v2"], 0
    if launches != want:
        raise AssertionError(f"ViTDet e2e launch counts {launches}, expected {want}")
    if syncs:
        raise AssertionError(f"the NMS read the host {syncs} times on the card")
    kept = check_detections(dets)
    got = sum(v for k, v in counts.items() if k != "policy_saturated")
    ref = vitdet_jax_flops(eventful, shares, E2E_SIZE, frames=frames_n, streams=1)
    if abs(got - ref) > 1e-6 * ref:
        raise AssertionError(f"counted {got} FLOPs per call, the JAX package's count is {ref}")
    share = sum(shares) / len(shares) if shares else None
    return launches, kept, syncs / frames_n, got / frames_n / 1e9, ref / frames_n / 1e9, share


def e2e_tokens_and_detections(model, frames):
    """run_e2e, recording the backbone's tokens of every frame at
    post_backbone. Returns (tokens, detections) per frame, on the CPU."""
    tokens = []
    post_backbone = model.post_backbone

    def recorded(ctx, t):
        tokens.append(t.float().cpu())
        return post_backbone(ctx, t)

    model.post_backbone = recorded
    try:
        dets, _ = run_e2e(model, frames)
    finally:
        del model.post_backbone
    return tokens, [{k: v.cpu() for k, v in det.items()} for det in dets]


def e2e_card_vs_cpu(device):
    """The eventful model, one stream x 3 frames in float32 (matmul-2 cast
    off), through ViTDet.apply on the card with the rel-pos bias add in its
    relpos_bias_add form (row 16's rounding; the flush frame's 4 global
    blocks) and on the CPU: tokens within VITDET_TOKEN_TOL, each frame's
    detections matched by match_detections. Returns (numbers, launches)."""
    cpu_model = e2e_model(True, "cpu", torch.float32, matmul_2_cast=None)
    card_model = copy.deepcopy(cpu_model).to(device)
    set_relpos_form(card_model, True)
    clip = vitdet_frames(3, 1, "cpu", torch.float32, E2E_SIZE, seed=SEED + 1)
    numbers, launches, outs = card_and_cpu(cpu_model, clip, device, e2e_tokens_and_detections,
                                           card_model=card_model)
    if (launches["relpos_bias_add"], launches["relpos_bias_add_v2"]) != (VITDET_GLOBAL, 0):
        raise AssertionError(f"the float32 e2e run's rel-pos launches: {launches}")
    matches = [match_detections(a, b) for a, b in zip(outs["card"][1], outs["cpu"][1])]
    numbers["detections_matched"] = matches
    if not all(m["ok"] for m in matches):
        raise AssertionError(f"float32 detections on the card disagree with the CPU's: {matches}")
    return numbers, launches


def phase_vitdet_e2e(device, smi, rows):
    """ViTDet-B at 672 through ViTDet.apply, eventful and dense, one stream;
    the eventful model also with the rel-pos bias add in its
    relpos_bias_add form (the path of kernel row 16). Returns the kernel
    rows of the final line."""
    eventful = e2e_model(True, device, torch.bfloat16)
    dense = e2e_model(False, device, torch.bfloat16)
    frames = vitdet_frames(E2E_FRAMES + 1, 1, device, torch.bfloat16, E2E_SIZE)
    launches, kept, syncs, g_eventful, g_eventful_jax, share = e2e_counted_call(eventful, frames, True)
    dense_launches, dense_kept, dense_syncs, g_dense, g_dense_jax, _ = e2e_counted_call(
        dense, frames, False)
    set_relpos_form(eventful, True)
    try:
        row16_launches, row16_kept = e2e_counted_call(eventful, frames, True, row16=True)[:2]
    finally:
        set_relpos_form(eventful, "auto")
    nms_rows = phase_nms_kernel(device, smi, eventful, frames, launches)
    numbers, f32_launches = e2e_card_vs_cpu(device)
    times = {"dense": [], "eventful": []}
    for name in ("dense", "eventful", "eventful", "dense"):
        times[name].append(time_vitdet(eventful if name == "eventful" else dense, frames,
                                       iters=2, run=run_e2e))
    emit(
        "vitdet_e2e", card=smi, streams=1, frames=E2E_FRAMES + 1, k=VITDET_K, dtype="bfloat16",
        launches=launches, dense_launches=dense_launches,
        row16_launches=row16_launches,
        kept_detections_per_frame=kept, dense_kept_detections_per_frame=dense_kept,
        row16_kept_detections_per_frame=row16_kept,
        nms_host_syncs_per_frame=syncs, dense_nms_host_syncs_per_frame=dense_syncs,
        gflops_per_frame_eventful=g_eventful, jax_gflops_per_frame_eventful=g_eventful_jax,
        gflops_per_frame_dense=g_dense, jax_gflops_per_frame_dense=g_dense_jax,
        mean_pooled_valid_share=share, **numbers,
        columns=["flush_frame_ms", "incremental_frame_ms", "mean_frame_ms"],
        dense_ms=times["dense"], eventful_ms=times["eventful"],
    )
    counts = {k: v or dense_launches[k] for k, v in launches.items()}
    out = [kernel_row(name, rows[(name, torch.bfloat16, "e2e")], counts, "vitdet_e2e")
           for name in E2E_KERNELS if name != "relpos_bias_add"]
    out.append(kernel_row("relpos_bias_add_v2", rows[("relpos_bias_add_v2", torch.bfloat16, "e2e_dense")],
                          dense_launches, "vitdet_e2e"))
    row16 = kernel_row("relpos_bias_add", rows[("relpos_bias_add", torch.bfloat16, "e2e")],
                       row16_launches, "vitdet_e2e_row16")
    row16["f32_check_launches"] = f32_launches["relpos_bias_add"]
    return out + [row16] + nms_rows


# -- row 22: NMS ----------------------------------------------------------------------------
#
# The main path's two NMS calls a frame (detection/rpn.py:38-40 and
# roi_heads.py:94-95 defaults): the RPN's batched_nms over the top 4096 of
# its 4 x 1000 + 363 candidates at 672, max_out 300 at IoU 0.7; the ROI
# heads' over the top 4096 of 300 x 30 class boxes, max_out 100 at 0.5. The
# contract cases (kernel_check.nms_inputs) at those shapes and at 900 boxes
# (the plain version's fixpoint form).
NMS_CASES = ("random", "ties", "threshold", "chains", "all_invalid", "few_valid")
NMS_CASE_SHAPES = ((4096, 300, 0.7), (4096, 100, 0.5), (900, 64, 0.5))


def recorded_nms_inputs(model, frame):
    """The (boxes, scores, threshold, max_out) of each NMS call of one
    flush frame through ViTDet.apply, cloned."""
    from eventful_transformer_tpu_torch.detection import nms

    seen = []
    wrapped = nms.nms_padded

    def recording(boxes, scores, threshold, max_out):
        seen.append((boxes.clone(), scores.clone(), threshold, max_out))
        return wrapped(boxes, scores, threshold, max_out)

    nms.nms_padded = recording
    try:
        run_e2e(model, frame[None])
    finally:
        nms.nms_padded = wrapped
    return seen


def phase_nms_kernel(device, smi, model, frames, launches):
    """Phase nms_kernel: row 22 on the inputs the e2e model's flush frame
    gives its two NMS calls, and on the contract cases: the kernel against
    its plain version index for index, the masked slots included (exact;
    kernel_check.errors), ms of both, the device microseconds of a call
    and of each kernel by name with the device launches a call
    (kernel_check.device_us_by_kernel; kernels_a_call: 1), the
    bound (kernel_check.bound: the function's bytes, kernel_check.nms_bytes,
    against its IoUs' float32 steps, kernel_check.nms_ious), and beside the
    device times the kernel's shared memory and scratch (smem_bytes,
    scratch_bytes, kernel_check.nms_design_bytes: this design's, not the
    function's). Returns the final line's rows, with the launches of the
    e2e counted run."""
    from eventful_transformer_tpu_torch.detection.nms import BLOCK
    from eventful_transformer_tpu_torch.ops import kernel_check

    wrapper = kernel_check.KERNELS["nms_padded"][0]
    rows = []
    for tag, (boxes, scores, threshold, max_out) in zip(
            ("rpn", "roi"), recorded_nms_inputs(model, frames[0])):
        d = dict(nms_boxes=boxes, nms_scores=scores, nms_threshold=threshold,
                 nms_max_out=max_out)
        outputs = kernel_check.errors("nms_padded", d)
        if not all(o["ok"] for o in outputs):
            raise AssertionError(f"nms_kernel {tag}: {outputs}")
        bound_ms, bound_by = kernel_check.bound("nms_padded", d)
        by = kernel_check.device_us_by_kernel(
            lambda: wrapper(boxes, scores, threshold, max_out, BLOCK))
        a_call = sum(n for n, _ in by.values())
        if a_call > 2:
            raise AssertionError(f"nms_kernel {tag}: {a_call} device launches a call, at most 2")
        smem_bytes, scratch_bytes = kernel_check.nms_design_bytes(d)
        kept = int(wrapper(boxes, scores, threshold, max_out, BLOCK)[1].sum())
        rows.append(dict(
            tag=tag, batch=1, n=boxes.shape[0], max_out=max_out, threshold=threshold,
            boxes_dtype=str(boxes.dtype).split(".")[-1],
            scores_dtype=str(scores.dtype).split(".")[-1], kept=kept, outputs=outputs,
            ms=kernel_check.time_ms("nms_padded", d),
            plain_ms=kernel_check.time_ms("nms_padded", d, plain=True),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            device_us=sum(us for _, us in by.values()),
            device_us_by={name: us for name, (_, us) in by.items()}, kernels_a_call=a_call,
            ious=kernel_check.nms_ious(d), smem_bytes=smem_bytes, scratch_bytes=scratch_bytes))
    cases = []
    for case in NMS_CASES:
        for n, max_out, threshold in NMS_CASE_SHAPES:
            boxes, scores = kernel_check.nms_inputs(n, max_out, threshold, device,
                                                    seed=n + max_out, case=case)
            d = dict(nms_boxes=boxes, nms_scores=scores, nms_threshold=threshold,
                     nms_max_out=max_out)
            outputs = kernel_check.errors("nms_padded", d)
            kept = int(kernel_check.call("nms_padded", d)[1].sum())
            cases.append(dict(case=case, n=n, max_out=max_out, threshold=threshold,
                              ok=all(o["ok"] for o in outputs), kept=kept))
    if not all(c["ok"] for c in cases):
        raise AssertionError(f"nms_kernel: a contract case differs: {cases}")
    emit("nms_kernel", card=smi, rows=rows, cases=cases, launches=launches["nms_padded"])
    return [kernel_row("nms_padded", row, launches, "vitdet_e2e") for row in rows]


# -- ViViT-B K400, the paper's eventful configuration -------------------------------
#
# configs/models/vivit_b_kinetics400.yml with configs/evaluate/vivit_kinetics400/
# _temporal.yml and temporal_24.yml: 3 spatial x 4 temporal = 12 views of 32
# frames at stride 2, 224 x 224, an EventfulBlock with the bfloat16 A.V cast in
# every spatial block, TokenNormTopK(k=24) on every gate; the dense twin is
# base.yml (Block everywhere). The input: one raw uint8 clip of 10 s at the K400
# loader's 25 fps and 224 short edge (scripts/evaluate/vivit_kinetics400.py:31),
# 1 x 250 x 3 x 224 x 398, through FactorizedViViT.apply.
EV_CLIP = (1, 250, 3, 224, 398)
EV_SPATIAL_VIEWS, EV_TEMPORAL_VIEWS, EV_K = 3, 4, 24
# The JAX package's counted GFLOPs per clip, from ``python
# scripts/misc/count_vivit.py`` (the JAX package on the CPU, one view at full
# width and depth, times 12 views): every run of the eventful model counts alike.
EV_GFLOPS_DENSE, EV_GFLOPS_EVENTFUL = 3359.582406336, 617.754671616
# the float32 card-vs-CPU check's spatial depth (cut from 12 to keep the
# script's time: the CPU side of that check took about 10 s at full depth)
EV_CHECK_DEPTH = 2
# the runs of the eventful model: "auto" ("v2mlp"), the forced gate-fusion
# regimes, the reference's cached q.kT product through the A.V kernel's logits
# form, and the reference's delta-accumulated A.V product; each sets these
# attributes on every spatial block
EV_RUNS = {
    "auto": {},
    "v1": dict(fused_gates="v1"),
    "v1v2": dict(fused_gates="v1v2"),
    "v3": dict(fused_gates="v3"),
    "cached_product": dict(recompute_product=False, av_kernel=True),
    "delta_accumulator": dict(recompute_av=False),
}
# Launches per clip beyond the temporal model's (window_attention and
# dense_mlp_residual, once per temporal block): per incremental step (15) and
# spatial block (12), "v2mlp" runs ln_norms and gate_group_mlp in its MLP
# group; "v1" ln_norms and ln_select_matmul in the qkv group, ln_select_matmul
# in the projection group, ln_norms and ln_select in the MLP group; "v1v2"
# the same qkv and projection groups and the "v2mlp" MLP group; "v3" the
# same qkv group, select_linear_skip_norms (which emits the MLP gate's norms)
# and gate_group_mlp; the cached product adds the A.V kernel's logits form to
# "v2mlp". The flush step runs no kernel (its attention carries the cast).
EV_STEP_LAUNCHES = {
    "auto": dict(ln_norms=1, gate_group_mlp=1),
    "v1": dict(ln_norms=2, ln_select_matmul=2, ln_select=1),
    "v1v2": dict(ln_norms=2, ln_select_matmul=2, gate_group_mlp=1),
    "v3": dict(ln_norms=1, ln_select_matmul=1, select_linear_skip_norms=1, gate_group_mlp=1),
    "cached_product": dict(ln_norms=1, gate_group_mlp=1, softmax_select_matmul_logits=1),
    "delta_accumulator": dict(ln_norms=1, gate_group_mlp=1),
}
# the forced gate-fusion regimes (rows 12-14), whose warm forwards' TMA
# encodes are reported, and those that run again in float32 on the card
FORCED_RUNS = ("v1", "v1v2", "v3")
FORCED_RUNS_F32 = ("v1", "v3")
# the kernels of the path, each with the run whose launches its row reports
EV_KERNELS = {
    "ln_norms": "auto", "gate_group_mlp": "auto", "window_attention": "auto",
    "dense_mlp_residual": "auto", "ln_select_matmul_post": "v1", "ln_select_matmul_none": "v1",
    "ln_select": "v1", "select_linear_skip_norms": "v3",
    "softmax_select_matmul_logits_noterms": "cached_product",
}


def ev_config(eventful, cast="bfloat16", depth=DEPTH):
    block = dict(dim=768, heads=12, mlp_ratio=4)
    return dict(
        classes=400, input_shape=[FRAMES, 3, SIZE, SIZE], normalize_mean=0.45,
        normalize_std=0.225, spatial_views=EV_SPATIAL_VIEWS, temporal_stride=2,
        temporal_views=EV_TEMPORAL_VIEWS, tubelet_shape=[2, 16, 16],
        spatial_config=dict(
            depth=depth, position_encoding_size=[14, 14],
            block_class="EventfulBlock" if eventful else "Block",
            block_config=dict(block, matmul_2_cast=cast) if eventful else block,
        ),
        temporal_config=dict(
            depth=TEMPORAL_DEPTH, position_encoding_size=[16], block_config=block
        ),
    )


def ev_model(eventful, device, dtype, cast="bfloat16", depth=DEPTH):
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.models import FactorizedViViT
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    model = FactorizedViViT(**ev_config(eventful, cast, depth), device=device, seed=SEED)
    if eventful:
        set_policies(model, TokenNormTopK, k=EV_K)
    return model.to(dtype)


def ev_clip(device, seed=SEED):
    """The raw uint8 clip, made on ``device``: one random image with a
    square that drifts a pixel a frame, and a little noise in every frame,
    so that consecutive frames are mostly alike."""
    g = torch.Generator(device=device).manual_seed(seed)
    b, t, c, h, w = EV_CLIP
    base = torch.rand((b, 1, c, h, w), generator=g, device=device) * 255.0
    frames = base.expand(b, t, c, h, w).clone()
    for i in range(t):
        frames[:, i, :, 60:124, 40 + i : 104 + i] = 255.0
    frames += 3.0 * torch.randn(frames.shape, generator=g, device=device)
    return frames.clamp(0.0, 255.0).to(torch.uint8)


def set_ev_run(model, attrs):
    """Every spatial block back to its defaults, then ``attrs`` set."""
    defaults = dict(fused_gates="auto", recompute_product=True, av_kernel="auto",
                    recompute_av=True)
    for blk in model.spatial_model.backbone.blocks:
        for name, value in {**defaults, **attrs}.items():
            setattr(blk, name, value)


def run_apply(model, clip, count=False):
    from eventful_transformer_tpu_torch.core.counting import Ctx

    ctx = Ctx(count_mode=count)
    out = model.apply(ctx, clip)
    if clip.is_cuda:
        torch.cuda.synchronize()
    return out, ctx.counts


def ev_expected_launches(run, depth=DEPTH):
    """Launches per clip: ``run``'s per-step kernels in every one of
    ``depth`` spatial blocks and incremental step, the temporal model's two
    dense kernels once per block; the dense twin (``run`` None) both dense
    kernels in every block of every step and of the temporal model."""
    want = dict.fromkeys(wrappers(), 0)
    want.update(window_attention=TEMPORAL_DEPTH, dense_mlp_residual=TEMPORAL_DEPTH)
    if run is None:
        for name in DENSE_KERNELS:
            want[name] += depth * STEPS
    else:
        for name, count in EV_STEP_LAUNCHES[run].items():
            want[name] = count * depth * (STEPS - 1)
    return want


def ev_counted_run(model, clip, run):
    """One clip through FactorizedViViT.apply, counting FLOPs, with every
    launch count set to 0 just before and read just after; checks the
    launches, the probabilities and the count against the JAX package's.
    Returns (launches, GFLOPs per clip)."""
    reset_launches()
    probs, counts = run_apply(model, clip, count=True)
    launches = read_launches()
    read_routes(model_dtype(model), f"vivit_evblock {run or 'dense'}")
    want = ev_expected_launches(run)
    if launches != want:
        raise AssertionError(f"ViViT {run or 'dense'} launch counts {launches}, expected {want}")
    probs = probs.float()
    if probs.shape != (1, 400) or not torch.isfinite(probs).all():
        raise AssertionError(f"bad ViViT {run or 'dense'} output: shape {tuple(probs.shape)}")
    if abs(float(probs.sum()) - 1.0) > 1e-2:
        raise AssertionError(f"ViViT {run or 'dense'} probabilities sum to {float(probs.sum())}")
    got, ref = gflops(counts), EV_GFLOPS_EVENTFUL if run else EV_GFLOPS_DENSE
    if abs(got - ref) > 1e-6 * ref:
        raise AssertionError(f"ViViT {run or 'dense'}: counted {got} GFLOPs/clip, the JAX "
                             f"package's count is {ref}")
    return launches, got


def phase_ev_kernels(device):
    """The kernels of the path at its shapes (12 views, N = 197, k = 24; the
    logits form over the 197 keys of a view), and the logits form with
    rel-pos terms at ViTDet-1024's pooled shape (2 streams, 4096 queries,
    32 x 32 keys)."""
    views = EV_SPATIAL_VIEWS * EV_TEMPORAL_VIEWS
    names = tuple(name for name in EV_KERNELS if name not in DENSE_KERNELS)
    return check_kernels("vivit_evblock_kernels", device, [
        ("vivit_evblock", views, N_TOKENS, EV_K, names, dict(window=(4, 6), pool=(1, N_TOKENS))),
        ("vivit_evblock_temporal", views, STEPS + 1, STEPS + 1, DENSE_KERNELS,
         dict(window=(4, 6))),
        ("vitdet1024_pooled", VITDET_STREAMS, VITDET[1024]["n"], VITDET_K,
         ("softmax_select_matmul_logits",), VITDET[1024]["inputs"]),
    ])


def ev_f32_forced_runs(cpu_model, clip, device):
    """One clip in float32 on the card under each run of FORCED_RUNS_F32,
    counted: launches, routes (rows 12 and 13 on the float32 core) and the
    probabilities checked; the model ``cpu_model``'s copy. Returns the
    launches by run."""
    model = copy.deepcopy(cpu_model).to(device)
    depth = len(model.spatial_model.backbone.blocks)
    out = {}
    for run in FORCED_RUNS_F32:
        set_ev_run(model, EV_RUNS[run])
        reset_launches()
        probs, _ = run_apply(model, clip)
        launches = read_launches()
        read_routes(torch.float32, f"vivit_evblock {run} float32")
        want = ev_expected_launches(run, depth)
        if launches != want:
            raise AssertionError(f"ViViT {run} float32 launch counts {launches}, expected {want}")
        probs = probs.float()
        if (probs.shape != (1, 400) or not torch.isfinite(probs).all()
                or abs(float(probs.sum()) - 1.0) > 1e-4):
            raise AssertionError(f"bad ViViT {run} float32 output: {probs}")
        out[run] = {k: v for k, v in launches.items() if v}
    return out


def phase_ev_slice(device):
    """The eventful model in bfloat16 under every run of EV_RUNS and its
    dense twin, each one counted clip, the forced runs with the TMA
    descriptors of two warm forwards; then one clip in float32 (the
    matmul-2 cast off) under "auto" on the card against the CPU, the
    spatial stack cut to EV_CHECK_DEPTH blocks, and that model on the card
    under FORCED_RUNS_F32."""
    clip = ev_clip(device)
    eventful = ev_model(True, device, torch.bfloat16)
    dense = ev_model(False, device, torch.bfloat16)
    launches, counted, encodes = {}, {}, {}
    for run, attrs in EV_RUNS.items():
        set_ev_run(eventful, attrs)
        before = tma_encodes()
        launches[run], counted[run] = ev_counted_run(eventful, clip, run)
        if run in FORCED_RUNS:
            encodes[run] = warm_encodes(eventful, clip, before, run=run_apply)
    set_ev_run(eventful, {})
    dense_launches, g_dense = ev_counted_run(dense, clip, None)
    cpu_model = ev_model(True, "cpu", torch.float32, cast=None, depth=EV_CHECK_DEPTH)
    numbers, _ = card_vs_cpu(cpu_model, clip.cpu(), device, run=run_apply)
    f32_launches = ev_f32_forced_runs(cpu_model, clip, device)
    emit(
        "vivit_evblock_slice", clip=list(EV_CLIP), views=EV_SPATIAL_VIEWS * EV_TEMPORAL_VIEWS,
        k=EV_K, dtype="bfloat16", launches_per_clip={
            run: {k: v for k, v in counts.items() if v} for run, counts in launches.items()
        },
        dense_launches_per_clip={k: v for k, v in dense_launches.items() if v},
        gflops_per_clip_eventful=counted, gflops_per_clip_dense=g_dense,
        jax_gflops_per_clip_eventful=EV_GFLOPS_EVENTFUL, jax_gflops_per_clip_dense=EV_GFLOPS_DENSE,
        f32_runs="auto, matmul-2 cast off", f32_depth=EV_CHECK_DEPTH, **numbers,
        f32_card_launches_per_clip=f32_launches, tma_encodes=encodes,
    )
    check_warm_encodes(encodes, "vivit_evblock_slice")
    return eventful, dense, clip, launches, dense_launches


def phase_ev_time(eventful, dense, clip, smi):
    """ms/clip in bfloat16 of the dense twin and of every run of the
    eventful model, alternated (there and back)."""
    order = ["dense"] + list(EV_RUNS)
    times = {name: [] for name in order}
    for name in order + order[::-1]:
        model = dense if name == "dense" else eventful
        if name != "dense":
            set_ev_run(eventful, EV_RUNS[name])
        times[name].append(time_model(model, clip, iters=1, run=run_apply))
    set_ev_run(eventful, {})
    emit("vivit_evblock_time", card=smi, clip=list(EV_CLIP), k=EV_K, dtype="bfloat16",
         ms_per_clip=times)


def ev_path(device, smi):
    """The kernels, the slice and the times of the paper's configuration.
    Returns the kernel rows of the final line and the kernel checks."""
    rows = phase_ev_kernels(device)
    eventful, dense, clip, launches, _ = phase_ev_slice(device)
    phase_ev_time(eventful, dense, clip, smi)
    del dense
    graph_path_b(eventful, clip, smi)
    del eventful, clip
    torch.cuda.empty_cache()
    out = []
    for name, run in EV_KERNELS.items():
        tag = "vivit_evblock_temporal" if name in DENSE_KERNELS else "vivit_evblock"
        out.append(kernel_row(name, rows[(name, torch.bfloat16, tag)], launches[run],
                              f"vivit_evblock_{run}"))
    out.append(kernel_row(
        "softmax_select_matmul_logits",
        rows[("softmax_select_matmul_logits", torch.bfloat16, "vitdet1024_pooled")],
        launches["cached_product"], "vivit_evblock_cached_product",
    ))
    return out, rows


# -- ViTDet-B with the block options: gates before LN, STGT gates, the A.V ablation --
#
# configs/evaluate/vitdet_vid/compare_ln_1024.yml (the paper's LN-placement
# ablation: an EventfulTokenwiseBlock in every block with its gates before
# the LN; k = 512, the first point of its sweep), its twin at 672 on
# tokenwise_672.yml (k = 256), stgt_672.yml (STGT gates in every block, k =
# 256; unfused) and ablate_av_672.yml (global EventfulMatmul1Blocks with the
# bf16 cast, k = 256); 2 streams x 16 frames each through pre_backbone and
# apply_backbone. Per path: the global blocks' class and block options; the
# launches of an incremental frame by wrapper and, for the form-counting
# wrappers, by form (every frame besides runs window_attention in the 8
# windowed blocks and relpos_bias_add_v2 in the 4 global ones: the gates
# before LN and STGT gates hand no norms, so ln_norms runs only in
# ablate_av, once a frame); the JAX package's counted FLOPs per stream, from
# ``python scripts/misc/count_vitdet_672.py --size <size> --config <config>
# [--k 512]``; whether the path is timed (against the dense twin's times
# from the same size's phase).
OPTION_PATHS = {
    "compare_ln_1024": dict(
        size=1024, k=512, global_class="EventfulTokenwiseBlock", options=dict(gate_before_ln=True),
        step_launches=dict(block_select_p=8, block_scatter_rows=8, block_select_scatter=28),
        step_forms=dict(block_select_p=dict(no_ln=8), block_select_scatter=dict(no_ln=28)),
        flops=dict(
            position_add=3145728.0, windowed_flush=30629228160.0,
            windowed_incremental=5246742144.0, global_flush=55600742400.0,
            global_incremental_base=30218256384.0, global_incremental_per_valid_share=0.0,
            windowed_once_per_forward=2304.0,
        ),
        timed=True,
    ),
    "compare_ln_672": dict(
        size=672, k=256, global_class="EventfulTokenwiseBlock", options=dict(gate_before_ln=True),
        step_launches=dict(gate_group_linear=16, gate_group_mlp=12, block_select_p=8,
                           block_scatter_rows=8),
        step_forms=dict(gate_group_linear=dict(pre=4, none=12), gate_group_mlp=dict(pre=12),
                        block_select_p=dict(no_ln=8)),
        flops=dict(
            position_add=1354752.0, windowed_flush=13077590400.0,
            windowed_incremental=2397776256.0, global_flush=17468341632.0,
            global_incremental_base=6788527488.0, global_incremental_per_valid_share=0.0,
            windowed_once_per_forward=0.0,
        ),
        timed=True,
    ),
    "stgt_672": dict(
        size=672, k=256, global_class="EventfulTokenwiseBlock", options=dict(stgt=True),
        step_launches={}, step_forms={},
        flops=dict(
            position_add=1354752.0, windowed_flush=13077590400.0,
            windowed_incremental=2397776256.0, global_flush=17468341632.0,
            global_incremental_base=6788527488.0, global_incremental_per_valid_share=0.0,
            windowed_once_per_forward=0.0,
        ),
        timed=True,
    ),
    "ablate_av_672": dict(
        size=672, k=256, global_class="EventfulMatmul1Block",
        options=dict(matmul_2_cast="bfloat16"),
        step_launches=dict(ln_norms=1, gate_group_linear=16, gate_group_mlp=12,
                           block_select_p=8, block_scatter_rows=8),
        step_forms=dict(gate_group_linear=dict(post=4, none=12), gate_group_mlp=dict(post=12),
                        block_select_p=dict(ln=8)),
        flops=dict(
            position_add=1354752.0, windowed_flush=13077590400.0,
            windowed_incremental=2397776256.0, global_flush=17468341632.0,
            global_incremental_base=5092377984.0, global_incremental_per_valid_share=0.0,
            windowed_once_per_forward=0.0,
        ),
        timed=False,
    ),
}
# The kernel forms these paths add to the final line: (kernel check tag,
# batch, N, k, names, make_inputs keywords) per size, and the path whose
# launches each row reports.
OPTION_KERNEL_CASES = [
    ("compare_ln_1024", VITDET_STREAMS, 64 * 64, 512,
     ("block_select_p_noln", "block_select_scatter_qkv_noln", "block_select_scatter_proj",
      "block_select_scatter_mlp_noln", "block_scatter_rows"),
     dict(window=(14, 14), windows=50, pool=(32, 32), pad_window=(14, 14))),
    ("compare_ln_672", VITDET_STREAMS, 42 * 42, 256,
     ("gate_group_linear_pre", "gate_group_mlp_pre", "block_select_p_noln"),
     dict(window=(14, 14), pool=(21, 21))),
]
# the f32 card-vs-CPU checks cut each path to one windowed and one global block
CUT_DEPTH, CUT_WINDOWS = 2, [0]


def option_config(path, depth=VITDET_DEPTH, window_indices=(0, 1, 3, 4, 6, 7, 9, 10),
                  matmul_2_cast="bfloat16", options=None):
    """The ViTDet-B configuration of an OPTION_PATHS path; ``matmul_2_cast``
    None takes the cast off; ``options`` the blocks' options in place of the
    path's."""
    cfg = OPTION_PATHS[path]
    options = cfg["options"] if options is None else options
    block = dict(dim=768, heads=12, mlp_ratio=4, window_size=[14, 14],
                 relative_embedding_size=[64, 64], **options)
    if "matmul_2_cast" in block:
        block["matmul_2_cast"] = matmul_2_cast
    backbone = dict(depth=depth, position_encoding_size=[14, 14],
                    window_indices=list(window_indices), block_config=block,
                    block_class=cfg["global_class"], windowed_class="EventfulTokenwiseBlock",
                    windowed_overrides=dict(matmul_2_cast=None))
    size = cfg["size"]
    return dict(
        backbone_config=backbone, classes=30, input_shape=[3, size, size],
        normalize_mean=[123.675, 116.28, 103.53], normalize_std=[58.395, 57.12, 57.375],
        output_channels=256, patch_size=[16, 16], scale_factors=[4.0, 2.0, 1.0, 0.5],
    )


def option_model(path, device, dtype, **config):
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.models import ViTDet
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    model = ViTDet(**option_config(path, **config), device=device, seed=SEED)
    set_policies(model, TokenNormTopK, k=OPTION_PATHS[path]["k"])
    return model.to(dtype)


def option_counted_call(path, model, frames, cfg=None):
    """One call of 2 streams x 16 frames with the launch counts set to 0
    just before and read just after, counting FLOPs; checks the launches
    by wrapper and by form, the output and the count against the JAX
    package's. ``cfg``: the path's size, launches and counts, by default
    OPTION_PATHS[path]. Returns (launches, form launches, the port's and
    the JAX package's GFLOPs per frame)."""
    cfg = cfg or OPTION_PATHS[path]
    steps = VITDET_FRAMES - 1
    with pooled_shares() as shares:
        reset_launches()
        tokens, counts, _ = run_vitdet(model, frames, count=True)
        launches, forms = read_launches(), read_form_launches()
        read_routes(frames.dtype, path)
    want = dict.fromkeys(wrappers(), 0)
    want.update(window_attention=VITDET_WINDOWED * VITDET_FRAMES,
                relpos_bias_add_v2=VITDET_GLOBAL * VITDET_FRAMES)
    want.update({name: count * steps for name, count in cfg["step_launches"].items()})
    if launches != want:
        raise AssertionError(f"{path} launch counts {launches}, expected {want}")
    want_forms = expected_forms(cfg["step_forms"], steps)
    if forms != want_forms:
        raise AssertionError(f"{path} launches by form {forms}, expected {want_forms}")
    n = (cfg["size"] // 16) ** 2
    if tokens.shape != (VITDET_STREAMS, n, model.dim) or not torch.isfinite(tokens).all():
        raise AssertionError(f"bad {path} output: shape {tuple(tokens.shape)}")
    got = sum(v for k, v in counts.items() if k != "policy_saturated")
    ref = vitdet_jax_flops(True, shares, cfg["size"], flops=cfg["flops"])
    if abs(got - ref) > 1e-6 * ref:
        raise AssertionError(f"{path}: counted {got} FLOPs per call, the JAX package's count is {ref}")
    return launches, forms, got / VITDET_FRAMES / 1e9, ref / VITDET_FRAMES / 1e9


def option_path(path, device, smi, dense_ms):
    """One OPTION_PATHS path: the counted bf16 call, the f32 check of the
    cut model (one stream x 3 frames), and, where timed, the eventful
    ms/frame twice beside the dense twin's from the same size's phase.
    Returns the launches of the counted call by wrapper and by form."""
    cfg = OPTION_PATHS[path]
    model = option_model(path, device, torch.bfloat16)
    frames = vitdet_frames(VITDET_FRAMES, VITDET_STREAMS, device, torch.bfloat16, cfg["size"])
    launches, forms, g_port, g_jax = option_counted_call(path, model, frames)
    cpu_model = option_model(path, "cpu", torch.float32, depth=CUT_DEPTH,
                             window_indices=CUT_WINDOWS, matmul_2_cast=None)
    clip = vitdet_frames(3, 1, "cpu", torch.float32, cfg["size"], seed=SEED + 1)
    numbers, f32_launches, _ = card_and_cpu(
        cpu_model, clip, device, lambda m, c: (run_vitdet(m, c, keep=True)[2],)
    )
    times = [time_vitdet(model, frames) for _ in range(2)] if cfg["timed"] else None
    emit(
        path, card=smi, streams=VITDET_STREAMS, frames=VITDET_FRAMES, k=cfg["k"],
        dtype="bfloat16", launches={k: v for k, v in launches.items() if v},
        form_launches=forms, gflops_per_frame_eventful=g_port, jax_gflops_per_frame_eventful=g_jax,
        f32_depth=CUT_DEPTH, **numbers,
        columns=["flush_frame_ms", "incremental_frame_ms", "mean_frame_ms"],
        eventful_ms=times, dense_ms_same_size=dense_ms[cfg["size"]] if times else None,
    )
    del model, frames
    torch.cuda.empty_cache()
    return launches, forms


def entry_launches(name, launches, forms):
    """A run's launches of kernel_check entry ``name``: its form's, or its
    wrapper's total."""
    from eventful_transformer_tpu_torch.ops import kernel_check

    wrapper = kernel_check.KERNELS[name][0].__name__
    if name in kernel_check.FORMS:
        return forms[wrapper][kernel_check.FORMS[name]]
    return launches[wrapper]


def option_paths(device, smi, dense_ms):
    """The kernel forms of the option paths at their shapes, then each
    path. Returns the kernel rows of the final line."""
    rows = check_kernels("option_kernels", device, OPTION_KERNEL_CASES)
    counts = {path: option_path(path, device, smi, dense_ms) for path in OPTION_PATHS}
    return [
        kernel_row(name, rows[(name, torch.bfloat16, tag)], entry_launches(name, *counts[tag]),
                   tag)
        for tag, _, _, _, names, _ in OPTION_KERNEL_CASES for name in names
    ]


# -- ViViT-B K400 with every gate before its LN ------------------------------------
#
# The bench's configuration (EventfulTokenwiseBlock, k = 98, 2 clips x 4
# views x 32 frames through apply_views) with gate_before_ln on every
# spatial block. "v4" does not take such a block, so "auto" runs "v2mlp";
# also the forced "v1", "v1v2" and "v3". Per incremental step (15) and
# spatial block (12), launches by wrapper and by form; every run besides
# runs global window_attention in each spatial block of every step (the
# attention of the "v2mlp"-family steps) and the temporal model's 4 + 4.
PRE_LN_RUNS = ("auto", "v1", "v1v2", "v3")
PRE_LN_STEP_LAUNCHES = {
    "auto": dict(gate_group_mlp=1),
    "v1": dict(ln_select_matmul=2, ln_select=1),
    "v1v2": dict(ln_select_matmul=2, gate_group_mlp=1),
    "v3": dict(ln_select_matmul=1, select_linear_skip_norms=1, gate_group_mlp=1),
}
PRE_LN_STEP_FORMS = {
    "auto": dict(gate_group_mlp=dict(pre=1)),
    "v1": dict(ln_select_matmul=dict(pre=1, none=1), ln_select=dict(no_ln=1)),
    "v1v2": dict(ln_select_matmul=dict(pre=1, none=1), gate_group_mlp=dict(pre=1)),
    "v3": dict(ln_select_matmul=dict(pre=1), select_linear_skip_norms=dict(no_ln=1),
               gate_group_mlp=dict(pre=1)),
}
# the kernel forms of the path at its shapes (8 views, N = 197, k = 98) and
# the run whose launches each row reports
PRE_LN_KERNELS = {
    "gate_group_mlp_pre": "auto", "ln_select_matmul_pre": "v1",
    "select_linear_skip_norms_noln": "v3", "ln_select_noln": "v1",
}
# the f32 check's spatial depth (one clip, every view and frame)
PRE_LN_CHECK_DEPTH = 2
# The JAX package's counted GFLOPs per clip, from ``python
# scripts/misc/count_vivit.py --bench --k 98 --gate-before-ln``: the post-LN
# count (GFLOPS_EVENTFUL, unrounded), since LN placement moves no counted op.
GFLOPS_EVENTFUL_PER_CLIP = 615.183057472


def pre_ln_model(device, dtype, depth=DEPTH):
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.models import FactorizedViViT
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    config = vivit_config(True)
    config["spatial_config"] = dict(
        config["spatial_config"], depth=depth,
        block_config=dict(config["spatial_config"]["block_config"], gate_before_ln=True),
    )
    model = FactorizedViViT(**config, device=device, seed=SEED)
    set_policies(model, TokenNormTopK, k=K)
    return model.to(dtype)


def pre_ln_counted_run(model, views, run):
    """One forward under ``run`` with the counts set to 0 just before and
    read just after, counting FLOPs; checks launches by wrapper and form,
    the probabilities and the count against the JAX package's. Returns
    (launches, form launches, GFLOPs per clip)."""
    for blk in model.spatial_model.backbone.blocks:
        blk.fused_gates = run
    reset_launches()
    probs, counts = run_model(model, views, count=True)
    launches, forms = read_launches(), read_form_launches()
    read_routes(views.dtype, f"vivit_pre_ln {run}")
    steps = DEPTH * (STEPS - 1)
    want = dict.fromkeys(wrappers(), 0)
    want.update({name: n * steps for name, n in PRE_LN_STEP_LAUNCHES[run].items()})
    want["window_attention"] = DEPTH * STEPS + TEMPORAL_DEPTH
    want["dense_mlp_residual"] = TEMPORAL_DEPTH
    if launches != want:
        raise AssertionError(f"ViViT gate_before_ln {run} launch counts {launches}, expected {want}")
    want_forms = expected_forms(PRE_LN_STEP_FORMS[run], steps)
    if forms != want_forms:
        raise AssertionError(f"ViViT gate_before_ln {run} forms {forms}, expected {want_forms}")
    probs = probs.float()
    if probs.shape != (views.shape[0], 400) or not torch.isfinite(probs).all():
        raise AssertionError(f"bad ViViT gate_before_ln output: shape {tuple(probs.shape)}")
    got = gflops(counts) / views.shape[0]
    if abs(got - GFLOPS_EVENTFUL_PER_CLIP) > 1e-6 * GFLOPS_EVENTFUL_PER_CLIP:
        raise AssertionError(f"ViViT gate_before_ln {run}: counted {got} GFLOPs/clip, the JAX "
                             f"package's count is {GFLOPS_EVENTFUL_PER_CLIP}")
    return launches, forms, got


def pre_ln_vivit_path(device, smi):
    """The kernel forms at ViViT's shapes; the model in bfloat16 under every
    run, counted; one clip in float32 under "auto" on the card against the
    CPU (the spatial stack cut to PRE_LN_CHECK_DEPTH blocks); "auto"
    timed, alternated with the dense twin. Returns the kernel rows of the
    final line."""
    rows = check_kernels("vivit_pre_ln_kernels", device, [
        ("vivit_pre_ln", CLIPS * VIEWS, N_TOKENS, K, tuple(PRE_LN_KERNELS), dict(window=(4, 6))),
    ])
    from eventful_transformer_tpu_torch.models import FactorizedViViT

    views = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (CLIPS, VIEWS, FRAMES, 3, SIZE, SIZE)).astype(np.float32))
    views_bf16 = views.to(device, torch.bfloat16)
    model = pre_ln_model(device, torch.bfloat16)
    launches, forms, counted, encodes = {}, {}, {}, {}
    for run in PRE_LN_RUNS:
        before = tma_encodes()
        launches[run], forms[run], counted[run] = pre_ln_counted_run(model, views_bf16, run)
        if run in FORCED_RUNS:
            encodes[run] = warm_encodes(model, views_bf16, before)
    for blk in model.spatial_model.backbone.blocks:
        blk.fused_gates = "auto"
    numbers, _ = card_vs_cpu(pre_ln_model("cpu", torch.float32, depth=PRE_LN_CHECK_DEPTH),
                             views[:1], device)
    dense = FactorizedViViT(**vivit_config(False), device=device, seed=SEED).to(torch.bfloat16)
    times = {"dense": [], "auto": []}
    for name in ("dense", "auto", "auto", "dense"):
        # two warm-ups: the float32 check just freed the card's memory, and
        # the caching allocator places "auto"'s scratch anew in the first
        # two forwards after it (one warm-up left the first timed run
        # encoding TMA descriptors)
        times[name].append(time_model(model if name == "auto" else dense, views_bf16, warmup=2))
    emit(
        "vivit_pre_ln", card=smi, clips=CLIPS, views=VIEWS, frames=FRAMES, k=K, dtype="bfloat16",
        launches={run: {k: v for k, v in c.items() if v} for run, c in launches.items()},
        form_launches=forms, gflops_per_clip=counted, jax_gflops_per_clip=GFLOPS_EVENTFUL_PER_CLIP,
        f32_run="auto", f32_depth=PRE_LN_CHECK_DEPTH, **numbers,
        dense_ms_per_clip=times["dense"], auto_ms_per_clip=times["auto"], tma_encodes=encodes,
    )
    check_warm_encodes(encodes, "vivit_pre_ln")
    del model, dense, views_bf16
    torch.cuda.empty_cache()
    return [
        kernel_row(name, rows[(name, torch.bfloat16, "vivit_pre_ln")],
                   entry_launches(name, launches[run], forms[run]), f"vivit_pre_ln_{run}")
        for name, run in PRE_LN_KERNELS.items()
    ]


# -- The group kernels' own top-k and the scatter-blend: two switches -----------------
#
# EventfulTokenwiseBlock.in_kernel_topk = True (bench.py --topk-in-kernel;
# core/blocks.py:1400-1460 of the JAX package) lets gate_group_linear and
# gate_group_mlp select their own rows (cov=None) where no norms were handed
# over and no index is needed; share_gate_passes = False (bench.py
# --no-share) stops the handoff of norms, which otherwise switches that off.
# core.indexing.USE_PALLAS_BLEND = True routes put_rows to scatter_blend.
#   A. ViViT-B of phase 4 forced to "v2mlp" (bench.py --fused v2mlp
#      --topk-in-kernel): the MLP group of every block step selects its rows.
#   B. spatiotemporal_672 with in_kernel_topk forced on every eventful block,
#      sharing off and on; counted only, with sharing off, its tokenwise twin
#      (tokenwise_672: the global blocks' qkv groups select, "post") and
#      compare_ln_672 (the "pre" forms).
#   C. stgt_672 with USE_PALLAS_BLEND: every buffer scatter (qkv 3C,
#      projection and MLP C) of every block and incremental frame.
# The kernel forms at the paths' shapes, with exact ties planted at the k-th
# norm in one case of each size; the blend at path C's buffer widths (C, 3C,
# and 4C besides), with and without a mask and with a duplicated index.
TOPK_NAMES = ("gate_group_linear_topk", "gate_group_linear_post_topk", "gate_group_linear_pre_topk",
              "gate_group_mlp_topk", "gate_group_mlp_pre_topk")
TOPK_KERNEL_CASES = [
    ("vivit_topk", CLIPS * VIEWS, N_TOKENS, K, ("gate_group_mlp_topk",), dict(window=(4, 6))),
    ("vivit_topk_ties", CLIPS * VIEWS, N_TOKENS, K, ("gate_group_mlp_topk",),
     dict(window=(4, 6), ties="gate_group_mlp_topk")),
    ("672_topk", VITDET_STREAMS, VITDET[672]["n"], VITDET_K, TOPK_NAMES, VITDET[672]["inputs"]),
    ("672_topk_ties", VITDET_STREAMS, VITDET[672]["n"], VITDET_K, ("gate_group_linear_topk",),
     dict(VITDET[672]["inputs"], ties="gate_group_linear_topk")),
]
BLEND_NAMES = ("scatter_blend", "scatter_blend_masked", "scatter_blend_qkv", "scatter_blend_wide",
               "scatter_blend_duplicate")
BLEND_KERNEL_CASES = [
    ("stgt_672", VITDET_STREAMS, VITDET[672]["n"], VITDET_K, BLEND_NAMES, VITDET[672]["inputs"]),
    ("vivit_blend", CLIPS * VIEWS, N_TOKENS, K, BLEND_NAMES, dict(window=(4, 6))),
]
# Path A per incremental step and spatial block, by wrapper and by form, with
# the switch on and off; every run besides runs window_attention in each
# spatial block of every step and the temporal model's two dense kernels.
VIVIT_TOPK_STEP = {
    True: (dict(gate_group_mlp=1), dict(gate_group_mlp=dict(post_topk=1))),
    False: (dict(ln_norms=1, gate_group_mlp=1), dict(gate_group_mlp=dict(post=1))),
}
# Path B per incremental frame (frame 0 a flush; 8 windowed blocks whose qkv
# groups keep window-major buffers and select outside; 4 global blocks): the
# JAX package's counts (FLOPs per stream, as OPTION_PATHS) and whether the
# run is timed. spatiotemporal_672's global EventfulBlocks need the qkv
# index (their attention gathers), so their qkv groups select outside;
# handed-over norms (sharing) take the MLP groups' own selection away.
_ST = dict(block_select_p=8, block_scatter_rows=8, gate_group_linear=16, gate_group_mlp=12)
TOPK_VITDET_RUNS = {
    "spatiotemporal_672_no_share": dict(
        model="spatiotemporal", share=False, size=672, flops=VITDET[672]["flops"],
        step_launches=dict(_ST, ln_norms=12),
        step_forms=dict(gate_group_linear=dict(post=4, none_topk=12),
                        gate_group_mlp=dict(post_topk=12), block_select_p=dict(ln=8)),
    ),
    "spatiotemporal_672_share": dict(
        model="spatiotemporal", share="auto", size=672, flops=VITDET[672]["flops"],
        step_launches=dict(_ST, ln_norms=1),
        step_forms=dict(gate_group_linear=dict(post=4, none_topk=12),
                        gate_group_mlp=dict(post=12), block_select_p=dict(ln=8)),
    ),
    "tokenwise_672_no_share": dict(
        model="tokenwise", share=False, size=672, flops=OPTION_PATHS["compare_ln_672"]["flops"],
        step_launches=dict(_ST, ln_norms=8),
        step_forms=dict(gate_group_linear=dict(post_topk=4, none_topk=12),
                        gate_group_mlp=dict(post_topk=12), block_select_p=dict(ln=8)),
    ),
    "compare_ln_672": dict(
        model="compare_ln", share="auto", size=672, flops=OPTION_PATHS["compare_ln_672"]["flops"],
        step_launches=_ST,
        step_forms=dict(gate_group_linear=dict(pre_topk=4, none_topk=12),
                        gate_group_mlp=dict(pre_topk=12), block_select_p=dict(no_ln=8)),
    ),
}
# the final line's rows: (kernel check tag, name, the run whose launches it
# reports)
TOPK_ROWS = [
    ("vivit_topk", "gate_group_mlp_topk", "vivit_v2mlp"),
    ("672_topk", "gate_group_mlp_topk", "spatiotemporal_672_no_share"),
    ("672_topk", "gate_group_linear_topk", "spatiotemporal_672_no_share"),
    ("672_topk", "gate_group_linear_post_topk", "tokenwise_672_no_share"),
    ("672_topk", "gate_group_linear_pre_topk", "compare_ln_672"),
    ("672_topk", "gate_group_mlp_pre_topk", "compare_ln_672"),
]
# path C per incremental frame: the blend in the qkv, projection and MLP
# buffers of the 12 blocks
STGT_BLEND_STEP = 3 * VITDET_DEPTH


def set_blocks(model, **attrs):
    """``attrs`` on every eventful block of ``model``."""
    from eventful_transformer_tpu_torch.core.blocks import EventfulTokenwiseBlock

    for blk in model.modules():
        if isinstance(blk, EventfulTokenwiseBlock):
            for name, value in attrs.items():
                setattr(blk, name, value)


def switch_runs(model, inputs, run, set_switch):
    """``run(model, inputs)`` with the switch off, then on, each with the
    gate selections recorded. Returns ({False: out, True: out}, the
    selections made, the selections that differ between the two runs)."""
    logs, outs = {False: [], True: []}, {}
    for on in (False, True):
        set_switch(on)
        with recorded_selections(logs[on]):
            outs[on] = run(model, inputs)
    set_switch(False)
    selections, flips = selection_flips(logs[True], logs[False])
    if flips > MAX_FLIP_SHARE * selections:
        raise AssertionError(f"the switch moved {flips} of {selections} selections")
    return outs, selections, flips


def alternated(timers, order):
    """Each ``timers[name]()`` in ``order`` and back (there and back)."""
    times = {name: [] for name in order}
    for name in list(order) + list(order)[::-1]:
        times[name].append(timers[name]())
    return times


def vivit_topk_counted_run(model, views, on):
    """One bf16 forward of path A with the switch on or off, the counts set
    to 0 just before and read just after: launches by wrapper and form and
    the counted GFLOPs per clip, checked."""
    set_blocks(model, in_kernel_topk=on)
    reset_launches()
    probs, counts = run_model(model, views, count=True)
    launches, forms = read_launches(), read_form_launches()
    read_routes(views.dtype, f"topk_slice_vivit {'on' if on else 'off'}")
    set_blocks(model, in_kernel_topk=False)
    steps = DEPTH * (STEPS - 1)
    step_launches, step_forms = VIVIT_TOPK_STEP[on]
    want = dict.fromkeys(wrappers(), 0)
    want.update({name: n * steps for name, n in step_launches.items()})
    want.update(window_attention=DEPTH * STEPS + TEMPORAL_DEPTH, dense_mlp_residual=TEMPORAL_DEPTH)
    if launches != want:
        raise AssertionError(f"ViViT v2mlp topk={on} launch counts {launches}, expected {want}")
    want_forms = expected_forms(step_forms, steps)
    if forms != want_forms:
        raise AssertionError(f"ViViT v2mlp topk={on} forms {forms}, expected {want_forms}")
    probs = probs.float()
    if probs.shape != (views.shape[0], 400) or not torch.isfinite(probs).all():
        raise AssertionError(f"bad ViViT v2mlp output: shape {tuple(probs.shape)}")
    got = gflops(counts) / views.shape[0]
    if abs(got - GFLOPS_EVENTFUL_PER_CLIP) > 1e-6 * GFLOPS_EVENTFUL_PER_CLIP:
        raise AssertionError(f"ViViT v2mlp topk={on}: counted {got} GFLOPs/clip, the JAX "
                             f"package's count is {GFLOPS_EVENTFUL_PER_CLIP}")
    return launches, forms, got


def vivit_topk_path(device, smi):
    """Path A: the counted bf16 forward with the switch on and off; one
    clip in float32 on the card with the switch off and on (probabilities
    within PROB_TOL, selections within MAX_FLIP_SHARE); ms/clip on and off,
    alternated. Returns the launches by form of the switch-on run."""
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.models import FactorizedViViT
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    views = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (CLIPS, VIEWS, FRAMES, 3, SIZE, SIZE)).astype(np.float32))
    model = FactorizedViViT(**vivit_config(True), device=device, seed=SEED)
    set_policies(model, TokenNormTopK, k=K)
    set_blocks(model, fused_gates="v2mlp")
    f32_views = views[:1].to(device)
    outs, selections, flips = switch_runs(
        model, f32_views, lambda m, v: run_model(m, v)[0],
        lambda on: set_blocks(model, in_kernel_topk=on),
    )
    prob_diff = float((outs[True] - outs[False]).abs().max())
    if prob_diff > PROB_TOL:
        raise AssertionError(f"ViViT v2mlp float32: the switch moved probabilities by {prob_diff}")
    model = model.to(torch.bfloat16)
    views_bf16 = views.to(device, torch.bfloat16)
    counted = {on: vivit_topk_counted_run(model, views_bf16, on) for on in (True, False)}

    def timer(on):
        def timed():
            set_blocks(model, in_kernel_topk=on)
            return time_model(model, views_bf16)
        return timed

    times = alternated({"off": timer(False), "on": timer(True)}, ("off", "on"))
    set_blocks(model, in_kernel_topk=False)
    emit(
        "topk_slice_vivit", card=smi, clips=CLIPS, views=VIEWS, frames=FRAMES, k=K, dtype="bfloat16",
        regime="v2mlp", launches={str(on): {k: v for k, v in c[0].items() if v}
                                  for on, c in counted.items()},
        form_launches={str(on): c[1] for on, c in counted.items()},
        gflops_per_clip={str(on): c[2] for on, c in counted.items()},
        jax_gflops_per_clip=GFLOPS_EVENTFUL_PER_CLIP,
        f32_switch_max_prob_diff=prob_diff, prob_tol=PROB_TOL, gate_selections=selections,
        selections_differing=flips, max_flip_share=MAX_FLIP_SHARE,
        ms_per_clip=times,
    )
    del model, views_bf16
    torch.cuda.empty_cache()
    return counted[True][1]


def topk_vitdet_model(kind, device, dtype, matmul_2_cast="bfloat16"):
    """spatiotemporal_672 (k = 256), tokenwise_672 or compare_ln_672."""
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.models import ViTDet
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    if kind == "spatiotemporal":
        model = ViTDet(**vitdet_config(True, 672, matmul_2_cast), device=device, seed=SEED)
        set_policies(model, TokenNormTopK, k=VITDET_K)
        return model.to(dtype)
    return option_model("compare_ln_672", device, dtype,
                        options={} if kind == "tokenwise" else None)


def vitdet_topk_path(device, smi):
    """Path B: each run of TOPK_VITDET_RUNS counted in bf16 with the switch
    on (launches by wrapper and form, GFLOPs against the JAX package's);
    spatiotemporal_672 in float32 (cast off), one stream x 3 frames, with
    the switch off and on, sharing off (tokens within VITDET_TOKEN_TOL,
    selections within MAX_FLIP_SHARE); ms/frame with the switch off
    (sharing on, the default), on without sharing and on with it,
    alternated. Returns the launches by form of each run."""
    model = topk_vitdet_model("spatiotemporal", device, torch.float32, matmul_2_cast=None)
    set_blocks(model, share_gate_passes=False)
    clip = vitdet_frames(3, 1, device, torch.float32, 672, seed=SEED + 1)
    outs, selections, flips = switch_runs(
        model, clip, lambda m, c: run_vitdet(m, c, keep=True)[2],
        lambda on: set_blocks(model, in_kernel_topk=on),
    )
    scaled = max(float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
                 for a, b in zip(outs[True], outs[False]))
    if scaled > VITDET_TOKEN_TOL:
        raise AssertionError(f"spatiotemporal_672 float32: the switch moved tokens by {scaled}")
    del model, outs
    frames = vitdet_frames(VITDET_FRAMES, VITDET_STREAMS, device, torch.bfloat16, 672)
    models = {kind: topk_vitdet_model(kind, device, torch.bfloat16)
              for kind in ("spatiotemporal", "tokenwise", "compare_ln")}
    counted = {}
    for run, cfg in TOPK_VITDET_RUNS.items():
        model = models[cfg["model"]]
        set_blocks(model, in_kernel_topk=True, share_gate_passes=cfg["share"])
        counted[run] = option_counted_call(run, model, frames, cfg=cfg)
        set_blocks(model, in_kernel_topk=False, share_gate_passes="auto")
    model = models["spatiotemporal"]

    def timer(on, share):
        def timed():
            set_blocks(model, in_kernel_topk=on, share_gate_passes=share)
            return time_vitdet(model, frames)
        return timed

    times = alternated({"off": timer(False, "auto"), "on_no_share": timer(True, False),
                        "on_share": timer(True, "auto")}, ("off", "on_no_share", "on_share"))
    set_blocks(model, in_kernel_topk=False, share_gate_passes="auto")
    emit(
        "topk_slice_vitdet", card=smi, streams=VITDET_STREAMS, frames=VITDET_FRAMES, k=VITDET_K,
        dtype="bfloat16", launches={run: {k: v for k, v in c[0].items() if v}
                                    for run, c in counted.items()},
        form_launches={run: c[1] for run, c in counted.items()},
        gflops_per_frame={run: c[2] for run, c in counted.items()},
        jax_gflops_per_frame={run: c[3] for run, c in counted.items()},
        f32_run="spatiotemporal_672, sharing off, switch off against on, 1 stream x 3 frames",
        f32_switch_max_scaled_token_err=scaled, token_tol=VITDET_TOKEN_TOL,
        gate_selections=selections, selections_differing=flips, max_flip_share=MAX_FLIP_SHARE,
        columns=["flush_frame_ms", "incremental_frame_ms", "mean_frame_ms"], ms=times,
    )
    del models, model, frames
    torch.cuda.empty_cache()
    return {run: c[1] for run, c in counted.items()}


def topk_paths(device, smi):
    """The cov=None forms at the paths' shapes, then paths A and B. Returns
    the kernel rows of the final line."""
    rows = check_kernels("topk_kernels", device, TOPK_KERNEL_CASES)
    forms = {"vivit_v2mlp": vivit_topk_path(device, smi), **vitdet_topk_path(device, smi)}
    return [
        kernel_row(name, rows[(name, torch.bfloat16, tag)], entry_launches(name, None, forms[run]),
                   f"topk_{run}")
        for tag, name, run in TOPK_ROWS
    ]


def blend_path(device, smi):
    """The blend at its shapes; path C: stgt_672 in bf16, counted with the
    switch on (launches, GFLOPs against the JAX package's), its tokens of
    every frame bit-identical with the switch off and on in bf16 (2 streams
    x 16 frames) and float32 (1 stream x 3 frames), ms/frame off and on,
    alternated. Returns the kernel rows of the final line."""
    from eventful_transformer_tpu_torch.core import indexing

    rows = check_kernels("blend_kernels", device, BLEND_KERNEL_CASES)

    def set_blend(on):
        indexing.USE_PALLAS_BLEND = on

    identical = {}
    for dtype, streams, frames_n in ((torch.float32, 1, 3),
                                     (torch.bfloat16, VITDET_STREAMS, VITDET_FRAMES)):
        model = option_model("stgt_672", device, dtype)
        frames = vitdet_frames(frames_n, streams, device, dtype, 672)
        outs = {}
        for on in (False, True):
            set_blend(on)
            outs[on] = run_vitdet(model, frames, keep=True)[2]
        set_blend(False)
        same = all(torch.equal(a, b) for a, b in zip(outs[True], outs[False]))
        identical[str(dtype).split(".")[-1]] = same
        if not same:
            raise AssertionError(f"stgt_672 {dtype}: the blend changed the tokens")
    cfg = dict(OPTION_PATHS["stgt_672"], step_launches=dict(scatter_blend=STGT_BLEND_STEP))
    set_blend(True)
    launches, forms, g_port, g_jax = option_counted_call("stgt_672", model, frames, cfg=cfg)
    set_blend(False)

    def timer(on):
        def timed():
            set_blend(on)
            return time_vitdet(model, frames)
        return timed

    times = alternated({"off": timer(False), "on": timer(True)}, ("off", "on"))
    set_blend(False)
    emit(
        "blend_slice", path="stgt_672", card=smi, streams=VITDET_STREAMS, frames=VITDET_FRAMES, k=VITDET_K,
        dtype="bfloat16", launches={k: v for k, v in launches.items() if v},
        gflops_per_frame=g_port, jax_gflops_per_frame=g_jax, tokens_identical=identical,
        columns=["flush_frame_ms", "incremental_frame_ms", "mean_frame_ms"], ms=times,
    )
    del model, frames
    torch.cuda.empty_cache()
    return [
        kernel_row(name, rows[(name, torch.bfloat16, "stgt_672")], launches, "blend_stgt_672")
        for name in ("scatter_blend", "scatter_blend_qkv")
    ]


# -- The kernels no path of the JAX package calls (rows 15, 19-21) -------------------
#
# Each at the shapes of the paths whose work it does (PERF.md sections 4 and
# 6): the row scatter and gather at stgt_672's C- and 3C-wide buffers (k =
# 256) and the paper's ViViT's qkv buffer (12 views, k = 24); the fused
# attention at ViViT's spatial and temporal shapes; the grid form at 672
# (the 42 x 42 map is 3 x 3 windows of 14 x 14) and 1024 (64 x 64 padded to
# 5 x 5 windows, the pad positions holding the qkv-bias row).
ROWS_NAMES = ("scatter_rows_inplace", "scatter_rows_inplace_masked", "scatter_rows_inplace_qkv",
              "scatter_rows_inplace_qkv_masked", "scatter_rows_inplace_cast", "gather_rows",
              "gather_rows_qkv")
FUSED_NAMES = ("fused_attention", "fused_attention_cast")
GRID_NAMES = ("window_attention_grid", "window_attention_grid_noterms")
UNWIRED_CASES = [
    ("672", VITDET_STREAMS, VITDET[672]["n"], VITDET_K, ROWS_NAMES + GRID_NAMES,
     dict(window=(14, 14), pad_window=(14, 14))),
    ("vivit_evblock", EV_SPATIAL_VIEWS * EV_TEMPORAL_VIEWS, N_TOKENS, EV_K,
     tuple(name for name in ROWS_NAMES if name.endswith(("_qkv", "_qkv_masked", "_cast"))),
     dict(window=(4, 6))),
    ("vivit", CLIPS * VIEWS, N_TOKENS, K, FUSED_NAMES, dict(window=(4, 6))),
    ("temporal", CLIPS * VIEWS, STEPS + 1, STEPS + 1, FUSED_NAMES, dict(window=(4, 6))),
    ("1024", VITDET_STREAMS, VITDET[1024]["n"], VITDET_K, GRID_NAMES[:1],
     dict(window=(14, 14), windows=50, pad_window=(14, 14))),
]
# the final line's row of each kernel: (entry, case)
UNWIRED_ROWS = [("scatter_rows_inplace_qkv", "672"), ("gather_rows_qkv", "672"),
                ("fused_attention", "vivit"), ("window_attention_grid", "672")]
CROSS_TOL = 1e-5  # scaled, float32: the two kernels differ in summation order only


def scaled_err(got, want):
    return float(((got - want).abs() / want.abs().clamp(min=1.0)).max())


def rows_against_indexing(d, names):
    """Each row scatter and gather of ``names`` against put_rows and
    take_rows on the same index: equal element for element; the cast entry
    also into a bfloat16 buffer."""
    from eventful_transformer_tpu_torch.core.indexing import put_rows, take_rows
    from eventful_transformer_tpu_torch.ops import kernel_check
    from eventful_transformer_tpu_torch.ops.scatter import gather_rows, scatter_rows_inplace

    out = {}
    for name in names:
        buf, values, index, mask = kernel_check.ROWS_INPUTS[name]
        x, idx = d[buf], d[index]
        if values is None:
            out[name] = dict(ok=torch.equal(gather_rows(x, idx), take_rows(x, idx)))
            continue
        m = None if mask is None else d[mask]
        targets = (x, x.to(torch.bfloat16)) if name.endswith("_cast") else (x,)
        out[name] = dict(ok=all(
            torch.equal(scatter_rows_inplace(t.clone(), d[values], idx, m),
                        put_rows(t, idx, d[values], m))
            for t in targets
        ))
    return out


def fused_against_global(d):
    """fused_attention (no cast) against the global window_attention on the
    same qkv, scaled error; the same qkv as a batch slice of a larger
    tensor (the same result bit for bit) and as a slice of a wider one's
    last axis (refused on the card, or else the same result); the cast
    form beside the no-cast one (their gap, one bfloat16 rounding of the
    probabilities, within the bfloat16 outputs' scaled bound)."""
    from eventful_transformer_tpu_torch.ops import kernel_check
    from eventful_transformer_tpu_torch.ops.attention import fused_attention
    from eventful_transformer_tpu_torch.ops.window_attention import window_attention

    qkv, heads = d["qkv"], d["heads"]
    scale = (qkv.shape[-1] // 3 // heads) ** 0.5
    got = fused_attention(qkv, heads=heads, scale=scale)
    err = scaled_err(got, window_attention(qkv, heads=heads, scale=scale))
    cast_gap = scaled_err(fused_attention(qkv, heads=heads, scale=scale, cast=torch.bfloat16), got)
    offset = torch.cat([qkv[:1], qkv])[1:]
    same = torch.equal(fused_attention(offset, heads=heads, scale=scale), got)
    try:
        strided = fused_attention(torch.cat([qkv, qkv[..., :8]], -1)[..., :-8], heads=heads,
                                  scale=scale)
        strided_view = "taken, the same" if torch.equal(strided, got) else "taken, wrong"
    except ValueError:
        strided_view = "refused"
    return {
        "fused_attention": dict(
            against="window_attention", scaled_err=err, offset_view_same=same,
            strided_view=strided_view,
            ok=err <= CROSS_TOL and same and strided_view != "taken, wrong",
        ),
        "fused_attention_cast": dict(
            against="fused_attention", scaled_err=cast_gap,
            ok=cast_gap <= kernel_check.BF16_BOUNDS["scaled"],
        ),
    }


def grid_against_partitioned(d):
    """window_attention_grid over the map against window_attention over
    its partition, with and without the rel-pos terms of the same tables:
    the windowed form where the map is the image (672), the padded form
    (the zero-padded partition, the bias row and its terms substituted)
    where it is padded (1024); scaled error at the image's rows."""
    from eventful_transformer_tpu_torch.ops import window_attention as wa

    x, heads, (a0, a1) = d["qkv_map"], d["heads"], d["pad_window"]
    b, hp, wp, c3 = x.shape
    c = c3 // 3
    scale = (c // heads) ** 0.5
    nh, nw, h, w = d["geom"]
    tab = torch.cat([d["rel_y"].repeat_interleave(a1, dim=0), d["rel_x"].repeat(a0, 1, 1)], 1)
    padded = (h, w) != (hp, wp)
    if padded:
        win, pad = d["qkv_pad"], dict(pad_bias=d["pad_bias"], a=(a0, a1), geom=d["geom"])
    else:
        win = x.reshape(b, nh, a0, nw, a1, c3).permute(0, 1, 3, 2, 4, 5).reshape(-1, a0 * a1, c3)
        pad = {}
    out = {}
    for name in ("window_attention_grid", "window_attention_grid_noterms"):
        if name.endswith("_noterms"):
            if padded:
                continue
            got = wa.window_attention_grid(x, heads=heads, scale=scale, window=(a0, a1))
            want = wa.window_attention(win, heads=heads, scale=scale)
        else:
            got = wa.window_attention_grid(x, d["rel_y"], d["rel_x"], heads=heads, scale=scale,
                                           window=(a0, a1), a=(a0, a1))
            terms = wa.window_bias_terms(win, tab, heads)
            if padded:
                pad["pad_terms"] = wa.window_bias_pad_terms(d["pad_bias"], tab, heads)
            want = wa.window_attention(win, terms, heads=heads, scale=scale, p=(a0, a1), **pad)
        want = want.reshape(b, nh, nw, a0, a1, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        err = scaled_err(got[:, :h, :w], want[:, :h, :w])
        out[name] = dict(against="window_attention_padded" if padded else "window_attention",
                         scaled_err=err, ok=err <= CROSS_TOL)
    return out


# the entries whose host microseconds a call the final line's rows carry
# (row 15 at every shape; its library call beside it), by case; rows 18-20
# carry theirs from check_kernels (row_copy_readings)
UNWIRED_HOST = {
    "672": ("window_attention_grid", "window_attention_grid_noterms"),
    "1024": ("window_attention_grid",),
}


def unwired_host(device):
    """Host microseconds of one bfloat16 call of each UNWIRED_HOST entry and
    of its library call (``kernel_check.host_us``), keyed (name, tag)."""
    from eventful_transformer_tpu_torch.ops import kernel_check

    out = {}
    for tag, bsz, n, k, _, inputs in UNWIRED_CASES:
        if tag not in UNWIRED_HOST:
            continue
        d = kernel_check.make_inputs(bsz, n, 768, 12, k, torch.bfloat16, device, seed=SEED,
                                     **inputs)
        for name in UNWIRED_HOST[tag]:
            library = kernel_check.library_call(name, d)
            out[(name, tag)] = dict(
                host_us=kernel_check.kernel_host_us(name, d),
                library_host_us=None if library is None else kernel_check.host_us(library),
            )
        del d
    emit("unwired_host", dtype="bfloat16",
         rows=[dict(kernel=name, tag=tag, **row) for (name, tag), row in out.items()])
    return out


def unwired_drive(device, dtype):
    """The counted drive of the four kernels at UNWIRED_CASES' inputs in
    ``dtype``: in float32 each wrapper against the ported kernel doing its
    work on the model paths; in bfloat16 each entry against its plain
    version (``kernel_check.errors``). Returns the checks, keyed by case."""
    from eventful_transformer_tpu_torch.ops import kernel_check

    checks = {}
    for tag, bsz, n, k, names, inputs in UNWIRED_CASES:
        d = kernel_check.make_inputs(bsz, n, 768, 12, k, dtype, device, seed=SEED, **inputs)
        if dtype == torch.bfloat16:
            checks[tag] = {name: dict(ok=all(row["ok"] for row in kernel_check.errors(name, d)))
                           for name in names}
            del d
            continue
        row_names = [name for name in names if name in ROWS_NAMES]
        if row_names:
            checks[f"{tag}_rows"] = rows_against_indexing(d, row_names)
        if set(names) & set(FUSED_NAMES):
            checks[f"{tag}_fused_attention"] = fused_against_global(d)
        if set(names) & set(GRID_NAMES):
            checks[f"{tag}_grid"] = grid_against_partitioned(d)
        del d
    torch.cuda.synchronize()
    return checks


def unwired_path(device, smi):
    """The four kernels at their shapes (phase unwired_kernels) and their
    host microseconds a call (phase unwired_host), then the phase's own
    path, twice, with the launch counts set to 0 just before each: in
    float32 (unwired_drive's cross-checks) and in bfloat16 (each kernel
    against its plain version), the attention launches of each read by
    body. Returns the final line's rows."""
    from eventful_transformer_tpu_torch.ops import kernel_check

    rows = check_kernels("unwired_kernels", device, UNWIRED_CASES)
    host = unwired_host(device)
    wrappers = {kernel_check.KERNELS[name][0].__name__: kernel_check.KERNELS[name][0]
                for name, _ in UNWIRED_ROWS}
    drives = {}
    for dtype in (torch.float32, torch.bfloat16):
        kernel_check.reset_launches()
        checks = unwired_drive(device, dtype)
        key = str(dtype).split(".")[-1]
        drives[key] = dict(
            launches={name: fn.launches for name, fn in wrappers.items()},
            form_launches={name: dict(fn.form_launches) for name, fn in wrappers.items()
                           if hasattr(fn, "form_launches")},
            body_launches=read_routes(dtype, f"unwired_path {key}"), checks=checks,
        )
    emit("unwired_path", card=smi, tf32=torch.backends.cuda.matmul.allow_tf32, **drives)
    failed = [f"{dtype}.{key}.{name}" for dtype, drive in drives.items()
              for key, check in drive["checks"].items()
              for name, row in check.items() if not row["ok"]]
    if failed:
        raise AssertionError(f"unwired_path: checks failed: {failed}")
    idle = [f"{dtype}.{name}" for dtype, drive in drives.items()
            for name, count in drive["launches"].items() if count == 0]
    idle += [f"{dtype}.{name}:{form}" for dtype, drive in drives.items()
             for name, counts in drive["form_launches"].items()
             for form, count in counts.items() if count == 0]
    if idle:
        raise AssertionError(f"unwired_path: not launched: {idle}")
    torch.cuda.empty_cache()
    launches = {name: sum(drive["launches"][name] for drive in drives.values())
                for name in wrappers}
    out = []
    for name, tag in UNWIRED_ROWS:
        row = dict(kernel_row(name, rows[(name, torch.bfloat16, tag)], launches, "unwired"),
                   model_path_launches=0)
        wrapper = kernel_check.KERNELS[name][0].__name__
        if (name, tag) in host:
            row.update(host[(name, tag)])
        if wrapper in drives["bfloat16"]["body_launches"]:
            row["body_launches"] = {dtype: drive["body_launches"][wrapper]
                                    for dtype, drive in drives.items()}
        out.append(row)
    return out


# -- the evaluation harness (paths A-C) ---------------------------------------------

# Path A: configs/evaluate/vivit_kinetics400/temporal_24.yml as the port's
# utils/config.py composes it, one generated clip (the JAX script's
# ``synthetic`` override) of HARNESS_CLIP_FRAMES frames of 240 x 320 (the
# preprocessing takes the short edge to 224), swept with top-k 24 and, as
# an override, the threshold HARNESS_VIVIT_THRESHOLD at full capacity (the
# "v2mlp" MLP group on a coverage of fewer than kcap rows, kcap = N = 197).
HARNESS_CLIP_FRAMES = 64
HARNESS_VIVIT_THRESHOLD = 0.5
# Path B: configs/evaluate/vitdet_vid/threshold_1024.yml (thresholds 0.2, 1.0,
# 5.0; buckets 512-4096), one generated video of HARNESS_VID_FRAMES raw
# 720 x 1280 frames through the port's VIDResize (long edge to 1024), one
# ground-truth box a frame; its card-vs-CPU check at VITDET_CHECK_DEPTH
# blocks, HARNESS_CHECK_FRAMES frames, at each of HARNESS_CHECK_THRESHOLDS.
HARNESS_VID_FRAMES = 5
HARNESS_VID_RAW = (720, 1280)
HARNESS_CHECK_FRAMES, HARNESS_CHECK_THRESHOLDS = 3, (0.2,)
# a card-vs-CPU check of path B may differ in this share of the valid
# selections (a norm within summation-order noise of the threshold or of
# the capacity's k-th norm)
HARNESS_MAX_DIFFER_SHARE = 1e-3
HARNESS_COUNTS_RTOL = 1e-6
# path B's launches per incremental frame run (blocked regime, 8 windowed
# and 4 global blocks): block_select_scatter in the 4 global qkv groups and
# every projection and MLP group, the windowed qkv groups' select/scatter
# pair, the global blocks' A.V kernel, ln_norms for the first block
HARNESS_B_STEP = dict(block_select_scatter=VITDET_GLOBAL + 2 * VITDET_DEPTH,
                      block_select_p=VITDET_WINDOWED, block_scatter_rows=VITDET_WINDOWED,
                      softmax_select_matmul=VITDET_GLOBAL, ln_norms=1)
# the kernel checks of the forms a threshold policy gives the kernels
# (kernel_check.THRESHOLD) at the paths' shapes, with the capacity at the
# smallest bucket and at N: (tag, batch, N, k, entries, make_inputs keywords)
_B_BLOCKED = ("block_select_p_threshold", "block_scatter_rows_threshold",
              "block_select_scatter_qkv_threshold", "block_select_scatter_proj_threshold",
              "block_select_scatter_mlp_threshold")
THRESHOLD_KERNEL_CASES = [
    ("vivit_evblock_kcap_n", EV_SPATIAL_VIEWS * EV_TEMPORAL_VIEWS, N_TOKENS, N_TOKENS,
     ("gate_group_mlp_threshold", "gate_group_mlp"), {}),
    ("672", VITDET_STREAMS, VITDET[672]["n"], VITDET_K,
     ("gate_group_linear_threshold", "gate_group_linear_post_threshold"), VITDET[672]["inputs"]),
    ("1024", 1, VITDET[1024]["n"], 512, _B_BLOCKED, VITDET[1024]["inputs"]),
    ("1024_kcap_n", 1, VITDET[1024]["n"], VITDET[1024]["n"],
     ("block_scatter_rows_threshold", "block_select_scatter_qkv_threshold",
      "block_select_scatter_qkv"), VITDET[1024]["inputs"]),
    ("1024_global", 1, VITDET[1024]["n"], 512, ("softmax_select_matmul_threshold",),
     dict(VITDET[1024]["inputs"], pool=(64, 64), relpos_keys=(8, 8))),
]
# the THRESHOLD entries a path launches, with the tag of their check
HARNESS_ROWS = {
    "harness_vivit": [("gate_group_mlp_threshold", "vivit_evblock_kcap_n")],
    "harness_vitdet": [(name, "1024") for name in _B_BLOCKED]
    + [("softmax_select_matmul_threshold", "1024_global")],
}


def harness_config(location, argv, kind="evaluate"):
    """The port's ``get_cli_config`` of ``configs/<kind>/<location>`` from
    the repo's root, as the entry points read it."""
    from eventful_transformer_tpu_torch.utils.config import get_cli_config

    with contextlib.chdir(REPO):
        return get_cli_config(Path("configs", kind, location), argv=argv)


def harness_vid(transform, frames=HARNESS_VID_FRAMES, seed=SEED, n_items=1):
    """``n_items`` generated VID videos (``data/synthetic.py::SyntheticVID``):
    HARNESS_VID_FRAMES raw uint8 frames of HARNESS_VID_RAW (a random
    image, a rectangle that drifts 8 pixels a frame, a little noise), each
    through ``transform`` (the port's VIDResize) as VIDItem does, with one
    ground-truth box on the rectangle."""
    from eventful_transformer_tpu_torch.data.synthetic import SyntheticVID

    return SyntheticVID(n_items=n_items, n_frames=frames, size=HARNESS_VID_RAW, seed=seed,
                        combined_transform=transform)


def harness_evaluate(evaluate, per_entry, check_output):
    """``evaluate(model, data, config)`` with the launch counts set to 0
    just before and read just after, the seconds it took (the card
    synchronised), the policy of the entry and ``check_output(model)``'s
    checks appended to ``per_entry``."""
    from eventful_transformer_tpu_torch.utils.misc import token_gates

    wrapped = {}

    def run(model, data, config):
        if id(model) not in wrapped:
            wrapped[id(model)] = check_output(model)
        finite = wrapped[id(model)]
        reset_launches()
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = evaluate(model, data, config)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = read_launches()
        gates = token_gates(model)
        policy = gates[0].policy if gates else None
        per_entry.append(dict(
            policy=type(policy).__name__ if gates else "vanilla",
            threshold=getattr(policy, "threshold", None), k=getattr(policy, "k", None),
            seconds=seconds, launches={k: v for k, v in launches.items() if v},
            finite=bool(torch.stack(finite).all()) if finite else None,
            metrics={k: float(v) for k, v in result["metrics"].items()},
            counts=dict(result["counts"]),
        ))
        per_entry[-1]["all_launches"] = launches
        finite.clear()
        return result

    return run


def threshold_launches(entries):
    """The launches by wrapper of a path's threshold entries: the runs
    that give the kernels the forms of kernel_check.THRESHOLD."""
    return {name: sum(e["launches"].get(name, 0) for e in entries
                      if e["policy"] == "TokenNormThreshold") for name in wrappers()}


@contextlib.contextmanager
def checked_eval_steps(finite):
    """Inside: the steps of utils/evaluate.py::make_vitdet_eval_step append
    whether each frame's boxes and scores are finite to ``finite`` (read
    from the step's outputs, after its graph has replayed)."""
    from eventful_transformer_tpu_torch.utils import evaluate

    build = evaluate.make_vitdet_eval_step

    def checked(*args, **kwargs):
        step = build(*args, **kwargs)

        def call(*step_args):
            out = step(*step_args)
            finite.extend(torch.isfinite(out[0][k].float()).all() for k in ("boxes", "scores"))
            return out

        call.reset = step.reset
        return call

    evaluate.make_vitdet_eval_step = checked
    try:
        yield
    finally:
        evaluate.make_vitdet_eval_step = build


def checked_method(model, name, outputs):
    """Wrap ``model.<name>`` so that each call appends whether its tensor
    outputs are finite to the returned list."""
    finite = []
    method = getattr(model, name)

    def call(*args, **kwargs):
        out = method(*args, **kwargs)
        for key in outputs:
            value = out[key] if isinstance(out, dict) else out
            finite.append(torch.isfinite(value.float()).all())
        return out

    setattr(model, name, call)
    return finite


def harness_vivit(device, tmp, smi):
    """Path A: the port's run_evaluations on temporal_24 (one synthetic
    clip, top-k 24 and a threshold entry), float32 as the harness builds it;
    each entry's launches (as the paper's ViViT's "auto" run: ln_norms and
    gate_group_mlp in every spatial block of the 15 incremental steps, the
    temporal model's window_attention and dense_mlp_residual), finite
    probabilities, top-1/top-5, counts and ms per clip."""
    from eventful_transformer_tpu_torch.data.synthetic import SyntheticVideoClassification
    from eventful_transformer_tpu_torch.models import FactorizedViViT
    from eventful_transformer_tpu_torch.utils.evaluate import (
        evaluate_vivit_metrics,
        run_evaluations,
    )

    synthetic = dict(n_items=1, n_frames=HARNESS_CLIP_FRAMES, size=[240, 320], classes=400,
                     seed=SEED)
    config = harness_config("vivit_kinetics400", [
        "temporal_24", f"_output={tmp}/vivit", "n_items=1", f"synthetic={json.dumps(synthetic)}",
        f"token_thresholds=[{HARNESS_VIVIT_THRESHOLD}]",
    ])
    data = SyntheticVideoClassification(**config["synthetic"])
    entries = []
    evaluate = harness_evaluate(
        evaluate_vivit_metrics, entries,
        lambda model: checked_method(model, "apply_views", (None,)),
    )
    models = []

    def build(**kwargs):
        models.append(FactorizedViViT(**kwargs))
        return models[-1]

    done = run_evaluations(config, build, data, evaluate)
    read_routes(torch.float32, "harness_vivit")
    want = ev_expected_launches("auto")
    for entry in entries:
        launches = entry.pop("all_launches")
        if launches != want:
            raise AssertionError(f"harness_vivit {entry['policy']}: launches {launches}, "
                                 f"expected {want}")
        if not entry["finite"]:
            raise AssertionError(f"harness_vivit {entry['policy']}: non-finite probabilities")
        entry["ms_per_clip"] = entry.pop("seconds") * 1e3 / len(data)
    emit("harness_vivit", card=smi, config="temporal_24",
         device=str(next(models[0].parameters()).device), dtype="float32", entries_done=done,
         clip=list(data[0][0].shape), entries=entries)
    return threshold_launches(entries)


def vid_frames(data, input_shape, device):
    """The frames of ``data``'s one video as ``evaluate_vitdet_metrics``
    hands them to the model: padded on the host to the input shape, with
    their content size."""
    c, h, w = input_shape
    out = []
    for frame, _ in data[0]:
        padded = torch.zeros((1, c, h, w))
        padded[0, :, : frame.shape[-2], : frame.shape[-1]] = torch.from_numpy(frame)
        out.append((padded.to(device), tuple(frame.shape[-2:])))
    return out


def backbone_dispatch(model, frames, threshold, capacities, log):
    """The frames through ``BucketedThresholdStep`` around the backbone
    (``pre_backbone`` and ``apply_backbone``, the head left out), each
    valid selection of a threshold policy appended to ``log`` (on the CPU).
    Returns (the last tokens, the mean counts a frame, the dispatcher)."""
    from eventful_transformer_tpu_torch.core.counting import Counts, Ctx
    from eventful_transformer_tpu_torch.core.indexing import coverage
    from eventful_transformer_tpu_torch.core.policies import TokenNormThreshold
    from eventful_transformer_tpu_torch.utils.bucketing import BucketedThresholdStep

    aux = model.precompute()

    def build(_capacity=None):
        @torch.no_grad()
        def step(state, frame, content_hw, first):
            ctx = Ctx(count_mode=True)
            tokens = model.pre_backbone(ctx, frame, content_hw)
            tokens, state = model.apply_backbone(ctx, state, tokens, aux,
                                                 mode="flush" if first else "incremental")
            return tokens, state, ctx.counts

        return step

    select = TokenNormThreshold.select_from_norms

    def recorded(policy, norms, ctx=None):
        index, mask = select(policy, norms, ctx)
        log.append(coverage(index, mask, norms.shape[-1]).cpu())
        return index, mask

    dispatcher = BucketedThresholdStep(model, build, threshold, capacities)
    p = next(model.parameters())
    state = model.init_state(1, p.dtype, p.device)
    total = Counts()
    TokenNormThreshold.select_from_norms = recorded
    try:
        for t, (frame, content_hw) in enumerate(frames):
            tokens, state, counts = dispatcher(state, frame, content_hw, t == 0)
            total = total + counts
    finally:
        TokenNormThreshold.select_from_norms = select
    return tokens, total / len(frames), dispatcher


def harness_vitdet_check(config, data, device):
    """Path B at VITDET_CHECK_DEPTH blocks (two windowed, one global) in
    float32, the card against the CPU (plain versions): HARNESS_CHECK_FRAMES
    frames through the bucketed dispatch at each of HARNESS_CHECK_THRESHOLDS.
    The same bucket levels and escalations, valid selections that differ in
    at most HARNESS_MAX_DIFFER_SHARE, and where every selection agrees the
    counts within HARNESS_COUNTS_RTOL and the tokens within
    VITDET_TOKEN_TOL (scaled)."""
    from eventful_transformer_tpu_torch.core.policies import TokenNormThreshold
    from eventful_transformer_tpu_torch.models import ViTDet
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    cfg = copy.deepcopy(config["model"])
    cfg.pop("device", None)
    cfg["backbone_config"].update(depth=VITDET_CHECK_DEPTH,
                                  window_indices=list(VITDET_CHECK_WINDOWS))
    cpu_model = ViTDet(**cfg, device="cpu", seed=SEED)
    card_model = copy.deepcopy(cpu_model).to(device)
    frames = vid_frames(data, cfg["input_shape"], "cpu")[:HARNESS_CHECK_FRAMES]
    checks = []
    for threshold in HARNESS_CHECK_THRESHOLDS:
        runs = {}
        for tag, model, dev in (("card", card_model, device), ("cpu", cpu_model, "cpu")):
            set_policies(model, TokenNormThreshold, threshold=threshold)
            log = []
            start = time.perf_counter()
            tokens, counts, dispatcher = backbone_dispatch(
                model, [(f.to(dev), hw) for f, hw in frames], threshold,
                config["bucket_capacities"], log,
            )
            runs[tag] = dict(tokens=tokens.cpu(), counts=counts, log=log,
                             seconds=time.perf_counter() - start,
                             escalations=dispatcher.escalations,
                             frames_per_level=list(dispatcher.frames_per_level))
        card, cpu = runs["card"], runs["cpu"]
        levels = {tag: (run["escalations"], run["frames_per_level"]) for tag, run in runs.items()}
        if levels["card"] != levels["cpu"] or len(card["log"]) != len(cpu["log"]):
            raise AssertionError(f"harness_vitdet check at {threshold}: (escalations, frames "
                                 f"per level) {levels}")
        selections = sum(float(b.sum()) for b in cpu["log"])
        differing = sum(float((a != b).sum()) for a, b in zip(card["log"], cpu["log"]))
        scaled = float(((card["tokens"] - cpu["tokens"]).abs()
                        / cpu["tokens"].abs().clamp(min=1.0)).max())
        worst = max(abs(card["counts"][k] - v) / abs(v) for k, v in cpu["counts"].items() if v)
        numbers = dict(
            threshold=threshold, escalations=card["escalations"],
            frames_per_level=card["frames_per_level"], valid_selections=selections,
            selections_differing=differing, counts_max_rel_diff=worst,
            max_scaled_token_err=scaled, card_s=card["seconds"], cpu_s=cpu["seconds"],
        )
        checks.append(numbers)
        if differing > HARNESS_MAX_DIFFER_SHARE * max(selections, 1.0):
            raise AssertionError(f"harness_vitdet check: selections differ: {numbers}")
        if differing == 0 and (worst > HARNESS_COUNTS_RTOL or scaled > VITDET_TOKEN_TOL):
            raise AssertionError(f"harness_vitdet check: counts or tokens differ: {numbers}")
    return dict(depth=VITDET_CHECK_DEPTH, frames=len(frames),
                max_differ_share=HARNESS_MAX_DIFFER_SHARE, counts_rtol=HARNESS_COUNTS_RTOL,
                token_tol=VITDET_TOKEN_TOL, thresholds=checks)


def harness_vitdet(device, tmp, smi):
    """Path B: the port's run_evaluations with evaluate_vitdet_metrics on
    threshold_1024 at full width and depth, float32, one generated video;
    per threshold entry the launches (HARNESS_B_STEP per incremental frame
    run, the escalated runs included), finite detections, mAP, counts, ms
    per frame, escalations and frames per bucket level; then the
    card-vs-CPU check (harness_vitdet_check)."""
    from eventful_transformer_tpu_torch.data.vid import VIDResize
    from eventful_transformer_tpu_torch.models import ViTDet
    from eventful_transformer_tpu_torch.utils.evaluate import (
        evaluate_vitdet_metrics,
        run_evaluations,
    )

    config = harness_config("vitdet_vid", ["threshold_1024", f"_output={tmp}/vitdet", "n_items=1"])
    long_edge = max(config["model"]["input_shape"][-2:])
    data = harness_vid(VIDResize(short_edge_length=640 * long_edge // 1024, max_size=long_edge))
    entries, dispatchers = [], []

    def evaluate(model, data, config):
        return evaluate_vitdet_metrics(model, data, config, dispatchers)

    finite = []
    evaluate = harness_evaluate(evaluate, entries, lambda model: finite)

    def build(**kwargs):
        model = ViTDet(**kwargs)
        with torch.no_grad():
            model.roi_heads.cls_score.kernel.mul_(CLS_SCORE_GAIN)
        return model

    with checked_eval_steps(finite):
        done = run_evaluations(config, build, data, evaluate)
    read_routes(torch.float32, "harness_vitdet")
    frames = len(data[0])
    for entry, dispatcher in zip(entries, dispatchers):
        launches = entry.pop("all_launches")
        runs = frames - 1 + dispatcher.escalations  # a flush frame never escalates
        wrong = {name: (launches[name], count * runs) for name, count in HARNESS_B_STEP.items()
                 if launches[name] != count * runs}
        if wrong:
            raise AssertionError(f"harness_vitdet {entry['threshold']}: launches (got, want) "
                                 f"{wrong}")
        idle = [name for name in ("window_attention", "relpos_bias_add_v2") if not launches[name]]
        if idle or not entry["finite"]:
            raise AssertionError(f"harness_vitdet {entry['threshold']}: idle {idle}, "
                                 f"finite detections {entry['finite']}")
        entry.update(ms_per_frame=entry.pop("seconds") * 1e3 / frames,
                     escalations=dispatcher.escalations,
                     frames_per_level=list(dispatcher.frames_per_level),
                     capacities=list(dispatcher.capacities), incremental_runs=runs)
    frame_shapes = sorted({tuple(f.shape) for f, _ in data[0]})
    check = harness_vitdet_check(config, data, device)
    emit("harness_vitdet", card=smi, config="threshold_1024", dtype="float32",
         entries_done=done, frames=frames, resized_frames=[list(s) for s in frame_shapes],
         entries=entries, f32_card_vs_cpu=check)
    return threshold_launches(entries)


def harness_cli(tmp, smi):
    """Path C: ``python -m eventful_transformer_tpu_torch.scripts.evaluate.
    vivit_kinetics400 synthetic_smoke`` as a user runs it, on the card (its
    output.txt names the card), against the same config run in this
    process with ``model.device=cpu``: the same metrics.csv, and counts.csv
    within HARNESS_COUNTS_RTOL."""
    import io

    from eventful_transformer_tpu_torch.scripts.evaluate import vivit_kinetics400

    module = "eventful_transformer_tpu_torch.scripts.evaluate.vivit_kinetics400"
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, "synthetic_smoke", f"_output={tmp}/cli_card"],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    card_s = time.perf_counter() - start
    if proc.returncode != 0:
        raise AssertionError(f"harness_cli: the entry point failed: {proc.stderr[-3000:]}")
    start = time.perf_counter()
    with contextlib.chdir(REPO), contextlib.redirect_stdout(io.StringIO()):
        vivit_kinetics400.main(["synthetic_smoke", "model.device=cpu", f"_output={tmp}/cli_cpu"])
    cpu_s = time.perf_counter() - start
    card, cpu = Path(tmp, "cli_card"), Path(tmp, "cli_cpu")
    described = [line for line in (card / "output.txt").read_text().splitlines()
                 if line.startswith(("gpu:", "cpu:"))]
    metrics = (card / "metrics.csv").read_text(), (cpu / "metrics.csv").read_text()

    def rows(path):
        lines = (path / "counts.csv").read_text().strip().splitlines()
        return lines[0], [[float(v) for v in line.split(",")] for line in lines[1:]]

    (card_head, card_rows), (cpu_head, cpu_rows) = rows(card), rows(cpu)
    worst = max(abs(a - b) / abs(b) for ra, rb in zip(card_rows, cpu_rows)
                for a, b in zip(ra, rb) if b)
    numbers = dict(devices=described, metrics_card=metrics[0], metrics_cpu=metrics[1],
                   counts_max_rel_diff=worst, counts_rtol=HARNESS_COUNTS_RTOL,
                   card_process_s=card_s, cpu_s=cpu_s)
    if (not described or not all(d.startswith("gpu:") for d in described)
            or metrics[0] != metrics[1] or card_head != cpu_head
            or len(card_rows) != len(cpu_rows) or worst > HARNESS_COUNTS_RTOL):
        raise AssertionError(f"harness_cli: the card's run disagrees with the CPU's: {numbers}")
    emit("harness_cli", card=smi, config="synthetic_smoke", **numbers)


def harness_paths(device, smi):
    """The masked kernel forms (phase threshold_kernels), then paths A, B
    and C. Returns the final line's rows of the THRESHOLD entries the
    paths launch."""
    import tempfile

    rows = check_kernels("threshold_kernels", device, THRESHOLD_KERNEL_CASES)
    out = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_harness_") as tmp:
        for path, run in (("harness_vivit", harness_vivit), ("harness_vitdet", harness_vitdet)):
            launches = run(device, tmp, smi)
            torch.cuda.empty_cache()
            out += [kernel_row(name, rows[(name, torch.float32, tag)], launches, path)
                    for name, tag in HARNESS_ROWS[path]]
        harness_cli(tmp, smi)
    idle = [row["name"] for row in out if not row["launches"]]
    if idle:
        raise AssertionError(f"harness paths launched no {idle}")
    return out


# -- ViViT's remaining serving surface: ATS, the spatial cache, the time entry points --
#
# ATS at EPIC-Kitchens ViViT-B's full width and depth (configs/models/
# vivit_b_epic_kitchens.yml: 3 x 4 = 12 views of 32 frames at stride 1, 320 x
# 320, 16 steps; 12 spatial blocks, whose 401 tokens fall to 111 under ATS
# 0.9): configs/evaluate/vivit_epic_kitchens/ats.yml (the vanilla model, ATS
# in every spatial Block) and temporal_ats_200.yml (EventfulBlocks with the
# bf16 A.V cast, ATS 0.9, TokenNormTopFraction(0.5)), as the port's
# utils/config.py composes them, through run_evaluations on one generated clip
# of ATS_CLIP, float32 as the harness builds the model. An ATS block runs
# unfused: the vanilla model launches dense_mlp_residual (row 5) in every
# spatial block at its own token count, and both run the temporal model's
# window_attention (row 6) and dense_mlp_residual.
ATS_RUNS = ("ats", "temporal_ats_200")
ATS_FRACTION = 0.9
ATS_VIEWS = EV_SPATIAL_VIEWS * EV_TEMPORAL_VIEWS
N_TOKENS_EPIC = 20 * 20 + 1
ATS_CLIP = dict(n_items=1, n_frames=48, size=[320, 400], classes=97, seed=SEED)
# The JAX package's counted GFLOPs per clip, from ``python scripts/misc/
# count_vivit.py --epic --ats 0.9 --fraction 0.5`` (the JAX package on the
# CPU, one view at full width and depth, times 12 views): the vanilla
# model's and the eventful model's
ATS_GFLOPS = {"ats": 3823.33654542, "temporal_ats_200": 2135.47053558}
# row 5 against its plain version at the token counts the MLPs of the first,
# the third and the last spatial block run at (after their ATS)
ATS_ROW5_COUNTS = (361, 292, 111)
# the float32 card-vs-CPU check: the spatial stack cut to 3 blocks, 1 x 2
# views, the A.V cast off (as the other paths' float32 checks). A model with
# the cast is run again with it on: each ATS scoring on the card is made
# again on the CPU from the same cast a and v, its selections held to
# MAX_FLIP_SHARE. The whole runs' probabilities and selections are reported,
# not held: float32 noise in a and v flips a bf16 rounding now and then, the
# bf16 scores tie often, and a token sampled differently changes every later
# block's input.
ATS_CHECK_DEPTH, ATS_CHECK_VIEWS = 3, (1, 2)
# The spatial cache: configs/spatial/vivit_kinetics400/24.yml (the paper's
# configuration, spatial_only) over SPATIAL_CLIPS generated clips of path A's
# kind into a temporary directory, read back by ViViTSpatial; a temporal_only
# model over the cache against the full model's apply on the same clips: the
# same operations on the same card, so SPATIAL_PROB_TOL is float32 noise
SPATIAL_CLIPS, SPATIAL_K = 2, 24
SPATIAL_PROB_TOL = 1e-6
# the time entry points' generated data
TIME_VIVIT_CLIP = ATS_CLIP
TIME_VID = dict(n_items=1, n_frames=HARNESS_VID_FRAMES, size=list(HARNESS_VID_RAW), seed=SEED)


def ats_counts(n=N_TOKENS_EPIC, depth=DEPTH):
    """The token count each spatial block hands on (its MLP's) under
    ATS_FRACTION, from n at the first block's input."""
    counts = []
    for _ in range(depth):
        n = int(ATS_FRACTION * (n - 1)) + 1
        counts.append(n)
    return counts


def ats_expected_launches(name, depth=DEPTH):
    """Per clip: the temporal model's two dense kernels once per block; the
    vanilla model's dense MLP kernel in every spatial block of every step
    (the eventful ATS blocks run unfused: no kernel)."""
    want = dict.fromkeys(wrappers(), 0)
    want.update(window_attention=TEMPORAL_DEPTH, dense_mlp_residual=TEMPORAL_DEPTH)
    if name == "ats":
        want["dense_mlp_residual"] += depth * STEPS
    return want


@contextlib.contextmanager
def ats_scores_against_cpu(fraction):
    """Every ATS scoring made on the card (``core.blocks.ats_scores``),
    made again on the CPU from the same a and v: the score elements and the
    ATS selections (the top ``n_select``) that differ, tallied."""
    from eventful_transformer_tpu_torch.core import blocks, indexing

    plain = blocks.ats_scores
    tally = dict(calls=0, scores=0, scores_differing=0, selections=0, selections_differing=0)

    def checked(a, v, group=None):
        scores = plain(a, v, group)
        if a.is_cuda and group is None:
            got, ref = scores.cpu(), plain(a.cpu(), v.cpu())
            k = int(fraction * (ref.shape[-1] - 1)) + 1
            cov, ref_cov = (indexing.coverage_from_norms(x, k) for x in (got, ref))
            tally["calls"] += 1
            tally["scores"] += ref.numel()
            tally["scores_differing"] += int((got != ref).sum())
            tally["selections"] += int(ref_cov.sum())
            tally["selections_differing"] += int((cov != ref_cov).sum()) // 2
        return scores

    blocks.ats_scores = checked
    try:
        yield tally
    finally:
        blocks.ats_scores = plain


def ats_card_vs_cpu(name, config, clip, device):
    """``name``'s model cut to ATS_CHECK_DEPTH spatial blocks and
    ATS_CHECK_VIEWS views, float32, on the card against the CPU: with the
    cast off, probabilities and the selections of every ATS and gate top-k;
    where the configuration casts A.V, again with the cast on: each ATS
    scoring of the card against the CPU's from the same cast a and ||v||
    (held), and the two runs (reported)."""
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopFraction
    from eventful_transformer_tpu_torch.models import FactorizedViViT
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    def cpu_model(cast):
        model_config = copy.deepcopy(config["model"])
        model_config["spatial_config"]["depth"] = ATS_CHECK_DEPTH
        model_config["spatial_config"]["block_config"]["matmul_2_cast"] = cast
        model_config["spatial_views"], model_config["temporal_views"] = ATS_CHECK_VIEWS
        model_config.update(device="cpu", seed=SEED)
        model = FactorizedViViT(**model_config)
        for fraction in config.get("token_top_fraction", []):
            set_policies(model, TokenNormTopFraction, fraction=fraction)
        return model

    numbers, _ = card_vs_cpu(cpu_model(None), clip, device, run=run_apply)
    cast = config["model"]["spatial_config"]["block_config"].get("matmul_2_cast")
    if cast is not None:
        with ats_scores_against_cpu(ATS_FRACTION) as per_call:
            runs, _ = card_vs_cpu(cpu_model(cast), clip, device, run=run_apply, hold=False)
        numbers["cast_on"] = dict(matmul_2_cast=cast, ats_calls=per_call,
                                  max_flip_share=MAX_FLIP_SHARE, runs_not_held=runs)
        flips = per_call["selections_differing"]
        if not per_call["calls"] or flips > MAX_FLIP_SHARE * per_call["selections"]:
            raise AssertionError(f"ats_path {name}: the card's ATS with the {cast} cast "
                                 f"disagrees with the CPU's: {numbers['cast_on']}")
    return numbers


def ats_path(device, smi):
    """Row 5 at the ATS counts; ats.yml and temporal_ats_200.yml through
    run_evaluations: launches (set to 0 just before, read just after), the
    probabilities, GFLOPs per clip against the JAX package's, ms per clip
    (the evaluation, and one warm apply_views); each model's float32 check
    on the card against the CPU. Returns the final line's rows."""
    import tempfile

    from eventful_transformer_tpu_torch.data.synthetic import SyntheticVideoClassification
    from eventful_transformer_tpu_torch.models import FactorizedViViT
    from eventful_transformer_tpu_torch.utils.evaluate import (
        evaluate_vivit_metrics,
        run_evaluations,
        vivit_views,
    )

    counts = ats_counts()
    if not set(ATS_ROW5_COUNTS) <= set(counts):
        raise AssertionError(f"ATS counts {counts} miss {ATS_ROW5_COUNTS}")
    checks = check_kernels("ats_kernels", device, [
        (f"ats_{n}", ATS_VIEWS, n, n, ("dense_mlp_residual",), {}) for n in ATS_ROW5_COUNTS
    ])
    data = SyntheticVideoClassification(**ATS_CLIP)
    clip = torch.from_numpy(data[0][0])[None]
    runs, launched = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ats_") as tmp:
        for name in ATS_RUNS:
            config = harness_config("vivit_epic_kitchens", [name, f"_output={tmp}/{name}",
                                                            "n_items=1"])
            entries, models = [], []
            evaluate = harness_evaluate(
                evaluate_vivit_metrics, entries,
                lambda model: checked_method(model, "apply_views", (None,)),
            )

            def build(**kwargs):
                models.append(FactorizedViViT(**kwargs))
                return models[-1]

            done = run_evaluations(config, build, data, evaluate)
            read_routes(torch.float32, f"ats_path {name}")
            (entry,) = entries
            launches = launched[name] = entry.pop("all_launches")
            want = ats_expected_launches(name)
            if launches != want:
                raise AssertionError(f"ats_path {name}: launches {launches}, expected {want}")
            if not entry["finite"]:
                raise AssertionError(f"ats_path {name}: non-finite probabilities")
            model = models[0]
            blocks = model.spatial_model.backbone.blocks
            if [blk.ats_fraction for blk in blocks] != [ATS_FRACTION] * DEPTH:
                raise AssertionError(f"ats_path {name}: the blocks' ATS fractions")
            got, ref = gflops(entry["counts"]), ATS_GFLOPS[name]
            if abs(got - ref) > 1e-6 * ref:
                raise AssertionError(f"ats_path {name}: counted {got} GFLOPs/clip, the JAX "
                                     f"package's count is {ref}")
            entry["ms_per_clip"] = entry.pop("seconds") * 1e3
            entry["warm_ms_per_clip"] = time_model(model, vivit_views(model, data[0][0]),
                                                   warmup=0, iters=1)
            del models[:], model, blocks
            torch.cuda.empty_cache()
            check = ats_card_vs_cpu(name, config, clip, device)
            runs[name] = dict(entries_done=done, block_class=config["model"]["spatial_config"]
                              .get("block_class", "Block"), gflops_per_clip=got,
                              jax_gflops_per_clip=ref, f32_check=check, **entry)
    emit("ats_path", card=smi, views=ATS_VIEWS, clip=list(clip.shape), token_counts=counts,
         dtype="float32", f32_check_depth=ATS_CHECK_DEPTH, f32_check_views=ATS_CHECK_VIEWS,
         runs=runs)
    return [kernel_row("dense_mlp_residual", checks[("dense_mlp_residual", torch.float32,
                                                     f"ats_{n}")],
                       launched["ats"], "ats_vanilla") for n in ATS_ROW5_COUNTS]


def spatial_cache_path(device, smi, ev_checks, tmp):
    """configs/spatial/vivit_kinetics400/24.yml through compute_vivit_spatial
    on the card (SPATIAL_CLIPS generated clips), read back by ViViTSpatial;
    a temporal_only model over the cache against the full model's apply on
    the same clips; one traced forward of the temporal_only model
    (utils/profiling.trace). Returns the final line's rows: the paper's
    configuration's kernels (the "v2mlp" MLP group's ln_norms and
    gate_group_mlp) on the spatial-cache run and rows 5 and 6 on the
    temporal_only model, each with its float32 check of phase
    vivit_evblock_kernels (the same shapes)."""
    from eventful_transformer_tpu_torch.core.counting import Ctx
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.data.synthetic import SyntheticVideoClassification
    from eventful_transformer_tpu_torch.data.vivit_spatial import ViViTSpatial
    from eventful_transformer_tpu_torch.models import FactorizedViViT
    from eventful_transformer_tpu_torch.utils import profiling
    from eventful_transformer_tpu_torch.utils.evaluate import load_model_params, vivit_views
    from eventful_transformer_tpu_torch.utils.misc import set_policies
    from eventful_transformer_tpu_torch.utils.spatial import compute_vivit_spatial

    config = harness_config("vivit_kinetics400", [str(SPATIAL_K)], kind="spatial")
    data = SyntheticVideoClassification(n_items=SPATIAL_CLIPS, n_frames=HARNESS_CLIP_FRAMES,
                                        size=[240, 320], classes=400, seed=SEED)
    location = Path(tmp, "kinetics400")
    reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    model = compute_vivit_spatial(config, location / "train" / f"spatial_224_25_{SPATIAL_K}",
                                  data)
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - start
    cache_launches = read_launches()
    read_routes(torch.float32, "spatial_cache")
    want = ev_expected_launches("auto")
    want.update(window_attention=0, dense_mlp_residual=0)  # spatial_only: no temporal model
    want = {name: SPATIAL_CLIPS * n for name, n in want.items()}
    if cache_launches != want:
        raise AssertionError(f"spatial cache launches {cache_launches}, expected {want}")
    cache = ViViTSpatial(location, split="train", k=SPATIAL_K, base_name="spatial_224_25")
    temporal = FactorizedViViT(**{"seed": SEED, **config["model"], "spatial_only": False,
                                  "temporal_only": True})
    load_model_params(temporal, config)
    model.spatial_only = False  # the same model, whole
    reset_launches()
    cached = []
    for i in range(len(cache)):
        spatial, label = cache[i]
        if spatial.shape != (ATS_VIEWS, STEPS, 768) or spatial.dtype != np.float32:
            raise AssertionError(f"cached features {spatial.shape} {spatial.dtype}")
        if label != data[i][1]:
            raise AssertionError(f"cached label {label}, the clip's {data[i][1]}")
        cached.append(temporal.apply(Ctx(), torch.from_numpy(spatial)[None]))
    torch.cuda.synchronize()
    temporal_launches = read_launches()
    read_routes(torch.float32, "spatial_cache temporal_only")
    want = dict.fromkeys(wrappers(), 0)
    want.update(window_attention=SPATIAL_CLIPS * TEMPORAL_DEPTH,
                dense_mlp_residual=SPATIAL_CLIPS * TEMPORAL_DEPTH)
    if temporal_launches != want:
        raise AssertionError(f"temporal_only launches {temporal_launches}, expected {want}")
    set_policies(model, TokenNormTopK, k=SPATIAL_K)
    full = [model.apply_views(Ctx(), vivit_views(model, data[i][0])) for i in range(len(data))]
    diff = max(float((a - b).abs().max()) for a, b in zip(cached, full))
    finite = all(bool(torch.isfinite(p).all()) and p.shape == (1, 400) for p in cached)
    with profiling.trace(Path(tmp, "profiles")) as prof:
        with profiling.annotate("temporal_only_forward"):
            temporal.apply(Ctx(), torch.from_numpy(cache[0][0])[None].to(device))
    trace_bytes = prof.trace_path.stat().st_size
    events = json.loads(prof.trace_path.read_text())["traceEvents"]
    kernel_events = sum(1 for e in events if e.get("cat") == "kernel")
    numbers = dict(config=f"spatial/vivit_kinetics400/{SPATIAL_K}", clips=SPATIAL_CLIPS,
                   k=SPATIAL_K, dtype="float32", cached_files=len(cache),
                   cache_s=cache_s, max_prob_diff=diff, prob_tol=SPATIAL_PROB_TOL,
                   trace_bytes=trace_bytes, trace_kernel_events=kernel_events,
                   cache_launches={k: v for k, v in cache_launches.items() if v},
                   temporal_only_launches={k: v for k, v in temporal_launches.items() if v})
    emit("spatial_cache_path", card=smi, **numbers)
    if not finite or diff > SPATIAL_PROB_TOL or not trace_bytes or not kernel_events:
        raise AssertionError(f"spatial cache path: {numbers}")
    del model, temporal, full, cached
    torch.cuda.empty_cache()
    rows = [kernel_row(name, ev_checks[(name, torch.float32, "vivit_evblock")], cache_launches,
                       "spatial_cache") for name in ("ln_norms", "gate_group_mlp")]
    rows += [kernel_row(name, ev_checks[(name, torch.float32, "vivit_evblock_temporal")],
                        temporal_launches, "spatial_cache_temporal_only")
             for name in DENSE_KERNELS]
    return rows


# Runs each [module, *argv] of the JSON list in argv[1] as ``python -m``
# runs it (runpy, as __main__), one after the other, and prints the seconds
# each took: the time entry points share one process start (torch's import
# and the card's context, about 10 s a process)
RUN_AS_MAIN = """
import json, runpy, sys, time
for module, *argv in json.loads(sys.argv[1]):
    sys.argv = [module, *argv]
    start = time.perf_counter()
    runpy.run_module(module, run_name="__main__", alter_sys=True)
    print(json.dumps({"module": module, "seconds": time.perf_counter() - start}))
"""


def run_as_main(runs, timeout=600, output=None):
    """``runs`` ([module, *argv] each) in one subprocess from the repo's
    root, each as ``python -m module *argv`` runs it. Returns (the
    process's seconds, {module: its seconds}); ``output``, a list, gets
    the process's standard output; raises if the process failed."""
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", RUN_AS_MAIN, json.dumps(runs)], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        raise AssertionError(f"{[run[0] for run in runs]} failed: {proc.stderr[-3000:]}")
    if output is not None:
        output.append(proc.stdout)
    done = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith('{"module"')]
    return seconds, {d["module"]: d["seconds"] for d in done}


def time_entry_points(tmp, smi):
    """The two time entry points as a user runs them (``python -m``), in one
    subprocess on the card, n_items=1 on generated data: ViViT on
    configs/time/vivit_epic_kitchens/temporal.yml, ViTDet on
    spatiotemporal_672.yml over one generated VID video; each wrote its
    times dict, every entry positive, and its output.txt names the card."""
    entries = {
        "vivit_epic_kitchens": ["temporal", f"synthetic={json.dumps(TIME_VIVIT_CLIP)}"],
        "vitdet_vid": ["spatiotemporal_672", f"synthetic={json.dumps(TIME_VID)}"],
    }
    modules = {entry: f"eventful_transformer_tpu_torch.scripts.time.{entry}" for entry in entries}
    outputs = {entry: Path(tmp, f"time_{entry}") for entry in entries}
    process_s, seconds = run_as_main([[modules[entry], *args, "n_items=1",
                                       f"_output={outputs[entry]}"]
                                      for entry, args in entries.items()])
    out = {}
    for entry, args in entries.items():
        output = outputs[entry]
        lines = (output / "times.csv").read_text().strip().splitlines()
        times = [dict(zip(lines[0].split(","), map(float, line.split(",")))) for line in lines[1:]]
        described = [line for line in (output / "output.txt").read_text().splitlines()
                     if line.startswith(("gpu:", "cpu:"))]
        out[entry] = dict(config=args[0], entry_s=seconds.get(modules[entry]),
                          devices=described, times=times)
        if (modules[entry] not in seconds or not times
                or not all(t > 0 for row in times for t in row.values())
                or not described or not all(d.startswith("gpu:") for d in described)):
            raise AssertionError(f"time entry point {entry}: {out[entry]}")
    emit("time_entry_points", card=smi, process_s=process_s, runs=out)


def serving_paths(device, smi, ev_checks):
    """Phases ats_path, spatial_cache_path and time_entry_points. Returns
    the final line's rows of the kernels they launch."""
    import tempfile

    rows = ats_path(device, smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serving_") as tmp:
        rows += spatial_cache_path(device, smi, ev_checks, tmp)
        time_entry_points(tmp, smi)
    idle = [row["name"] for row in rows if not row["launches"]]
    if idle:
        raise AssertionError(f"serving paths launched no {idle}")
    return rows


# -- ViTDet-B COCO: the cascade and mask heads end to end at 1024 -----------------
#
# configs/models/vitdet_b_coco.yml (ViTDet-B, dense, 1024 x 1024: 12 blocks,
# windows at 0, 1, 3, 4, 6, 7, 9, 10, C = 768; the 3-stage cascade with its
# mask head over 80 classes) through ViTDet.apply, seed weights, COCO_FRAMES
# generated frames. The stages' class scorers are scaled by CLS_SCORE_GAIN
# (the e2e phase's reason: a random model keeps no detection otherwise) and
# the mask predictor by MASK_GAIN (its seeded std of 0.001 gives masks within
# 1e-3 of 1/2, which no comparison could tell apart; std 0.3 spreads them).
COCO_SIZE, COCO_FRAMES = 1024, 2
COCO_CLASSES = 80
MASK_GAIN = 300.0
# masks of matched detections, card against CPU in float32: the boxes agree
# within DET_BOX_TOL pixels, and a mask's 14 x 14 ROIAlign samples move with
# its box (1e-2 pixels on p2 moves a sample by 2.5e-3 of a cell)
MASK_TOL = 1e-2
# the path's kernels at one stream of 4096 tokens: row 5 in every block, row
# 6 in the 8 windowed blocks (the 64 x 64 grid pads to 70 x 70: the padded
# form; the windowed form, the same wrapper, held at the same shapes too),
# row 17 on the 4 global blocks' 4096 x 4096 logits
COCO_N = VITDET[1024]["n"]
COCO_INPUTS = dict(VITDET[1024]["inputs"], windows=25)
COCO_KERNEL_CASES = [
    ("coco", 1, COCO_N, VITDET_K,
     ("dense_mlp_residual", "window_attention_windowed", "window_attention_padded"), COCO_INPUTS),
    ("coco_dense", 1, COCO_N, VITDET_K, ("relpos_bias_add_v2",),
     dict(COCO_INPUTS, relpos_keys=VITDET[1024]["keys"]["dense"])),
]
COCO_ROWS = (("dense_mlp_residual", "coco"), ("window_attention_padded", "coco"),
             ("relpos_bias_add_v2", "coco_dense"))


def coco_config():
    """configs/models/vitdet_b_coco.yml's model as the port's utils/config.py
    reads it."""
    from eventful_transformer_tpu_torch.utils.config import load_config

    return load_config(REPO / "configs" / "models" / "vitdet_b_coco.yml")["model"]


def coco_model(device, dtype=torch.float32, depth=VITDET_DEPTH,
               window_indices=(0, 1, 3, 4, 6, 7, 9, 10)):
    """:func:`coco_config`, the backbone cut to ``depth`` blocks windowed at
    ``window_indices`` where asked, on ``device`` in ``dtype``, weights
    from the seed, the class scorers and the mask predictor scaled as
    above."""
    from eventful_transformer_tpu_torch.models import ViTDet

    config = coco_config()
    config["backbone_config"] = dict(config["backbone_config"], depth=depth,
                                     window_indices=list(window_indices))
    model = ViTDet(**config, device=device, seed=SEED)
    with torch.no_grad():
        for stage in model.roi_heads.stages:
            stage.cls_score.kernel.mul_(CLS_SCORE_GAIN)
        model.roi_heads.mask_head.predictor.kernel.mul_(MASK_GAIN)
    return model.to(dtype)


def coco_heads_on_features(model, tokens, device):
    """Check 2, the heads at full size: the pyramid of the card's tokens
    (1, N, 768), as float32, through float32 copies of the RPN and of the
    cascade and mask heads on the card and on the CPU; each detection of
    the CPU's matched by match_masks. Returns the numbers."""
    h, w = model.backbone_input_size
    with torch.no_grad():
        features = [f.float() for f in model.pyramid(tokens.reshape(1, h, w, model.dim))]
        image_size = (COCO_SIZE, COCO_SIZE)
        dets = {}
        for tag, where in (("card", device), ("cpu", "cpu")):
            rpn = copy.deepcopy(model.proposal_generator).float().to(where)
            heads = copy.deepcopy(model.roi_heads).float().to(where)
            feats = [f.to(where) for f in features]
            proposals, _, mask = rpn.propose(feats, image_size)
            dets[tag] = heads.inference(feats[:4], proposals, mask, image_size)
    match = match_masks(dets["card"], dets["cpu"])
    if not match["ok"]:
        raise AssertionError(f"COCO heads on the card disagree with the CPU's: {match}")
    return match


def coco_card_vs_cpu(device):
    """Check 1, the whole model: one frame in float32 through ViTDet.apply,
    the backbone cut to VITDET_CHECK_DEPTH blocks (windowed at
    VITDET_CHECK_WINDOWS), on the card and on the CPU: tokens within
    VITDET_TOKEN_TOL, detections and masks matched by match_masks. Returns
    (numbers, launches)."""
    cpu_model = coco_model("cpu", depth=VITDET_CHECK_DEPTH, window_indices=VITDET_CHECK_WINDOWS)
    card_model = copy.deepcopy(cpu_model).to(device)
    clip = vitdet_frames(1, 1, "cpu", torch.float32, COCO_SIZE, seed=SEED + 1)
    outs, seconds = {}, {}
    for tag, model, frames in (("card", card_model, clip.to(device)), ("cpu", cpu_model, clip)):
        reset_launches()
        start = time.perf_counter()
        outs[tag] = e2e_tokens_and_detections(model, frames)
        seconds[tag] = time.perf_counter() - start
        if tag == "card":
            launches = read_launches()
            read_routes(torch.float32, "coco card vs cpu")
    scaled = max(float(((a.cpu() - b).abs() / b.abs().clamp(min=1.0)).max())
                 for a, b in zip(outs["card"][0], outs["cpu"][0]))
    numbers = dict(f32_card_vs_cpu_max_scaled_token_err=scaled, token_tol=VITDET_TOKEN_TOL,
                   f32_card_s=seconds["card"], f32_cpu_s=seconds["cpu"])
    if scaled > VITDET_TOKEN_TOL:
        raise AssertionError(f"float32 COCO tokens on the card disagree with the CPU's: {numbers}")
    windowed = len(VITDET_CHECK_WINDOWS)
    want = dict.fromkeys(wrappers(), 0)
    want.update(window_attention=windowed, relpos_bias_add_v2=VITDET_CHECK_DEPTH - windowed,
                dense_mlp_residual=VITDET_CHECK_DEPTH, nms_padded=HEAD_NMS_PER_FRAME)
    if launches != want:
        raise AssertionError(f"the float32 COCO run's launches {launches}, expected {want}")
    matches = [match_masks(a, b) for a, b in zip(outs["card"][1], outs["cpu"][1])]
    numbers["detections_matched"] = matches
    if not all(m["ok"] for m in matches):
        raise AssertionError(f"float32 COCO detections on the card disagree with the CPU's: {matches}")
    return numbers, launches


def coco_path(device, smi):
    """Phases coco_kernels and coco_path: ViTDet-B COCO at full width and
    depth in bfloat16 through ViTDet.apply on COCO_FRAMES frames: launches,
    detections and masks, GFLOPs per frame against the JAX package's (the
    dense 1024 backbone's; the heads count none), ms per frame, the peak
    of allocated memory; check 1 and check 2 above. Returns the final
    line's rows."""
    from eventful_transformer_tpu_torch.core.counting import Ctx
    from eventful_transformer_tpu_torch.detection import nms
    from eventful_transformer_tpu_torch.detection.roi_heads import CascadeROIHeads

    rows = check_kernels("coco_kernels", device, COCO_KERNEL_CASES)
    model = coco_model(device, torch.bfloat16)
    if not isinstance(model.roi_heads, CascadeROIHeads) or model.roi_heads.mask_head is None:
        raise AssertionError("vitdet_b_coco.yml did not build the cascade with its mask head")
    frames = vitdet_frames(COCO_FRAMES, 1, device, torch.bfloat16, COCO_SIZE)
    run_e2e(model, frames)  # warm-up: cuDNN's algorithms, the anchors
    torch.cuda.reset_peak_memory_stats(device)
    held = torch.cuda.memory_allocated(device)  # the weights, and what earlier phases hold
    syncs = nms.host_syncs
    reset_launches()
    dets, counts = run_e2e(model, frames, count=True)
    launches = read_launches()
    read_routes(torch.bfloat16, "coco")
    syncs = (nms.host_syncs - syncs) / COCO_FRAMES
    peak = torch.cuda.max_memory_allocated(device)
    want = vitdet_expected_launches(False, 1024, frames=COCO_FRAMES, streams=1)
    want["nms_padded"] = HEAD_NMS_PER_FRAME * COCO_FRAMES
    if launches != want or syncs:
        raise AssertionError(f"COCO launch counts {launches}, expected {want}; NMS host reads "
                             f"{syncs} a frame")
    kept = check_detections(dets, classes=COCO_CLASSES, size=COCO_SIZE)
    got = gflops(counts)
    ref = vitdet_jax_flops(False, [], 1024, frames=COCO_FRAMES, streams=1) / 1e9
    if abs(got - ref) > 1e-6 * ref:
        raise AssertionError(f"counted {got} GFLOPs per call, the JAX package's count is {ref}")
    times = [time_vitdet(model, frames, warmup=0, iters=2, run=run_e2e) for _ in range(2)]
    with torch.no_grad():
        ctx = Ctx()
        tokens, _ = model.apply_backbone(ctx, model.init_state(1), model.pre_backbone(ctx, frames[0]),
                                         model.precompute())
    heads_check = coco_heads_on_features(model, tokens, device)
    del tokens
    torch.cuda.empty_cache()
    numbers, f32_launches = coco_card_vs_cpu(device)
    emit("coco_path", card=smi, config="models/vitdet_b_coco.yml", size=COCO_SIZE,
         frames=COCO_FRAMES, dtype="bfloat16", launches={k: v for k, v in launches.items() if v},
         kept_detections_per_frame=kept,
         masks_of_kept_per_frame=[int(d["masks"][d["mask"]].shape[0]) for d in dets],
         nms_host_syncs_per_frame=syncs, gflops_per_frame=got / COCO_FRAMES,
         jax_gflops_per_frame=ref / COCO_FRAMES, max_memory_allocated=peak,
         memory_allocated_at_start=held,
         columns=["first_frame_ms", "later_frames_ms", "mean_frame_ms"], ms=times,
         f32_heads_check=heads_check, f32_depth=VITDET_CHECK_DEPTH, mask_tol=MASK_TOL, **numbers)
    graph_coco(model, frames, smi)
    del model, frames
    torch.cuda.empty_cache()
    return [kernel_row(name, rows[(name, torch.bfloat16, tag)], launches, "coco")
            for name, tag in COCO_ROWS]


# -- the temporal fine-tune --------------------------------------------------------
#
# configs/train/vivit_kinetics400/final_24.yml as the port's utils/config.py
# composes it: the full ViViT-B K400 model, temporal_only, whose temporal
# model (4 blocks, C = 768, 12 heads, 17 tokens) and classifier train, AdamW
# lr 2e-6 and weight decay 0.05, dropout 0.5, train_batch_size 16 clips of
# 12 views: 192 sequences a step. The cache is generated: TRAIN_CLIPS
# train and TRAIN_VAL_CLIPS validation clips of (12, 16, 768) float32
# features ~ N(0, 1) (the spatial model's output is layer-normed),
# random labels of 400 classes, in the layout scripts/spatial writes.
TRAIN_CONFIG = "final_24"
TRAIN_CLIPS, TRAIN_VAL_CLIPS = 32, 16
TRAIN_TIMED_STEPS = 4
# card against CPU on one batch, float32, TF32 off, dropout 0: the loss
# within TRAIN_LOSS_TOL (relative) and each trained parameter's gradient
# within TRAIN_GRAD_TOL of its largest magnitude (sums in other orders);
# after one AdamW step every parameter within 2 lr (1 + weight decay) plus 2
# float32 ulps of its value: a first Adam step is lr g / (|g| + eps), so a
# gradient within float32 noise of 0 may step either way, by up to lr on
# each side; the others agree to the ulp, and the share beyond 1e-3 lr plus
# 2 ulps is reported
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-5, 1e-4
TRAIN_ROWS = ("dense_mlp_residual", "window_attention")


def train_shape(model_config):
    """(views, time steps, dim) of a clip's spatial features for the
    model of ``model_config``."""
    views = model_config["spatial_views"] * model_config["temporal_views"]
    steps = model_config["input_shape"][0] // model_config["tubelet_shape"][0]
    return views, steps, model_config["temporal_config"]["block_config"]["dim"]


def train_cache(root, model_config, seed=SEED):
    """The generated cache under ``root`` (data/kinetics400's layout:
    train_40 and val, spatial_224_25_24)."""
    rng = np.random.default_rng(seed)
    for split, n in (("train_40", TRAIN_CLIPS), ("val", TRAIN_VAL_CLIPS)):
        location = Path(root, split, "spatial_224_25_24")
        location.mkdir(parents=True)
        for i in range(n):
            np.savez(location / f"{i:05d}.npz", label=np.asarray(rng.integers(400)),
                     spatial=rng.standard_normal(train_shape(model_config)).astype(np.float32))


def train_card_vs_cpu(model, config, inputs, labels, device):
    """One batch through ``loss_fn`` under Ctx(training=True) with dropout
    0, backward and one AdamW step (``make_optimizer``) on the card and on
    a CPU copy made first: the loss, every trained parameter's gradient and
    value after the step within the bounds above, the frozen parameters
    unchanged on both sides, no kernel launched. Returns the numbers."""
    from eventful_transformer_tpu_torch.core.counting import Ctx
    from eventful_transformer_tpu_torch.utils.train import loss_fn, make_optimizer

    lr = config["optimizer_kwargs"]["lr"]
    decay = config["optimizer_kwargs"]["weight_decay"]
    rate = model.dropout.rate
    model.dropout.rate = 0.0
    cpu = copy.deepcopy(model).cpu()
    out = {}
    for tag, m, where in (("card", model, device), ("cpu", cpu, "cpu")):
        optimizer = make_optimizer(config, m)
        reset_launches()
        loss, _ = loss_fn(m, inputs.to(where), labels.to(where),
                          Ctx(training=True, generator=torch.Generator(device=where).manual_seed(0)))
        loss.backward()
        grads = {n: p.grad.detach().cpu() for n, p in m.named_parameters() if p.requires_grad}
        optimizer.step()
        if tag == "card":
            torch.cuda.synchronize()
            launched = {k: v for k, v in read_launches().items() if v}
            if launched:
                raise AssertionError(f"a training step launched {launched}")
        out[tag] = dict(loss=float(loss.detach()), grads=grads,
                        params={n: p.detach().cpu() for n, p in m.named_parameters()},
                        trained={n for n, p in m.named_parameters() if p.requires_grad})
        optimizer.zero_grad(set_to_none=True)
    model.dropout.rate = rate
    card, ref = out["card"], out["cpu"]
    start = dict(cpu.named_parameters())  # the CPU model after its step: frozen ones unchanged
    loss_err = abs(card["loss"] - ref["loss"]) / abs(ref["loss"])
    grad_err = max(float((card["grads"][n] - g).abs().max() / g.abs().max().clamp(min=1e-30))
                   for n, g in ref["grads"].items())
    step_err, beyond, total = 0.0, 0, 0
    ulp = torch.finfo(torch.float32).eps
    for n in ref["trained"]:
        a, b = card["params"][n], ref["params"][n]
        slack = 2 * ulp * b.abs()
        diff = (a - b).abs()
        step_err = max(step_err, float((diff - slack).max()))
        beyond += int((diff > 1e-3 * lr + slack).sum())
        total += b.numel()
    frozen_same = all(torch.equal(card["params"][n], start[n].detach())
                      for n in card["params"] if n not in card["trained"])
    numbers = dict(loss_card=card["loss"], loss_cpu=ref["loss"], loss_rel_err=loss_err,
                   loss_tol=TRAIN_LOSS_TOL, max_scaled_grad_err=grad_err, grad_tol=TRAIN_GRAD_TOL,
                   max_step_err_beyond_2ulp=step_err, step_tol=2 * lr * (1 + decay),
                   step_elements_beyond_milli_lr=beyond, trained_elements=total,
                   trained_tensors=len(ref["trained"]), frozen_unchanged=frozen_same)
    if (loss_err > TRAIN_LOSS_TOL or grad_err > TRAIN_GRAD_TOL or not frozen_same
            or step_err > 2 * lr * (1 + decay) or card["trained"] != ref["trained"]):
        raise AssertionError(f"the training step on the card disagrees with the CPU's: {numbers}")
    return numbers, cpu


def train_path(device, smi):
    """Phases train_kernels and train_path: the fine-tune of final_24.yml
    over a generated cache in a temporary directory. The entry point
    (python -m eventful_transformer_tpu_torch.scripts.train.
    vivit_kinetics400) in a subprocess for one epoch from a seed .npz that
    the port wrote, its printed lines and output weights read back; in
    this process, check train_card_vs_cpu, TRAIN_TIMED_STEPS timed steps
    (loss and ms a step, the peak of allocated memory, no kernel
    launched), a validation batch (rows 5 and 6), the grad guard raising
    where an inference path meets parameters that require grad, and a
    save_params/load_params round trip of the trained weights. Returns the
    final line's rows."""
    import tempfile

    from eventful_transformer_tpu_torch.core.counting import Ctx
    from eventful_transformer_tpu_torch.data.vivit_spatial import ViViTSpatial
    from eventful_transformer_tpu_torch.models import FactorizedViViT
    from eventful_transformer_tpu_torch.utils.params import load_params, params_to_numpy, save_params
    from eventful_transformer_tpu_torch.utils.train import (
        _batches,
        eval_step,
        loss_fn,
        make_optimizer,
        train_step,
    )

    config = harness_config("vivit_kinetics400", [TRAIN_CONFIG], kind="train")
    batch = config["train_batch_size"]
    views, steps, _ = train_shape(config["model"])
    depth = config["model"]["temporal_config"]["depth"]
    rows = check_kernels("train_kernels", device, [
        ("train_val", batch * views, steps + 1, steps + 1, TRAIN_ROWS, dict(window=(4, 6))),
    ])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        tmp = Path(tmp)
        train_cache(tmp / "kinetics400", config["model"])
        model = FactorizedViViT(**{"seed": SEED, **config["model"]})
        save_params(tmp / "start.npz", model)
        output = []
        module = "eventful_transformer_tpu_torch.scripts.train.vivit_kinetics400"
        argv = [TRAIN_CONFIG, f"data={tmp / 'kinetics400'}", "epochs=1",
                f"starting_weights={tmp / 'start.npz'}", f"output_weights={tmp / 'out.npz'}"]
        process_s, _ = run_as_main([[module, *argv]], output=output)
        printed = [line for line in output[0].splitlines() if line.startswith("Loss:")]
        train_data = ViViTSpatial(tmp / "kinetics400", split="train_40", k=24,
                                  base_name="spatial_224_25")
        val_data = ViViTSpatial(tmp / "kinetics400", split="val", k=24, base_name="spatial_224_25")
        batches = list(_batches(train_data, batch, True, SEED, device))
        (val_inputs, val_labels), = _batches(val_data, config["val_batch_size"], False, 0, device)
        check, holder = train_card_vs_cpu(model, config, *batches[0], device)

        optimizer = make_optimizer(config, model)
        generator = torch.Generator(device=device).manual_seed(42)
        train_step(model, optimizer, *batches[0], generator)  # warm-up
        events = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_TIMED_STEPS + 1)]
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
        reset_launches()
        losses = []
        events[0].record()
        for i in range(TRAIN_TIMED_STEPS):
            loss, _ = train_step(model, optimizer, *batches[i % len(batches)], generator)
            events[i + 1].record()
            losses.append(loss)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device)
        step_ms = [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
        losses = [float(v) for v in losses]
        step_launches = {k: v for k, v in read_launches().items() if v}
        reset_launches()
        val_loss, probs = eval_step(model, val_inputs, val_labels)
        torch.cuda.synchronize()
        val_launches = read_launches()
        read_routes(torch.float32, "train validation")
        try:  # the inference path in grad mode: parameters that require grad meet a kernel
            with torch.enable_grad():
                loss_fn(model, val_inputs, val_labels, Ctx())
            guard = None
        except RuntimeError as error:
            guard = str(error)
        save_params(tmp / "trained.npz", model)
        holder = load_params(tmp / "trained.npz", holder.to(device))
        _, again = eval_step(holder, val_inputs, val_labels)
        roundtrip = float((again - probs).abs().max())
        load_params(tmp / "out.npz", holder)
        entry_loss, _ = eval_step(holder, val_inputs, val_labels)
        with np.load(tmp / "start.npz") as start:
            saved = params_to_numpy(holder)
            frozen_kept = all(np.array_equal(saved[k], start[k]) for k in start.files
                              if not k.startswith(("temporal_model", "classifier")))
            trained_moved = any(not np.array_equal(saved[k], start[k]) for k in start.files
                                if k.startswith(("temporal_model", "classifier")))
    want_val = dict.fromkeys(wrappers(), 0)
    want_val.update(window_attention=depth, dense_mlp_residual=depth)
    entry_val = float(printed[-1].split(";")[0].split()[-1]) if printed else None
    numbers = dict(config=f"train/vivit_kinetics400/{TRAIN_CONFIG}", dtype="float32",
                   sequences_per_step=batch * views, tokens=steps + 1,
                   train_clips=TRAIN_CLIPS, val_clips=TRAIN_VAL_CLIPS, entry_process_s=process_s,
                   entry_printed=printed, entry_val_loss_recomputed=float(entry_loss),
                   step_loss=losses, step_ms=step_ms, max_memory_allocated=peak,
                   memory_allocated_at_start=held,
                   step_launches=step_launches, val_loss=float(val_loss),
                   val_launches={k: v for k, v in val_launches.items() if v},
                   grad_guard=guard, npz_roundtrip_max_prob_diff=roundtrip,
                   entry_frozen_kept=frozen_kept, entry_trained_moved=trained_moved, **check)
    emit("train_path", card=smi, **numbers)
    if (step_launches or val_launches != want_val or guard is None or "requires grad" not in guard
            or roundtrip > 1e-6 or not frozen_kept or not trained_moved or len(printed) != 3
            or abs(entry_val - float(entry_loss)) > 1e-4
            or not all(np.isfinite(v) for v in losses + step_ms)):
        raise AssertionError(f"train path: {numbers}")
    del model, holder, optimizer
    torch.cuda.empty_cache()
    return [kernel_row(name, rows[(name, torch.float32, "train_val")], val_launches, "train_val")
            for name in TRAIN_ROWS]


# -- Multi-process evaluation: data and sequence parallelism (parallel/) --------
#
# One rank function, parallel_rank, for any number of processes: each rank
# drives three paths at full width on seed weights and generated data, each
# against the same configuration run in that process without the parallel
# option, and the first rank compares. The phase runs it as one rank under
# torchrun (``python -m torch.distributed.run --standalone
# --nproc_per_node=1``: NCCL at world size 1, the machine's one card); on a
# host of G cards it runs by hand, the kernels built first:
#
#     python -c 'from eventful_transformer_tpu_torch.ops import _build; _build.load_library()'
#     torchrun --standalone --nproc_per_node=G chip_smoke.py --parallel-rank out.json \
#         --frames 8 --items 5
#
# (a) SP: configs/evaluate/vitdet_vid/ulysses_smoke_672.yml (ViTDet-B, 12 dense
# global blocks of 768, 12 heads, N = 1764) through
# evaluate_vitdet_metrics_sp, the blocks' sequence_parallel off for the other
# run; (b) DP ViTDet: spatiotemporal_672.yml with token_top_k=[512] through
# evaluate_vitdet_metrics_dp; (a) over one, (b) over ``items`` generated VID
# videos of ``frames`` raw 720 x 1280 frames through VIDResize, their ground
# truth the other run's three best detections a frame moved by a pixel (the
# class scorer scaled by CLS_SCORE_GAIN, as the e2e phase does), so that the
# mAP the two compare is not 0; (c) DP ViViT: the vivit_kinetics400 entry
# point with data_parallel=true on temporal_24.yml over ``items`` of harness
# path A's generated clips, against the entry point without it. Float32, as
# the harness builds the models. The metrics and counts must be equal (SP's
# metrics within PARALLEL_SP_RTOL where P > 1), and the launches by wrapper:
# on SP each rank's those of its plain run, on DP the ranks' sum.
PARALLEL_FRAMES = 3
PARALLEL_K = 512
PARALLEL_TIMEOUT = 300
# the parallel driver's runs: the first may hold one-time costs; the last
# is compared and its launches kept
PARALLEL_RUNS = 2
# SP over P > 1 runs its GEMMs on N/P rows, so float32 sums in other orders
PARALLEL_SP_RTOL = 1e-4
# the kernels of paths (a) and (b) (dense_mlp_residual the only one of (a))
PARALLEL_672 = ("dense_mlp_residual", "ln_norms", "gate_group_linear", "gate_group_linear_post",
                "block_select_p", "block_scatter_rows", "gate_group_mlp",
                "window_attention_windowed", "softmax_select_matmul", "relpos_bias_add_v2")
# the paths' kernels at their shapes, in float32 (the harness's dtype)
PARALLEL_CASES = [
    ("parallel_672", 1, VITDET[672]["n"], PARALLEL_K, PARALLEL_672,
     dict(VITDET[672]["inputs"], relpos_keys=VITDET[672]["keys"]["pooled"])),
    ("parallel_vivit", EV_SPATIAL_VIEWS * EV_TEMPORAL_VIEWS, N_TOKENS, EV_K,
     ("ln_norms", "gate_group_mlp"), dict(window=(4, 6), pool=(1, N_TOKENS))),
    ("parallel_vivit_temporal", EV_SPATIAL_VIEWS * EV_TEMPORAL_VIEWS, STEPS + 1, STEPS + 1,
     DENSE_KERNELS, dict(window=(4, 6))),
    # the TP path's dense ViViT-B, 3 x 4 views of 197 tokens (its temporal
    # model runs the same kernels at 17)
    ("tp_vivit", EV_SPATIAL_VIEWS * EV_TEMPORAL_VIEWS, N_TOKENS, N_TOKENS, DENSE_KERNELS,
     dict(window=(4, 6))),
]
# each path's kernels, with the tag of their check
PARALLEL_ROWS = {
    "parallel_sp": [("dense_mlp_residual", "parallel_672")],
    "parallel_dp_vitdet": [(name, "parallel_672") for name in PARALLEL_672[1:]],
    "parallel_dp_vivit": [("ln_norms", "parallel_vivit"), ("gate_group_mlp", "parallel_vivit"),
                          ("window_attention", "parallel_vivit_temporal"),
                          ("dense_mlp_residual", "parallel_vivit_temporal")],
}


def counted(fn, *args):
    """``fn(*args)`` with the launch counts set to 0 just before and read
    just after: (its result, the launches by wrapper, its seconds)."""
    reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, read_launches(), time.perf_counter() - start


def counted_runs(fn, *args):
    """``fn(*args)`` PARALLEL_RUNS times, each started on every rank
    together: (the last run's result and launches, every run's seconds)."""
    import torch.distributed as dist

    seconds = []
    for _ in range(PARALLEL_RUNS):
        dist.barrier()
        out, launches, run_s = counted(fn, *args)
        seconds.append(run_s)
    return out, launches, seconds


def parallel_annotated(model, data):
    """``data``'s videos with each frame's ground truth the three best
    detections of ``model`` (the path's other run) moved by a pixel, made
    on the first rank and sent to the others."""
    import torch.distributed as dist

    from eventful_transformer_tpu_torch.utils.evaluate import (
        make_vitdet_eval_step,
        vitdet_item_results,
    )

    videos = None
    if dist.get_rank() == 0:
        videos = []
        results = vitdet_item_results(model, data, range(len(data)),
                                      make_vitdet_eval_step(model, {}))
        for i, frames in enumerate(results):
            video = []
            for (frame, _), (kept, _, _) in zip(data[i], frames):
                top = np.argsort(-kept["scores"], kind="stable")[:3]
                video.append((frame, {"boxes": kept["boxes"][top] + 1.0,
                                      "labels": kept["labels"][top].astype(np.int32)}))
            videos.append(video)
    box = [videos]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def warm_group(group):
    """One all-reduce and one all-to-all on ``group``: its communicator
    comes up at its first collective, and NCCL's connection between two of
    its peers at their first exchange, which no timed run should hold."""
    import torch.distributed as dist

    on = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    dist.all_reduce(torch.zeros(1, device=on), group=group)
    x = torch.zeros(dist.get_world_size(group), device=on)
    dist.all_to_all_single(torch.empty_like(x), x, group=group)


def parallel_vitdet(location, overrides, mesh_axis, evaluate_parallel, frames, items, sp=False):
    """Path (a) or (b): the model of ``configs/evaluate/vitdet_vid/<location>``
    with ``overrides`` on the card, float32, over ``items`` videos of
    ``frames`` frames; the evaluation without the parallel option and
    without capture (``graph=False``), then ``evaluate_parallel`` over
    ``mesh_axis`` (DP replays the frame's graphs)."""
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.data.vid import VIDResize
    from eventful_transformer_tpu_torch.models import ViTDet
    from eventful_transformer_tpu_torch.parallel.mesh import make_mesh
    from eventful_transformer_tpu_torch.utils.evaluate import evaluate_vitdet_metrics
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    config = harness_config("vitdet_vid", [location, f"n_items={items}", *overrides])
    model = ViTDet(**{"seed": SEED, **config["model"]})
    with torch.no_grad():
        model.roi_heads.cls_score.kernel.mul_(CLS_SCORE_GAIN)
    for k in config.get("token_top_k", []):
        set_policies(model, TokenNormTopK, k=k)
    mesh = make_mesh((-1,), (mesh_axis,), "cuda")
    warm_group(mesh.get_group(mesh_axis))

    def sequence_parallel(axis):
        for block in model.backbone.blocks:
            block.sequence_parallel = axis

    long_edge = max(config["model"]["input_shape"][-2:])
    data = harness_vid(VIDResize(short_edge_length=640 * long_edge // 1024, max_size=long_edge),
                       frames=frames, n_items=items)
    sequence_parallel(None)
    data = parallel_annotated(model, data)

    def eager(model, data, config):  # the one-process run without its graphs
        return evaluate_vitdet_metrics(model, data, config, graph=False)

    plain, plain_launches, plain_s = counted(eager, model, data, config)
    if sp:
        sequence_parallel(mesh_axis)
    par, launches, seconds = counted_runs(evaluate_parallel, model, data, config, mesh)
    return dict(plain=plain, par=par, plain_launches=plain_launches, launches=launches,
                plain_s=plain_s, seconds=seconds)


def parallel_vivit(tmp, items):
    """Path (c): the ViViT entry point on temporal_24 over ``items`` clips
    without and with data_parallel=true, each run's titles, CSVs (where
    this rank wrote them) and launches."""
    from eventful_transformer_tpu_torch.scripts.evaluate import vivit_kinetics400

    synthetic = dict(n_items=items, n_frames=HARNESS_CLIP_FRAMES, size=[240, 320], classes=400,
                     seed=SEED)

    def run(name, extra):
        argv = ["temporal_24", f"n_items={items}", f"synthetic={json.dumps(synthetic)}",
                f"_output={tmp}/{name}", *extra]
        with contextlib.chdir(REPO):
            done = vivit_kinetics400.main(argv)
        written = Path(tmp, name, "metrics.csv").is_file()
        return dict(done=done, **{key: Path(tmp, name, f"{key}.csv").read_text()
                                  for key in ("metrics", "counts") if written})

    plain, plain_launches, plain_s = counted(run, "plain", [])
    n = iter(range(PARALLEL_RUNS))  # each run its own output (a sweep appends to its CSVs)
    par, launches, seconds = counted_runs(lambda: run(f"par_{next(n)}", ["data_parallel=true"]))
    return dict(plain=plain, par=par, plain_launches=plain_launches, launches=launches,
                plain_s=plain_s, seconds=seconds)


def parallel_same(path, runs):
    """Whether ``path``'s parallel run equals its plain run, from every
    rank's result: the first rank's metrics and counts (SP's metrics within
    PARALLEL_SP_RTOL where P > 1), and the launches by wrapper (SP: each
    rank's its plain run's; DP: the ranks' sum the first rank's plain
    run's)."""
    first = runs[0]
    plain, par = first["plain"], first["par"]
    if path == "parallel_sp" and len(runs) > 1:
        same = (plain["counts"] == par["counts"] and set(plain["metrics"]) == set(par["metrics"])
                and all(np.isclose(par["metrics"][k], v, rtol=PARALLEL_SP_RTOL, atol=0)
                        for k, v in plain["metrics"].items()))
    else:
        same = plain == par
    if path == "parallel_sp":
        return same and all(r["launches"] == r["plain_launches"] for r in runs)
    return same and parallel_launches(path, runs) == first["plain_launches"]


def parallel_launches(path, runs):
    """The path's launches by wrapper: SP's on the first rank (each rank
    runs every block), DP's summed over the ranks (each runs its items)."""
    if path == "parallel_sp":
        return runs[0]["launches"]
    return {name: sum(r["launches"][name] for r in runs) for name in runs[0]["launches"]}


def parallel_rank(out, frames=PARALLEL_FRAMES, items=1):
    """The rank of the parallel paths, under torchrun: paths (a), (b) and
    (c) on the process group of torchrun's environment (NCCL on the card),
    (a) over one video of ``frames`` frames, (b) and (c) over ``items``
    videos or clips, then pipeline, tp and dryrun; the first rank writes
    their results, compared, to ``out`` as JSON."""
    import tempfile

    import torch.distributed as dist

    from eventful_transformer_tpu_torch.ops import _build
    from eventful_transformer_tpu_torch.parallel.evaluate import (
        evaluate_vitdet_metrics_dp,
        evaluate_vitdet_metrics_sp,
    )
    from eventful_transformer_tpu_torch.parallel.mesh import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    _build.load_library()
    result, path_s = {}, {}
    with distributed("cuda"), tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        warm_group(dist.group.WORLD)
        rank, size = dist.get_rank(), dist.get_world_size()
        result.update(backend=dist.get_backend(), world_size=size, frames=frames, items=items,
                      device=torch.cuda.get_device_name(torch.cuda.current_device()),
                      ready_s=time.perf_counter() - _START)
        paths = {
            "parallel_sp": lambda: parallel_vitdet("ulysses_smoke_672", [], "seq",
                                                   evaluate_vitdet_metrics_sp, frames, 1, sp=True),
            "parallel_dp_vitdet": lambda: parallel_vitdet(
                "spatiotemporal_672", [f"token_top_k=[{PARALLEL_K}]"], "data",
                evaluate_vitdet_metrics_dp, frames, items),
            "parallel_dp_vivit": lambda: parallel_vivit(tmp, items),
        }
        for path, run in paths.items():
            start = time.perf_counter()
            mine = run()
            runs = [None] * size if rank == 0 else None
            dist.gather_object(mine, runs, dst=0)
            path_s[path] = time.perf_counter() - start
            if rank == 0:
                # the group's seconds: its slowest rank's
                result[path] = dict(
                    mine, launches=parallel_launches(path, runs),
                    seconds=[max(r["seconds"][i] for r in runs) for i in range(PARALLEL_RUNS)],
                    same_as_plain=parallel_same(path, runs),
                )
            torch.cuda.empty_cache()
        for path, run in (("pipeline", pipeline_path), ("tp", tp_path), ("dryrun", dryrun_path)):
            start = time.perf_counter()
            mine = run(size)
            path_s[path] = time.perf_counter() - start
            if rank == 0:
                result[path] = mine
            torch.cuda.empty_cache()
    if rank == 0:
        result["path_s"] = path_s
        Path(out).write_text(json.dumps(result, default=float))


def run_parallel_rank(tmp):
    """``parallel_rank`` under torchrun in its own session, killed with
    every process it started after PARALLEL_TIMEOUT seconds. Returns (its
    results, the process's seconds)."""
    import os
    import signal

    out = Path(tmp, "parallel_rank.json")
    start = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
         str(REPO / "chip_smoke.py"), "--parallel-rank", str(out)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True,
    )
    try:
        _, stderr = proc.communicate(timeout=PARALLEL_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"parallel_paths: the rank ran past {PARALLEL_TIMEOUT} s")
    if proc.returncode != 0 or not out.is_file():
        raise AssertionError(f"parallel_paths: the rank failed: {stderr[-3000:]}")
    return json.loads(out.read_text()), time.perf_counter() - start


def parallel_paths(device, smi, vivit_rows):
    """Phases parallel_kernels (each kernel of paths (a)-(c) and tp at their
    shapes, as in 3), parallel_paths (the three evaluation paths in one rank
    under torchrun, NCCL at world size 1: each run's metrics, counts and
    launches by wrapper equal to those of its run without the parallel
    option; on (a) dense_mlp_residual 12 times a frame), and from the same
    rank pipeline_path, tp_paths and dryrun (``training_parallel_paths``;
    ``vivit_rows``: phase 3's checks). Returns the final line's rows."""
    import tempfile

    rows = check_kernels("parallel_kernels", device, PARALLEL_CASES, dtypes=(torch.float32,))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        result, process_s = run_parallel_rank(tmp)
    paths, failures = {}, []
    for path in PARALLEL_ROWS:
        r = result[path]
        launches = r["launches"]
        same = r["same_as_plain"]
        if path == "parallel_dp_vivit":
            same = same and launches == ev_expected_launches("auto")
        else:
            same = same and r["par"]["metrics"]["map"] > 0
        if path == "parallel_sp":
            same = same and launches["dense_mlp_residual"] == VITDET_DEPTH * PARALLEL_FRAMES
        paths[path] = dict(seconds=r["seconds"], plain_s=r["plain_s"], result=r["par"],
                           launches={k: v for k, v in launches.items() if v},
                           same_as_plain=same)
        if not same:
            failures.append(path)
    emit("parallel_paths", card=smi, backend=result["backend"], world_size=result["world_size"],
         device=result["device"], process_s=process_s, ready_s=result["ready_s"],
         path_s=result["path_s"], paths=paths)
    if result["backend"] != "nccl" or result["world_size"] != 1 or failures:
        raise AssertionError(f"parallel paths {failures} differ from their plain runs, or the "
                             f"backend is {result['backend']}: {paths}")
    out = [kernel_row(name, rows[(name, torch.float32, tag)], result[path]["launches"], path)
           for path, names in PARALLEL_ROWS.items() for name, tag in names]
    out += training_parallel_paths(result, smi, vivit_rows, rows)
    idle = [(row["path"], row["name"]) for row in out if not row["launches"]]
    if idle:
        raise AssertionError(f"parallel paths launched no {idle}")
    return out


# -- Training and pipeline parallelism, the dry run (parallel/{sharding,train,
# pipeline,dryrun}.py) and the detector's losses (detection/training.py) ------
#
# Three more paths of parallel_rank, on the same process group: pipeline (the
# ViViT-B K400 spatial stack of the slice phase, 12 EventfulTokenwiseBlocks,
# k = 98, "v4", bf16, over one clip's 16 tubelet steps of the bench's 2 x 4
# views, through make_pipelined_backbone over every rank, P = the world
# size), against the backbone's block loop (ViTBackbone.run_blocks) in that
# process: outputs and every state tensor equal (torch.equal), the launches
# by wrapper too (at P > 1 each stage's first block computes its own
# qkv-gate norms, so ln_norms runs P times a step where the loop hands the
# norms on); tp (ViViT-B K400 with dense blocks, 3 x 4 views of 32 frames at
# 224, float32, on best_dp_tp_mesh(max_tp=TP_MAX): 1 x 1 on one card, 2 x 2
# on four) against the same model unsharded in that process: apply_views on
# this rank's data shard, then TRAIN_STEPS steps of make_sharded_train_step
# on dp clips against TRAIN_STEPS plain autograd steps over the same data
# shards, each drawn from its data rank's generator: equal at world size 1,
# within TP_RTOL beyond; and dryrun (dryrun_multichip at the world size).
# On four cards by hand, as above:
#
#     torchrun --standalone --nproc_per_node=4 chip_smoke.py --parallel-rank out.json
#
# runs TP at 2 x 2, the pipeline at P = 4 (3 blocks a stage) and
# dryrun_multichip(4) with the evaluation paths.
TP_MAX = 2
TRAIN_STEPS = 2
TRAIN_SEED = 1
# SGD with momentum: its step is linear in the gradient, so beyond world
# size 1 the parameters stay as close as the gradients (AdamW turns a
# float32-noise gradient element into a step of up to lr; the CPU tests hold
# it against optax's, tests/test_torch_tensor_parallel.py)
TRAIN_OPTIMIZER = {"optimizer": "SGD", "optimizer_kwargs": {"lr": 1e-2, "momentum": 0.9}}
# beyond world size 1 the TP sums (and the data all-reduce) run in other orders
TP_RTOL = 1e-4
PIPELINE_KERNELS = ("ln_norms", "qkv_attention_group", "proj_group", "gate_group_mlp",
                    "window_attention")
# each training path's kernels, with the tag of their check: the pipeline's
# at the slice phase's shapes (phase 3, bf16), the TP model's at 12 x 197
# (float32, in parallel_kernels)
TRAINING_ROWS = {
    "pipeline": [(name, "vivit") for name in PIPELINE_KERNELS],
    "tp": [(name, "tp_vivit") for name in DENSE_KERNELS],
}


def rank_device():
    """The card of this rank."""
    return torch.device("cuda", torch.cuda.current_device())


def tp_config():
    """ViViT-B K400 (configs/models/vivit_b_kinetics400.yml) with dense
    blocks: 3 x 4 views."""
    return dict(vivit_config(False), spatial_views=EV_SPATIAL_VIEWS,
                temporal_views=EV_TEMPORAL_VIEWS)


def generated_views(config, clips, seed=SEED):
    """``clips`` clips of the config's views, standard normal."""
    views = config["spatial_views"] * config["temporal_views"]
    shape = (clips, views, *config["input_shape"])
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def equal_states(a, b):
    """Whether two block states hold equal tensors (and other leaves)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            equal_states(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    return a == b


def pipeline_path(size):
    """Path pipeline: (its result on the first rank, None on the others)."""
    import torch.distributed as dist

    from eventful_transformer_tpu_torch.core.counting import Ctx
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.models import FactorizedViViT
    from eventful_transformer_tpu_torch.parallel.mesh import make_mesh
    from eventful_transformer_tpu_torch.parallel.pipeline import make_pipelined_backbone
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    device = rank_device()
    config = vivit_config(True)
    model = FactorizedViViT(**config, device=device, seed=SEED).to(torch.bfloat16)
    set_policies(model, TokenNormTopK, k=K)
    backbone = model.spatial_model.backbone
    views = generated_views(config, CLIPS).to(device, torch.bfloat16)
    with torch.no_grad():
        x = model.embedding(Ctx(), views.flatten(0, 1))
        cls = model.spatial_model.class_token.to(x.dtype).expand(x.shape[0], 1, x.shape[-1])
        encoding = backbone.precompute()["position_encoding"]
        frames = torch.stack([backbone.position_encoding(Ctx(), torch.cat([cls, x[:, t]], 1),
                                                         encoding)
                              for t in range(x.shape[1])])
    run = make_pipelined_backbone(backbone, make_mesh((-1,), ("pipe",), "cuda"))
    batch = frames.shape[1]
    dist.barrier()
    (out, state), launches, seconds = counted(
        run, backbone.init_state(batch, torch.bfloat16, device), frames)
    every = [None] * size if dist.get_rank() == 0 else None
    dist.gather_object(launches, every, dst=0)
    if dist.get_rank() != 0:
        return None

    def loop():
        states = backbone.init_state(batch, torch.bfloat16, device)["blocks"]
        aux = backbone.precompute()["blocks"]
        ys = []
        with torch.no_grad():
            for t in range(frames.shape[0]):
                mode = "flush" if t == 0 else "incremental"
                y, states = backbone.run_blocks(Ctx(), states, frames[t], mode, aux)
                ys.append(y)
        return torch.stack(ys), states

    (want, want_states), plain_launches, plain_s = counted(loop)
    summed = {name: sum(r[name] for r in every) for name in launches}
    expected = dict(plain_launches, ln_norms=size * plain_launches["ln_norms"])
    same = (torch.equal(out, want)
            and all(equal_states(a, b) for a, b in zip(state["blocks"], want_states))
            and summed == expected)
    return dict(stages=size, frames=list(frames.shape), same_as_plain=same,
                launches=summed, plain_launches=plain_launches, seconds=seconds,
                plain_s=plain_s)


def tp_path(size):
    """Path tp: (its result on the first rank, None on the others)."""
    import torch.distributed as dist

    from eventful_transformer_tpu_torch.core.counting import Ctx
    from eventful_transformer_tpu_torch.models import FactorizedViViT
    from eventful_transformer_tpu_torch.parallel.mesh import best_dp_tp_mesh
    from eventful_transformer_tpu_torch.parallel.sharding import gathered_params, shard_params
    from eventful_transformer_tpu_torch.parallel.train import (
        cross_entropy_from_probs,
        data_generator,
        make_sharded_train_step,
    )
    from eventful_transformer_tpu_torch.utils.train import make_optimizer

    device = rank_device()
    mesh = best_dp_tp_mesh(max_tp=TP_MAX, device="cuda")
    data, model_group = mesh.get_group("data"), mesh.get_group("model")
    dp, tp = dist.get_world_size(data), dist.get_world_size(model_group)
    data_rank = dist.get_rank(data)
    first = dist.get_rank() == 0
    config = tp_config()
    views = generated_views(config, dp)
    labels = torch.from_numpy(np.random.default_rng(SEED + 1).integers(0, config["classes"], dp))
    mine = views[data_rank : data_rank + 1].to(device)

    def close(a, b):
        if size == 1:
            return torch.equal(a, b)
        return torch.allclose(a, b, rtol=TP_RTOL, atol=TP_RTOL * float(b.abs().max()))

    sharded = FactorizedViViT(**config, device=device, seed=SEED)
    shard_params(mesh, sharded)
    dist.barrier()
    probs, launches, seconds = counted(run_model, sharded, mine)
    plain = FactorizedViViT(**config, device=device, seed=SEED)
    plain_probs, plain_launches, plain_s = counted(run_model, plain, mine)
    inference = dict(same_as_plain=close(probs[0], plain_probs[0]), launches=launches,
                     plain_launches=plain_launches, seconds=seconds, plain_s=plain_s)

    init_fn, make_step = make_sharded_train_step(sharded, TRAIN_OPTIMIZER, mesh)
    step = make_step(*init_fn())
    batch = {"inputs": views, "labels": labels}
    torch.cuda.reset_peak_memory_stats(device)
    dist.barrier()
    losses, step_ms = [], []
    reset_launches()
    for i in range(TRAIN_STEPS):
        start = time.perf_counter()
        losses.append(float(step(batch, TRAIN_SEED + i)))
        torch.cuda.synchronize()
        step_ms.append(1000 * (time.perf_counter() - start))
    train_launches = {k: v for k, v in read_launches().items() if v}
    peak = torch.cuda.max_memory_allocated(device)
    params = gathered_params(mesh, sharded)
    del sharded, step
    torch.cuda.empty_cache()
    if not first:
        dist.barrier()
        return None
    for p in plain.parameters():
        p.requires_grad_(True)
    optimizer = make_optimizer(TRAIN_OPTIMIZER, plain, list(plain.parameters()))
    plain_losses, plain_ms = [], []
    for i in range(TRAIN_STEPS):
        start = time.perf_counter()
        optimizer.zero_grad(set_to_none=True)
        total = 0.0
        for d in range(dp):
            ctx = Ctx(training=True, generator=data_generator(TRAIN_SEED + i, d, device))
            loss = cross_entropy_from_probs(plain.apply_views(ctx, views[d : d + 1].to(device)),
                                            labels[d : d + 1].to(device))
            (loss / dp).backward()
            total += float(loss.detach()) / dp
        optimizer.step()
        torch.cuda.synchronize()
        plain_ms.append(1000 * (time.perf_counter() - start))
        plain_losses.append(total)
    same_params = all(close(params[name], p.detach()) for name, p in plain.named_parameters())
    same_losses = (losses == plain_losses if size == 1
                   else np.allclose(losses, plain_losses, rtol=TP_RTOL, atol=0))
    del plain, optimizer
    torch.cuda.empty_cache()
    dist.barrier()
    training = dict(same_as_plain=same_losses and same_params, losses=losses,
                    plain_losses=plain_losses, step_ms=step_ms, plain_step_ms=plain_ms,
                    max_memory_allocated=peak, launches=train_launches, clips=dp,
                    views=int(views.shape[1]), frames=int(views.shape[2]))
    return dict(dp=dp, tp=tp, inference=inference, training=training)


def dryrun_path(size):
    """Path dryrun: dryrun_multichip over the world, timed."""
    from eventful_transformer_tpu_torch.parallel.dryrun import dryrun_multichip

    start = time.perf_counter()
    result = dryrun_multichip(size)
    return dict(result, seconds=time.perf_counter() - start)


def training_parallel_paths(result, smi, vivit_rows, rows):
    """Phases pipeline_path, tp_paths and dryrun from the rank's results:
    each checked; returns their final line's rows."""
    failures = []
    pipeline = result["pipeline"]
    want = dict(expected_launches(True), window_attention=DEPTH, dense_mlp_residual=0)
    want = {k: v for k, v in want.items() if v}
    launched = {k: v for k, v in pipeline["plain_launches"].items() if v}
    emit("pipeline_path", card=smi, path_s=result["path_s"]["pipeline"], **pipeline)
    if not pipeline["same_as_plain"] or launched != want:
        failures.append(("pipeline", launched, want))
    tp = result["tp"]
    emit("tp_paths", card=smi, path_s=result["path_s"]["tp"], **tp)
    # at tp > 1 the MLP runs plain (dense_mlp_residual would add its bias
    # and residual on every rank)
    inference_want = {name: DEPTH * STEPS + TEMPORAL_DEPTH for name in DENSE_KERNELS
                      if tp["tp"] == 1 or name == "window_attention"}
    launched = {k: v for k, v in tp["inference"]["launches"].items() if v}
    if (not tp["inference"]["same_as_plain"] or not tp["training"]["same_as_plain"]
            or tp["training"]["launches"] or launched != inference_want
            or not all(np.isfinite(v) for v in tp["training"]["losses"])):
        failures.append(("tp", tp))
    dry = result["dryrun"]
    emit("dryrun", card=smi, path_s=result["path_s"]["dryrun"], **dry)
    if not (np.isfinite(dry["loss"]) and np.isfinite(dry["map"])):
        failures.append(("dryrun", dry))
    if failures:
        raise AssertionError(f"training parallel paths failed: {failures}")
    out = [kernel_row(name, vivit_rows[(name, torch.bfloat16, tag)],
                      pipeline["plain_launches"], "pipeline")
           for name, tag in TRAINING_ROWS["pipeline"]]
    out += [kernel_row(name, rows[(name, torch.float32, tag)], tp["inference"]["launches"], "tp")
            for name, tag in TRAINING_ROWS["tp"]]
    return out


# -- Tensor parallelism of the eventful and ATS blocks (phase tp_eventful_paths)
#
# Two processes on the one card form a tp = 2 group over gloo
# (parallel/mesh.py's BACKEND_ENV: NCCL refuses two ranks on one device),
# under ``python -m torch.distributed.run --standalone --nproc_per_node=2
# chip_smoke.py --tp-eventful-rank <out>``; each rank holds 6 of ViViT-B's
# 12 heads (C = 768, 12 spatial and 4 temporal blocks), float32, one
# generated clip of 1 x 4 views of 32 frames. Three configurations
# (TP_EVENTFUL_RUNS): temporal_24 (EventfulBlock, k = 24, with
# ``av_kernel = True`` so that row 8 runs on each rank's heads: under
# "auto" it takes the kernel at one stream or 512 keys), the bench's
# tokenwise model (k = 98, "v4" unsharded, unfused at tp = 2) and
# EPIC-Kitchens ats.yml (ATS 0.9 in every dense spatial block, 401 tokens).
# Each rank runs the model unsharded on the unfused path (the one the
# sharded blocks take), then sharded: the probabilities within TP_RTOL,
# every selection (each gate's top-k, each ATS sampling) equal, the
# launches by wrapper kept per rank. temporal_24 is held with its bf16 A.V
# cast off, as the card-vs-CPU checks hold it: the cast rounds A.V's
# operands to bf16, and the group's float32 sums in another order flip
# some of those roundings, which move later selections (609 of 51840 with
# the cast on, NVIDIA H100 80GB HBM3, SEED 0); the run with it on is reported. Then
# TP_EVENTFUL_STEPS SGD steps of make_sharded_train_step against as many
# plain autograd steps of the unsharded model, the depth cut to
# TP_EVENTFUL_TRAIN_DEPTH spatial blocks and one temporal block: losses
# and this rank's parameter shards within TP_RTOL. The rank's kernels are
# checked in the main process at a rank's width (C = 384, 6 heads).
TP_EVENTFUL_RUNS = ("temporal_24", "tokenwise_98", "ats")
TP_EVENTFUL_WORLD = 2
TP_EVENTFUL_STEPS = 2
TP_EVENTFUL_TRAIN_DEPTH = 2
TP_EVENTFUL_TIMEOUT = 300
TP_EVENTFUL_WIDTH = (768 // TP_EVENTFUL_WORLD, 12 // TP_EVENTFUL_WORLD)
TP_EVENTFUL_VIEWS = 4
TP_EVENTFUL_CASES = [
    ("tp_eventful", TP_EVENTFUL_VIEWS, N_TOKENS, K, ("window_attention",), dict(window=(4, 6))),
    ("tp_eventful_temporal", TP_EVENTFUL_VIEWS, STEPS + 1, STEPS + 1, ("window_attention",),
     dict(window=(4, 6))),
    ("tp_eventful_evblock", TP_EVENTFUL_VIEWS, N_TOKENS, EV_K,
     ("softmax_select_matmul_noterms",), dict(window=(4, 6), pool=(1, N_TOKENS))),
]
# each configuration's kernels at tp = 2, with the tag of their check: the
# spatial stack's, then the temporal model's window_attention
TP_EVENTFUL_ROWS = {
    "temporal_24": [("softmax_select_matmul_noterms", "tp_eventful_evblock"),
                    ("window_attention", "tp_eventful_temporal")],
    "tokenwise_98": [("window_attention", "tp_eventful")],
    "ats": [("window_attention", "tp_eventful_temporal")],
}
# launches a rank makes a forward: row 8 at each incremental step of each
# spatial block; the global attention at each step of each tokenwise block
# and once in each temporal block
TP_EVENTFUL_LAUNCHES = {
    "temporal_24": {"softmax_select_matmul": DEPTH * (STEPS - 1),
                    "window_attention": TEMPORAL_DEPTH},
    "tokenwise_98": {"window_attention": DEPTH * STEPS + TEMPORAL_DEPTH},
    "ats": {"window_attention": TEMPORAL_DEPTH},
}


def tp_eventful_model_config(name, depth=DEPTH, temporal_depth=TEMPORAL_DEPTH):
    """(The model's keywords at 1 x 4 views, its policy as (class name,
    keywords) or None, the attributes set on every spatial block) of
    configuration ``name``."""
    if name == "tokenwise_98":
        model, policy, attrs = vivit_config(True), ("TokenNormTopK", dict(k=K)), {}
    elif name == "temporal_24":
        config = harness_config("vivit_kinetics400", ["temporal_24"])
        model, policy = config["model"], ("TokenNormTopK", dict(k=config["token_top_k"][0]))
        attrs = dict(av_kernel=True)
    else:
        model, policy, attrs = harness_config("vivit_epic_kitchens", ["ats"])["model"], None, {}
    model = copy.deepcopy(dict(model, spatial_views=1, temporal_views=TP_EVENTFUL_VIEWS))
    model["spatial_config"]["depth"] = depth
    model["temporal_config"]["depth"] = temporal_depth
    return model, policy, attrs


def tp_eventful_model(name, device, cast=True, **depths):
    """Configuration ``name``'s ViViT on ``device``, weights from SEED,
    its policy set; its A.V cast taken off unless ``cast``."""
    from eventful_transformer_tpu_torch.core import policies
    from eventful_transformer_tpu_torch.models import FactorizedViViT
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    kwargs, policy, attrs = tp_eventful_model_config(name, **depths)
    if not cast:
        kwargs["spatial_config"]["block_config"]["matmul_2_cast"] = None
    model = FactorizedViViT(**kwargs, device=device, seed=SEED)
    if policy is not None:
        set_policies(model, getattr(policies, policy[0]), **policy[1])
    for block in model.spatial_model.backbone.blocks:
        for key, value in attrs.items():
            setattr(block, key, value)
    return model


def tp_eventful_inference(model, mesh, views):
    """``model`` unsharded on the unfused path, then sharded over ``mesh``'s
    "model" axis (copies of it): the probabilities' largest difference,
    the selections that differ, the launches by wrapper of each."""
    import torch.distributed as dist

    from eventful_transformer_tpu_torch.parallel.sharding import shard_params

    plain = copy.deepcopy(model)
    for block in plain.spatial_model.backbone.blocks:
        if hasattr(block, "fused_gates"):
            block.fused_gates = False
    want_log, got_log = [], []
    with recorded_selections(want_log):
        (want, _), plain_launches, plain_s = counted(run_model, plain, views)
    del plain
    sharded = copy.deepcopy(model)
    shard_params(mesh, sharded)
    heads = {block.local_heads for block in sharded.modules() if hasattr(block, "local_heads")}
    dist.barrier()
    with recorded_selections(got_log):
        (probs, _), launches, seconds = counted(run_model, sharded, views)
    del sharded
    selections, flips = selection_flips(got_log, want_log)
    close = bool(torch.allclose(probs, want, rtol=TP_RTOL, atol=TP_RTOL * float(want.abs().max())))
    return dict(
        same_as_plain=close and flips == 0, max_prob_diff=float((probs - want).abs().max()),
        selections=selections, selections_differing=flips, gate_calls=len(got_log),
        launches={k: v for k, v in launches.items() if v},
        plain_launches={k: v for k, v in plain_launches.items() if v}, seconds=seconds,
        plain_s=plain_s, local_heads=sorted(heads))


def tp_eventful_run(name, mesh, device):
    """One configuration on this rank (the section's comment): the
    inference and the training comparisons, with the launches by wrapper
    of the sharded forward and of the training steps."""
    import torch.distributed as dist

    from eventful_transformer_tpu_torch.core.counting import Ctx
    from eventful_transformer_tpu_torch.parallel.sharding import shard_params
    from eventful_transformer_tpu_torch.parallel.train import (
        cross_entropy_from_probs,
        data_generator,
        make_sharded_train_step,
    )
    from eventful_transformer_tpu_torch.utils.train import make_optimizer

    kwargs = tp_eventful_model_config(name)[0]
    cast = kwargs["spatial_config"]["block_config"].get("matmul_2_cast")
    views = generated_views(kwargs, 1).to(device)
    model = tp_eventful_model(name, device, cast=False)
    inference = tp_eventful_inference(model, mesh, views)
    del model
    if cast is not None:  # reported, not held (the section's comment)
        model = tp_eventful_model(name, device)
        inference["cast_on"] = dict(tp_eventful_inference(model, mesh, views),
                                    matmul_2_cast=cast)
        del model
    torch.cuda.empty_cache()

    def close(a, b):
        return bool(torch.allclose(a, b, rtol=TP_RTOL, atol=TP_RTOL * float(b.abs().max())))

    labels = torch.from_numpy(np.random.default_rng(SEED + 1).integers(0, kwargs["classes"], 1))
    plain = tp_eventful_model(name, device, cast=False, depth=TP_EVENTFUL_TRAIN_DEPTH,
                              temporal_depth=1)
    trained = copy.deepcopy(plain)
    init_fn, make_step = make_sharded_train_step(trained, TRAIN_OPTIMIZER, mesh)
    step = make_step(*init_fn())
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats(device)
    dist.barrier()
    reset_launches()
    for i in range(TP_EVENTFUL_STEPS):
        start = time.perf_counter()
        losses.append(float(step({"inputs": views, "labels": labels}, TRAIN_SEED + i)))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - start))
    train_launches = {k: v for k, v in read_launches().items() if v}
    peak = torch.cuda.max_memory_allocated(device)
    for p in plain.parameters():
        p.requires_grad_(True)
    optimizer = make_optimizer(TRAIN_OPTIMIZER, plain, list(plain.parameters()))
    plain_losses = []
    for i in range(TP_EVENTFUL_STEPS):
        optimizer.zero_grad(set_to_none=True)
        ctx = Ctx(training=True, generator=data_generator(TRAIN_SEED + i, 0, device))
        loss = cross_entropy_from_probs(plain.apply_views(ctx, views), labels.to(device))
        loss.backward()
        optimizer.step()
        plain_losses.append(float(loss.detach()))
    shard_params(mesh, plain)  # this rank's shards of the plain model's parameters
    mine = dict(trained.named_parameters())
    same_params = all(close(mine[key], p.detach()) for key, p in plain.named_parameters())
    param_err = max(float((mine[key] - p).abs().max() / p.abs().max())
                    for key, p in plain.named_parameters() if p.abs().max() > 0)
    training = dict(
        same_as_plain=same_params and bool(np.allclose(losses, plain_losses, rtol=TP_RTOL,
                                                       atol=0)),
        losses=losses, plain_losses=plain_losses, max_param_err=param_err, step_ms=step_ms,
        launches=train_launches, max_memory_allocated=peak, depth=TP_EVENTFUL_TRAIN_DEPTH)
    del trained, plain, optimizer, step
    torch.cuda.empty_cache()
    return dict(views=list(views.shape), inference=inference, training=training)


def tp_eventful_rank(out):
    """The rank of phase tp_eventful_paths under torchrun: every
    configuration on a ("data", "model") mesh of 1 x 2 over gloo on the one
    card; the first rank writes every rank's results to ``out`` as JSON."""
    import torch.distributed as dist

    from eventful_transformer_tpu_torch.ops import _build
    from eventful_transformer_tpu_torch.parallel.mesh import best_dp_tp_mesh, distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    _build.load_library()
    mine = {}
    with distributed("cuda"):
        device = rank_device()
        dist.all_reduce(torch.zeros(1, device=device))
        mesh = best_dp_tp_mesh(max_tp=TP_EVENTFUL_WORLD, device="cuda")
        model_group = mesh.get_group("model")
        mine.update(rank=dist.get_rank(), backend=dist.get_backend(),
                    world_size=dist.get_world_size(), tp=dist.get_world_size(model_group),
                    device=str(device), ready_s=time.perf_counter() - _START, runs={})
        for name in TP_EVENTFUL_RUNS:
            start = time.perf_counter()
            mine["runs"][name] = dict(tp_eventful_run(name, mesh, device),
                                      run_s=time.perf_counter() - start)
        every = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
        dist.gather_object(mine, every, dst=0)
    if mine["rank"] == 0:
        Path(out).write_text(json.dumps(every, default=float))


def run_tp_eventful_rank(tmp):
    """``tp_eventful_rank`` on TP_EVENTFUL_WORLD processes under torchrun in
    its own session, gloo on the card, killed with every process it started
    after TP_EVENTFUL_TIMEOUT seconds. Returns (every rank's results, the
    process's seconds)."""
    import os
    import signal

    from eventful_transformer_tpu_torch.parallel.mesh import BACKEND_ENV

    out = Path(tmp, "tp_eventful_rank.json")
    start = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={TP_EVENTFUL_WORLD}", str(REPO / "chip_smoke.py"),
         "--tp-eventful-rank", str(out)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True, env=dict(os.environ, **{BACKEND_ENV: "gloo"}),
    )
    try:
        _, stderr = proc.communicate(timeout=TP_EVENTFUL_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"tp_eventful_paths: the ranks ran past {TP_EVENTFUL_TIMEOUT} s")
    if proc.returncode != 0 or not out.is_file():
        raise AssertionError(f"tp_eventful_paths: the ranks failed: {stderr[-3000:]}")
    return json.loads(out.read_text()), time.perf_counter() - start


BUCKET_SMOKE = ("--capacities", "24", "--clips", "1", "--iters", "1")


def bucket_script_run():
    """scripts/misc/measure_vivit_buckets.py as a user runs it, at one
    capacity, one clip and one timed call: its JSON line and seconds."""
    start = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "eventful_transformer_tpu_torch.scripts.misc.measure_vivit_buckets",
         *BUCKET_SMOKE], cwd=REPO, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"measure_vivit_buckets failed: {proc.stderr[-3000:]}")
    (row,) = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    if row["capacity"] != 24 or not 0 < row["ms_per_clip"] < float("inf"):
        raise AssertionError(f"measure_vivit_buckets: {row}")
    return dict(row, process_s=time.perf_counter() - start)


def tp_eventful_paths(device, smi):
    """Phases tp_eventful_kernels (the rank's kernels at a rank's width, as
    in 3, float32) and tp_eventful_paths (the section's comment; the bucket
    script's short run). Returns the final line's rows."""
    import tempfile

    rows = check_kernels("tp_eventful_kernels", device, TP_EVENTFUL_CASES,
                         dtypes=(torch.float32,), width=TP_EVENTFUL_WIDTH)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_eventful_") as tmp:
        ranks, process_s = run_tp_eventful_rank(tmp)
    bucket = bucket_script_run()
    failures = []
    if ({(r["backend"], r["world_size"], r["tp"]) for r in ranks}
            != {("gloo", TP_EVENTFUL_WORLD, TP_EVENTFUL_WORLD)}):
        failures.append("mesh")
    for name in TP_EVENTFUL_RUNS:
        for r in ranks:
            run = r["runs"][name]
            want = {key: value for key, value in TP_EVENTFUL_LAUNCHES[name].items()}
            if not (run["inference"]["same_as_plain"] and run["training"]["same_as_plain"]
                    and run["inference"]["launches"] == want and not run["training"]["launches"]
                    and run["inference"]["local_heads"] == [TP_EVENTFUL_WIDTH[1]]
                    and all(np.isfinite(run["training"]["losses"]))):
                failures.append((name, r["rank"]))
    emit("tp_eventful_paths", card=smi, process_s=process_s, width=TP_EVENTFUL_WIDTH,
         ranks=ranks, bucket_script=bucket)
    if failures:
        raise AssertionError(f"tp_eventful_paths: {failures} differ from their unsharded runs "
                             "or launched other kernels")
    return [kernel_row(name, rows[(name, torch.float32, tag)],
                       ranks[0]["runs"][path]["inference"]["launches"], f"tp_eventful_{path}")
            for path, names in TP_EVENTFUL_ROWS.items() for name, tag in names]


DET_LOSS_RTOL = 1e-5
DET_GT, DET_GT_VALID = 8, 5


def detection_losses(device, smi):
    """Phase detection_losses: ViTDet-B VID at 672 (vitdet_b_vid.yml's
    standard heads; the dense backbone of base_672), float32, one generated
    frame on the card: the RPN head's logits and deltas over every anchor,
    propose(training=True) (the training pair's 2000 and 1000), rpn_losses
    against 5 generated gt boxes (padded to 8), sample_proposals on the
    proposals and the gt, the box head on the sampled proposals and
    fast_rcnn_losses on its scores and the boxes it predicts for each
    proposal's class; then the same losses on the CPU from the card's
    head outputs, with the same uniforms: the samples equal, the losses and
    their gradients (logits, deltas, class scores, predicted boxes) within
    DET_LOSS_RTOL relative."""
    from eventful_transformer_tpu_torch.core.counting import Ctx
    from eventful_transformer_tpu_torch.detection import training
    from eventful_transformer_tpu_torch.detection.boxes import apply_deltas
    from eventful_transformer_tpu_torch.models import ViTDet

    model = ViTDet(**vitdet_config(False, E2E_SIZE), device=device, seed=SEED)
    rng = np.random.default_rng(SEED)
    frame = torch.from_numpy(rng.uniform(0, 1, (1, 3, E2E_SIZE, E2E_SIZE)).astype(np.float32))
    start = time.perf_counter()
    rpn, roi = model.proposal_generator, model.roi_heads
    image_size = (E2E_SIZE, E2E_SIZE)
    with torch.no_grad():
        tokens = model.pre_backbone(Ctx(), frame.to(device))
        tokens, _ = model.apply_backbone(Ctx(), model.init_state(1, torch.float32, device), tokens)
        h, w = model.backbone_input_size
        features = model.pyramid(tokens.reshape(1, h, w, model.dim))
        heads = [rpn.head(f) for f in features]
        logits = torch.cat([lg[0] for lg, _ in heads])
        deltas = torch.cat([d[0] for _, d in heads])
        anchors = torch.cat(rpn.anchors([tuple(f.shape[1:3]) for f in features], device))
        proposals, _, proposal_mask = rpn.propose(features, image_size, training=True)
    xy = rng.uniform(0, E2E_SIZE - 200, (DET_GT, 2))
    gt = np.concatenate([xy, xy + rng.uniform(40, 200, (DET_GT, 2))], -1).astype(np.float32)
    gt_mask = np.arange(DET_GT) < DET_GT_VALID
    gt_classes = rng.integers(0, 30, DET_GT).astype(np.int32)
    draws = torch.Generator().manual_seed(SEED)
    n_prop = proposals.shape[0] + DET_GT
    u_rpn = tuple(torch.rand(anchors.shape[0], generator=draws) for _ in range(2))
    u_roi = tuple(torch.rand(n_prop, generator=draws) for _ in range(2))

    def losses(on, head=None):
        """The four losses on ``on``; the head outputs the card's (made on
        the card where ``head`` is None). Returns (losses, samples, leaves)."""
        gt_t, mask_t = torch.from_numpy(gt).to(on), torch.from_numpy(gt_mask).to(on)
        lg = logits.detach().to(on).requires_grad_()
        dl = deltas.detach().to(on).requires_grad_()
        out = training.rpn_losses(u_rpn, anchors.to(on), lg, dl, gt_t, mask_t)
        samples = training.sample_proposals(
            u_roi, proposals.to(on), proposal_mask.to(on), gt_t,
            torch.from_numpy(gt_classes).to(on), mask_t, num_classes=30)
        boxes, classes, sampled, matched = samples
        if head is None:
            with torch.no_grad():
                scores, box_deltas = roi.predict(roi.box_head(roi._pool(features[:4], boxes)))
                per_class = box_deltas.reshape(-1, 30, 4)
                pick = classes.long().clamp(max=29)
                pred = apply_deltas(per_class[torch.arange(len(pick), device=on), pick], boxes,
                                    weights=roi.box_weights)
            head = (scores, pred)
        sc = head[0].detach().to(on).requires_grad_()
        pb = head[1].detach().to(on).requires_grad_()
        out.update(training.fast_rcnn_losses(sc, pb, classes, sampled, matched, 30))
        sum(out.values()).backward()
        leaves = dict(logits=lg, deltas=dl, scores=sc, pred_boxes=pb)
        return ({k: float(v.detach()) for k, v in out.items()}, [t.cpu() for t in samples],
                {k: (v.grad.cpu(), v.detach().cpu()) for k, v in leaves.items()}, head)

    card, card_samples, card_grads, head = losses(device)
    cpu, cpu_samples, cpu_grads, _ = losses(torch.device("cpu"), head)
    loss_err = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-30) for k in cpu}
    grad_err = {k: float((card_grads[k][0] - cpu_grads[k][0]).abs().max()
                         / cpu_grads[k][0].abs().max()) for k in cpu_grads}
    same_samples = all(torch.equal(a, b) for a, b in zip(card_samples, cpu_samples))
    valid = int(proposal_mask.sum())
    emit("detection_losses", card=smi, path_s=time.perf_counter() - start,
         anchors=int(anchors.shape[0]), proposals=int(proposals.shape[0]),
         valid_proposals=valid, sampled_rois=int(card_samples[2].sum()),
         foreground_rois=int((card_samples[2] & (card_samples[1] < 30)).sum()),
         losses_card=card, losses_cpu=cpu, loss_rel_err=loss_err, grad_rel_err=grad_err,
         same_samples=same_samples)
    bad = [k for k, v in {**loss_err, **grad_err}.items() if not v <= DET_LOSS_RTOL]
    if bad or not same_samples or not all(np.isfinite(v) for v in card.values()):
        raise AssertionError(f"detection losses: card against CPU beyond {DET_LOSS_RTOL}: {bad}, "
                             f"samples equal {same_samples}")
    del model, features
    torch.cuda.empty_cache()


# -- the captured steps: eager against CUDA graph ---------------------------------------
#
# The step builders of utils/evaluate.py capture their step on the card
# (utils/graphs.py). Each path runs its eager step (graph=False) and its
# captured step on one model and one input: once each (the graph side
# captures there), then in turns, eager, graph, graph, eager, each call timed
# by CUDA events around it (the host's work included), with the peak of
# allocated memory of each side's calls, and one call of each profiled for
# the card's busy share. Path A: the flagship ViViT-B K400 ("v4", k = 98)
# and its dense twin, bf16, one clip of 4 views x 32 frames. Path B: the
# paper's temporal_24 (EventfulBlock, k = 24, the bf16 A.V cast), float32,
# one raw clip of 12 views; then TokenNormThreshold through the bucketed
# dispatch, threshold GRAPH_THRESHOLD over GRAPH_BUCKETS (every candidate is
# over 0, so each call escalates through every capacity: one graph each).
# Path C: ViTDet-B end to end through make_vitdet_step, the whole frame in
# one graph a mode (the preprocessing, the backbone and the head with row
# 22's NMS), spatiotemporal (k = 256) and base, the VID head, one stream,
# bf16, a flush frame then E2E_FRAMES frames, at 1024 and at 672. Path D:
# the bucketed ViTDet ladder of threshold_1024 (float32), captured. COCO:
# coco_path's model (the cascade and the mask head) captured. Each path but
# D runs on the models an earlier phase built (A: phase slice's; B:
# vivit_evblock's eventful model, cast to float32; C: each size's
# vitdet_slice models; COCO: coco_path's).
GRAPH_ORDER = ("eager", "graph", "graph", "eager")
GRAPH_THRESHOLD, GRAPH_BUCKETS = 0.0, [49, 197]


def tree_bits(a, b):
    """(equal bit for bit, the largest |a - b| where not) of two trees of
    tensors (dicts, lists, tuples) of one structure."""
    from eventful_transformer_tpu_torch.utils.graphs import leaves

    la, lb = list(leaves(a)), list(leaves(b))
    if [p for p, _ in la] != [p for p, _ in lb]:
        return False, None
    equal, diff = True, 0.0
    for (_, x), (_, y) in zip(la, lb):
        if not isinstance(x, torch.Tensor):
            equal = equal and x == y
            continue
        if x.shape != y.shape or x.dtype != y.dtype:
            return False, None
        if not torch.equal(x.contiguous().reshape(-1).view(torch.uint8),
                           y.contiguous().reshape(-1).view(torch.uint8)):
            equal = False
            if x.is_floating_point():
                d = (x.double() - y.double()).abs().nan_to_num(nan=float("inf"))
                d = torch.where(x.isnan() & y.isnan(), 0.0, d)
            else:
                d = (x.long() - y.long()).abs()
            diff = max(diff, float(d.max()))
    return equal, diff


def profiled_busy(fn):
    """One ``fn()`` under torch.profiler, the card's activity only (the
    host's operator events would multiply what the profiler sorts after
    the call): the card's busy share (its kernels' and copies' device ms
    over the call's wall ms), the device ms and the device events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) * 1e3
    on_device = [e for e in prof.key_averages()
                 if str(getattr(e, "device_type", "")).endswith("CUDA")]
    device = sum(getattr(e, "self_device_time_total", None) or
                 getattr(e, "self_cuda_time_total", 0) for e in on_device) / 1e3
    return dict(busy_share=device / wall, device_ms=device, wall_ms=wall,
                device_events=sum(e.count for e in on_device))


def graph_sides(run, graphs, per=1, first_eager=contextlib.nullcontext):
    """``run(side)`` for side "eager" and "graph" -> (outputs, final state
    or None, counts): the first call of each (the graph side captures; the
    eager one inside ``first_eager()``), its launches, then GRAPH_ORDER
    timed (ms per clip or frame: the call's ms over ``per``), the peak of
    allocated memory of each side's calls and one profiled call each.
    ``graphs()``: the graph side's GraphSteps. Returns the numbers and the
    first calls' outputs, states and counts."""
    first, launches = {}, {}
    for side in ("eager", "graph"):
        reset_launches()
        with first_eager() if side == "eager" else contextlib.nullcontext():
            first[side] = run(side)
        torch.cuda.synchronize()
        launches[side] = read_launches()
    times = {"eager": [], "graph": []}
    peak = {"eager": 0, "graph": 0}
    again = []
    for side in GRAPH_ORDER:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(side)
        end.record()
        torch.cuda.synchronize()
        times[side].append(start.elapsed_time(end) / per)
        peak[side] = max(peak[side], torch.cuda.max_memory_allocated())
        if side == "graph":
            again.append(tree_bits(out[:2], first["graph"][:2])[0])
    start = time.perf_counter()
    busy = {side: profiled_busy(lambda side=side: run(side)) for side in ("eager", "graph")}
    profile_s = time.perf_counter() - start
    steps = graphs()
    outputs_equal, outputs_diff = tree_bits(first["eager"][0], first["graph"][0])
    state_equal, state_diff = tree_bits(first["eager"][1], first["graph"][1])
    numbers = dict(
        outputs_equal=outputs_equal, outputs_max_diff=outputs_diff,
        state_equal=state_equal, state_max_diff=state_diff,
        replays_equal=all(again),
        counts_equal=dict(first["eager"][2]) == dict(first["graph"][2]),
        launches_equal=launches["eager"] == launches["graph"],
        launches={k: v for k, v in launches["graph"].items() if v},
        eager_ms=times["eager"], graph_ms=times["graph"],
        eager_busy=busy["eager"], graph_busy=busy["graph"],
        eager_peak_bytes=peak["eager"], graph_peak_bytes=peak["graph"],
        graphs_captured=sum(g.captures for g in steps),
        capture_s=sum(g.capture_seconds for g in steps), profile_s=profile_s,
    )
    return numbers, first


def graph_check(path, numbers, exact=True):
    """Raise unless the graph side's outputs, state, counts and launches
    equal the eager side's (outputs and state bit for bit where ``exact``)."""
    keys = ["counts_equal", "launches_equal", "replays_equal"]
    keys += ["outputs_equal", "state_equal"] if exact else []
    failed = [k for k in keys if not numbers[k]]
    if failed:
        raise AssertionError(f"graph_paths {path}: {failed}: {numbers}")


def graph_vivit_sides(model, views, count_mode=True):
    from eventful_transformer_tpu_torch.utils.evaluate import make_vivit_step

    steps = {"eager": make_vivit_step(model, count_mode, graph=False),
             "graph": make_vivit_step(model, count_mode)}

    def run(side):
        out, counts = steps[side](views)
        return out, None, counts

    return graph_sides(run, lambda: [steps["graph"].graph])


def graph_path_a(eventful, dense, views, smi):
    """Path A on the flagship models of phase slice: one clip of their
    views."""
    clip = views[:1]
    out = {}
    for name, model in (("eventful", eventful), ("dense", dense)):
        numbers, first = graph_vivit_sides(model, clip)
        graph_check(f"A {name}", numbers)
        numbers["gflops_per_clip"] = gflops(first["graph"][2])
        want = GFLOPS_EVENTFUL if name == "eventful" else GFLOPS_DENSE
        if abs(round(numbers["gflops_per_clip"], 2) - want) > 1e-6:
            raise AssertionError(f"graph_paths A {name}: {numbers['gflops_per_clip']} GFLOPs/clip, "
                                 f"expected {want}")
        out[name] = numbers
    emit("graph_paths", path="A", card=smi, config="vivit_b_k400 v4 k=98 and its dense twin",
         dtype="bfloat16", clip=list(clip.shape), **out)


def graph_path_b(model, clip, smi):
    """Path B on vivit_evblock's eventful model (the paper's temporal_24,
    k = 24), in float32, and its raw clip: make_vivit_step, then the
    bucketed threshold through make_bucketed_vivit_step."""
    from eventful_transformer_tpu_torch.core.policies import TokenNormThreshold
    from eventful_transformer_tpu_torch.utils.evaluate import make_bucketed_vivit_step
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    set_ev_run(model, {})
    model = model.to(torch.float32)
    views = torch.stack(model.preprocessing(clip), dim=1).to(torch.float32)
    topk, first = graph_vivit_sides(model, views)
    graph_check("B top-k", topk)
    topk["gflops_per_clip"] = gflops(first["graph"][2])
    if abs(topk["gflops_per_clip"] - EV_GFLOPS_EVENTFUL) > 1e-6 * EV_GFLOPS_EVENTFUL:
        raise AssertionError(f"graph_paths B: {topk['gflops_per_clip']} GFLOPs/clip, the JAX "
                             f"package's count is {EV_GFLOPS_EVENTFUL}")
    set_policies(model, TokenNormThreshold, threshold=GRAPH_THRESHOLD)
    config = {"bucket_capacities": GRAPH_BUCKETS}
    steps = {"eager": make_bucketed_vivit_step(model, config, graph=False),
             "graph": make_bucketed_vivit_step(model, config)}

    def run(side):
        out, counts = steps[side](views)
        return out, None, counts

    bucketed, _ = graph_sides(
        run, lambda: [s.graph for s in steps["graph"].dispatcher._steps.values()])
    for side in ("eager", "graph"):
        d = steps[side].dispatcher
        bucketed[f"{side}_escalations"] = d.escalations
        bucketed[f"{side}_frames_per_level"] = d.frames_per_level
    graph_check("B bucketed", bucketed)
    if bucketed["eager_frames_per_level"] != bucketed["graph_frames_per_level"]:
        raise AssertionError(f"graph_paths B: the dispatch differs: {bucketed}")
    emit("graph_paths", path="B", card=smi, config="temporal_24", dtype="float32",
         clip=list(views.shape), topk=topk, threshold=GRAPH_THRESHOLD, capacities=GRAPH_BUCKETS,
         bucketed=bucketed)


def graph_vitdet_sides(model, frames, first_eager=contextlib.nullcontext):
    """make_vitdet_step eager and captured (the whole frame, one graph a
    mode) over ``frames`` (T, 1, 3, S, S): outputs the detections of every
    frame with the backbone's tokens (``keep_tokens``), the final state (a
    copy) and the counts of the call; beside graph_sides' numbers the write-
    back plan and the NMS host reads of every call of either side (0: the
    kernel of row 22)."""
    from eventful_transformer_tpu_torch.detection import nms
    from eventful_transformer_tpu_torch.utils.evaluate import make_vitdet_step

    steps = {"eager": make_vitdet_step(model, graph=False, keep_tokens=True),
             "graph": make_vitdet_step(model, keep_tokens=True)}
    syncs = nms.host_syncs

    def run(side):
        from eventful_transformer_tpu_torch.core.counting import Counts
        from eventful_transformer_tpu_torch.utils.bucketing import clone_state

        state = model.init_state(1, frames.dtype, frames.device)
        total, dets = Counts(), []
        for t in range(frames.shape[0]):
            det, state, counts = steps[side](state, frames[t], None, t == 0)
            dets.append(det)
            total = total + counts
        return dets, clone_state(state), total

    numbers, first = graph_sides(run, lambda: [steps["graph"].graph], per=frames.shape[0],
                                 first_eager=first_eager)
    numbers["write_back"] = steps["graph"].graph.write_back_summary()
    numbers["nms_host_syncs"] = nms.host_syncs - syncs
    if numbers["nms_host_syncs"]:
        raise AssertionError(f"the captured frame's NMS read the host: {numbers}")
    return numbers, first


def graph_segments(model, frames, smi, size):
    """The time entry point's three segments (scripts/time/vitdet_vid.py::
    segment_steps: pre, mid and post, counting nothing) captured against
    eager over ``frames``: every frame's tokens after pre and after mid,
    its detections, the final state and the launches bit for bit."""
    from eventful_transformer_tpu_torch.core.counting import Counts
    from eventful_transformer_tpu_torch.scripts.time.vitdet_vid import segment_steps
    from eventful_transformer_tpu_torch.utils.bucketing import clone_state

    steps = {"eager": segment_steps(model, graph=False), "graph": segment_steps(model)}
    hw = torch.tensor([size, size], dtype=torch.int32, device=frames.device)

    def run(side):
        pre, mid, post = steps[side]
        state = model.init_state(1, frames.dtype, frames.device)
        out = []
        with torch.no_grad():
            for t in range(frames.shape[0]):
                tokens, _ = pre(frames[t], hw)
                backbone, state, _ = mid(state, tokens, mode="flush" if t == 0 else "incremental")
                dets, _ = post(backbone)
                out.append((tokens, backbone, dets))
        return out, clone_state(state), Counts()

    numbers, _ = graph_sides(run, lambda: list(steps["graph"]), per=frames.shape[0])
    graph_check(f"time segments {size}", numbers)
    emit("graph_paths", path="time segments", size=size, card=smi, frames=frames.shape[0],
         dtype="bfloat16", config=f"spatiotemporal_{size}", **numbers)


def detections_of(dets):
    """The detections of every frame without the backbone's tokens."""
    return [{k: v for k, v in det.items() if k != "tokens"} for det in dets]


def graph_path_c(eventful, dense, smi, size):
    """Path C at ``size`` on the vitdet_slice models (their class scorer
    scaled by CLS_SCORE_GAIN here, as e2e_model scales it): eventful and
    dense ViTDet-B end to end, counts against the JAX package's (the
    pooled valid shares of the eager side's first call)."""
    frames = vitdet_frames(E2E_FRAMES + 1, 1, eventful.embedding.kernel.device, torch.bfloat16,
                           size)
    out = {}
    for name, model in (("eventful", eventful), ("dense", dense)):
        with torch.no_grad():
            model.roi_heads.cls_score.kernel.mul_(CLS_SCORE_GAIN)
        shares = []

        @contextlib.contextmanager
        def recorded():
            with pooled_shares() as got:
                yield
            shares.extend(got)

        numbers, first = graph_vitdet_sides(model, frames, recorded)
        graph_check(f"C {size} {name}", numbers)
        got = sum(v for k, v in first["graph"][2].items() if k != "policy_saturated")
        ref = vitdet_jax_flops(name == "eventful", shares, size, frames=frames.shape[0],
                               streams=1)
        numbers.update(gflops_per_frame=got / frames.shape[0] / 1e9,
                       jax_gflops_per_frame=ref / frames.shape[0] / 1e9,
                       kept_detections_per_frame=check_detections(
                           detections_of(first["graph"][0]), size=size))
        if abs(got - ref) > 1e-6 * ref:
            raise AssertionError(f"graph_paths C {size} {name}: counted {got} FLOPs, the JAX "
                                 f"package's count is {ref}")
        out[name] = numbers
    emit("graph_paths", path="C", size=size, card=smi, streams=1, frames=E2E_FRAMES + 1,
         k=VITDET_K, dtype="bfloat16", config=f"spatiotemporal_{size} and base_{size}", **out)
    if size == E2E_SIZE:  # the time entry point's configuration
        graph_segments(eventful, frames, smi, size)


# Path D: the bucketed ViTDet ladder of harness_vitdet (threshold_1024,
# float32, one generated video of HARNESS_VID_FRAMES frames through
# VIDResize) at a threshold where its incremental frames escalate (graph_path_d
# requires an escalation).
GRAPH_D_THRESHOLD = 1.0


def graph_path_d(device, smi):
    """Path D: threshold_1024 at full width and depth through
    make_vitdet_eval_step captured (one frame step for every capacity: a
    graph per capacity and mode over one static state, the state backed up
    before each run below the top) and eager, eager, graph, graph, eager:
    every frame's kept detections and counts (as vitdet_item_results gives
    them) equal bit for bit, the same escalations and frames per level and
    the same launches in the first call of each side, no NMS host read;
    ms a frame of each call (the first graph call captures), the graphs
    captured and the peak of allocated memory of each side."""
    from eventful_transformer_tpu_torch.core.policies import TokenNormThreshold
    from eventful_transformer_tpu_torch.data.vid import VIDResize
    from eventful_transformer_tpu_torch.detection import nms
    from eventful_transformer_tpu_torch.models import ViTDet
    from eventful_transformer_tpu_torch.utils.evaluate import (
        make_vitdet_eval_step,
        vitdet_item_results,
    )
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    config = harness_config("vitdet_vid", ["threshold_1024", "n_items=1"])
    long_edge = max(config["model"]["input_shape"][-2:])
    data = harness_vid(VIDResize(short_edge_length=640 * long_edge // 1024, max_size=long_edge))
    cfg = {k: v for k, v in config["model"].items() if k != "device"}
    model = ViTDet(**cfg, device=device, seed=SEED)
    with torch.no_grad():
        model.roi_heads.cls_score.kernel.mul_(CLS_SCORE_GAIN)
    set_policies(model, TokenNormThreshold, threshold=GRAPH_D_THRESHOLD,
                 capacity=config.get("threshold_capacity"))
    steps = {side: make_vitdet_eval_step(model, config, graph=side == "graph")
             for side in ("eager", "graph")}
    frames = len(data[0])
    first, tallies, launches, ms, peak = {}, {}, {}, {"eager": [], "graph": []}, {}
    syncs = nms.host_syncs
    for side in ("eager", "graph", "graph", "eager"):
        step = steps[side]
        before = (step.escalations, list(step.frames_per_level))
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        with torch.no_grad():
            results = vitdet_item_results(model, data, [0], step)[0]
        torch.cuda.synchronize()
        ms[side].append((time.perf_counter() - start) * 1e3 / frames)
        peak[side] = max(peak.get(side, 0), torch.cuda.max_memory_allocated())
        tally = (step.escalations - before[0],
                 [a - b for a, b in zip(step.frames_per_level, before[1])])
        if side not in first:
            first[side], tallies[side], launches[side] = results, tally, read_launches()
        elif tally != tallies[side]:
            raise AssertionError(f"graph_paths D {side}: the second call's dispatch {tally}, "
                                 f"the first's {tallies[side]}")
    read_routes(torch.float32, "graph_paths D")
    same = all(
        all(np.array_equal(a[0][k], b[0][k]) for k in ("boxes", "scores", "labels"))
        and dict(a[2]) == dict(b[2])
        for a, b in zip(first["eager"], first["graph"]))
    graphs_made = {id(s.graph): s.graph for s in steps["graph"]._steps.values() if s.graph}
    numbers = dict(
        detections_and_counts_equal=same, dispatch=tallies,
        launches_equal=launches["eager"] == launches["graph"],
        launches={k: v for k, v in launches["graph"].items() if v},
        kept_detections_per_frame=[int(r[0]["scores"].shape[0]) for r in first["graph"]],
        eager_ms_per_frame=ms["eager"], graph_ms_per_frame=ms["graph"],
        eager_peak_bytes=peak["eager"], graph_peak_bytes=peak["graph"],
        frame_steps=len(graphs_made), graphs_captured=sum(g.captures for g in graphs_made.values()),
        capture_s=sum(g.capture_seconds for g in graphs_made.values()),
        nms_host_syncs=nms.host_syncs - syncs)
    if (not same or tallies["eager"] != tallies["graph"] or not numbers["launches_equal"]
            or numbers["nms_host_syncs"] or not tallies["graph"][0]):
        raise AssertionError(f"graph_paths D: {numbers}")
    emit("graph_paths", path="D", card=smi, config="threshold_1024", dtype="float32",
         threshold=GRAPH_D_THRESHOLD, capacities=config["bucket_capacities"], frames=frames,
         **numbers)


def graph_coco(model, frames, smi):
    """The COCO frame (the cascade and the mask head, coco_path's model in
    bfloat16) captured against eager, as path C: detections with their
    masks, the backbone's tokens, final state, counts and launches bit for
    bit."""
    numbers, first = graph_vitdet_sides(model, frames)
    graph_check("COCO", numbers)
    numbers["kept_detections_per_frame"] = check_detections(
        detections_of(first["graph"][0]), classes=COCO_CLASSES, size=COCO_SIZE)
    emit("graph_paths", path="COCO", size=COCO_SIZE, card=smi, frames=frames.shape[0],
         dtype="bfloat16", config="models/vitdet_b_coco.yml", **numbers)


def main():
    smi = phase_env()
    from eventful_transformer_tpu_torch.ops import kernel_check

    device = torch.device("cuda", 0)
    phase_build()
    kernel_rows = phase_kernels(device)
    phase_gemm_core(device, smi)
    phase_f32_bodies(device, smi)
    eventful, dense, views, launches = phase_slice(device)
    phase_time(eventful, dense, views, smi)
    graph_path_a(eventful, dense, views, smi)
    del eventful, dense, views
    torch.cuda.empty_cache()
    kernels = [
        kernel_row(name, kernel_rows[(name, torch.bfloat16, "vivit")], launches, "vivit")
        for name in VIVIT_KERNELS
    ]
    rows, dense_ms = {}, {}
    for size in VITDET:
        path_rows, rows[size], dense_ms[size] = vitdet_path(device, smi, size)
        kernels += path_rows
    kernels += phase_vitdet_e2e(device, smi, rows[E2E_SIZE])
    ev_rows, ev_checks = ev_path(device, smi)
    kernels += ev_rows
    kernels += option_paths(device, smi, dense_ms)
    kernels += pre_ln_vivit_path(device, smi)
    kernels += topk_paths(device, smi)
    kernels += blend_path(device, smi)
    kernels += unwired_path(device, smi)
    kernels += harness_paths(device, smi)
    graph_path_d(device, smi)
    kernels += serving_paths(device, smi, ev_checks)
    kernels += coco_path(device, smi)
    kernels += train_path(device, smi)
    detection_losses(device, smi)
    kernels += parallel_paths(device, smi, kernel_rows)
    kernels += tp_eventful_paths(device, smi)
    phase_attention_bodies()
    phase_row_bodies()
    cores = phase_gemm_cores()
    for row in kernels:
        wrapper = kernel_check.KERNELS[row["name"]][0].__name__
        if wrapper in GEMM_ROWS:
            row["core_launches"] = {dtype: by_wrapper.get(wrapper) for dtype, by_wrapper
                                    in cores.items()}
    emit("total", seconds=round(time.perf_counter() - _START, 3),
         earlier_total_seconds=EARLIER_TOTAL_S,
         float32_phases_s={phase: PHASE_SECONDS[phase] for phase in F32_PHASES
                           if phase in PHASE_SECONDS})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


def parallel_rank_main(argv):
    """``chip_smoke.py --parallel-rank OUT [--frames F] [--items I]``."""
    import argparse

    parser = argparse.ArgumentParser(prog="chip_smoke.py --parallel-rank")
    parser.add_argument("out", help="the JSON file the first rank writes")
    parser.add_argument("--frames", type=int, default=PARALLEL_FRAMES,
                        help="frames of each generated video")
    parser.add_argument("--items", type=int, default=1, help="videos and clips of the DP paths")
    args = parser.parse_args(argv)
    parallel_rank(args.out, args.frames, args.items)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        parallel_rank_main(sys.argv[2:])
    elif sys.argv[1:2] == ["--tp-eventful-rank"]:
        tp_eventful_rank(sys.argv[2])
    else:
        main()
