"""The port imports and runs with JAX unavailable, as on the card's machine."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = """
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import numpy as np
import torch
torch.set_num_threads(2)
import eventful_transformer_tpu_torch
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
from eventful_transformer_tpu_torch.models import FactorizedViViT
from eventful_transformer_tpu_torch.utils.misc import set_policies
model = FactorizedViViT(
    classes=5, input_shape=[4, 3, 16, 16], normalize_mean=0.45, normalize_std=0.225,
    spatial_views=1, temporal_stride=2, temporal_views=1, tubelet_shape=[2, 8, 8],
    spatial_config=dict(depth=2, position_encoding_size=[2, 2],
                        block_class="EventfulTokenwiseBlock",
                        block_config=dict(dim=32, heads=4, mlp_ratio=2)),
    temporal_config=dict(depth=1, position_encoding_size=[2],
                         block_config=dict(dim=32, heads=4, mlp_ratio=2)),
    device="cpu",
)
set_policies(model, TokenNormTopK, k=3)
views = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 1, 4, 3, 16, 16)))
with torch.no_grad():
    out = model.apply_views(Ctx(), views.float())
assert out.shape == (1, 5) and abs(float(out.sum()) - 1.0) < 1e-5
from eventful_transformer_tpu_torch.utils.graphs import GraphStep
with torch.no_grad():
    static_out, _ = GraphStep(model, model.apply_views, capture=False)(views.float())
assert torch.equal(static_out, out)
assert not any(name == "jax" or name.startswith(("jax.", "eventful_transformer_tpu."))
               for name, mod in sys.modules.items() if mod is not None)
print("ok")
"""


VITDET_SCRIPT = """
import sys
sys.modules["jax"] = None
import numpy as np
import torch
torch.set_num_threads(2)
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
from eventful_transformer_tpu_torch.models import ViTDet
from eventful_transformer_tpu_torch.utils.misc import set_policies
block = dict(dim=32, heads=4, mlp_ratio=2, window_size=[3, 3], relative_embedding_size=[8, 8],
             pool_size=2, matmul_2_cast="bfloat16")
model = ViTDet(
    backbone_config=dict(depth=2, position_encoding_size=[4, 4], window_indices=[0],
                         block_class="EventfulBlock", windowed_class="EventfulTokenwiseBlock",
                         windowed_overrides=dict(pool_size=None, matmul_2_cast=None),
                         block_config=block),
    classes=5, input_shape=[3, 96, 96], normalize_mean=[0.0] * 3, normalize_std=[1.0] * 3,
    output_channels=16, patch_size=[16, 16], scale_factors=[1.0], device="cpu",
)
set_policies(model, TokenNormTopK, k=8)
for blk in model.backbone.blocks:
    blk.fused_gates = "v2"
state = model.init_state(1)
frames = torch.from_numpy(np.random.default_rng(0).uniform(size=(3, 1, 3, 96, 96)).astype(np.float32))
ctx = Ctx(count_mode=True)
for t in range(3):
    tokens = model.pre_backbone(ctx, frames[t])
    out, state = model.apply_backbone(ctx, state, tokens, mode="flush" if t == 0 else "incremental")
assert out.shape == (1, 36, 32) and bool(torch.isfinite(out).all())
assert ctx.counts["accumulator_flops"] > 0
assert not any(name == "jax" or name.startswith(("jax.", "eventful_transformer_tpu."))
               for name, mod in sys.modules.items() if mod is not None)
print("ok")
"""


E2E_SCRIPT = """
import sys
sys.modules["jax"] = None
import numpy as np
import torch
torch.set_num_threads(2)
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
from eventful_transformer_tpu_torch.models import ViTDet
from eventful_transformer_tpu_torch.utils.misc import set_policies
block = dict(dim=48, heads=6, mlp_ratio=2, window_size=[2, 2], relative_embedding_size=[4, 4],
             pool_size=2)
model = ViTDet(
    backbone_config=dict(depth=2, position_encoding_size=[4, 4], window_indices=[0],
                         block_class="EventfulBlock", windowed_class="EventfulTokenwiseBlock",
                         windowed_overrides=dict(pool_size=None), block_config=block),
    classes=5, input_shape=[3, 64, 64], normalize_mean=[123.675, 116.28, 103.53],
    normalize_std=[58.395, 57.12, 57.375], output_channels=32, patch_size=[16, 16],
    scale_factors=[4.0, 2.0, 1.0, 0.5], rpn_config=dict(pre_nms_topk=200, post_nms_topk=50),
    roi_config=dict(test_topk_per_image=20), device="cpu",
)
set_policies(model, TokenNormTopK, k=10)
for blk in model.backbone.blocks:
    blk.fused_gates = "v2"
state = model.init_state(1)
frames = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (3, 1, 3, 56, 60), dtype=np.uint8))
for t in range(3):
    det, state = model.apply(Ctx(), state, frames[t], mode="flush" if t == 0 else "incremental")
    assert det["boxes"].shape == (20, 4) and bool(torch.isfinite(det["boxes"]).all())
    assert det["labels"].dtype == torch.int32 and det["mask"].dtype == torch.bool
assert not any(name == "jax" or name.startswith(("jax.", "eventful_transformer_tpu."))
               for name, mod in sys.modules.items() if mod is not None)
print("ok")
"""


APPLY_SCRIPT = """
import sys
sys.modules["jax"] = None
import numpy as np
import torch
torch.set_num_threads(2)
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
from eventful_transformer_tpu_torch.models import FactorizedViViT
from eventful_transformer_tpu_torch.utils.misc import set_policies
model = FactorizedViViT(
    classes=5, input_shape=[4, 3, 16, 16], normalize_mean=0.45, normalize_std=0.225,
    spatial_views=3, temporal_stride=2, temporal_views=2, tubelet_shape=[2, 8, 8],
    spatial_config=dict(depth=2, position_encoding_size=[2, 2], block_class="EventfulBlock",
                        block_config=dict(dim=32, heads=4, mlp_ratio=2,
                                          matmul_2_cast="bfloat16")),
    temporal_config=dict(depth=1, position_encoding_size=[2],
                         block_config=dict(dim=32, heads=4, mlp_ratio=2)),
    device="cpu",
)
set_policies(model, TokenNormTopK, k=3)
video = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 12, 3, 20, 26), dtype=np.uint8))
ctx = Ctx(count_mode=True)
out = model.apply(ctx, video)
assert out.shape == (1, 5) and abs(float(out.sum()) - 1.0) < 1e-5
assert ctx.counts["accumulator_flops"] > 0
assert not any(name == "jax" or name.startswith(("jax.", "eventful_transformer_tpu."))
               for name, mod in sys.modules.items() if mod is not None)
print("ok")
"""


OPTIONS_SCRIPT = """
import sys
sys.modules["jax"] = None
import numpy as np
import torch
torch.set_num_threads(2)
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
from eventful_transformer_tpu_torch.models import ViTDet
from eventful_transformer_tpu_torch.utils.misc import set_policies
frames = torch.from_numpy(np.random.default_rng(0).uniform(size=(3, 1, 3, 96, 96)).astype(np.float32))
for options, regime in ((dict(gate_before_ln=True), "v2"), (dict(gate_before_ln=True), "blocked"),
                        (dict(stgt=True), "auto")):
    block = dict(dim=32, heads=4, mlp_ratio=2, window_size=[3, 3], relative_embedding_size=[8, 8],
                 **options)
    model = ViTDet(
        backbone_config=dict(depth=2, position_encoding_size=[4, 4], window_indices=[0],
                             block_class="EventfulTokenwiseBlock", block_config=block),
        classes=5, input_shape=[3, 96, 96], normalize_mean=[0.0] * 3, normalize_std=[1.0] * 3,
        output_channels=16, patch_size=[16, 16], scale_factors=[1.0], device="cpu",
    )
    set_policies(model, TokenNormTopK, k=8)
    for blk in model.backbone.blocks:
        blk.fused_gates = regime
    state = model.init_state(1)
    for t in range(3):
        tokens = model.pre_backbone(Ctx(), frames[t])
        out, state = model.apply_backbone(Ctx(), state, tokens, mode="flush" if t == 0 else "incremental")
    assert out.shape == (1, 36, 32) and bool(torch.isfinite(out).all())
assert not any(name == "jax" or name.startswith(("jax.", "eventful_transformer_tpu."))
               for name, mod in sys.modules.items() if mod is not None)
print("ok")
"""


SWITCHES_SCRIPT = """
import sys
sys.modules["jax"] = None
import numpy as np
import torch
torch.set_num_threads(2)
from eventful_transformer_tpu_torch.core import indexing
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
from eventful_transformer_tpu_torch.models import ViTDet
from eventful_transformer_tpu_torch.ops import gate_group, scatter_blend
from eventful_transformer_tpu_torch.utils.misc import set_policies
picked = []
gate_group.record_selection = picked.append
frames = torch.from_numpy(np.random.default_rng(0).uniform(size=(3, 1, 3, 96, 96)).astype(np.float32))
for options, share in ((dict(), False), (dict(), "auto"), (dict(stgt=True), "auto")):
    block = dict(dim=128, heads=4, mlp_ratio=2, window_size=[3, 3], relative_embedding_size=[8, 8],
                 **options)
    model = ViTDet(
        backbone_config=dict(depth=2, position_encoding_size=[4, 4], window_indices=[0],
                             block_class="EventfulTokenwiseBlock", block_config=block),
        classes=5, input_shape=[3, 96, 96], normalize_mean=[0.0] * 3, normalize_std=[1.0] * 3,
        output_channels=16, patch_size=[16, 16], scale_factors=[1.0], device="cpu",
    )
    set_policies(model, TokenNormTopK, k=8)
    for blk in model.backbone.blocks:
        blk.fused_gates, blk.in_kernel_topk, blk.share_gate_passes = "v2", True, share
    indexing.USE_PALLAS_BLEND = "stgt" in options
    state = model.init_state(1)
    for t in range(3):
        tokens = model.pre_backbone(Ctx(), frames[t])
        out, state = model.apply_backbone(Ctx(), state, tokens, mode="flush" if t == 0 else "incremental")
    assert out.shape == (1, 36, 128) and bool(torch.isfinite(out).all())
# own selections a step: without sharing 5 (the global qkv group, 2 projection
# and 2 MLP groups; the windowed qkv group selects outside), with it 2 (the
# projection groups); STGT none
assert len(picked) == 2 * 5 + 2 * 2, len(picked)
assert not any(name == "jax" or name.startswith(("jax.", "eventful_transformer_tpu."))
               for name, mod in sys.modules.items() if mod is not None)
print("ok")
"""

UNWIRED_SCRIPT = """
import sys
sys.modules["jax"] = None
import torch
torch.set_num_threads(2)
from eventful_transformer_tpu_torch.ops.attention import fused_attention
from eventful_transformer_tpu_torch.ops.scatter import gather_rows, scatter_rows_inplace
from eventful_transformer_tpu_torch.ops.window_attention import window_attention_grid
g = torch.Generator().manual_seed(0)
buf = torch.randn((2, 16, 128), generator=g)
index = torch.tensor([[3, 7, 1], [0, 15, 9]], dtype=torch.int32)
rows = gather_rows(buf, index)
out = scatter_rows_inplace(buf, -rows, index, torch.tensor([[True, False, True]] * 2))
assert out is buf and torch.equal(buf[0, 3], -rows[0, 0]) and torch.equal(buf[0, 7], rows[0, 1])
qkv = torch.randn((2, 17, 96), generator=g)
for cast in (None, torch.bfloat16):
    assert fused_attention(qkv, heads=4, scale=8 ** 0.5, cast=cast).shape == (2, 17, 32)
x = torch.randn((2, 4, 6, 96), generator=g)
tables = (torch.randn((2, 2, 8), generator=g), torch.randn((3, 3, 8), generator=g))
for rel in ((), tables):
    y = window_attention_grid(x, *rel, heads=4, scale=8 ** 0.5, window=(2, 3), a=(2, 3))
    assert y.shape == (2, 4, 6, 32) and bool(torch.isfinite(y).all())
assert not any(name == "jax" or name.startswith(("jax.", "eventful_transformer_tpu."))
               for name, mod in sys.modules.items() if mod is not None)
print("ok")
"""


HARNESS_SCRIPT = """
import contextlib, io, sys, tempfile
sys.modules["jax"] = None
import numpy as np
import torch
torch.set_num_threads(2)
import eventful_transformer_tpu_torch.data.epic_kitchens
import eventful_transformer_tpu_torch.data.kinetics400
import eventful_transformer_tpu_torch.data.vid
import eventful_transformer_tpu_torch.scripts.evaluate.vitdet_vid
import eventful_transformer_tpu_torch.scripts.evaluate.vivit_epic_kitchens
import eventful_transformer_tpu_torch.utils.image
from eventful_transformer_tpu_torch.core.policies import TokenNormThreshold
from eventful_transformer_tpu_torch.models import ViTDet
from eventful_transformer_tpu_torch.scripts.evaluate import vivit_kinetics400
from eventful_transformer_tpu_torch.utils.evaluate import evaluate_vitdet_metrics
from eventful_transformer_tpu_torch.utils.misc import set_policies
out = tempfile.mkdtemp()
with contextlib.redirect_stdout(io.StringIO()):
    done = vivit_kinetics400.main(["synthetic_smoke", "model.device=cpu", "n_items=1",
                                   "synthetic.n_items=1", "token_thresholds=[0.5]",
                                   "bucket_capacities=[4,17]", f"_output={out}"])
assert done[-1] == "Token threshold 0.5", done
assert open(f"{out}/metrics.csv").read().count("\\n") == 4
model = ViTDet(
    backbone_config=dict(depth=2, position_encoding_size=[4, 4], window_indices=[0],
                         block_class="EventfulBlock", windowed_class="EventfulTokenwiseBlock",
                         block_config=dict(dim=32, heads=4, mlp_ratio=2, window_size=[2, 2])),
    classes=5, input_shape=[3, 64, 64], normalize_mean=[123.675, 116.28, 103.53],
    normalize_std=[58.395, 57.12, 57.375], output_channels=16, patch_size=[16, 16],
    scale_factors=[4.0, 2.0, 1.0, 0.5], rpn_config=dict(pre_nms_topk=200, post_nms_topk=50),
    roi_config=dict(test_topk_per_image=20), device="cpu",
)
set_policies(model, TokenNormThreshold, threshold=0.05)
rng = np.random.default_rng(0)
ann = {"boxes": np.asarray([[4.0, 4.0, 40.0, 40.0]], np.float32), "labels": np.asarray([1])}
video = [(rng.uniform(size=(3, 56, 60)).astype(np.float32), ann) for _ in range(3)]
dispatchers = []
result = evaluate_vitdet_metrics(model, [video], {"bucket_capacities": [4, 16]}, dispatchers)
assert np.isfinite(result["metrics"]["map"]) and result["counts"]["linear_flops"] > 0
assert sum(dispatchers[0].frames_per_level) == 3
assert not any(name == "jax" or name.startswith(("jax.", "eventful_transformer_tpu."))
               for name, mod in sys.modules.items() if mod is not None)
print("ok")
"""


SERVING_SCRIPT = """
import contextlib, io, sys, tempfile
from pathlib import Path
sys.modules["jax"] = None
import numpy as np
import torch
torch.set_num_threads(2)
import eventful_transformer_tpu_torch.scripts.spatial.vivit_epic_kitchens
import eventful_transformer_tpu_torch.scripts.spatial.vivit_kinetics400
import eventful_transformer_tpu_torch.scripts.time.vitdet_vid
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.policies import TokenNormTopFraction
from eventful_transformer_tpu_torch.data.synthetic import SyntheticVID, SyntheticVideoClassification
from eventful_transformer_tpu_torch.data.vivit_spatial import ViViTSpatial
from eventful_transformer_tpu_torch.models import FactorizedViViT
from eventful_transformer_tpu_torch.scripts.time import vivit_epic_kitchens
from eventful_transformer_tpu_torch.utils import profiling, timing
from eventful_transformer_tpu_torch.utils.misc import set_policies
from eventful_transformer_tpu_torch.utils.spatial import compute_vivit_spatial
block = dict(dim=32, heads=4, mlp_ratio=2)
def config(block_class, **kw):
    return dict(
        classes=5, input_shape=[8, 3, 32, 32], normalize_mean=0.45, normalize_std=0.225,
        spatial_views=1, temporal_stride=1, temporal_views=2, tubelet_shape=[2, 8, 8],
        spatial_config=dict(depth=2, position_encoding_size=[4, 4], block_class=block_class,
                            block_config=dict(block, **kw)),
        temporal_config=dict(depth=1, position_encoding_size=[4], block_config=block),
        device="cpu",
    )
video = torch.from_numpy(SyntheticVideoClassification(1, 10, (36, 40), 5)[0][0])[None]
# ATS: the dense Block (vanilla) and EventfulBlock with the bf16 cast
for block_class, kw in (("Block", {}), ("EventfulBlock", dict(matmul_2_cast="bfloat16"))):
    model = FactorizedViViT(**config(block_class, ats_fraction=0.9, **kw))
    set_policies(model, TokenNormTopFraction, fraction=0.5)
    out = model.apply(Ctx(), video)
    assert out.shape == (1, 5) and abs(float(out.sum()) - 1.0) < 1e-5
# the spatial cache, read back, through a temporal-only model
tmp = Path(tempfile.mkdtemp())
cfg = dict(model=config("EventfulBlock", matmul_2_cast="bfloat16"), k=8)
cfg["model"]["spatial_only"] = True
with contextlib.redirect_stdout(io.StringIO()):
    compute_vivit_spatial(cfg, tmp / "cache", SyntheticVideoClassification(2, 10, (36, 40), 5))
spatial, label = ViViTSpatial(tmp / "cache")[1]
temporal = FactorizedViViT(**config("EventfulBlock"), temporal_only=True)
out = temporal.apply(Ctx(), torch.from_numpy(spatial)[None])
assert spatial.shape == (2, 4, 32) and out.shape == (1, 5)
# the timing helpers, a trace, the ViViT time entry point
assert timing.time_jitted(lambda x: x + 1, (torch.zeros(4),), iters=2) > 0
with profiling.trace(tmp / "trace") as prof:
    with profiling.annotate("region"):
        temporal.apply(Ctx(), torch.from_numpy(spatial)[None])
assert prof.trace_path.stat().st_size > 0
small = ["model.input_shape=[8,3,32,32]", "model.tubelet_shape=[2,8,8]", "model.spatial_views=1",
         "model.temporal_views=2", "model.classes=10", "model.spatial_config.depth=1",
         "model.spatial_config.position_encoding_size=[4,4]",
         "model.spatial_config.block_config.dim=32", "model.spatial_config.block_config.heads=4",
         "model.temporal_config.depth=1", "model.temporal_config.position_encoding_size=[4]",
         "model.temporal_config.block_config.dim=32", "model.temporal_config.block_config.heads=4",
         "token_top_k=[8]", "n_items=1", "model.device=cpu", f"_output={tmp}/time",
         "synthetic={n_items: 1, n_frames: 10, size: [36, 40], classes: 10, seed: 0}"]
with contextlib.redirect_stdout(io.StringIO()):
    assert vivit_epic_kitchens.main(["temporal", *small]) == ["Token top k=8"]
assert len(SyntheticVID(1, 2, (48, 64))[0]) == 2
assert not any(name == "jax" or name.startswith(("jax.", "eventful_transformer_tpu."))
               for name, mod in sys.modules.items() if mod is not None)
print("ok")
"""


COCO_SCRIPT = """
import sys
sys.modules["jax"] = None
import numpy as np
import torch
torch.set_num_threads(2)
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.detection.roi_heads import CascadeROIHeads
from eventful_transformer_tpu_torch.models import ViTDet
block = dict(dim=48, heads=6, mlp_ratio=2, window_size=[2, 2], relative_embedding_size=[4, 4])
model = ViTDet(
    backbone_config=dict(depth=2, position_encoding_size=[4, 4], window_indices=[0],
                         block_config=block),
    classes=5, input_shape=[3, 64, 64], normalize_mean=[123.675, 116.28, 103.53],
    normalize_std=[58.395, 57.12, 57.375], output_channels=32, patch_size=[16, 16],
    scale_factors=[4.0, 2.0, 1.0, 0.5], rpn_config=dict(pre_nms_topk=200, post_nms_topk=50),
    roi_config=dict(test_topk_per_image=20, cascade=True, with_mask=True), device="cpu",
)
assert isinstance(model.roi_heads, CascadeROIHeads)
frame = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (1, 3, 56, 60), dtype=np.uint8))
det, _ = model.apply(Ctx(), model.init_state(1), frame)
assert det["masks"].shape == (20, 28, 28) and bool(((det["masks"] >= 0) & (det["masks"] <= 1)).all())
assert det["boxes"].shape == (20, 4) and bool(torch.isfinite(det["boxes"]).all())
assert not any(name == "jax" or name.startswith(("jax.", "eventful_transformer_tpu."))
               for name, mod in sys.modules.items() if mod is not None)
print("ok")
"""


TRAIN_SCRIPT = """
import contextlib, io, sys, tempfile
from pathlib import Path
sys.modules["jax"] = None
import numpy as np
import torch
torch.set_num_threads(2)
import eventful_transformer_tpu_torch.scripts.train.vivit_epic_kitchens
from eventful_transformer_tpu_torch.scripts.train import vivit_kinetics400
from eventful_transformer_tpu_torch.utils import checkpoint
from eventful_transformer_tpu_torch.utils.params import load_params, params_to_numpy
tmp = Path(tempfile.mkdtemp())
rng = np.random.default_rng(0)
for split, n in (("train_40", 4), ("val", 2)):
    cache = tmp / "k400" / split / "spatial_224_25_24"
    cache.mkdir(parents=True)
    for i in range(n):
        np.savez(cache / f"{i:05d}.npz", label=np.asarray(i % 10),
                 spatial=rng.standard_normal((2, 4, 32)).astype(np.float32))
small = ["model.input_shape=[8,3,32,32]", "model.tubelet_shape=[2,8,8]", "model.spatial_views=1",
         "model.temporal_views=2", "model.classes=10", "model.spatial_config.depth=1",
         "model.spatial_config.position_encoding_size=[4,4]",
         "model.spatial_config.block_config.dim=32", "model.spatial_config.block_config.heads=4",
         "model.temporal_config.depth=1", "model.temporal_config.position_encoding_size=[4]",
         "model.temporal_config.block_config.dim=32", "model.temporal_config.block_config.heads=4",
         "model.temporal_config.block_config.drop_path_rate=0.1", "model.device=cpu",
         f"data={tmp}/k400", "epochs=1", "train_batch_size=2", "val_batch_size=2",
         "starting_weights=null", f"output_weights={tmp}/out.npz", f"checkpoint_dir={tmp}/ckpt"]
with contextlib.redirect_stdout(io.StringIO()) as out:
    model, history = vivit_kinetics400.main(["final_24", *small])
assert [h["pass"] for h in history] == ["val", "train", "val"], history
assert "Saved weights to" in out.getvalue() and checkpoint.latest_epoch(tmp / "ckpt") == 1
saved = params_to_numpy(model)
with torch.no_grad():
    for p in model.parameters():
        p.zero_()
load_params(tmp / "out.npz", model)
for key, value in params_to_numpy(model).items():
    assert np.array_equal(value, saved[key]), key
assert not any(name == "jax" or name.startswith(("jax.", "eventful_transformer_tpu."))
               for name, mod in sys.modules.items() if mod is not None)
print("ok")
"""

PARALLEL_SCRIPT = """
import contextlib, io, sys, tempfile
from pathlib import Path
sys.modules["jax"] = None
import numpy as np
import torch
torch.set_num_threads(2)
import torch.distributed as dist
from eventful_transformer_tpu_torch.data.synthetic import SyntheticVID, SyntheticVideoClassification
from eventful_transformer_tpu_torch.models import FactorizedViViT, ViTDet
from eventful_transformer_tpu_torch.parallel.evaluate import (
    evaluate_vitdet_metrics_dp, evaluate_vitdet_metrics_sp, evaluate_vivit_metrics_dp)
from eventful_transformer_tpu_torch.parallel.mesh import distributed, make_mesh
from eventful_transformer_tpu_torch.scripts.convert import vitdet as convert_vitdet
from eventful_transformer_tpu_torch.scripts.convert import vivit as convert_vivit
from eventful_transformer_tpu_torch.utils.evaluate import evaluate_vitdet_metrics
from eventful_transformer_tpu_torch.utils.params import convert_torch_state_dict, load_params
block = dict(dim=48, heads=6, mlp_ratio=2)
config = dict(backbone_config=dict(depth=2, position_encoding_size=[4, 4], block_config=block),
              classes=5, input_shape=[3, 64, 64], normalize_mean=[0.0] * 3, normalize_std=[1.0] * 3,
              output_channels=16, patch_size=[16, 16], scale_factors=[1.0], device="cpu",
              rpn_config=dict(pre_nms_topk=100, post_nms_topk=20), roi_config=dict(test_topk_per_image=10))
sp = dict(config, backbone_config=dict(config["backbone_config"],
                                       block_config=dict(block, sequence_parallel="seq")))
data = SyntheticVID(n_items=1, n_frames=2, size=(64, 64))
with distributed("cpu"):
    want = evaluate_vitdet_metrics(ViTDet(**config), data, {})
    got = evaluate_vitdet_metrics_sp(ViTDet(**sp), data, {}, make_mesh((-1,), ("seq",), "cpu"))
    assert got == want, (got, want)
    assert evaluate_vitdet_metrics_dp(ViTDet(**config), data, {},
                                      make_mesh((-1,), ("data",), "cpu")) == want
    vivit = FactorizedViViT(
        classes=5, input_shape=[4, 3, 16, 16], normalize_mean=0.45, normalize_std=0.225,
        spatial_views=1, temporal_stride=2, temporal_views=1, tubelet_shape=[2, 8, 8],
        spatial_config=dict(depth=1, position_encoding_size=[2, 2], block_config=block),
        temporal_config=dict(depth=1, position_encoding_size=[2], block_config=block), device="cpu")
    clips = SyntheticVideoClassification(n_items=2, n_frames=4, size=(16, 16), classes=5)
    result = evaluate_vivit_metrics_dp(vivit, clips, {}, make_mesh((-1,), ("data",), "cpu"))
    assert set(result) == {"metrics", "counts"}
assert not dist.is_initialized()
tmp = Path(tempfile.mkdtemp())
state = {"head.linear.weight": torch.ones(5, 48), "backbone.cls_token": torch.zeros(1, 1, 48)}
torch.save({"model_state": state}, tmp / "vivit.pyth")
with contextlib.redirect_stdout(io.StringIO()):
    convert_vivit.main(convert_vivit.parse_args([str(tmp / "vivit.pyth"), str(tmp / "out.npz")]))
with np.load(tmp / "out.npz") as out:
    assert out["classifier/kernel"].shape == (48, 5) and "spatial_model/class_token" in out.files
assert convert_torch_state_dict({"a.conv.weight": np.zeros((4, 3, 2, 2))})["a/kernel"].shape == (12, 4)
assert convert_vitdet.parse_args(["a.pkl", "b.npz"]).pattern_file == "configs/convert/vitdet_b.txt"
assert not any(name == "jax" or name.startswith(("jax.", "eventful_transformer_tpu."))
               for name, mod in sys.modules.items() if mod is not None)
print("ok")
"""


TRAINING_PARALLEL_SCRIPT = """
import sys
sys.modules["jax"] = None
import torch
torch.set_num_threads(2)
import torch.distributed as dist
from eventful_transformer_tpu_torch.detection import training
from eventful_transformer_tpu_torch.parallel import dryrun
g = torch.Generator().manual_seed(0)
corner = torch.rand(64, 2, generator=g) * 40
boxes = torch.cat([corner, corner + 8], 1)
losses = training.rpn_losses(torch.Generator().manual_seed(1), boxes, torch.randn(64, generator=g),
                             torch.randn(64, 4, generator=g), boxes[:2] + 1, torch.ones(2, dtype=bool))
assert all(torch.isfinite(v) for v in losses.values())
result = dryrun.dryrun_here("cpu")
assert result["world_size"] == 1 and result["pipeline"] == (3, 2, 16, 32), result
assert not dist.is_initialized()
assert not any(name == "jax" or name.startswith(("jax.", "eventful_transformer_tpu."))
               for name, mod in sys.modules.items() if mod is not None)
print("ok")
"""


SLICE_26_SCRIPT = """
import contextlib, io, sys
sys.modules["jax"] = None
import torch
torch.set_num_threads(2)
from eventful_transformer_tpu_torch.core.policies import vector_norm
from eventful_transformer_tpu_torch.parallel.mesh import backend_for
from eventful_transformer_tpu_torch.scripts.misc import measure_vitdet_padding
from eventful_transformer_tpu_torch.scripts.misc import measure_vivit_buckets
tiny = ["model.input_shape=[4, 3, 16, 16]", "model.tubelet_shape=[2, 8, 8]", "model.classes=5",
        "model.spatial_config.depth=1", "model.spatial_config.position_encoding_size=[2, 2]",
        "model.spatial_config.block_config={dim: 48, heads: 6, mlp_ratio: 2}",
        "model.temporal_config.depth=1", "model.temporal_config.position_encoding_size=[2]",
        "model.temporal_config.block_config={dim: 48, heads: 6, mlp_ratio: 2}"]
with contextlib.redirect_stdout(io.StringIO()):
    rows = measure_vivit_buckets.main(["--device", "cpu", "--capacities", "2", "--clips", "1",
                                       "--iters", "1", *tiny])
assert rows[0]["capacity"] == 2 and rows[0]["ms_per_clip"] > 0
assert callable(measure_vitdet_padding.padding_shares) and backend_for("cpu") == "gloo"
e = torch.randn(3, 5, 8)
assert torch.equal(vector_norm(e, -1, 2), e.square().sum(-1).sqrt())
assert not any(name == "jax" or name.startswith(("jax.", "eventful_transformer_tpu."))
               for name, mod in sys.modules.items() if mod is not None)
print("ok")
"""


SLICE_29_SCRIPT = """
import sys
sys.modules["jax"] = None
import torch
torch.set_num_threads(2)
from eventful_transformer_tpu_torch.detection import nms, roi_align
from eventful_transformer_tpu_torch.models import ViTDet
from eventful_transformer_tpu_torch.ops import kernel_check
from eventful_transformer_tpu_torch.ops import nms as nms_kernel
from eventful_transformer_tpu_torch.utils import graphs
from eventful_transformer_tpu_torch.utils.bucketing import BucketedThresholdStep
from eventful_transformer_tpu_torch.utils.evaluate import make_vitdet_step
sys.path.insert(0, "tests")
from torch_nms_contract import walk
boxes, scores = kernel_check.nms_inputs(300, 50, 0.7, case="chains")
walked = walk(boxes, scores, 0.7, 50)
got = nms.nms_padded(boxes, scores, 0.7, 50)
assert torch.equal(walked[0], got[0]) and torch.equal(walked[1], got[1])
assert nms_kernel.nms_padded.launches == 0
assert "nms_padded" in kernel_check.KERNELS and roi_align.level_tables
block = dict(dim=32, heads=4, mlp_ratio=2, window_size=[2, 2], relative_embedding_size=[4, 4])
model = ViTDet(
    backbone_config=dict(depth=2, position_encoding_size=[4, 4], window_indices=[0],
                         block_config=block),
    classes=5, input_shape=[3, 64, 64], normalize_mean=[0.0] * 3, normalize_std=[1.0] * 3,
    output_channels=16, patch_size=[16, 16], scale_factors=[4.0, 2.0, 1.0, 0.5],
    rpn_config=dict(pre_nms_topk=50, post_nms_topk=20), roi_config=dict(test_topk_per_image=10),
    device="cpu",
)
frame = torch.rand((1, 3, 64, 64), generator=torch.Generator().manual_seed(0))
hw = torch.tensor([56, 60], dtype=torch.int32)
static = graphs.GraphStep(model, model.frame_run(model.precompute()), stateful=True,
                          capture=False)
with torch.no_grad():
    a, _, _ = static(model.init_state(1), frame, hw, mode="flush")
b, _, _ = make_vitdet_step(model)(model.init_state(1), frame, (56, 60), True)
assert all(torch.equal(a[k], b[k]) for k in a) and set(a) == {"boxes", "scores", "labels", "mask"}
assert BucketedThresholdStep
assert not any(name == "jax" or name.startswith(("jax.", "eventful_transformer_tpu."))
               for name, mod in sys.modules.items() if mod is not None)
print("ok")
"""


def _run(script):
    result = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True,
        timeout=300, check=False,
    )
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "ok"


def test_vitdet_runs_without_jax():
    """The ViTDet slice's modules (resize, rel-pos, windows, the v2 gate
    kernels' wrappers, EventfulBlock) import and run without JAX."""
    _run(VITDET_SCRIPT)


def test_vitdet_detects_without_jax():
    """The detection head (SimplePyramid, RPN, ROIAlign, NMS, the standard
    ROI heads) through ``ViTDet.apply``, eventful, without JAX."""
    _run(E2E_SCRIPT)


def test_port_runs_without_jax():
    _run(SCRIPT)


def test_vivit_apply_runs_without_jax():
    """The paper's K400 configuration in small (EventfulBlock with the
    matmul-2 cast, "v2mlp" under "auto"), a raw uint8 video through
    ``FactorizedViViT.apply``: preprocessing with the antialiased resize,
    3 x 2 views."""
    _run(APPLY_SCRIPT)


def test_block_options_run_without_jax():
    """Gates before LN ("v2", "blocked") and STGT gates in a small ViTDet
    backbone, without JAX."""
    _run(OPTIONS_SCRIPT)


def test_block_switches_run_without_jax():
    """The group kernels' own top-k (``in_kernel_topk``, sharing on and
    off) and the scatter-blend under ``USE_PALLAS_BLEND`` (STGT), the
    modules ``ops/gate_group.py`` and ``ops/scatter_blend.py``, in a small
    ViTDet backbone without JAX."""
    _run(SWITCHES_SCRIPT)


def test_unwired_kernels_run_without_jax():
    """The four kernels no path of the JAX package calls (rows 15, 19-21:
    the row scatter and gather, the fused attention, the grid form of the
    windowed attention) through their wrappers, without JAX."""
    _run(UNWIRED_SCRIPT)


def test_harness_runs_without_jax():
    """The harness (config, the ViViT entry point's ``main`` with a bucketed
    threshold sweep, ``evaluate_vitdet_metrics`` with its dispatch and the
    mAP, the data readers and the other entry points) without JAX."""
    _run(HARNESS_SCRIPT)


def test_serving_surface_runs_without_jax():
    """ATS (the dense and the eventful block), the spatial cache
    (``utils/spatial.py``, ``data/vivit_spatial.py``, ``spatial_only`` and
    ``temporal_only``), the timing and profiling helpers, the generated
    VID video and the spatial and time entry points, without JAX."""
    _run(SERVING_SCRIPT)


def test_coco_heads_run_without_jax():
    """The COCO cascade and its mask head (``detection/roi_heads.py``,
    ``detection/mask_head.py``) through ``ViTDet.apply``, without JAX."""
    _run(COCO_SCRIPT)


def test_training_runs_without_jax():
    """The temporal fine-tune (``utils/train.py``, ``utils/checkpoint.py``,
    ``save_params``/``load_params``, dropout and drop-path) through the
    Kinetics-400 train entry point's ``main`` on a small model and a
    generated cache, and the EPIC-Kitchens entry point's import, without
    JAX."""
    _run(TRAIN_SCRIPT)


def test_parallel_runs_without_jax():
    """The parallel package (the mesh, Ulysses attention, the SP and DP
    drivers at one gloo rank) and the converters, without JAX."""
    _run(PARALLEL_SCRIPT)


def test_training_parallel_runs_without_jax():
    """The training half of the parallel package (the dp x tp step, the
    pipeline, through the dry run at one gloo rank) and the detector's
    losses, without JAX."""
    _run(TRAINING_PARALLEL_SCRIPT)


def test_slice_26_runs_without_jax():
    """The two measurement scripts (the bucket script on a tiny ViViT at
    ``--device cpu``), the norms that TP all-reduces and the backend rule,
    without JAX."""
    _run(SLICE_26_SCRIPT)


def test_slice_29_runs_without_jax():
    """NMS's plain route on the CPU against the kernel's contract
    (``tests/torch_nms_contract.py``, no launch), the cached ROIAlign tables, the whole-frame step's body through the
    static-buffer step and ``make_vitdet_step``, without JAX."""
    _run(SLICE_29_SCRIPT)
