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
