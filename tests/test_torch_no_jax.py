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


def test_port_runs_without_jax():
    result = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True, text=True,
        timeout=300, check=False,
    )
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "ok"
