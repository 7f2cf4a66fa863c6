"""The warm ms per clip of configs/evaluate/vivit_epic_kitchens/
temporal_ats_200.yml (EventfulBlock, bf16 A.V cast, ATS 0.9, top fraction
0.5) at EPIC-Kitchens ViViT-B's full size on the card, float32, seed
weights, one generated clip (``chip_smoke.ATS_CLIP``): ``apply_views``
timed 7 times, the card synchronised around each; the first 2 are
reported apart (the kernels' build, the first shapes). The model and its
modules come from the tree given, so that two trees compare in turns in
one call, each forward in a process of its own:

    for t in old new new old old new; do
        python scripts/misc/time_vivit_ats.py <root of tree $t> $t
    done

Prints one JSON line: the warm ms, the first ms, and the seconds the
imports, the model and the data took.
"""
import json
import sys
import time

root, tag = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
t_start = time.perf_counter()
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from eventful_transformer_tpu_torch.core.counting import Ctx  # noqa: E402
from eventful_transformer_tpu_torch.core.policies import TokenNormTopFraction  # noqa: E402
from eventful_transformer_tpu_torch.data.synthetic import SyntheticVideoClassification  # noqa: E402
from eventful_transformer_tpu_torch.models import FactorizedViViT  # noqa: E402
from eventful_transformer_tpu_torch.utils.evaluate import vivit_views  # noqa: E402
from eventful_transformer_tpu_torch.utils.misc import set_policies  # noqa: E402

t_import = time.perf_counter()
torch.backends.cuda.matmul.allow_tf32 = False
config = cs.harness_config("vivit_epic_kitchens", ["temporal_ats_200", "_output=/tmp/ab", "n_items=1"])
model = FactorizedViViT(**{"seed": 0, **config["model"]})
set_policies(model, TokenNormTopFraction, fraction=0.5)
t_model = time.perf_counter()
data = SyntheticVideoClassification(**cs.ATS_CLIP)
views = vivit_views(model, data[0][0])
t_data = time.perf_counter()
times = []
with torch.no_grad():
    for i in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.apply_views(Ctx(), views)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
print(json.dumps(dict(tag=tag, warm_ms=times[2:], first_ms=times[:2],
                      import_s=t_import - t_start, model_s=t_model - t_import,
                      data_s=t_data - t_model)))
