"""The cost of each capacity of the ViViT threshold ladder on the card (port
of ``scripts/misc/measure_vivit_buckets.py``): the table behind
``utils/bucketing.py``'s escalating dispatch, whose ladders the configs
set on the TPU.

    python -m eventful_transformer_tpu_torch.scripts.misc.measure_vivit_buckets \
        [--capacities 24 49 98 197] [--threshold 1.0] [--clips 8] [--iters 3] \
        [--dtypes float32 bfloat16] [--device cuda] [overrides]

run from the repo's root. The model is ViViT-B K400 from
``configs/models/vivit_b_kinetics400.yml`` through ``utils/config.py``,
with the JAX script's changes (:data:`MODEL_OVERRIDES`: eventful
token-wise spatial blocks over 1 x 4 views of 32 frames), then the
``a.b.c=value`` overrides, weights from the seed 0. For each dtype and each
capacity every gate takes ``TokenNormThreshold(threshold, capacity)``, and
``apply_views`` runs on ``--clips`` generated clips (standard normal, made
on the device from the seed 0) once untimed, then ``--iters`` times, each
call timed by CUDA events (``time.perf_counter`` on the CPU). Prints one
JSON line a capacity: the median ms a clip and the spread of the calls
(their min, max and (max - min) / median), clips a second, and the peak
``torch.cuda.max_memory_allocated`` since the dtype's model was built.
``--device cpu`` is for tests; the default is the card.
"""

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.policies import TokenNormThreshold
from eventful_transformer_tpu_torch.models import FactorizedViViT
from eventful_transformer_tpu_torch.utils.config import _merge, load_config, parse_dotlist
from eventful_transformer_tpu_torch.utils.misc import set_policies

CONFIG = Path("configs", "models", "vivit_b_kinetics400.yml")
# the JAX script's model (bench.build_model(True, capacity, 4, 32)): the
# config's ViViT-B with EventfulTokenwiseBlocks, 1 x 4 views
MODEL_OVERRIDES = ("model.spatial_config.block_class=EventfulTokenwiseBlock",
                   "model.spatial_views=1", "model.temporal_views=4")
CAPACITIES = (24, 49, 98, 197)
SEED = 0
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_config(overrides=(), config=CONFIG):
    """The model's keywords: ``config``'s ``model`` with MODEL_OVERRIDES,
    then ``overrides``, applied."""
    merged = _merge(load_config(config), parse_dotlist([*MODEL_OVERRIDES, *overrides]))
    return merged["model"]


def bucket_model(capacity, threshold=1.0, overrides=(), device="cuda", dtype=torch.float32):
    """The ViViT of :func:`model_config` on ``device`` in ``dtype``, weights
    from SEED, every gate on ``TokenNormThreshold(threshold, capacity)``."""
    model = FactorizedViViT(**model_config(overrides), device=device, seed=SEED).to(dtype)
    set_policies(model, TokenNormThreshold, threshold=threshold, capacity=capacity)
    return model


def generated_views(model_kwargs, clips, device, dtype):
    """(clips, views, t, c, h, w) standard normal from SEED, made on
    ``device``."""
    views = model_kwargs["spatial_views"] * model_kwargs["temporal_views"]
    generator = torch.Generator(device=device).manual_seed(SEED)
    shape = (clips, views, *model_kwargs["input_shape"])
    return torch.randn(shape, generator=generator, device=device).to(dtype)


def timed_calls(fn, iters, card):
    """``fn()`` once untimed, then ``iters`` times: each call's ms (CUDA
    events on the card, else ``time.perf_counter``)."""
    fn()
    ms = []
    for _ in range(iters):
        if card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        else:
            start = time.perf_counter()
            fn()
            ms.append(1e3 * (time.perf_counter() - start))
    return ms


def measure(capacities=CAPACITIES, threshold=1.0, clips=8, iters=3, dtypes=("float32",),
            device="cuda", overrides=()):
    """One row a (dtype, capacity): the ladder's cost table (the module's
    docstring)."""
    device = torch.device(device)
    card = device.type == "cuda"
    kwargs = model_config(overrides)
    rows = []
    for name in dtypes:
        dtype = DTYPES[name]
        if card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        model = bucket_model(capacities[0], threshold, overrides, device, dtype)
        views = generated_views(kwargs, clips, device, dtype)
        for capacity in capacities:
            set_policies(model, TokenNormThreshold, threshold=threshold, capacity=capacity)
            ms = timed_calls(lambda: model.apply_views(Ctx(), views), iters, card)
            median = float(np.median(ms))
            rows.append(dict(
                capacity=capacity, dtype=name, device=str(device),
                card=torch.cuda.get_device_name(device) if card else None,
                threshold=threshold, clips=clips, views=int(views.shape[1]),
                frames=int(views.shape[2]), iters=iters,
                ms_per_clip=median / clips, ms_per_clip_min=min(ms) / clips,
                ms_per_clip_max=max(ms) / clips, spread=(max(ms) - min(ms)) / median,
                clips_per_s=1e3 * clips / median,
                max_memory_allocated=torch.cuda.max_memory_allocated(device) if card else None,
            ))
            print(json.dumps(rows[-1]), flush=True)
        del model, views
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--capacities", type=int, nargs="+", default=list(CAPACITIES))
    parser.add_argument("--threshold", type=float, default=1.0)
    parser.add_argument("--clips", type=int, default=8)
    parser.add_argument("--iters", type=int, default=3)
    parser.add_argument("--dtypes", nargs="+", default=["float32"], choices=list(DTYPES))
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu (tests)")
    parser.add_argument("overrides", nargs="*", help="model config overrides (a.b.c=value)")
    args = parser.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("measure_vivit_buckets: no CUDA device (--device cpu for tests)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        return measure(args.capacities, args.threshold, args.clips, args.iters, args.dtypes,
                       args.device, args.overrides)


if __name__ == "__main__":
    main()
