"""The port's timing and profiling helpers and its time entry points, on
the CPU:

- ``utils/timing.py``: the warm-up calls before the timed ones, the
  interleaving A, B, A, B of ``time_jitted_pair`` (and its raw arrays),
  ``time_repeated``'s ``repeat`` calls a region divided by ``repeat``,
  median and mean, on a clock each call advances by a known amount; the
  card synchronised around every timed region whenever CUDA is in use,
  also where the arguments lie on the host; ``scalar_probe``;
- ``utils/profiling.py``: ``trace`` writes a Chrome trace that holds the
  ``annotate``d region and the forward's ops;
- the time entry points' ``main`` (``configs/time/*`` with small dotlist
  overrides, ``model.device=cpu``, generated clips and a generated VID
  video): every time positive, the times dict's keys as the JAX scripts
  name them, and the card by default.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from eventful_transformer_tpu_torch.utils import profiling, timing

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


class _Clock:
    """A perf_counter that only the timed callables move."""

    def __init__(self):
        self.now, self.log = 0.0, []

    def __call__(self):
        return self.now

    def fn(self, name, seconds):
        def call(*args):
            self.log.append(name)
            self.now += seconds if not callable(seconds) else seconds()
            return args
        return call


@pytest.fixture
def clock(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(timing.time, "perf_counter", clock)
    return clock


def test_time_jitted_warms_up_then_times_each_call(clock):
    steps = iter([9.0, 9.0, 1.0, 2.0, 6.0, 9.0, 9.0, 1.0, 2.0, 6.0])
    fn = clock.fn("a", lambda: next(steps))
    args = (torch.zeros(2),)
    assert timing.time_jitted(fn, args, iters=3, warmup=2) == 2.0  # the median
    assert timing.time_jitted(fn, args, iters=3, warmup=2, median=False) == 3.0
    assert clock.log == ["a"] * 10
    # at least one warm-up call, the first at a shape
    clock.log.clear()
    timing.time_jitted(clock.fn("b", 1.0), args, iters=2, warmup=0)
    assert clock.log == ["b"] * 3


def test_time_jitted_pair_interleaves(clock):
    fa, fb = clock.fn("a", 2.0), clock.fn("b", 3.0)
    args = (torch.zeros(2),)
    assert timing.time_jitted_pair(fa, args, fb, args, iters=4, warmup=2) == (2.0, 3.0)
    assert clock.log == ["a", "b"] * 6
    times_a, times_b = timing.time_jitted_pair(fa, args, fb, args, iters=3, warmup=1, full=True)
    np.testing.assert_array_equal(times_a, [2.0] * 3)
    np.testing.assert_array_equal(times_b, [3.0] * 3)


def test_time_repeated_divides_a_region_by_repeat(clock):
    fn = clock.fn("a", 0.5)
    assert timing.time_repeated(fn, (torch.zeros(2),), repeat=8, iters=3, warmup=2) == 0.5
    assert clock.log == ["a"] * (8 * 5)


class _Event:
    """A CUDA event on the fake clock."""

    def __init__(self, clock):
        self.clock = clock

    def record(self):
        self.clock.log.append("record")
        self.t = self.clock.now

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def cuda_in_use(clock, monkeypatch):
    """CUDA initialised in the process, its synchronisations logged."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: clock.log.append("sync"))
    monkeypatch.setattr(torch.cuda, "Event", lambda enable_timing: _Event(clock))
    return clock


# each helper with host arguments, as a card model that moves its input takes
TIMERS = {
    "time_jitted": lambda fn, args: timing.time_jitted(fn, args, iters=2, warmup=1),
    "time_jitted_pair": lambda fn, args: timing.time_jitted_pair(fn, args, fn, args, iters=1,
                                                                 warmup=1)[0],
    "time_repeated": lambda fn, args: timing.time_repeated(fn, args, repeat=1, iters=2,
                                                           warmup=1),
}


@pytest.mark.parametrize("helper", sorted(TIMERS))
def test_timers_synchronise_the_card_for_host_arguments(helper, cuda_in_use):
    seconds = TIMERS[helper](cuda_in_use.fn("a", 0.25), (torch.zeros(2),))
    assert seconds == 0.25
    log = cuda_in_use.log
    # the warm-up calls, then every timed call between two synchronisations
    first = log.index("sync")
    assert first and set(log[:first]) == {"a"} and (len(log) - first) % 5 == 0
    for i in range(first, len(log), 5):
        assert log[i:i + 5] == ["sync", "record", "a", "record", "sync"], log


def test_clock_synchronises_where_cuda_is_in_use(cuda_in_use):
    cuda_in_use.now = 3.0
    assert timing.clock() == 3.0 and cuda_in_use.log == ["sync"]


def test_scalar_probe_sums_every_tensor():
    tree = {"a": torch.ones(2, 3), "b": [torch.full((4,), 0.5, dtype=torch.bfloat16)], "c": 7}
    probe = timing.scalar_probe(tree)
    assert probe.dtype == torch.float32 and probe.shape == () and float(probe) == 8.0
    with pytest.raises(ValueError):
        timing.scalar_probe({"c": 1})


def test_trace_writes_a_chrome_trace_of_the_forward(tmp_path):
    from eventful_transformer_tpu_torch.core.counting import Ctx
    from eventful_transformer_tpu_torch.core.policies import TokenNormTopK
    from eventful_transformer_tpu_torch.models import FactorizedViViT
    from eventful_transformer_tpu_torch.utils.misc import set_policies

    model = FactorizedViViT(**_vivit_model(), device="cpu")
    set_policies(model, TokenNormTopK, k=8)
    views = torch.zeros(1, 2, 8, 3, 32, 32)
    with profiling.trace(tmp_path / "profiles") as prof:
        with profiling.annotate("vivit_forward"):
            model.apply_views(Ctx(), views)
    files = list((tmp_path / "profiles").glob("*.json"))
    assert files == [prof.trace_path] and files[0].stat().st_size > 0
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "vivit_forward" in names and any("matmul" in str(n) for n in names)


def _vivit_model():
    block = dict(dim=32, heads=4, mlp_ratio=2)
    return dict(
        classes=10, input_shape=[8, 3, 32, 32], normalize_mean=0.45, normalize_std=0.225,
        spatial_views=1, temporal_stride=1, temporal_views=2, tubelet_shape=[2, 8, 8],
        spatial_config=dict(depth=1, position_encoding_size=[4, 4], block_class="EventfulBlock",
                            block_config=dict(block, matmul_2_cast="bfloat16")),
        temporal_config=dict(depth=1, position_encoding_size=[4], block_config=block),
    )


# small overrides of configs/time/vivit_epic_kitchens/temporal.yml and
# configs/time/vitdet_vid/spatiotemporal_672.yml
VIVIT_SMALL = [
    "model.input_shape=[8,3,32,32]", "model.tubelet_shape=[2,8,8]", "model.spatial_views=1",
    "model.temporal_views=2", "model.classes=10", "model.spatial_config.depth=1",
    "model.spatial_config.position_encoding_size=[4,4]",
    "model.spatial_config.block_config.dim=32", "model.spatial_config.block_config.heads=4",
    "model.temporal_config.depth=1", "model.temporal_config.position_encoding_size=[4]",
    "model.temporal_config.block_config.dim=32", "model.temporal_config.block_config.heads=4",
    "token_top_k=[8]", "n_items=1",
    "synthetic={n_items: 2, n_frames: 10, size: [36, 40], classes: 10, seed: 0}",
]
VITDET_SMALL = [
    "input_size=64", "model.input_shape=[3,64,64]", "model.output_channels=32",
    "model.backbone_config.depth=2", "model.backbone_config.window_indices=[0]",
    "model.backbone_config.position_encoding_size=[4,4]",
    "model.backbone_config.block_config.dim=48", "model.backbone_config.block_config.heads=6",
    "model.backbone_config.block_config.window_size=[2,2]",
    "model.backbone_config.block_config.relative_embedding_size=[4,4]",
    "model.rpn_config={pre_nms_topk: 200, post_nms_topk: 50}",
    "model.roi_config.test_topk_per_image=20", "token_top_k=[8]", "n_items=1",
    "synthetic={n_items: 1, n_frames: 3, size: [48, 64], classes: 30, seed: 0}",
]
TIME_ENTRIES = {
    "vivit_epic_kitchens": ("temporal", VIVIT_SMALL, ("spatial", "temporal", "total")),
    "vitdet_vid": ("spatiotemporal_672", VITDET_SMALL,
                   ("backbone", "backbone_non_first", "other", "other_non_first", "total",
                    "total_non_first")),
}


def _time_module(entry):
    import importlib

    return importlib.import_module(f"eventful_transformer_tpu_torch.scripts.time.{entry}")


@pytest.mark.parametrize("entry", sorted(TIME_ENTRIES))
def test_time_entry_points_on_cpu(entry, tmp_path, monkeypatch, capsys):
    name, small, keys = TIME_ENTRIES[entry]
    monkeypatch.chdir(REPO)
    done = _time_module(entry).main([name, *small, "model.device=cpu",
                                     f"_output={tmp_path}/out"])
    assert done == ["Token top k=8"]
    lines = (tmp_path / "out" / "times.csv").read_text().strip().splitlines()
    assert lines[0].split(",") == list(keys) and len(lines) == 2
    times = dict(zip(keys, map(float, lines[1].split(","))))
    assert all(t > 0 for t in times.values()), times
    parts = ("spatial", "temporal") if "spatial" in times else ("backbone", "other")
    # the CSV keeps 6 significant digits
    assert times["total"] == pytest.approx(sum(times[k] for k in parts), rel=1e-5)
    out = capsys.readouterr().out
    assert "Times" in out and "cpu:cpu x1" in out
    assert (tmp_path / "out" / "config.yml").is_file()


@pytest.mark.parametrize("entry", sorted(TIME_ENTRIES))
def test_time_entry_points_need_the_card_by_default(entry, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would take it")
    name, small, _ = TIME_ENTRIES[entry]
    monkeypatch.chdir(REPO)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _time_module(entry).main([name, *small, f"_output={tmp_path}/out"])
