"""``chip_smoke.py``'s multi-process rank (phase ``parallel_paths``, and the
run by hand on every GPU of a host) on the CPU at slim widths: gloo ranks
spawned through ``parallel.mesh.spawn`` run paths (a)-(c), each through
its parallel driver and without the option, and the pipeline, TP and dry
run paths, each against its run in one process, and the first rank's
comparison must find every pair equal; at one rank as the phase runs it,
at two over a number of items the ranks do not divide. The comparison
itself is checked on results made by hand."""

import json
import sys
from pathlib import Path

import pytest

import torch_parallel_ranks
from eventful_transformer_tpu_torch.parallel.mesh import spawn

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("world, frames, items", [(1, chip_smoke.PARALLEL_FRAMES, 1), (2, 2, 3)])
def test_parallel_rank_paths_agree_on_the_cpu(world, frames, items, tmp_path):
    out = tmp_path / "rank.json"
    spawn(torch_parallel_ranks.smoke_rank, world, args=(str(out), frames, items), threads=2)
    result = json.loads(out.read_text())
    assert (result["backend"], result["world_size"]) == ("gloo", world)
    assert (result["frames"], result["items"]) == (frames, items)
    for path in chip_smoke.PARALLEL_ROWS:
        r = result[path]
        assert r["same_as_plain"], path
        assert len(r["seconds"]) == chip_smoke.PARALLEL_RUNS and min(r["seconds"]) > 0
        assert result["path_s"][path] > 0
    for path in ("parallel_sp", "parallel_dp_vitdet"):
        assert result[path]["par"]["metrics"]["map"] > 0
    vivit = result["parallel_dp_vivit"]["par"]
    assert vivit["done"] == ["Token top k=24"]
    assert len(vivit["metrics"].strip().splitlines()) == 2
    # the training paths: the pipeline over every rank, TP on
    # best_dp_tp_mesh(max_tp=2), the dry run
    pipeline, tp, dry = result["pipeline"], result["tp"], result["dryrun"]
    assert pipeline["same_as_plain"] and pipeline["stages"] == world
    assert (tp["dp"], tp["tp"]) == {1: (1, 1), 2: (1, 2)}[world]
    assert tp["inference"]["same_as_plain"] and tp["training"]["same_as_plain"]
    assert len(tp["training"]["losses"]) == chip_smoke.TRAIN_STEPS
    assert dry["world_size"] == world and dry["backend"] == "gloo"
    for path in ("pipeline", "tp", "dryrun"):
        assert result["path_s"][path] > 0


def test_tp_eventful_rank_agrees_on_the_cpu(tmp_path):
    """Phase tp_eventful_paths's rank at two gloo ranks and slim widths:
    each configuration sharded over tp = 2 (6 of 12 heads a rank) equal
    to its unsharded unfused run, every selection included, and its train
    steps to the plain autograd steps; the first rank writes both ranks'
    results."""
    out = tmp_path / "tp_eventful.json"
    spawn(torch_parallel_ranks.smoke_tp_eventful_rank, chip_smoke.TP_EVENTFUL_WORLD,
          args=(str(out),), threads=2)
    ranks = json.loads(out.read_text())
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert (r["backend"], r["world_size"], r["tp"]) == ("gloo", 2, 2)
        assert set(r["runs"]) == set(chip_smoke.TP_EVENTFUL_RUNS)
        for name, run in r["runs"].items():
            inference, training = run["inference"], run["training"]
            assert inference["same_as_plain"] and inference["selections_differing"] == 0, name
            assert inference["local_heads"] == [6], name
            assert training["same_as_plain"], name
            assert len(training["losses"]) == chip_smoke.TP_EVENTFUL_STEPS
            # the gates and ATS select in every configuration
            assert inference["gate_calls"] > 0 and inference["selections"] > 0, name


def _run(plain_launches, launches, metric=0.5, par_metric=0.5):
    result = dict(metrics={"map": metric}, counts={"linear_flops": 1.0})
    return dict(plain=result, par=dict(result, metrics={"map": par_metric}),
                plain_launches=plain_launches, launches=launches)


@pytest.mark.parametrize("path, runs, same", [
    # SP: every rank launches what its plain run launches
    ("parallel_sp", [_run({"a": 3}, {"a": 3}), _run({"a": 3}, {"a": 3})], True),
    ("parallel_sp", [_run({"a": 3}, {"a": 3}), _run({"a": 3}, {"a": 2})], False),
    # SP at P > 1: metrics within PARALLEL_SP_RTOL, not beyond
    ("parallel_sp", [_run({}, {}, 0.5, 0.5 * (1 + 1e-6)), _run({}, {})], True),
    ("parallel_sp", [_run({}, {}, 0.5, 0.5 * (1 + 1e-3)), _run({}, {})], False),
    ("parallel_sp", [_run({}, {}, 0.5, 0.5 * (1 + 1e-6))], False),
    # DP: the ranks' launches sum to the first rank's plain run's; metrics exact
    ("parallel_dp_vitdet", [_run({"a": 3}, {"a": 2}), _run({"a": 3}, {"a": 1})], True),
    ("parallel_dp_vitdet", [_run({"a": 3}, {"a": 3}), _run({"a": 3}, {"a": 3})], False),
    ("parallel_dp_vivit", [_run({}, {}, 0.5, 0.5 * (1 + 1e-6)), _run({}, {})], False),
])
def test_parallel_same(path, runs, same):
    assert chip_smoke.parallel_same(path, runs) is same
