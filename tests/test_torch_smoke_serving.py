"""``chip_smoke.py``'s helpers for the serving paths, on the CPU:
``run_as_main`` runs modules as ``python -m`` runs them, in one subprocess;
``ats_scores_against_cpu`` scores each ATS call made on the card again on
the CPU and tallies what differs."""

import json

import pytest
import torch

import chip_smoke
from eventful_transformer_tpu_torch.core import blocks

MODULE = '''
import json, sys
from pathlib import Path
Path(sys.argv[1]).write_text(json.dumps(dict(name=__name__, argv=sys.argv[1:])))
'''


def test_run_as_main_runs_each_module_as_python_m(tmp_path, monkeypatch):
    (tmp_path / "first_entry.py").write_text(MODULE)
    (tmp_path / "second_entry.py").write_text(MODULE)
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    out = [tmp_path / "a.json", tmp_path / "b.json"]
    seconds, each = chip_smoke.run_as_main([["first_entry", str(out[0]), "x=1"],
                                            ["second_entry", str(out[1])]])
    assert json.loads(out[0].read_text()) == dict(name="__main__", argv=[str(out[0]), "x=1"])
    assert json.loads(out[1].read_text()) == dict(name="__main__", argv=[str(out[1])])
    assert set(each) == {"first_entry", "second_entry"}
    assert 0 < sum(each.values()) < seconds


def test_run_as_main_raises_when_a_module_fails(tmp_path, monkeypatch):
    (tmp_path / "failing_entry.py").write_text("raise SystemExit('no card')\n")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    with pytest.raises(AssertionError, match="no card"):
        chip_smoke.run_as_main([["failing_entry"]])


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card."""

    @property
    def is_cuda(self):
        return True


def test_ats_scores_against_cpu_tallies_the_card_calls():
    g = torch.Generator().manual_seed(0)
    b, heads, n, d = 2, 4, 17, 8
    a = torch.softmax(torch.randn((b, heads, n, n), generator=g), dim=-1).bfloat16()
    v = torch.randn((b, heads, n, d), generator=g).bfloat16()
    plain = blocks.ats_scores
    with chip_smoke.ats_scores_against_cpu(0.5) as tally:
        on_cpu = blocks.ats_scores(a, v)
        # as the blocks call it: with their tensor-parallel group, None here
        on_card = blocks.ats_scores(a.as_subclass(_OnCard), v.as_subclass(_OnCard), None)
    assert blocks.ats_scores is plain
    assert torch.equal(on_cpu, plain(a, v)) and torch.equal(on_card, on_cpu)
    k = int(0.5 * (n - 1)) + 1
    assert tally == dict(calls=1, scores=b * n, scores_differing=0, selections=b * k,
                         selections_differing=0)
