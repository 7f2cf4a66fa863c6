"""The port's multi-process evaluation (``parallel/``) on the CPU: ranks
spawned through ``parallel.mesh.spawn`` on gloo, held against the JAX
package's parallel code on 2 and 4 of the 8 virtual CPU devices
(tests/conftest.py) and against the sequential drivers.

- the dense ``Block``'s ``sequence_parallel`` attention (the exchanges of
  ``parallel.sequence.ulysses_attention`` around its single-process route:
  the global kernel at N = 32, the plain product at N = 576) at P = 2 and 4
  against JAX ``make_ulysses_attention`` and the port's single-process
  attention, float32, within 1e-5;
- a 2-block ``ViTBackbone`` with ``sequence_parallel="seq"`` at P = 4
  against JAX ``TestUlyssesBackbone``'s setup (tests/test_parallel.py), within
  2e-5, its counts summed over the ranks equal to the JAX package's;
- ``evaluate_vitdet_metrics_sp`` at P = 2 against the JAX package's on a
  2-device mesh (``TINY`` and ``_SyntheticVID`` of
  tests/test_vitdet_eval_driver.py), and its refusal of a backbone whose
  blocks lack the option;
- ``evaluate_vitdet_metrics_dp`` and ``evaluate_vivit_metrics_dp`` at P = 2,
  with a number of items that P divides and one it does not, against the
  JAX package's sequential drivers and exactly against the port's; the JAX
  ``evaluate_vivit_metrics_dp`` counts the padded duplicate of its last
  group (ROADMAP.md §3);
- the two evaluate entry points with ``model.device=cpu`` at 2 ranks against
  their 1-process output: only rank 0 writes, and every rank destroys its
  group.

The rank functions live in tests/torch_parallel_ranks.py, which imports no
JAX; one spawn serves every check of a world size."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import torch_parallel_ranks
from eventful_transformer_tpu.core.backbones import ViTBackbone as JaxViTBackbone
from eventful_transformer_tpu.core.counting import Counts as JaxCounts, Ctx as JaxCtx
from eventful_transformer_tpu.core.policies import TokenNormTopK as JaxTopK
from eventful_transformer_tpu.data import SyntheticVideoClassification
from eventful_transformer_tpu.models import FactorizedViViT as JaxViViT
from eventful_transformer_tpu.models.vitdet import ViTDet as JaxViTDet
from eventful_transformer_tpu.parallel.evaluate import (
    evaluate_vitdet_metrics_sp as jax_evaluate_vitdet_sp,
    evaluate_vivit_metrics_dp as jax_evaluate_vivit_dp,
)
from eventful_transformer_tpu.parallel.mesh import make_mesh as jax_make_mesh
from eventful_transformer_tpu.parallel.sequence import make_ulysses_attention
from eventful_transformer_tpu.utils.evaluate import evaluate_vivit_metrics as jax_evaluate_vivit
from eventful_transformer_tpu.utils.misc import set_policies as jax_set_policies
from eventful_transformer_tpu.utils.params import _flatten
from eventful_transformer_tpu_torch.core import blocks
from eventful_transformer_tpu_torch.core.counting import Ctx
from eventful_transformer_tpu_torch.core.policies import TokenNormThreshold, TokenNormTopK
from eventful_transformer_tpu_torch.models import FactorizedViViT, ViTDet
from eventful_transformer_tpu_torch.parallel.mesh import spawn
from eventful_transformer_tpu_torch.scripts.evaluate import vitdet_vid, vivit_kinetics400
from eventful_transformer_tpu_torch.utils.evaluate import (
    evaluate_vitdet_metrics,
    evaluate_vivit_metrics,
)
from eventful_transformer_tpu_torch.utils.misc import set_policies
from eventful_transformer_tpu_torch.utils.params import params_from_jax

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from scripts.evaluate.vitdet_vid import evaluate_vitdet_metrics as jax_evaluate_vitdet  # noqa: E402
from tests.test_torch_evaluate import VITDET, VIVIT, _annotated, _SyntheticVID  # noqa: E402
from tests.test_vitdet_eval_driver import TINY, _SyntheticVID as _DriverVID  # noqa: E402

ATTN = dict(batch=2, dim=32, heads=4)
# the global window_attention route (N <= 512) and the plain product
ATTN_TOKENS = (32, 576)
BACKBONE = dict(depth=2, position_encoding_size=[4, 8], input_size=(4, 8))
COUNTS_RTOL = 1e-6
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
VIVIT_K, VITDET_K = 6, 8
# a threshold whose selections differ between frames: the JAX DP ViTDet
# driver's per-lane scaling is exact only where the lanes' counts are equal
THRESHOLD = 0.2
# the evaluate entry points at a slim size: ViTDet-B's ulysses_smoke_672
# cut to 2 blocks of 48 at 64 x 64, over 3 generated 2-frame VID videos; the
# ViViT synthetic_smoke over 3 generated clips
SLIM_VITDET = [
    "model.device=cpu", "model.input_shape=[3,64,64]", "model.output_channels=32",
    "model.backbone_config.depth=2", "model.backbone_config.position_encoding_size=[4,4]",
    "model.backbone_config.block_config.dim=48", "model.backbone_config.block_config.heads=6",
    "model.backbone_config.block_config.mlp_ratio=2",
    "model.rpn_config={pre_nms_topk: 200, post_nms_topk: 50}",
    "model.roi_config.test_topk_per_image=20", "n_items=3",
    "synthetic={n_items: 3, n_frames: 2, size: [48, 64]}",
]
SLIM_VIVIT = ["synthetic_smoke", "model.device=cpu", "n_items=3", "synthetic.n_items=3"]
VIVIT_MODULE = "eventful_transformer_tpu_torch.scripts.evaluate.vivit_kinetics400"
VITDET_MODULE = "eventful_transformer_tpu_torch.scripts.evaluate.vitdet_vid"


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _flat(params):
    return {k: np.array(v) for k, v in _flatten(params).items()}


def _qkv(tokens):
    b, c = ATTN["batch"], ATTN["dim"]
    return np.random.default_rng(11).standard_normal((b, tokens, 3 * c)).astype(np.float32)


def _ulysses_jobs():
    return [("ulysses", _qkv(n), ATTN["heads"]) for n in ATTN_TOKENS]


def _scale():
    return float(np.sqrt(ATTN["dim"] // ATTN["heads"]))


def _sp_backbone_config(jax_side):
    block = dict(dim=32, heads=4, mlp_ratio=2, sequence_parallel="seq")
    return dict(BACKBONE, block_config=block) if not jax_side else block


def _dense_tiny(sequence_parallel=None):
    """test_parallel.py's TestVitDetSequenceParallelEval configuration:
    TINY with a dense global backbone."""
    bb = dict(TINY["backbone_config"], window_indices=[], block_class="Block")
    bb.pop("windowed_class", None)
    bb["block_config"] = dict(bb["block_config"], window_size=None)
    if sequence_parallel:
        bb["block_config"]["sequence_parallel"] = sequence_parallel
    return dict(TINY, backbone_config=bb)


def _videos(seed, n):
    """n annotated videos (3 and 4 frames, alternately) for VITDET."""
    data = _SyntheticVID(seed)
    while len(data.videos) < n:
        data.videos += _SyntheticVID(seed + len(data.videos)).videos
    data.videos = data.videos[:n]
    return data


@pytest.fixture(scope="module")
def jax_models(tmp_path_factory):
    """The JAX references' weights and data."""
    vitdet = JaxViTDet(**VITDET)
    jax_set_policies(vitdet, JaxTopK, k=VITDET_K)
    vitdet_params = vitdet.init(jax.random.PRNGKey(3))
    vivit = JaxViViT(**VIVIT)
    jax_set_policies(vivit, JaxTopK, k=VIVIT_K)
    vivit_params = vivit.init(jax.random.PRNGKey(4))
    flat = _flat(vitdet_params)
    clips = SyntheticVideoClassification(n_items=4, n_frames=20, size=(40, 48))
    return dict(
        vitdet=vitdet, vitdet_params=vitdet_params, vitdet_flat=flat,
        vivit=vivit, vivit_params=vivit_params, vivit_flat=_flat(vivit_params),
        videos={n: _annotated(_videos(0, n), flat).videos for n in (2, 3)},
        clips=[clips[i] for i in range(4)],
        sp_params=JaxViTDet(**_dense_tiny()).init(jax.random.PRNGKey(1)),
        sp_data=_DriverVID(np.random.default_rng(9)).videos,
    )


@pytest.fixture(scope="module")
def world_4(tmp_path_factory):
    """One spawn of 4 ranks: Ulysses attention and the SP backbone."""
    x = np.random.default_rng(12).standard_normal((2, 32, 32)).astype(np.float32)
    params = JaxViTBackbone(block_config=dict(dim=32, heads=4, mlp_ratio=2),
                            **BACKBONE).init(jax.random.PRNGKey(0))
    jobs = [("sp_backbone", _sp_backbone_config(False), _flat(params), x), *_ulysses_jobs()]
    store = tmp_path_factory.mktemp("store_4")
    results = spawn(torch_parallel_ranks.run_jobs, 4, args=(jobs, str(store)), threads=1)
    return dict(results=results, x=x, params=params)


@pytest.fixture(scope="module")
def world_2(tmp_path_factory, jax_models):
    """One spawn of 2 ranks: SP and DP evaluation, the entry points, the
    SP refusals, Ulysses attention."""
    m = jax_models
    out = tmp_path_factory.mktemp("entries")
    jobs = [
        ("vitdet_sp_refused", [_dense_tiny(), _dense_tiny("data"), VITDET]),
        ("vitdet_sp", _dense_tiny("seq"), _flat(m["sp_params"]), m["sp_data"], {"n_items": 2}),
        ("vitdet_dp", VITDET, m["vitdet_flat"], m["videos"][2], {"n_items": 2},
         ("top_k", VITDET_K)),
        ("vitdet_dp", VITDET, m["vitdet_flat"], m["videos"][3], {"n_items": 3},
         ("top_k", VITDET_K)),
        ("vivit_dp", VIVIT, m["vivit_flat"], m["clips"], {"n_items": 4}, ("top_k", VIVIT_K)),
        ("vivit_dp", VIVIT, m["vivit_flat"], m["clips"], {"n_items": 3}, ("top_k", VIVIT_K)),
        ("entry", VIVIT_MODULE, SLIM_VIVIT + ["data_parallel=true", f"_output={out}/vivit"],
         str(REPO)),
        ("entry", VITDET_MODULE,
         ["ulysses_smoke_672", *SLIM_VITDET, f"_output={out}/vitdet_sp"], str(REPO)),
        ("entry", VITDET_MODULE,
         ["ulysses_smoke_672", *SLIM_VITDET, "sequence_parallel=null",
          "model.backbone_config.block_config.sequence_parallel=null", "data_parallel=true",
          f"_output={out}/vitdet_dp"], str(REPO)),
        ("vitdet_dp", VITDET, m["vitdet_flat"], m["videos"][2], {"n_items": 2},
         ("threshold", THRESHOLD)),
        *_ulysses_jobs(),
    ]
    store = tmp_path_factory.mktemp("store_2")
    results = spawn(torch_parallel_ranks.run_jobs, 2, args=(jobs, str(store)), threads=2)
    return dict(results=results, out=out)


def _job(world, index):
    return [rank[index] for rank in world["results"]]


def _same_metrics(got, want, exact=False):
    assert set(got["metrics"]) == set(want["metrics"])
    for key, value in want["metrics"].items():
        if exact:
            assert got["metrics"][key] == value, key
        else:
            np.testing.assert_allclose(got["metrics"][key], value, **METRIC_TOL, err_msg=key)


def _same_counts(got, want, exact=False):
    want = dict(want)
    assert set(got) == set(want)
    for key, value in want.items():
        if exact:
            assert got[key] == value, key
        else:
            np.testing.assert_allclose(got[key], value, rtol=COUNTS_RTOL, err_msg=key)


def _port_attention(qkv):
    blk = torch_parallel_ranks.attention_block(qkv, ATTN["heads"])
    with torch.no_grad():
        return blk._forward_attention(Ctx(), torch.from_numpy(qkv), None)[0].numpy()


@pytest.mark.parametrize("tokens", ATTN_TOKENS)
@pytest.mark.parametrize("world", [2, 4])
def test_ulysses_attention_matches_jax(world, tokens, world_2, world_4):
    qkv = _qkv(tokens)
    first = {2: 10, 4: 1}[world]
    got = np.concatenate(_job({2: world_2, 4: world_4}[world],
                              first + ATTN_TOKENS.index(tokens)), axis=1)
    mesh = Mesh(np.array(jax.devices()[:world]), ("seq",))
    want = make_ulysses_attention(ATTN["heads"], _scale(), mesh)(jnp.asarray(qkv))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _port_attention(qkv), rtol=1e-5, atol=1e-5)


def test_sequence_parallel_backbone_matches_jax(world_4):
    """JAX TestUlyssesBackbone's setup at P = 4: the JAX backbone on one
    device and sharded over "seq", the port's over 4 gloo ranks."""
    x, params = world_4["x"], world_4["params"]
    ref = JaxViTBackbone(block_config=dict(dim=32, heads=4, mlp_ratio=2), **BACKBONE)
    spb = JaxViTBackbone(block_config=_sp_backbone_config(True), **BACKBONE)
    jax_ctx = JaxCtx(count_mode=True)
    want, _ = ref.apply(jax_ctx, params, ref.init_state(2), jnp.asarray(x))
    mesh = Mesh(np.array(jax.devices()[:4]), ("seq",))
    aux = spb.precompute(params)

    def local(p, a, xs):
        y, _ = spb.apply(JaxCtx(), p, spb.init_state(2), xs, aux=a)
        return y

    sharded = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(jax.tree_util.tree_map(lambda _: P(), params),
                  jax.tree_util.tree_map(lambda _: P(None, "seq", None), aux),
                  P(None, "seq", None)),
        out_specs=P(None, "seq", None),
    ))(params, aux, jnp.asarray(x))
    shards = _job(world_4, 0)
    got = np.concatenate([y for y, _ in shards], axis=1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(sharded), rtol=2e-5, atol=2e-5)
    summed = {}
    for _, counts in shards:
        for key, value in counts.items():
            summed[key] = summed.get(key, 0.0) + value
    _same_counts({k: v for k, v in summed.items() if v}, JaxCounts.from_device(jax_ctx.counts)
                 .nonzero())


def test_sequence_parallel_refusals():
    """JAX test_incompatible_options_rejected, and the eventful blocks."""
    kwargs = dict(dim=32, heads=4, mlp_ratio=2, input_size=(4, 8), sequence_parallel="seq")
    for extra in (dict(window_size=[2, 2]), dict(pool_size=2),
                  dict(relative_embedding_size=[4, 8]), dict(ats_fraction=0.5)):
        with pytest.raises(ValueError, match="sequence_parallel"):
            blocks.Block(**kwargs, **extra)
    for cls in (blocks.EventfulTokenwiseBlock, blocks.EventfulMatmul1Block, blocks.EventfulBlock):
        with pytest.raises(ValueError, match="dense Block"):
            cls(**kwargs)


def test_sequence_parallel_without_a_group_raises():
    blk = blocks.Block(dim=32, heads=4, mlp_ratio=2, input_size=(4, 8), sequence_parallel="nope")
    with pytest.raises(ValueError, match="no process group of that mesh axis"), torch.no_grad():
        blk(Ctx(), {}, torch.zeros(1, 32, 32))


def test_sp_evaluation_refuses_backbones_without_the_option(world_2):
    """At 2 ranks, a backbone whose blocks lack ``sequence_parallel="seq"``
    (a dense one without it, one naming another axis, an eventful windowed
    one) is refused before any exchange, on every rank: its ranks would
    attend only within their own tokens."""
    for messages in _job(world_2, 0):
        assert len(messages) == 3
        for message in messages:
            assert message is not None and "dense Block with sequence_parallel='seq'" in message


def test_sp_evaluation_matches_jax(world_2, jax_models):
    """evaluate_vitdet_metrics_sp at P = 2 against the JAX package's on a
    2-device mesh, and against the port's sequential driver exactly."""
    params, data = jax_models["sp_params"], jax_models["sp_data"]
    mesh = jax_make_mesh((2,), ("seq",), devices=jax.devices()[:2])
    want = jax_evaluate_vitdet_sp(JaxViTDet(**_dense_tiny("seq")), params, data,
                                  {"n_items": 2}, mesh)
    ranks = _job(world_2, 1)
    assert ranks[0] == ranks[1]
    _same_metrics(ranks[0], want)
    _same_counts(ranks[0]["counts"], want["counts"])
    model = params_from_jax(ViTDet(**_dense_tiny(), device="cpu"), _flat(params))
    single = evaluate_vitdet_metrics(model, data, {"n_items": 2})
    _same_metrics(ranks[0], single, exact=True)
    _same_counts(ranks[0]["counts"], single["counts"], exact=True)


@pytest.mark.parametrize("n_items", [2, 3])
def test_dp_vitdet_matches_sequential(n_items, world_2, jax_models):
    m = jax_models
    data = m["videos"][n_items]
    want = jax_evaluate_vitdet(m["vitdet"], m["vitdet_params"], data, {"n_items": n_items})
    ranks = _job(world_2, n_items)
    assert ranks[0] == ranks[1]
    assert ranks[0]["metrics"]["map"] > 0
    _same_metrics(ranks[0], want)
    _same_counts(ranks[0]["counts"], want["counts"])
    model = params_from_jax(ViTDet(**VITDET, device="cpu"), m["vitdet_flat"])
    set_policies(model, TokenNormTopK, k=VITDET_K)
    single = evaluate_vitdet_metrics(model, data, {"n_items": n_items})
    _same_metrics(ranks[0], single, exact=True)
    _same_counts(ranks[0]["counts"], single["counts"], exact=True)


@pytest.mark.parametrize("n_items", [4, 3])
def test_dp_vivit_matches_sequential(n_items, world_2, jax_models):
    m = jax_models
    want = jax_evaluate_vivit(m["vivit"], m["vivit_params"], m["clips"], {"n_items": n_items})
    ranks = _job(world_2, 4 if n_items == 4 else 5)
    assert ranks[0] == ranks[1]
    _same_metrics(ranks[0], want)
    _same_counts(ranks[0]["counts"], want["counts"])
    model = params_from_jax(FactorizedViViT(**VIVIT, device="cpu"), m["vivit_flat"])
    set_policies(model, TokenNormTopK, k=VIVIT_K)
    single = evaluate_vivit_metrics(model, m["clips"], {"n_items": n_items})
    _same_metrics(ranks[0], single, exact=True)
    _same_counts(ranks[0]["counts"], single["counts"], exact=True)


def test_jax_dp_vivit_counts_its_padding(jax_models):
    """The JAX package's DP ViViT driver runs 3 items on 2 devices as 2
    groups, the last padded with a duplicate, and counts the duplicate's
    work: its counts are 4/3 of the sequential driver's (the port counts no
    padding: test_dp_vivit_matches_sequential)."""
    m = jax_models
    mesh = jax_make_mesh((2,), ("data",), devices=jax.devices()[:2])
    config = {"n_items": 3}
    dp = jax_evaluate_vivit_dp(m["vivit"], m["vivit_params"], m["clips"], config, mesh)
    seq = jax_evaluate_vivit(m["vivit"], m["vivit_params"], m["clips"], config)
    assert dp["metrics"] == seq["metrics"]
    for key in ("linear_flops", "matmul_flops"):
        np.testing.assert_allclose(dp["counts"][key], 4 / 3 * seq["counts"][key], rtol=1e-6)


def test_dp_vitdet_threshold_matches_sequential(world_2, jax_models):
    """Under a threshold policy (videos of 3 and 4 frames: at frame 3 one
    lane repeats its last frame) the JAX DP driver's counts, the psum of
    the lanes scaled by the valid share, miss the sequential driver's; the
    port's equal them (ROADMAP.md §3)."""
    from eventful_transformer_tpu.core.policies import TokenNormThreshold as JaxThreshold
    from eventful_transformer_tpu.parallel.evaluate import evaluate_vitdet_metrics_dp

    m = jax_models
    data, config = m["videos"][2], {"n_items": 2}
    model = JaxViTDet(**VITDET)
    jax_set_policies(model, JaxThreshold, threshold=THRESHOLD)
    want = jax_evaluate_vitdet(model, m["vitdet_params"], data, config)
    mesh = jax_make_mesh((2,), ("data",), devices=jax.devices()[:2])
    jax_dp = evaluate_vitdet_metrics_dp(model, m["vitdet_params"], data, config, mesh)
    assert jax_dp["counts"]["linear_flops"] < want["counts"]["linear_flops"] * (1 - 1e-3)
    ranks = _job(world_2, 9)
    assert ranks[0] == ranks[1]
    _same_metrics(ranks[0], want)
    _same_counts(ranks[0]["counts"], want["counts"])
    port = params_from_jax(ViTDet(**VITDET, device="cpu"), m["vitdet_flat"])
    set_policies(port, TokenNormThreshold, threshold=THRESHOLD)
    single = evaluate_vitdet_metrics(port, data, config)
    _same_counts(ranks[0]["counts"], single["counts"], exact=True)


def _entry_output(path):
    return {name: (path / name).read_text() for name in ("metrics.csv", "counts.csv")}


def _titles_once(path, titles):
    text = (path / "output.txt").read_text()
    return all(text.count(t + "\n") == 1 for t in titles)


def test_vivit_entry_point_data_parallel(world_2, tmp_path, monkeypatch):
    """``data_parallel=true`` at 2 ranks: the 1-process run's CSVs, written
    once, and no group left on either rank."""
    (done_0, left_0), (done_1, left_1) = _job(world_2, 6)
    assert done_0 == done_1 == ["Token top k=8", "Token top k=16"]
    assert not left_0 and not left_1
    monkeypatch.chdir(REPO)
    vivit_kinetics400.main(SLIM_VIVIT + [f"_output={tmp_path}/one"])
    out = world_2["out"] / "vivit"
    assert _entry_output(out) == _entry_output(tmp_path / "one")
    assert _titles_once(out, done_0)
    assert len((out / "metrics.csv").read_text().strip().splitlines()) == 3


@pytest.mark.parametrize("option", ["sequence_parallel", "data_parallel"])
def test_vitdet_entry_point_parallel(option, world_2, tmp_path, monkeypatch):
    """``ulysses_smoke_672`` (slim) with its sequence_parallel, and without
    it under ``data_parallel=true``, at 2 ranks: the 1-process run's CSVs,
    written once, and no group left."""
    (done_0, left_0), (done_1, left_1) = _job(world_2, 7 if option == "sequence_parallel" else 8)
    assert done_0 == done_1 == ["Vanilla"]
    assert not left_0 and not left_1
    monkeypatch.chdir(REPO)
    vitdet_vid.main(["ulysses_smoke_672", *SLIM_VITDET, "sequence_parallel=null",
                     "model.backbone_config.block_config.sequence_parallel=null",
                     f"_output={tmp_path}/one"])
    out = world_2["out"] / ("vitdet_sp" if option == "sequence_parallel" else "vitdet_dp")
    assert _entry_output(out) == _entry_output(tmp_path / "one")
    assert _titles_once(out, done_0)
    assert (out / "config.yml").is_file()
