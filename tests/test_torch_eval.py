"""Port data packing and the dense ranker against the JAX package.

eval_pack / synthetic_kg arrays must be equal; the dense ranker's ranks
must be identical to the JAX dense ranker's in f64 (same scores to ~1e-15,
and a rank changes only on a score tie within that).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.data.dataset import dedup_filter_rows, synthetic_kg
from complexhyperbolickge_torch.kernels.chyp_rank import ChypRanker
from complexhyperbolickge_torch.models import ModelConfig, get_model
from complexhyperbolickge_torch.train import evaluate as TEV
from complexhyperbolickge_torch.train.checkpoint import params_from_jax
from complexhyperbolickge_torch.utils.platform import resolve_device
from complexhyperbolickge_tpu.data.dataset import dedup_filter_rows as jax_dedup
from complexhyperbolickge_tpu.data.dataset import synthetic_kg as jax_synthetic_kg
from complexhyperbolickge_tpu.models import ModelConfig as JaxConfig
from complexhyperbolickge_tpu.models import get_model as jax_get_model
from complexhyperbolickge_tpu.train import evaluate as JEV

KG = dict(n_entities=150, n_train=900, n_valid=80, n_test=90, seed=4)


@pytest.fixture(scope="module")
def kgs():
    return synthetic_kg(**KG), jax_synthetic_kg(**KG)


@pytest.mark.parametrize("split", ["train", "valid", "test"])
@pytest.mark.parametrize("direction", ["rhs", "lhs"])
def test_eval_pack_equals_jax(kgs, split, direction):
    t, j = kgs
    assert (t.n_entities, t.n_predicates) == (j.n_entities, j.n_predicates)
    pt, pj = t.eval_pack(split, direction), j.eval_pack(split, direction)
    np.testing.assert_array_equal(pt.queries, pj.queries)
    # rows are sets (built from a Python set): compare sorted rows
    np.testing.assert_array_equal(np.sort(pt.filter_idx, 1), np.sort(pj.filter_idx, 1))
    assert pt.queries.dtype == np.int32 and pt.filter_idx.dtype == np.int32


@pytest.mark.parametrize("split", ["train", "valid", "test"])
def test_examples_and_filters_equal_jax(kgs, split):
    t, j = kgs
    np.testing.assert_array_equal(t.get_examples(split), j.get_examples(split))
    assert t.get_filters() == j.get_filters()
    assert t.get_shape() == j.get_shape()


def test_dedup_filter_rows_equals_jax():
    f = np.random.default_rng(0).integers(0, 12, (30, 9)).astype(np.int32)
    np.testing.assert_array_equal(dedup_filter_rows(f, 12), jax_dedup(f, 12))


def test_filtered_rank_counts_equals_jax():
    rng = np.random.default_rng(1)
    scores = rng.normal(size=(6, 20))
    scores[0, 3] = -2e6  # a score below the -1e6 overwrite
    target = scores[np.arange(6), rng.integers(0, 20, 6)][:, None]
    target[0] = -3e6
    fidx = dedup_filter_rows(rng.integers(0, 21, (6, 5)).astype(np.int64), 20)
    want = JEV.filtered_rank_counts(jnp.asarray(scores), jnp.asarray(target),
                                    jnp.asarray(fidx), 20)
    got = TEV.filtered_rank_counts(torch.as_tensor(scores), torch.as_tensor(target),
                                   torch.as_tensor(fidx), 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["FFTRotH", "FFTIsoH"])
def test_dense_ranks_identical_to_jax_f64(kgs, name):
    t, j = kgs
    cfg = dict(n_entities=t.n_entities, n_relations=t.n_predicates, rank=6,
               bias="learn", multi_c=True, dtype="float64")
    jm = jax_get_model(name)(JaxConfig(**cfg))
    rng = np.random.default_rng(2)
    npp = {k: rng.normal(0, 0.2, np.shape(v)) + (1.0 if k == "c" else 0.0)
           for k, v in jm.init(jax.random.PRNGKey(0)).items()}
    tm = get_model(name)(ModelConfig(**cfg))
    tm.load_state_dict(params_from_jax(npp, "cpu"))
    jp = {k: jnp.asarray(v) for k, v in npp.items()}
    for direction in ("rhs", "lhs"):
        want = JEV.get_ranking(jm, jp, j.eval_pack("test", direction), 32)
        got = TEV.get_ranking(tm, t.eval_pack("test", direction), 32)
        np.testing.assert_array_equal(got, want)
    mt = TEV.avg_both(TEV.compute_metrics(tm, t, "valid", 32))
    mj = JEV.avg_both(JEV.compute_metrics(jm, jp, j, "valid", 32))
    assert mt == mj
    assert TEV.format_metrics(mt, "valid") == JEV.format_metrics(mj, "valid")
    assert TEV.count_params(tm) == JEV.count_params(jp)


def _small_model(t):
    cfg = ModelConfig(n_entities=t.n_entities, n_relations=t.n_predicates, rank=5)
    return get_model("FFTRotH")(cfg, generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("backend,kind,masked", [
    ("auto", ChypRanker, True), ("pallas", ChypRanker, True),
    ("pallas_maskless", ChypRanker, False), ("dense", None, None)])
def test_best_ranker_policy(kgs, backend, kind, masked):
    """auto picks the masked fused ranker for the FFT family on any device;
    the JAX backend names select the CUDA rankers."""
    model = _small_model(kgs[0])
    r = TEV.make_best_ranker(model, 64, backend)
    if kind is None:
        assert not isinstance(r, ChypRanker)
    else:
        assert isinstance(r, kind) and r.masked is masked


def test_cuda_device_without_card_raises(monkeypatch):
    """device='cuda' never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_predictor_matches_jax_and_masks_filters(kgs):
    t, j = kgs
    cfg = dict(n_entities=t.n_entities, n_relations=t.n_predicates, rank=6,
               bias="learn", multi_c=True, dtype="float64")
    jm = jax_get_model("FFTRefH")(JaxConfig(**cfg))
    rng = np.random.default_rng(3)
    npp = {k: rng.normal(0, 0.2, np.shape(v)) + (1.0 if k == "c" else 0.0)
           for k, v in jm.init(jax.random.PRNGKey(0)).items()}
    tm = get_model("FFTRefH")(ModelConfig(**cfg))
    tm.load_state_dict(params_from_jax(npp, "cpu"))
    q = np.stack([rng.integers(0, t.n_entities, 8), rng.integers(0, t.n_predicates, 8)], 1)
    fidx = np.full((8, 4), t.n_entities, np.int64)
    fidx[:, 0] = rng.integers(0, t.n_entities, 8)
    ids_j, vals_j = JEV.make_predictor(jm, k=5)(
        {k: jnp.asarray(v) for k, v in npp.items()}, jnp.asarray(q), jnp.asarray(fidx))
    ids_t, vals_t = TEV.make_predictor(tm, k=5)(torch.as_tensor(q), torch.as_tensor(fidx))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(vals_t.numpy(), np.asarray(vals_j), atol=1e-10, rtol=1e-10)
    assert not (ids_t == torch.as_tensor(fidx[:, :1])).any()


def test_predictor_refuses_nan_params(kgs):
    model = _small_model(kgs[0])
    with torch.no_grad():
        model.rel[0, 0] = float("nan")
    with pytest.raises(FloatingPointError):
        TEV.make_predictor(model, k=3)(torch.zeros((2, 2), dtype=torch.int64))
