"""The entity-sharded rankers (parallel/ranking.py) on the CPU.

Each case runs the M shards of one model group in this process
(run_shards: every tensor a shard yields is summed over the shards, as the
model group's all_reduce sums it), at an entity count that M in {2, 4} does
not divide, on shard models that hold only their own rows
(mesh.shard_model_).  The summed ranks must EQUAL the port's single-device
ranker's (the same per-pair arithmetic on a row slice) and JAX's
make_sharded_* ranker's on its 8-device CPU mesh (interpret-mode Pallas),
from the same params.  The params are well spread (uniform +-0.5) so that
scores rarely lie within float rounding of their threshold: the JAX
kernels sum in another order, and only such near-ties can tell the two
apart.  A query with a near-tie (an entity other than the gold within
1e-5 (1 + |t|) of the gold's float64 score, as test_torch_hyp_rank.py
bounds the single-device rankers) may differ from JAX's rank by at most
its near-tie count; every other rank must be equal.  The single-device
port ranker shares the shards' arithmetic and is held to equality on
every query; it is the shard that holds every row, so one shard of
Mesh((1, 1), 0), like two, equals it bit for bit also on filter ids that
no row owns.
"""

import argparse
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.data.dataset import synthetic_kg
from complexhyperbolickge_torch.models import ModelConfig, get_model
from complexhyperbolickge_torch.parallel import (
    Mesh,
    make_best_sharded_ranker,
    run_shards,
    shard_model_,
)
from complexhyperbolickge_torch.train.checkpoint import params_from_jax
from complexhyperbolickge_torch.train.evaluate import get_ranking, make_best_ranker
from complexhyperbolickge_tpu import parallel as JP
from complexhyperbolickge_tpu.data.dataset import synthetic_kg as jax_synthetic_kg
from complexhyperbolickge_tpu.models import ModelConfig as JaxConfig
from complexhyperbolickge_tpu.models import get_model as jax_get_model

N_ENT = 49  # odd: no model axis of 2 or 4 divides it (4 -> 13 rows, the last 10 real)
DATA = dict(n_entities=N_ENT, n_relations=4, n_train=256, n_valid=32, n_test=32, seed=3)
GNN_ARGS = dict(hidden_dim=8, layers=2, edge_dropout=0.0, dropout=0.0, opn="mult",
                interaction="distmult", basis=0, gnn_agg_method=1)
# (model, port backend, JAX sharded ranker maker)
CASES = [
    ("FFTRotH", "auto", "pallas"),
    ("FFTRotH", "pallas_maskless", "pallas_maskless"),
    ("RotH", "auto", "hyp"),
    ("RotLH", "pallas_maskless", "hyp_maskless"),
    ("AttRH", "auto", "attrh"),
    ("AttRH", "pallas_maskless", "attrh_maskless"),
    ("CompGCN", "auto", "gnn"),
    ("RotE", "auto", "dense"),
]


@pytest.fixture(scope="module")
def data():
    return synthetic_kg(**DATA), jax_synthetic_kg(**DATA)


def build(data, name, bias="learn", dtype="float64", seed=9):
    """(JAX model, JAX params, port model) holding the same well-spread params."""
    tdata, jdata = data
    n_ent, n_rel, _ = tdata.get_shape()
    cfg = dict(n_entities=n_ent, n_relations=n_rel, rank=8, bias=bias, gamma=0.7,
               multi_c=True, dtype=dtype)
    rng = np.random.default_rng(seed)
    if name == "CompGCN":
        args = argparse.Namespace(**GNN_ARGS)
        jm = jax_get_model(name)(JaxConfig(**cfg), args, jdata)
        tm = get_model(name)(ModelConfig(**cfg), args, tdata)
    else:
        jm = jax_get_model(name)(JaxConfig(**cfg))
        tm = get_model(name)(ModelConfig(**cfg))
    npp = jax.tree.map(lambda v: rng.uniform(-0.5, 0.5, np.shape(v)),
                       jm.init(jax.random.PRNGKey(0)))
    if "c" in npp:
        npp["c"] = np.abs(npp["c"]) + 0.5
    tm.load_state_dict(params_from_jax(npp, "cpu", tm.cfg.torch_dtype))
    return jm, jax.tree.map(lambda v: jnp.asarray(v, dtype=dtype), npp), tm


def shards(tm, m, backend="auto", precision="highest"):
    """The M shard rankers of one model group over copies of tm that hold
    only their own rows."""
    out = []
    for i in range(m):
        local = copy.deepcopy(tm)
        shard_model_(local, i, m)
        out.append(make_best_sharded_ranker(local, Mesh((1, m), i), N_ENT, backend, precision))
    return out


def packs(tdata):
    for split in ("valid", "test"):
        for direction in ("rhs", "lhs"):
            p = tdata.eval_pack(split, direction)
            yield (torch.as_tensor(p.queries, dtype=torch.int64),
                   torch.as_tensor(p.filter_idx, dtype=torch.int64), p)


@torch.no_grad()
def near_ties(tm, q):
    """Per query: the entities besides the gold whose float64 dense score
    lies within 1e-5 (1 + |t|) of the gold's score t."""
    s = tm.score_all(q[:, :2]).double()
    t = torch.gather(s, 1, q[:, 2:3])
    return ((s - t).abs() <= 1e-5 * (1.0 + t.abs())).sum(1).numpy() - 1


def jax_ranker(jm, kind, m):
    mesh = JP.make_mesh((1, m), devices=jax.devices()[:m])
    if kind == "dense":
        return JP.make_sharded_ranker(jm, mesh, N_ENT)
    if kind == "gnn":
        return JP.make_sharded_gnn_ranker(jm, mesh, N_ENT)
    make = {"pallas": JP.make_sharded_pallas_ranker, "hyp": JP.make_sharded_hyp_ranker,
            "attrh": JP.make_sharded_attrh_ranker}[kind.removesuffix("_maskless")]
    return make(jm, mesh, N_ENT, interpret=True, masked=not kind.endswith("_maskless"))


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name,backend,jax_kind", CASES)
def test_sharded_ranks_equal_single_device_and_jax(data, name, backend, jax_kind, m):
    tdata, _ = data
    jm, jp, tm = build(data, name)
    single = make_best_ranker(tm, 64, backend)
    rankers = shards(tm, m, backend)
    jr = jax_ranker(jm, jax_kind, m)
    for q, f, pack in packs(tdata):
        got = run_shards(rankers, q, f)
        np.testing.assert_array_equal(got.numpy(), single(q, f).numpy())
        want = np.asarray(jr(jp, jnp.asarray(pack.queries), jnp.asarray(pack.filter_idx)))
        near = near_ties(tm, q)
        np.testing.assert_array_equal(got.numpy()[near == 0], want[near == 0])
        assert np.all(np.abs(got.numpy() - want) <= near), near


@pytest.mark.parametrize("bias", ["learn", "none", "constant"])
@pytest.mark.parametrize("name,backend", [("FFTRotH", "auto"), ("FFTRotH", "pallas_maskless"),
                                          ("RotLH", "auto"), ("AttRH", "pallas_maskless"),
                                          ("RotH", "dense"), ("CompGCN", "auto"),
                                          ("ComplEx", "auto")])
def test_sharded_ranks_equal_single_device_across_bias_modes(data, name, backend, bias):
    tdata, _ = data
    if name == "ComplEx":
        tm = get_model(name)(ModelConfig(n_entities=N_ENT, n_relations=tdata.n_predicates,
                                         rank=8, bias=bias, gamma=0.7, dtype="float64"))
        with torch.no_grad():
            for p in tm.parameters():
                p.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(1))
    else:
        tm = build(data, name, bias)[2]
    single = make_best_ranker(tm, 64, backend)
    for m in (2, 4):
        rankers = shards(tm, m, backend)
        for q, f, _ in packs(tdata):
            np.testing.assert_array_equal(run_shards(rankers, q, f).numpy(),
                                          single(q, f).numpy())


@pytest.mark.parametrize("name,backend", [("FFTRotH", "auto"), ("FFTRotH", "pallas_maskless"),
                                          ("RotH", "pallas_maskless"), ("AttRH", "auto"),
                                          ("RotE", "auto")])
def test_sharded_precision_default_equals_single_device(data, name, backend):
    """--eval_precision default: the shards run the plain versions of the
    bf16 instances (the dense ranker its rounded operands) on their rows."""
    tdata, _ = data
    tm = build(data, name, dtype="float32")[2]
    single = make_best_ranker(tm, 64, backend, precision="default")
    rankers = shards(tm, 2, backend, "default")
    for q, f, _ in packs(tdata):
        np.testing.assert_array_equal(run_shards(rankers, q, f).numpy(), single(q, f).numpy())


def test_shard_models_hold_their_rows_only(data):
    tm = build(data, "FFTRotH")[2]
    rankers = shards(tm, 4, "auto")
    assert [r.model.entity.shape[0] for r in rankers] == [13] * 4
    assert [r.real for r in rankers] == [13, 13, 13, 10]
    assert rankers[3].lo == 39
    # a ranker on a full model cuts its rows from the table
    full = make_best_sharded_ranker(tm, Mesh((1, 4), 3), N_ENT)
    np.testing.assert_array_equal(full.local("entity").detach().numpy()[:10],
                                  tm.entity.detach().numpy()[39:])


def test_make_best_sharded_ranker_selects_by_family(data):
    from complexhyperbolickge_torch.parallel import ranking as R

    picks = {"FFTRotH": R.ShardedChypRanker, "RotH": R.ShardedHypRanker,
             "RotLH": R.ShardedHypRanker, "AttRH": R.ShardedAttRHRanker,
             "CompGCN": R.ShardedGNNRanker, "RotE": R.ShardedDenseRanker}
    for name, cls in picks.items():
        tm = build(data, name)[2]
        r = make_best_sharded_ranker(tm, Mesh((1, 2), 0), N_ENT)
        assert type(r) is cls, name
        if name != "CompGCN":
            assert type(make_best_sharded_ranker(tm, Mesh((1, 2), 0), N_ENT, "dense")) \
                is R.ShardedDenseRanker
    assert not make_best_sharded_ranker(build(data, "AttRH")[2], Mesh((1, 2), 0), N_ENT,
                                        "pallas_maskless").masked
    with pytest.raises(NotImplementedError, match="no fused CUDA ranker"):
        make_best_sharded_ranker(build(data, "RotE")[2], Mesh((1, 2), 0), N_ENT, "pallas")
    with pytest.raises(ValueError, match="unknown eval backend"):
        make_best_sharded_ranker(build(data, "RotE")[2], Mesh((1, 2), 0), N_ENT, "x")


def test_sharded_nan_params_raise_through_get_ranking(data):
    """A NaN in one shard's rows: its check_params flag is summed over the
    group (a no-op here, one process), so get_ranking raises before
    ranking, as the single-device check does."""
    tdata, _ = data
    tm = build(data, "FFTRotH")[2]
    rankers = shards(tm, 2)
    with torch.no_grad():
        rankers[1].model.entity[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="non-finite model parameters"):
        get_ranking(rankers[1].model, tdata.eval_pack("test", "rhs"), 64, rankers[1])
    rankers[0].check_params()  # the clean shard alone passes


def bad_filter_ids(f):
    """The filter rows with a negative id, the pad id N, an id past every
    padded table (Np = round_up(N + 1, 128) = 128 here) and a duplicate of
    each row's first id appended: ids the filter must skip or take once."""
    extra = torch.tensor([-3, N_ENT, 1000], dtype=torch.int64).expand(f.shape[0], 3)
    return torch.cat([f, extra, f[:, :1]], dim=1)


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("backend", ["auto", "pallas_maskless"])
@pytest.mark.parametrize("name", ["FFTRotH", "RotH", "RotLH", "AttRH"])
def test_shards_of_one_group_equal_single_device_on_any_filter_ids(data, name, backend,
                                                                    precision, m):
    """A device's fused ranker is the shard that holds every row: one shard
    of Mesh((1, 1), 0) (m = 1) run through run_shards equals
    make_best_ranker bit for bit, and so do two, on filter rows that hold
    ids no row owns and a duplicate."""
    tdata, _ = data
    tm = build(data, name, dtype="float32" if precision == "default" else "float64")[2]
    single = make_best_ranker(tm, 64, backend, precision=precision)
    rankers = shards(tm, m, backend, precision)
    assert [r.masked for r in rankers] == [backend == "auto"] * m
    for q, f, _ in packs(tdata):
        f = bad_filter_ids(f)
        np.testing.assert_array_equal(run_shards(rankers, q, f).numpy(), single(q, f).numpy())


@pytest.mark.parametrize("name", ["FFTRotH", "RotH", "RotLH", "AttRH"])
def test_kernel_inputs_mask_is_the_clamp_and_scatter_of_all_rows(data, name):
    """A device's mask over ids in and out of range: the ids outside [0,
    Np) sent to pad row N, then the pad rows and the scattered ids set."""
    tdata, _ = data
    tm = build(data, name)[2]
    ranker = make_best_ranker(tm, 64, "auto")
    for q, f, _ in packs(tdata):
        f = bad_filter_ids(f)
        mask = ranker.kernel_inputs(q, f)["mask"]
        np_ = ranker._get_tables()[0].shape[0]
        ids = torch.where((f >= 0) & (f < np_), f, torch.full_like(f, N_ENT))
        want = torch.zeros((q.shape[0], np_), dtype=torch.int8)
        want[:, N_ENT:] = 1
        want.scatter_(1, ids, 1)
        assert torch.equal(mask, want)
