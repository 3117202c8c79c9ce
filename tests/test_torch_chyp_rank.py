"""The chyp_rank kernels' plain versions and ChypRanker against the JAX
Pallas kernels (interpret mode) and PallasChypRanker, in float32.

Tolerance: the two sides sum the Hermitian form in different orders, so a
query's count may differ by at most the number of entities whose plain
score lies within 1e-5 * (1 + |t2|) of its threshold t2.  Filtered MRR
agrees within 1e-4.  The kernel-vs-plain tests, which need a CUDA card and
no JAX, are in test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.kernels import chyp_rank as K
from complexhyperbolickge_torch.models import ModelConfig, get_model
from complexhyperbolickge_torch.train import evaluate as TEV
from complexhyperbolickge_torch.train.checkpoint import params_from_jax
from complexhyperbolickge_tpu.kernels.chyp_rank import (
    PallasChypRanker,
    chyp_rank_counts as jax_counts,
    chyp_rank_counts_nomask as jax_counts_nomask,
)
from complexhyperbolickge_tpu.data.dataset import synthetic_kg as jax_synthetic_kg
from complexhyperbolickge_tpu.models import ModelConfig as JaxConfig
from complexhyperbolickge_tpu.models import get_model as jax_get_model
from complexhyperbolickge_tpu.train import evaluate as JEV

N, B, L, RANK = 300, 48, 6, 9
D = 2 * RANK
NP = 512  # the JAX kernel's tile_n divides its padded table


def _near(scores, t2):
    """Per query: entities whose plain score is within float rounding of t2."""
    tol = 1e-5 * (1.0 + t2.abs())
    return ((scores - t2[:, None]).abs() <= tol[:, None]).sum(1)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    lhs = rng.normal(0, 0.15, (B, D)).astype(np.float32)
    ent = rng.normal(0, 0.15, (N, D)).astype(np.float32)
    bt = rng.normal(0, 0.3, N).astype(np.float32)
    gold = rng.integers(0, N, B)
    fidx = np.full((B, L), N, np.int32)
    for i in range(B):
        others = rng.choice(np.setdiff1d(np.arange(N), [gold[i]]), rng.integers(0, L), False)
        fidx[i, :len(others)] = others
        fidx[i, len(others)] = gold[i]

    rhs = np.zeros((NP, D), np.float32)
    rhs[:N] = ent
    bt_p = np.full(NP, -1e30, np.float32)
    bt_p[:N] = bt
    lhs2 = np.concatenate([lhs, np.concatenate([lhs[:, RANK:], -lhs[:, :RANK]], 1)])
    eps = 4e-3
    zn = np.clip((lhs * lhs).sum(1) - 1.0, -1.0, -eps).astype(np.float32)
    t = dict(lhs2=torch.as_tensor(lhs2), zn=torch.as_tensor(zn),
             rhs=torch.as_tensor(rhs), bt=torch.as_tensor(bt_p))
    t["wn"] = (torch.sum(t["rhs"] ** 2, -1) - 1.0).clamp(-1.0, -eps)
    scores = K.chyp_scores_plain(t["lhs2"], t["zn"], t["rhs"], t["wn"], t["bt"])
    # thresholds at each query's gold score: a realistic, tie-prone target
    t["t2"] = scores[torch.arange(B), torch.as_tensor(gold)].contiguous()
    t["scores"] = scores
    t["gold"] = torch.as_tensor(gold, dtype=torch.int32)
    t["fidx"] = torch.as_tensor(fidx)
    mask = np.zeros((B, NP), np.int8)
    mask[:, N:] = 1
    np.put_along_axis(mask, np.minimum(fidx, NP - 1).astype(np.int64), 1, axis=1)
    t["mask"] = torch.as_tensor(mask)

    dp = 128
    j = dict(
        lhs2=jnp.zeros((2 * B, dp), jnp.float32).at[:, :D].set(lhs2),
        zn=jnp.asarray(zn)[:, None], t2=jnp.asarray(t["t2"].numpy())[:, None],
        rhs=jnp.zeros((NP, dp), jnp.float32).at[:, :D].set(rhs),
        bt=jnp.asarray(bt_p)[None, :], mask=jnp.asarray(mask),
        fidx=jnp.asarray(fidx), gold=jnp.asarray(gold, jnp.int32),
    )
    return t, j


def test_plain_masked_matches_pallas_interpret(inputs):
    t, j = inputs
    want = np.asarray(jax_counts(j["lhs2"], j["zn"], j["t2"], j["rhs"], j["bt"],
                                 j["mask"], tile_n=NP, interpret=True))
    got = K.chyp_rank_counts(t["lhs2"], t["zn"], t["t2"], t["rhs"], t["wn"],
                             t["bt"], t["mask"])
    assert got.dtype == torch.int32 and got.shape == (B,)
    near = _near(t["scores"], t["t2"]).numpy()
    assert (np.abs(got.numpy() - want) <= near).all()
    assert got.sum() > 0  # thresholds sit inside the score range


def test_plain_nomask_matches_pallas_interpret(inputs):
    t, j = inputs
    want = np.asarray(jax_counts_nomask(
        j["lhs2"], j["zn"], j["t2"], j["rhs"], j["bt"], j["fidx"], None,
        j["gold"], tile_n=NP, interpret=True))
    got = K.chyp_rank_counts_nomask(t["lhs2"], t["zn"], t["t2"], t["rhs"],
                                    t["wn"], t["bt"], t["fidx"], t["gold"])
    near = _near(t["scores"], t["t2"]).numpy()
    assert (np.abs(got.numpy() - want) <= near).all()


def test_plain_nomask_equals_masked_up_to_ties(inputs):
    """With the gold filtered, sweep - subtraction == masked count, up to
    the near-threshold entities (the plain forms sum in two orders)."""
    t, _ = inputs
    masked = K.chyp_rank_counts(t["lhs2"], t["zn"], t["t2"], t["rhs"], t["wn"],
                                t["bt"], t["mask"])
    nomask = K.chyp_rank_counts_nomask(t["lhs2"], t["zn"], t["t2"], t["rhs"],
                                       t["wn"], t["bt"], t["fidx"], t["gold"])
    assert ((masked - nomask).abs() <= _near(t["scores"], t["t2"])).all()


def test_plain_filtered_sub_skips_gold_pad_and_out_of_range(inputs):
    t, _ = inputs
    fidx = t["fidx"].clone()
    fidx[:, -1] = -3  # out of range: skipped, never wrapped
    sub = K.chyp_rank_filtered_sub(t["lhs2"], t["zn"], t["t2"], t["rhs"],
                                   t["wn"], t["bt"], fidx, t["gold"])
    hit = torch.gather(t["scores"], 1, fidx.long().clamp(0, NP - 1)) >= t["t2"][:, None]
    ok = (fidx >= 0) & (fidx < NP) & (fidx != t["gold"][:, None])
    assert ((sub - (hit & ok).sum(1)).abs() <= _near(t["scores"], t["t2"])).all()


PLAIN = {
    "masked": (K.chyp_rank_counts_plain, ("mask",)),
    "nomask": (K.chyp_rank_sweep_nomask_plain, ("gold",)),
    "filtered_sub": (K.chyp_rank_filtered_sub_plain, ("fidx", "gold")),
}


@pytest.mark.parametrize("kernel", sorted(PLAIN))
def test_plain_counts_equal_on_padded_table(inputs, kernel):
    """The plain versions contract over the table's first D columns only: a
    table whose rows are padded (D = 18 in rows of 20, with garbage in the
    pad columns) gives the counts of the unpadded one, bit for bit."""
    t, _ = inputs
    fn, extra = PLAIN[kernel]
    padded = torch.cat([t["rhs"], torch.full((NP, 2), 7.0)], 1)
    args = [t[k] for k in ("lhs2", "zn", "t2")]
    tail = [t["wn"], t["bt"], *[t[k] for k in extra]]
    want = fn(*args, t["rhs"], *tail)
    assert torch.equal(fn(*args, padded, *tail), want)
    assert want.sum() > 0


def test_wrappers_refuse_non_cpu_non_cuda_tensors(inputs):
    """No fallback: a tensor on neither the CPU nor a CUDA card raises."""
    t, _ = inputs
    meta = {k: v.to("meta") for k, v in t.items()}
    with pytest.raises(ValueError, match="CPU or CUDA"):
        K.chyp_rank_counts(meta["lhs2"], meta["zn"], meta["t2"], meta["rhs"],
                           meta["wn"], meta["bt"], meta["mask"])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        K.chyp_rank_counts_nomask(meta["lhs2"], meta["zn"], meta["t2"], meta["rhs"],
                                  meta["wn"], meta["bt"], meta["fidx"], meta["gold"])


# ------------------------------ ranker vs JAX ---------------------------------


@pytest.fixture(scope="module")
def kg_pair():
    data = jax_synthetic_kg(n_entities=N, n_train=1500, n_valid=120, n_test=120, seed=3)
    cfg = dict(n_entities=data.n_entities, n_relations=data.n_predicates, rank=RANK,
               bias="learn", multi_c=True, dtype="float32")
    jm = jax_get_model("FFTRotH")(JaxConfig(**cfg))
    rng = np.random.default_rng(5)
    shapes = {k: np.shape(v) for k, v in jm.init(jax.random.PRNGKey(0)).items()}
    npp = {k: (rng.normal(0, 0.1, s) + (1.0 if k == "c" else 0.0)).astype(np.float32)
           for k, s in shapes.items()}
    tm = get_model("FFTRotH")(ModelConfig(**cfg))
    tm.load_state_dict(params_from_jax(npp, "cpu"))
    from complexhyperbolickge_torch.data.dataset import synthetic_kg

    tdata = synthetic_kg(n_entities=N, n_train=1500, n_valid=120, n_test=120, seed=3)
    return data, jm, {k: jnp.asarray(v) for k, v in npp.items()}, tdata, tm


def _near_ranker(ranker, q, fidx):
    tables = ranker._get_tables()
    rhs, bt, wn = tables
    lhs2, zn, t2 = ranker._queries_core(q, tables)
    return _near(K.chyp_scores_plain(lhs2, zn, rhs, wn, bt), t2)


@pytest.mark.parametrize("masked", [True, False])
def test_chyp_ranker_matches_pallas_ranker(kg_pair, masked):
    data, jm, jp, tdata, tm = kg_pair
    jr = PallasChypRanker(jm, 64, interpret=True, masked=masked)
    tr = K.ChypRanker(tm, masked=masked)
    for direction in ("rhs", "lhs"):
        pack = tdata.eval_pack("test", direction)
        want = JEV.get_ranking(jm, jp, data.eval_pack("test", direction), 64, rank_fn=jr)
        got = TEV.get_ranking(tm, pack, 64, rank_fn=tr)
        q = torch.as_tensor(pack.queries, dtype=torch.int64)
        f = torch.as_tensor(pack.filter_idx, dtype=torch.int64)
        near = _near_ranker(tr, q, f).numpy()
        assert got.dtype == np.float32
        assert (np.abs(got - want) <= near).all()
        assert abs(np.mean(1 / got) - np.mean(1 / want)) < 1e-4


@pytest.mark.parametrize("name,bias", [("FFTRefH", "none"), ("FFTAttH", "constant"),
                                       ("FFTIsoH", "learn")])
def test_chyp_ranker_matches_dense_across_fft_models(kg_pair, name, bias):
    """Every FFT model and bias mode ranks alike through the fused ranker
    (both forms) and the dense ranker, up to near-threshold ties."""
    tdata = kg_pair[3]
    cfg = ModelConfig(n_entities=tdata.n_entities, n_relations=tdata.n_predicates,
                      rank=8, bias=bias, gamma=0.7, multi_c=True)
    model = get_model(name)(cfg, generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(6)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.as_tensor(rng.normal(0, 0.1, p.shape)) + (1.0 if p is model.c else 0.0))
    pack = tdata.eval_pack("test", "rhs")
    q = torch.as_tensor(pack.queries, dtype=torch.int64)
    f = torch.as_tensor(pack.filter_idx, dtype=torch.int64)
    dense = TEV.get_ranking(model, pack, 64, rank_fn=TEV.make_ranker(model))
    for masked in (True, False):
        ranker = K.ChypRanker(model, masked=masked)
        got = TEV.get_ranking(model, pack, 64, rank_fn=ranker)
        assert (np.abs(got - dense) <= _near_ranker(ranker, q, f).numpy()).all()
        assert abs(np.mean(1 / got) - np.mean(1 / dense)) < 1e-4


@pytest.mark.parametrize("rank", [RANK, 33])
def test_chyp_ranker_pads_table_rows(kg_pair, rank):
    """The ranker's table: rows padded with zeros to a multiple of 4 floats
    (D = 18 -> 20; the main path's D = 66 -> 68), pad rows zero, and wn
    bit-equal to the unpadded rows' computation."""
    tdata = kg_pair[3]
    cfg = ModelConfig(n_entities=tdata.n_entities, n_relations=tdata.n_predicates, rank=rank,
                      bias="learn", multi_c=True)
    model = get_model("FFTRotH")(cfg, generator=torch.Generator().manual_seed(2))
    rhs, bt, wn = K.ChypRanker(model)._get_tables()
    n, d = model.entity.shape
    np_ = -(-(n + 1) // 128) * 128
    assert rhs.shape == (np_, -(-d // 4) * 4) and rhs.is_contiguous()
    assert rhs.shape[1] > d and rhs.data_ptr() % 16 == 0
    assert torch.equal(rhs[:n, :d], model.entity.detach())
    assert not rhs[n:].any() and not rhs[:, d:].any()
    rows = torch.zeros((np_, d))
    rows[:n] = model.entity.detach()
    want = (torch.sum(rows * rows, dim=-1) - 1.0).clamp(-1.0, -K._EPS)
    assert torch.equal(wn, want)
    assert bt.shape == (np_,) and (bt[n:] == -1e30).all()


def test_chyp_ranker_maskless_gold_not_filtered_adds_one(kg_pair):
    """A gold outside the filter list counts +1, as the dense path does."""
    _, _, _, tdata, tm = kg_pair
    pack = tdata.eval_pack("test", "rhs")
    q = torch.as_tensor(pack.queries[:16], dtype=torch.int64)
    f = torch.as_tensor(pack.filter_idx[:16], dtype=torch.int64)
    f_nogold = torch.where(f == q[:, 2:3], torch.full_like(f, tdata.n_entities), f)
    ranker = K.ChypRanker(tm, masked=False)
    diff = ranker(q, f_nogold) - ranker(q, f)
    assert torch.equal(diff, torch.ones_like(diff))


def test_chyp_ranker_tables_follow_in_place_updates(kg_pair):
    """The table cache keys on the parameter objects AND their _version: an
    in-place update is never served stale."""
    _, _, _, tdata, tm = kg_pair
    model = get_model("FFTRotH")(tm.cfg)
    model.load_state_dict(tm.state_dict())
    pack = tdata.eval_pack("test", "rhs")
    q = torch.as_tensor(pack.queries, dtype=torch.int64)
    f = torch.as_tensor(pack.filter_idx, dtype=torch.int64)
    ranker = K.ChypRanker(model)
    before = ranker(q, f)
    tables = ranker._tables
    with torch.no_grad():
        model.entity.mul_(1.7)
        model.bt.add_(0.3)
    after = ranker(q, f)
    assert ranker._tables is not tables
    torch.testing.assert_close(after, K.ChypRanker(model)(q, f), rtol=0, atol=0)
    assert not torch.equal(before, after)


def test_ranker_nan_discipline(kg_pair):
    """NaN params give NaN ranks (t2 * 0) and get_ranking refuses them."""
    _, _, _, tdata, tm = kg_pair
    model = get_model("FFTRotH")(tm.cfg)
    model.load_state_dict(tm.state_dict())
    with torch.no_grad():
        model.entity[0] = float("nan")
    pack = tdata.eval_pack("test", "rhs")
    with pytest.raises(FloatingPointError):
        TEV.get_ranking(model, pack, 64, rank_fn=K.ChypRanker(model))
