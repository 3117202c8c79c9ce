"""The hyp_rank kernels' plain versions and HypRanker / AttRHRanker against
the JAX Pallas kernels (interpret mode) and the JAX rankers, in float32.

Tolerance: the two sides sum <x, v> in different orders, so a query's
count may differ by at most the number of entities whose plain score lies
within 1e-5 * (1 + |t2|) of its threshold t2.  Filtered MRR agrees within
1e-4.  The kernel-vs-plain tests, which need a CUDA card and no JAX, are in
test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.data.dataset import synthetic_kg
from complexhyperbolickge_torch.kernels import hyp_rank as K
from complexhyperbolickge_torch.kernels.chyp_rank import ChypRanker
from complexhyperbolickge_torch.models import ModelConfig, get_model
from complexhyperbolickge_torch.train import evaluate as TEV
from complexhyperbolickge_torch.train.checkpoint import params_from_jax
from complexhyperbolickge_tpu.data.dataset import synthetic_kg as jax_synthetic_kg
from complexhyperbolickge_tpu.kernels import hyp_rank as JK
from complexhyperbolickge_tpu.models import ModelConfig as JaxConfig
from complexhyperbolickge_tpu.models import get_model as jax_get_model
from complexhyperbolickge_tpu.train import evaluate as JEV

N, B, L, D = 300, 48, 6, 8
NP = 512  # the JAX kernel's tile_n divides its padded table
DP = 128  # the JAX kernel's lane-padded feature width
KINDS = ["poincare", "lorentz", "attrh"]
PER_QUERY = {"hyp": ("x2", "c", "t2"), "attrh": ("x2r", "x2f", "c", "w0", "w1", "t2")}
PER_ROW = {"hyp": ("un", "bt"), "attrh": ("un_rot", "un_ref", "bt")}


def _near(scores, t2):
    """Per query: entities whose plain score is within float rounding of t2."""
    tol = 1e-5 * (1.0 + t2.abs())
    return ((scores - t2[:, None]).abs() <= tol[:, None]).sum(1)


def _pad(a, rows, cols):
    return jnp.zeros((rows, cols), jnp.float32).at[: a.shape[0], : a.shape[1]].set(a)


def _norm(rows):
    return torch.sqrt(torch.sum(rows * rows, -1).clamp_min(1e-30))


@pytest.fixture(scope="module", params=KINDS)
def inputs(request):
    """Kernel inputs of one family on the CPU (t) and for the JAX kernels
    (j): thresholds at each query's gold score, filter rows holding the gold
    once, pad = N."""
    kind = request.param
    rng = np.random.default_rng(KINDS.index(kind))
    lhs = rng.normal(0, 0.2, (B, D)).astype(np.float32)
    rhs = np.zeros((NP, D), np.float32)
    rhs[:N] = rng.normal(0, 0.4, (N, D))
    bt = np.full(NP, -1e30, np.float32)
    bt[:N] = rng.normal(0, 0.3, N)
    gold = rng.integers(0, N, B)
    fidx = np.full((B, L), N, np.int32)
    for i in range(B):
        others = rng.choice(np.setdiff1d(np.arange(N), [gold[i]]), rng.integers(0, L), False)
        fidx[i, :len(others)] = others
        fidx[i, len(others)] = gold[i]
    mask = np.zeros((B, NP), np.int8)
    mask[:, N:] = 1
    np.put_along_axis(mask, fidx.astype(np.int64), 1, axis=1)
    c = rng.uniform(0.5, 1.5, B).astype(np.float32)

    t = dict(lhs=torch.as_tensor(lhs), rhs=torch.as_tensor(rhs), bt=torch.as_tensor(bt),
             c=torch.as_tensor(c), gold=torch.as_tensor(gold, dtype=torch.int32),
             fidx=torch.as_tensor(fidx), mask=torch.as_tensor(mask))
    j = dict(bt=jnp.asarray(bt)[None, :], c=jnp.asarray(c)[:, None], mask=jnp.asarray(mask),
             fidx=jnp.asarray(fidx), gold=jnp.asarray(gold, jnp.int32))
    h = D // 2
    if kind == "attrh":
        t["x2r"] = torch.sum(t["lhs"][:, :h] ** 2, -1)
        t["x2f"] = torch.sum(t["lhs"][:, h:] ** 2, -1)
        w = torch.softmax(torch.as_tensor(rng.normal(0, 1, (B, 2)), dtype=torch.float32), -1)
        t["w0"], t["w1"] = w[:, 0].contiguous(), w[:, 1].contiguous()
        t["un_rot"], t["un_ref"] = _norm(t["rhs"][:, :h]), _norm(t["rhs"][:, h:])
        scores = K.attrh_scores_plain(*(t[k] for k in ("lhs", "x2r", "x2f", "c", "w0", "w1",
                                                       "rhs", "un_rot", "un_ref", "bt")))
        j.update(lrot=_pad(lhs[:, :h], B, DP), lref=_pad(lhs[:, h:], B, DP),
                 rrot=_pad(rhs[:, :h], NP, DP), rref=_pad(rhs[:, h:], NP, DP),
                 **{k: jnp.asarray(t[k].numpy())[:, None] for k in ("x2r", "x2f", "w0", "w1")})
    else:
        t["x2"] = torch.sum(t["lhs"] ** 2, -1)
        t["un"] = _norm(t["rhs"])
        scores = K.hyp_scores_plain(t["lhs"], t["x2"], t["c"], t["rhs"], t["un"], t["bt"], kind)
        j.update(lhs=_pad(lhs, B, DP), rhs=_pad(rhs, NP, DP),
                 x2=jnp.asarray(t["x2"].numpy())[:, None])
    t["t2"] = scores[torch.arange(B), torch.as_tensor(gold)].contiguous()
    j["t2"] = jnp.asarray(t["t2"].numpy())[:, None]
    return kind, t, j, scores


def _args(kind, t):
    g = "attrh" if kind == "attrh" else "hyp"
    return [t["lhs"], *(t[k] for k in PER_QUERY[g]), t["rhs"], *(t[k] for k in PER_ROW[g])]


def _tabled(kind, fn, cid=None):
    """A sweep wrapper (K5-K8, or the maskless count) or its plain version,
    called with the subtractions' inputs (c in place of cid, cvals and
    radii) and then its own extra inputs: by default each query its own
    curvature, cid = arange(B), cvals = c, the radius table from its plain
    version."""
    fam = {} if kind == "attrh" else dict(family=kind)

    def call(lhs, *rest):
        if kind == "attrh":
            (x2r, x2f, c, w0, w1, t2, rhs, un_rot, un_ref, bt), extra = rest[:10], rest[10:]
            radii = K.hyp_rank_radii_plain(c, un_rot, "attrh", un_ref)
            pre, post = (x2r, x2f), (w0, w1, t2, rhs, un_rot, un_ref, bt, radii)
        else:
            (x2, c, t2, rhs, un, bt), extra = rest[:6], rest[6:]
            radii = K.hyp_rank_radii_plain(c, un, kind)
            pre, post = (x2,), (t2, rhs, un, bt, radii)
        ids = torch.arange(len(c), dtype=torch.int32, device=c.device) if cid is None else cid
        return fn(lhs, *pre, ids, c, *post, *extra, **fam)
    return call


def _fns(kind, cid=None):
    """(masked, sweep, filtered_sub, maskless) wrappers of the family, each
    called with the subtractions' inputs and its own extras."""
    if kind == "attrh":
        return (_tabled(kind, K.attrh_rank_counts, cid),
                _tabled(kind, K.attrh_rank_sweep_nomask, cid), K.attrh_rank_filtered_sub,
                _tabled(kind, K.attrh_rank_counts_nomask, cid))
    return (_tabled(kind, K.hyp_rank_counts, cid), _tabled(kind, K.hyp_rank_sweep_nomask, cid),
            lambda *a: K.hyp_rank_filtered_sub(*a, family=kind),
            _tabled(kind, K.hyp_rank_counts_nomask, cid))


def _jax_counts(kind, j, masked):
    if kind == "attrh":
        a = (j["lrot"], j["lref"], j["x2r"], j["x2f"], j["c"], j["w0"], j["w1"], j["t2"],
             j["rrot"], j["rref"], j["bt"])
        if masked:
            return JK.attrh_rank_counts(*a, j["mask"], tile_n=NP, interpret=True)
        return JK.attrh_rank_counts_nomask(*a, j["fidx"], None, j["gold"], tile_n=NP,
                                           interpret=True)
    a = (j["lhs"], j["x2"], j["c"], j["t2"], j["rhs"], j["bt"])
    if masked:
        return JK.hyp_rank_counts(*a, j["mask"], tile_n=NP, interpret=True, family=kind)
    return JK.hyp_rank_counts_nomask(*a, j["fidx"], None, j["gold"], tile_n=NP,
                                     interpret=True, family=kind)


@pytest.mark.parametrize("masked", [True, False])
def test_plain_matches_pallas_interpret(inputs, masked):
    kind, t, j, scores = inputs
    want = np.asarray(_jax_counts(kind, j, masked))
    masked_fn, _, _, maskless_fn = _fns(kind)
    got = (masked_fn(*_args(kind, t), t["mask"]) if masked
           else maskless_fn(*_args(kind, t), t["fidx"], t["gold"]))
    assert got.dtype == torch.int32 and got.shape == (B,)
    near = _near(scores, t["t2"]).numpy()
    assert (np.abs(got.numpy() - want) <= near).all()
    assert got.sum() > 0  # thresholds sit inside the score range


def test_plain_nomask_gold_minus_one_and_bad_cid_match_pallas_interpret(inputs):
    """The maskless plain versions with gold = -1 (every row counts, the
    gold's filter slot is subtracted) and a cid outside [0, n_c) (a NaN
    curvature: the query counts 0) against the JAX maskless kernel given
    gold -1 and c = NaN for those queries."""
    kind, t, j, scores = inputs
    gold = t["gold"].clone()
    gold[::3] = -1
    cid = torch.arange(B, dtype=torch.int32)
    bad = torch.zeros(B, dtype=torch.bool)
    bad[1::5] = True
    cid[1::10], cid[6::10] = B + 3, -1
    c_jax = np.where(bad.numpy(), np.nan, t["c"].numpy()).astype(np.float32)[:, None]
    want = np.asarray(_jax_counts(kind, {**j, "gold": jnp.asarray(gold.numpy()),
                                         "c": jnp.asarray(c_jax)}, masked=False))
    got = _fns(kind, cid)[3](*_args(kind, t), t["fidx"], gold)
    assert got.dtype == torch.int32 and got.shape == (B,)
    assert (got[bad] == 0).all() and (want[bad.numpy()] == 0).all()
    assert (np.abs(got.numpy() - want) <= _near(scores, t["t2"]).numpy()).all()
    # gold = -1: the gold row counts in the sweep and its filter slot is
    # subtracted, so the count matches the filtered one
    sweep = _fns(kind, cid)[1](*_args(kind, t), gold)
    keep = torch.arange(NP)[None, :] != gold[:, None].long()
    full = ((scores >= t["t2"][:, None]) & keep).sum(1, dtype=torch.int32)
    assert torch.equal(sweep[~bad], full[~bad]) and (sweep[bad] == 0).all()


def test_plain_nomask_equals_masked_up_to_ties(inputs):
    """With the gold filtered, sweep - subtraction == masked count, up to
    the near-threshold entities (the plain forms sum in two orders)."""
    kind, t, _, scores = inputs
    masked_fn, _, _, maskless_fn = _fns(kind)
    masked = masked_fn(*_args(kind, t), t["mask"])
    nomask = maskless_fn(*_args(kind, t), t["fidx"], t["gold"])
    assert ((masked - nomask).abs() <= _near(scores, t["t2"])).all()


def test_plain_sweep_counts_all_but_gold(inputs):
    kind, t, _, scores = inputs
    sweep = _fns(kind)[1](*_args(kind, t), t["gold"])
    keep = torch.arange(NP)[None, :] != t["gold"][:, None].long()
    assert torch.equal(sweep, ((scores >= t["t2"][:, None]) & keep).sum(1, dtype=torch.int32))


def test_plain_filtered_sub_skips_gold_pad_and_out_of_range(inputs):
    kind, t, _, scores = inputs
    fidx = t["fidx"].clone()
    fidx[:, -1] = -3  # out of range: skipped, never wrapped
    sub = _fns(kind)[2](*_args(kind, t), fidx, t["gold"])
    hit = torch.gather(scores, 1, fidx.long().clamp(0, NP - 1)) >= t["t2"][:, None]
    ok = (fidx >= 0) & (fidx < NP) & (fidx != t["gold"][:, None])
    assert ((sub - (hit & ok).sum(1)).abs() <= _near(scores, t["t2"])).all()


def test_pad_rows_never_count(inputs):
    """Zero pad rows have a finite distance; bt = -1e30 keeps them below
    every threshold in the sweep (the masked sweep masks them too)."""
    kind, t, _, scores = inputs
    assert torch.isfinite(scores[:, N:]).all() and (scores[:, N:] < -1e29).all()


def test_wrappers_refuse_non_cpu_non_cuda_tensors(inputs):
    """No fallback: a tensor on neither the CPU nor a CUDA card raises."""
    kind, t, _, _ = inputs
    meta = {k: v.to("meta") for k, v in t.items()}
    masked_fn, _, _, maskless_fn = _fns(kind)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        masked_fn(*_args(kind, meta), meta["mask"])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        maskless_fn(*_args(kind, meta), meta["fidx"], meta["gold"])


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="unknown hyp_rank family"):
        K._family("klein")


# ------------------------------ rankers vs JAX ---------------------------------


RANKS = {"AttRH": 8, "IFFTH": 6}


@pytest.fixture(scope="module")
def kgs():
    kg = dict(n_entities=N, n_train=1500, n_valid=120, n_test=120, seed=3)
    return synthetic_kg(**kg), jax_synthetic_kg(**kg)


def _model_pair(name, tdata, bias="learn", multi_c=True, seed=5):
    cfg = dict(n_entities=tdata.n_entities, n_relations=tdata.n_predicates,
               rank=RANKS.get(name, 8), bias=bias, gamma=0.7, multi_c=multi_c,
               dtype="float32")
    jm = jax_get_model(name)(JaxConfig(**cfg))
    rng = np.random.default_rng(seed)
    shapes = {k: np.shape(v) for k, v in jm.init(jax.random.PRNGKey(0)).items()}
    npp = {k: (rng.normal(0, 0.3, s) + (1.0 if k == "c" else 0.0)).astype(np.float32)
           for k, s in shapes.items()}
    if name == "HyboNet":  # its init's scale column: time^2 > 1 in _lorentz_linear
        npp["rel_diag"][:, -1] = 1.0
    tm = get_model(name)(ModelConfig(**cfg))
    tm.load_state_dict(params_from_jax(npp, "cpu"))
    return jm, {k: jnp.asarray(v) for k, v in npp.items()}, tm


def _near_ranker(ranker, q):
    """Near-threshold counts of a batch, from the plain all-entity scores."""
    tables = ranker._get_tables()
    x = dict(zip(ranker.TABLES, tables))
    x.update(zip(ranker.QUERIES, ranker._queries_core(q, tables)))
    if isinstance(ranker, K.AttRHRanker):
        s = K.attrh_scores_plain(*(x[k] for k in ("lhs", "x2r", "x2f", "c", "w0", "w1",
                                                  "rhs", "un_rot", "un_ref", "bt")))
    else:
        s = K.hyp_scores_plain(x["lhs"], x["x2"], x["c"], x["rhs"], x["un"], x["bt"],
                               ranker.family)
    return _near(s, x["t2"])


def _ranker(tm, masked):
    return (K.AttRHRanker if type(tm).__name__ == "AttRH" else K.HypRanker)(tm, masked=masked)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("name", ["RotH", "RotLH", "AttRH"])
def test_ranker_matches_pallas_ranker(kgs, name, masked):
    tdata, jdata = kgs
    jm, jp, tm = _model_pair(name, tdata)
    jr = (JK.PallasAttRHRanker if name == "AttRH" else JK.PallasHypRanker)(
        jm, 64, interpret=True, masked=masked)
    tr = _ranker(tm, masked)
    for direction in ("rhs", "lhs"):
        pack = tdata.eval_pack("test", direction)
        want = JEV.get_ranking(jm, jp, jdata.eval_pack("test", direction), 64, rank_fn=jr)
        got = TEV.get_ranking(tm, pack, 64, rank_fn=tr)
        near = torch.cat([_near_ranker(tr, torch.as_tensor(pack.queries[i:i + 64],
                                                            dtype=torch.int64))
                          for i in range(0, len(pack.queries), 64)]).numpy()
        assert got.dtype == np.float32
        assert (np.abs(got - want) <= near).all()
        assert abs(np.mean(1 / got) - np.mean(1 / want)) < 1e-4


@pytest.mark.parametrize("name,bias", [
    ("RotH", "none"), ("RefH", "learn"), ("AttH", "constant"), ("IsoH", "learn"),
    ("IFFTH", "learn"), ("RotLH", "constant"), ("HyboNet", "learn"), ("AttRH", "none")])
def test_ranker_matches_dense_across_models(kgs, name, bias):
    """Every hyperbolic model and bias mode ranks alike through the fused
    ranker (both forms) and the port's dense ranker, up to near-threshold
    ties; the two fused forms agree the same way."""
    tdata = kgs[0]
    _, _, tm = _model_pair(name, tdata, bias=bias, multi_c=name != "IFFTH", seed=6)
    pack = tdata.eval_pack("test", "rhs")
    q = torch.as_tensor(pack.queries, dtype=torch.int64)
    dense = TEV.get_ranking(tm, pack, len(q), rank_fn=TEV.make_ranker(tm))
    got = {}
    for masked in (True, False):
        ranker = _ranker(tm, masked)
        got[masked] = TEV.get_ranking(tm, pack, len(q), rank_fn=ranker)
        near = _near_ranker(ranker, q).numpy()
        assert (np.abs(got[masked] - dense) <= near).all()
        assert abs(np.mean(1 / got[masked]) - np.mean(1 / dense)) < 1e-4
    assert (np.abs(got[True] - got[False]) <= near).all()


@pytest.mark.parametrize("name", ["RotH", "RotLH", "AttRH"])
def test_maskless_gold_not_filtered_adds_one(kgs, name):
    """A gold outside the filter list counts +1, as the dense path does."""
    tdata = kgs[0]
    _, _, tm = _model_pair(name, tdata)
    pack = tdata.eval_pack("test", "rhs")
    q = torch.as_tensor(pack.queries[:16], dtype=torch.int64)
    f = torch.as_tensor(pack.filter_idx[:16], dtype=torch.int64)
    f_nogold = torch.where(f == q[:, 2:3], torch.full_like(f, tdata.n_entities), f)
    ranker = _ranker(tm, masked=False)
    diff = ranker(q, f_nogold) - ranker(q, f)
    assert torch.equal(diff, torch.ones_like(diff))
    dense = TEV.make_ranker(tm)
    assert torch.equal(dense(q, f_nogold) - dense(q, f), diff)


@pytest.mark.parametrize("n", [127, 128, 200])
def test_padded_tables(kgs, n):
    """Tables pad to round_up(n + 1, 128) with zero rows, un at the
    MIN_NORM floor and bt = -1e30 there; ranks stay within [1, n]."""
    cfg = ModelConfig(n_entities=n, n_relations=4, rank=8, bias="learn", multi_c=True)
    for name in ("RotH", "AttRH"):
        tm = get_model(name)(cfg, generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            tm.entity.normal_(0, 0.3, generator=torch.Generator().manual_seed(1))
        ranker = _ranker(tm, masked=False)
        tables = dict(zip(ranker.TABLES, ranker._get_tables()))
        np_ = -(-(n + 1) // 128) * 128
        assert tables["rhs"].shape == (np_, 8) and (tables["rhs"][n:] == 0).all()
        assert (tables["bt"][n:] == -1e30).all()
        for k in ranker.TABLES:
            if k.startswith("un"):
                assert torch.equal(tables[k][n:], torch.full((np_ - n,), 1e-15))
        q = torch.stack([torch.arange(8), torch.arange(8) % 4, (torch.arange(8) * 7) % n], 1)
        f = torch.full((8, 3), n, dtype=torch.int64)
        for masked in (True, False):
            r = _ranker(tm, masked)(q, f)
            assert ((r >= 1) & (r <= n)).all()


@pytest.mark.parametrize("backend,masked", [("auto", True), ("pallas", True),
                                            ("pallas_maskless", False)])
def test_best_ranker_dispatch(kgs, backend, masked):
    """AttRH takes AttRHRanker (tested before BaseH, which it subclasses),
    the rest of BaseH the Poincare HypRanker, BaseLorentz the Lorentz one;
    'dense' takes the materializing ranker."""
    tdata = kgs[0]
    want = {"RotH": "poincare", "RefH": "poincare", "AttH": "poincare", "IsoH": "poincare",
            "IFFTH": "poincare", "RotLH": "lorentz", "HyboNet": "lorentz", "AttRH": None}
    for name, family in want.items():
        tm = _model_pair(name, tdata)[2]
        r = TEV.make_best_ranker(tm, 64, backend)
        kind = K.AttRHRanker if family is None else K.HypRanker
        assert type(r) is kind and r.masked is masked, name
        assert getattr(r, "family", None) == family, name
        d = TEV.make_best_ranker(tm, 64, "dense")
        assert not isinstance(d, (K.HypRanker, K.AttRHRanker, ChypRanker)), name


def test_rankers_refuse_other_families(kgs):
    tdata = kgs[0]
    roth, attrh = _model_pair("RotH", tdata)[2], _model_pair("AttRH", tdata)[2]
    with pytest.raises(TypeError, match="HypRanker"):
        K.HypRanker(attrh)
    with pytest.raises(TypeError, match="AttRHRanker"):
        K.AttRHRanker(roth)


def test_ranker_tables_follow_in_place_updates(kgs):
    """The table cache keys on the parameter objects AND their _version."""
    tdata = kgs[0]
    tm = _model_pair("RotLH", tdata)[2]
    pack = tdata.eval_pack("test", "rhs")
    q = torch.as_tensor(pack.queries, dtype=torch.int64)
    f = torch.as_tensor(pack.filter_idx, dtype=torch.int64)
    ranker = K.HypRanker(tm)
    before = ranker(q, f)
    tables = ranker._tables
    with torch.no_grad():
        tm.entity.mul_(1.7)
        tm.bt.add_(0.3)
    after = ranker(q, f)
    assert ranker._tables is not tables
    torch.testing.assert_close(after, K.HypRanker(tm)(q, f), rtol=0, atol=0)
    assert not torch.equal(before, after)


@pytest.mark.parametrize("name", ["RotH", "AttRH"])
def test_ranker_nan_discipline(kgs, name):
    """NaN params give NaN ranks (t2 * 0) and get_ranking refuses them."""
    tdata = kgs[0]
    tm = _model_pair(name, tdata)[2]
    with torch.no_grad():
        tm.entity[tdata.eval_pack("test", "rhs").queries[0, 2]] = float("nan")
    pack = tdata.eval_pack("test", "rhs")
    ranks = _ranker(tm, True)(torch.as_tensor(pack.queries, dtype=torch.int64),
                              torch.as_tensor(pack.filter_idx, dtype=torch.int64))
    assert torch.isnan(ranks).any()
    with pytest.raises(FloatingPointError):
        TEV.get_ranking(tm, pack, 64, rank_fn=_ranker(tm, True))


# ------------------------- radius tables and curvatures -------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_radii_plain_equals_inline(kind, monkeypatch):
    """The radius table holds, bit for bit in float32, the radius part that
    the plain K5/K7 compute inline for a query of curvature cvals[cid]
    (captured from their all-entity scores), and the ball distance's
    products as _ball_dist associates them."""
    rng = np.random.default_rng(11)
    n_c, b = 5, 12
    cvals = torch.as_tensor(rng.uniform(0.3, 2.0, n_c), dtype=torch.float32)
    cid = torch.as_tensor(rng.integers(0, n_c, b), dtype=torch.int32)
    rhs = torch.as_tensor(rng.normal(0, 0.6, (NP, D)), dtype=torch.float32)
    lhs = torch.as_tensor(rng.normal(0, 0.2, (b, D)), dtype=torch.float32)
    bt = torch.zeros(NP)
    c = cvals[cid.long()]
    seen = []
    if kind == "lorentz":
        inner = K._lorentz_radius
        monkeypatch.setattr(K, "_lorentz_radius", lambda *a: seen.append(inner(*a)) or seen[-1])
        K.hyp_scores_plain(lhs, torch.sum(lhs * lhs, -1), c, rhs, _norm(rhs), bt, kind)
        table = K.hyp_rank_radii_plain(cvals, _norm(rhs), kind)[cid.long()]
        assert torch.equal(table[..., 0], seen[0][0]) and torch.equal(table[..., 1], seen[0][1])
        return
    inner = K._ball_dist
    monkeypatch.setattr(K, "_ball_dist",
                        lambda xv, gamma, *a: seen.append(gamma) or inner(xv, gamma, *a))
    h = D // 2
    if kind == "attrh":
        un_rot, un_ref = _norm(rhs[:, :h]), _norm(rhs[:, h:])
        w = torch.full((b,), 0.5)
        K.attrh_scores_plain(lhs, torch.sum(lhs[:, :h] ** 2, -1), torch.sum(lhs[:, h:] ** 2, -1),
                             c, w, w, rhs, un_rot, un_ref, bt)
        table = K.hyp_rank_radii_plain(cvals, un_rot, kind, un_ref)[cid.long()]
        assert table.shape == (b, NP, 2)
        assert torch.equal(table[..., 0], seen[0]) and torch.equal(table[..., 1], seen[1])
        return
    K.hyp_scores_plain(lhs, torch.sum(lhs * lhs, -1), c, rhs, _norm(rhs), bt, kind)
    table = K.hyp_rank_radii_plain(cvals, _norm(rhs), kind)[cid.long()]
    g, cc = seen[0], c[:, None]
    assert table.shape == (b, NP, 4)
    for i, want in enumerate((g, 2.0 * cc * g, cc * g * g, cc * cc * g * g)):
        assert torch.equal(table[..., i], want), i


@pytest.mark.parametrize("multi_c", [True, False])
@pytest.mark.parametrize("name", ["RotH", "RefH", "AttH", "IsoH", "IFFTH", "RotLH",
                                  "HyboNet", "AttRH"])
def test_ranker_curvature_ids_match_get_queries(kgs, name, multi_c):
    """The kernels' curvature cvals[cid] is, bit for bit, the curvature
    get_queries used, with and without multi_c."""
    tdata = kgs[0]
    _, _, tm = _model_pair(name, tdata, multi_c=multi_c, seed=7)
    pack = tdata.eval_pack("test", "rhs")
    q = torch.as_tensor(pack.queries, dtype=torch.int64)
    ranker = _ranker(tm, masked=True)
    x = ranker.kernel_inputs(q, torch.as_tensor(pack.filter_idx, dtype=torch.int64))
    assert x["cvals"].shape == (tdata.n_predicates if multi_c else 1,)
    assert x["cid"].dtype == torch.int32 and x["cid"].shape == (len(q),)
    c = tm.get_queries(q[:, :2])[0][1].to(torch.float32).expand(len(q), 1)[:, 0]
    assert torch.equal(x["c"], c)
    assert torch.equal(x["cvals"][x["cid"].long()], c)
    assert x["radii"].shape == (len(x["cvals"]), x["rhs"].shape[0],
                                2 if name in ("RotLH", "HyboNet", "AttRH") else 4)


@pytest.mark.parametrize("name", ["RotH", "RotLH", "AttRH"])
def test_ranker_tables_follow_curvature_updates(kgs, name):
    """An in-place change to the curvatures alone rebuilds cvals and the
    radius table."""
    tdata = kgs[0]
    tm = _model_pair(name, tdata)[2]
    pack = tdata.eval_pack("test", "rhs")
    q = torch.as_tensor(pack.queries, dtype=torch.int64)
    f = torch.as_tensor(pack.filter_idx, dtype=torch.int64)
    ranker = _ranker(tm, masked=True)
    ranker(q, f)
    tables = ranker._tables
    with torch.no_grad():
        tm.c.mul_(0.5)
    after = ranker(q, f)
    assert ranker._tables is not tables
    new = dict(zip(ranker.TABLES, ranker._tables))
    old = dict(zip(ranker.TABLES, tables))
    assert not torch.equal(new["cvals"], old["cvals"])
    assert not torch.equal(new["radii"], old["radii"])
    assert torch.equal(new["rhs"], old["rhs"])
    torch.testing.assert_close(after, _ranker(tm, masked=True)(q, f), rtol=0, atol=0)


@pytest.mark.parametrize("name", ["RotH", "RotLH", "AttRH"])
def test_rankers_build_the_radius_table_in_both_forms(kgs, name):
    """The masked and the maskless rankers hand their sweeps the same
    radius table, hyp_rank_radii_plain of the padded table's norms at the
    model's curvatures, bit for bit."""
    tdata = kgs[0]
    tm = _model_pair(name, tdata)[2]
    pack = tdata.eval_pack("test", "rhs")
    q = torch.as_tensor(pack.queries, dtype=torch.int64)
    f = torch.as_tensor(pack.filter_idx, dtype=torch.int64)
    got = {m: _ranker(tm, masked=m).kernel_inputs(q, f) for m in (True, False)}
    x = got[True]
    if name == "AttRH":
        want = K.hyp_rank_radii_plain(x["cvals"], x["un_rot"], "attrh", x["un_ref"])
    else:
        want = K.hyp_rank_radii_plain(x["cvals"], x["un"], "lorentz" if name == "RotLH"
                                      else "poincare")
    for m in (True, False):
        assert torch.equal(got[m]["radii"], want), m
