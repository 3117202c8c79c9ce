"""--eval_precision default in the port, against its definition and against
the JAX package, on the CPU.

The definition (JAX's Precision.DEFAULT on the MXU): both operands of each
score contraction rounded to bfloat16 (round-to-nearest-even), their
products summed in float32, everything else float32 (norms from the
unrounded rows).  JAX's CPU backend contracts DEFAULT at full float32, so
JAX on the CPU is held to the port only through the rounding bound:

(a) each plain default version (K1, K2's sweep and subtraction; K5/K6 and
    their subtraction, Poincare and Lorentz; K7/K8 and theirs) against a
    float64 numpy evaluation of the definition: the contraction within rtol
    1e-6 (the plain versions sum the exact products in float64 and round
    once; a float32 sum of <= 80 terms in any order stays within 80 2^-24
    of the terms' magnitudes), each count within the entities whose float64
    score lies within 1e-5 (1 + |t2|) of t2 (the float32 epilogue);
(b) masked == maskless - subtraction exactly, in default mode, every family;
(c) the counts against JAX's Pallas kernels in interpret mode with
    precision="default": per query |port - JAX| <= the number of entities
    whose exact (float64) score interval contains t2 (EPS below);
(d) make_best_ranker(..., precision="default") against JAX's, the same way,
    and MRR within the mean of min(near, 1);
(e) the dense ranker's scores at the JAX sites that read mm_precision()
    inside score_all equal JAX's under eval_matmul_precision("default") with
    those contractions' operands rounded to bfloat16 (float64 models, the
    GNN's encoder exact), and score_all outside the context is unchanged;
(f) kge-test and cli.run with --eval_precision default end to end,
    including a JAX-written run dir whose config.json says "default".

EPS, the contraction's distance from exact: each operand rounds within
2^-9 of itself, so a product within (2^-8 + 2^-18) |q_k w_k|; a float32 sum
of <= 80 terms adds at most 80 2^-24 sum_k |q_k w_k| on either side:
delta = sum_k |q_k w_k| (2^-8 + 2^-18 + 80 2^-24).  Pushed through the
epilogue as an interval (the FFT cross-ratio is convex in (Re, Im), the
real-hyperbolic scores monotone in <x, v>), widened by 1e-5 (1 + |t2|) for
the float32 epilogue and thresholds.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.data.dataset import synthetic_kg
from complexhyperbolickge_torch.kernels import chyp_rank as KC
from complexhyperbolickge_torch.kernels import hyp_rank as KH
from complexhyperbolickge_torch.kernels._ranker import (
    bf16_rows,
    near_threshold,
    plain_mm,
    plain_rows,
    score_interval,
    to_bf16,
)
from complexhyperbolickge_torch.models import ModelConfig, get_model
from complexhyperbolickge_torch.ops.math import eval_matmul_precision, mm_precision
from complexhyperbolickge_torch.train import evaluate as TEV
from complexhyperbolickge_torch.train.checkpoint import params_from_jax
from complexhyperbolickge_tpu.data.dataset import synthetic_kg as jax_synthetic_kg
from complexhyperbolickge_tpu.kernels import chyp_rank as JC
from complexhyperbolickge_tpu.kernels import hyp_rank as JH
from complexhyperbolickge_tpu.models import ModelConfig as JaxConfig
from complexhyperbolickge_tpu.models import get_model as jax_get_model
from complexhyperbolickge_tpu.ops import math as JM
from complexhyperbolickge_tpu.train import evaluate as JEV

N, B, L = 300, 48, 6
NP, DP = 512, 128  # the JAX kernels' padded table and lane width
DEFAULT = "default"
REL = 2.0 ** -8 + 2.0 ** -18 + 80 * 2.0 ** -24
KINDS = ("chyp", "poincare", "lorentz", "attrh")


def f64(t):
    return t.double() if isinstance(t, torch.Tensor) else torch.as_tensor(t, dtype=torch.float64)


def bf16_f64(t):
    """t rounded to bfloat16, as float64."""
    return to_bf16(torch.as_tensor(t)).double()


# ------------------------------ kernel-level inputs -------------------------------


def _filters(rng, gold):
    fidx = np.full((B, L), N, np.int32)
    for i in range(B):
        others = rng.choice(np.setdiff1d(np.arange(N), [gold[i]]), rng.integers(0, L), False)
        fidx[i, :len(others)] = others
        fidx[i, len(others)] = gold[i]
    mask = np.zeros((B, NP), np.int8)
    mask[:, N:] = 1
    np.put_along_axis(mask, fidx.astype(np.int64), 1, axis=1)
    return fidx, mask


def _pad(a, rows, cols):
    return jnp.zeros((rows, cols), jnp.float32).at[: a.shape[0], : a.shape[1]].set(a)


@pytest.fixture(scope="module", params=KINDS)
def inputs(request):
    """One family's plain-version inputs (float32, the unrounded operands)
    with thresholds at each query's exact gold score, filters holding the
    gold once, and the JAX kernels' padded copies."""
    kind = request.param
    rng = np.random.default_rng(KINDS.index(kind) + 10)
    gold = rng.integers(0, N, B)
    fidx, mask = _filters(rng, gold)
    bt = np.full(NP, -1e30, np.float32)
    bt[:N] = rng.normal(0, 0.3, N)
    x = dict(bt=torch.as_tensor(bt), fidx=torch.as_tensor(fidx), mask=torch.as_tensor(mask),
             gold=torch.as_tensor(gold, dtype=torch.int32))
    j = dict(bt=jnp.asarray(bt)[None, :], mask=jnp.asarray(mask), fidx=jnp.asarray(fidx),
             gold=jnp.asarray(gold, jnp.int32))
    if kind == "chyp":
        r = 9
        lhs = rng.normal(0, 0.15, (B, 2 * r)).astype(np.float32)
        rhs = np.zeros((NP, 2 * r), np.float32)
        rhs[:N] = rng.normal(0, 0.15, (N, 2 * r))
        lhs2 = np.concatenate([lhs, np.concatenate([lhs[:, r:], -lhs[:, :r]], 1)])
        x.update(lhs2=torch.as_tensor(lhs2), rhs=torch.as_tensor(rhs),
                 zn=torch.as_tensor(np.clip((lhs * lhs).sum(1) - 1.0, -1.0, -4e-3)
                                    .astype(np.float32)))
        x["wn"] = (torch.sum(x["rhs"] ** 2, -1) - 1.0).clamp(-1.0, -4e-3)
        j.update(lhs2=_pad(lhs2, 2 * B, DP), rhs=_pad(rhs, NP, DP),
                 zn=jnp.asarray(x["zn"].numpy())[:, None])
    else:
        d = 8
        lhs = rng.normal(0, 0.2, (B, d)).astype(np.float32)
        rhs = np.zeros((NP, d), np.float32)
        rhs[:N] = rng.normal(0, 0.4, (N, d))
        x.update(lhs=torch.as_tensor(lhs), rhs=torch.as_tensor(rhs),
                 c=torch.as_tensor(rng.uniform(0.5, 1.5, B).astype(np.float32)))
        j["c"] = jnp.asarray(x["c"].numpy())[:, None]

        def norm(rows):
            return torch.sqrt(torch.sum(rows * rows, -1).clamp_min(1e-30))

        if kind == "attrh":
            h = d // 2
            w = torch.softmax(torch.as_tensor(rng.normal(0, 1, (B, 2)), dtype=torch.float32), -1)
            x.update(x2r=torch.sum(x["lhs"][:, :h] ** 2, -1), x2f=torch.sum(x["lhs"][:, h:] ** 2, -1),
                     w0=w[:, 0].contiguous(), w1=w[:, 1].contiguous(),
                     un_rot=norm(x["rhs"][:, :h]), un_ref=norm(x["rhs"][:, h:]))
            j.update(lrot=_pad(lhs[:, :h], B, DP), lref=_pad(lhs[:, h:], B, DP),
                     rrot=_pad(rhs[:, :h], NP, DP), rref=_pad(rhs[:, h:], NP, DP),
                     **{k: jnp.asarray(x[k].numpy())[:, None] for k in ("x2r", "x2f", "w0", "w1")})
        else:
            x.update(x2=torch.sum(x["lhs"] ** 2, -1), un=norm(x["rhs"]))
            j.update(lhs=_pad(lhs, B, DP), rhs=_pad(rhs, NP, DP),
                     x2=jnp.asarray(x["x2"].numpy())[:, None])
    exact, _ = score_interval(kind, x)
    x["t2"] = exact[torch.arange(B), torch.as_tensor(gold)].float().contiguous()
    j["t2"] = jnp.asarray(x["t2"].numpy())[:, None]
    return kind, x, j


SCORE_ARGS = {"chyp": ("lhs2", "zn", "rhs", "wn", "bt"),
              "poincare": ("lhs", "x2", "c", "rhs", "un", "bt"),
              "lorentz": ("lhs", "x2", "c", "rhs", "un", "bt"),
              "attrh": ("lhs", "x2r", "x2f", "c", "w0", "w1", "rhs", "un_rot", "un_ref", "bt")}


def plain_counts(kind, x, precision=DEFAULT):
    """(masked, maskless sweep, filtered subtraction, maskless count) of
    the family's plain versions; the sweeps' curvature ids are arange(B)
    over cvals = c."""
    if kind == "chyp":
        base = [x[k] for k in ("lhs2", "zn", "t2", "rhs", "wn", "bt")]
        return (KC.chyp_rank_counts(*base, x["mask"], precision=precision),
                KC.chyp_rank_sweep_nomask(*base, x["gold"], precision=precision),
                KC.chyp_rank_filtered_sub(*base, x["fidx"], x["gold"], precision=precision),
                KC.chyp_rank_counts_nomask(*base, x["fidx"], x["gold"], precision=precision))
    cid = torch.arange(B, dtype=torch.int32)
    if kind == "attrh":
        radii = KH.hyp_rank_radii_plain(x["c"], x["un_rot"], "attrh", x["un_ref"])
        pre = [x["lhs"], x["x2r"], x["x2f"]]
        post = [x[k] for k in ("w0", "w1", "t2", "rhs", "un_rot", "un_ref", "bt")] + [radii]
        sub = [x["lhs"], x["x2r"], x["x2f"], x["c"], *post[:-1]]
        kw = dict(precision=precision)
        return (KH.attrh_rank_counts(*pre, cid, x["c"], *post, x["mask"], **kw),
                KH.attrh_rank_sweep_nomask(*pre, cid, x["c"], *post, x["gold"], **kw),
                KH.attrh_rank_filtered_sub(*sub, x["fidx"], x["gold"], **kw),
                KH.attrh_rank_counts_nomask(*pre, cid, x["c"], *post, x["fidx"], x["gold"],
                                            **kw))
    radii = KH.hyp_rank_radii_plain(x["c"], x["un"], kind)
    pre = [x["lhs"], x["x2"]]
    post = [x[k] for k in ("t2", "rhs", "un", "bt")] + [radii]
    kw = dict(family=kind, precision=precision)
    return (KH.hyp_rank_counts(*pre, cid, x["c"], *post, x["mask"], **kw),
            KH.hyp_rank_sweep_nomask(*pre, cid, x["c"], *post, x["gold"], **kw),
            KH.hyp_rank_filtered_sub(*pre, x["c"], *post[:-1], x["fidx"], x["gold"], **kw),
            KH.hyp_rank_counts_nomask(*pre, cid, x["c"], *post, x["fidx"], x["gold"], **kw))


def counts_of(s, x):
    """(masked, sweep, subtraction) counts of a (B, Np) score matrix."""
    hit = s >= x["t2"][:, None].double()
    cols = torch.arange(NP)[None, :]
    fidx = x["fidx"].long()
    ok = (fidx < NP) & (fidx != x["gold"][:, None].long())
    return ((hit & (x["mask"] == 0)).sum(1), (hit & (cols != x["gold"][:, None].long())).sum(1),
            (torch.gather(hit, 1, fidx.clamp_max(NP - 1)) & ok).sum(1))


# ----------------------------------- (a), (b) -------------------------------------


def test_bf16_rounding_equals_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    vals = rng.normal(0, 3, 4000).astype(np.float32)
    bits = vals.view(np.uint32)
    # exact ties of both parities, and their neighbours
    ties = np.concatenate([(bits & 0xFFFF0000) | 0x8000, (bits & 0xFFFF0000) | 0x7FFF,
                           (bits & 0xFFFF0000) | 0x8001]).view(np.float32)
    x = np.concatenate([vals, ties, np.float32([0.0, -0.0, 1e-40, 3e38, -3e38])])
    got = to_bf16(torch.as_tensor(x)).view(torch.int16).numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.int16)
    np.testing.assert_array_equal(got, want)


def test_plain_contractions_equal_the_rounded_products_sum():
    """plain_mm / plain_rows under default: the bfloat16 operands' exact
    product sum, rounded once to float32 (rtol 1e-6); bf16_rows pads with
    exact zeros, halves each on its own."""
    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.normal(0, 0.3, (20, 18)), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(0, 0.3, (70, 18)), dtype=torch.float32)
    want = (bf16_f64(a) @ bf16_f64(w).T).numpy()
    got = plain_mm(a, w, DEFAULT)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(plain_mm(a, w, "highest").numpy(), (f64(a) @ f64(w).T).numpy(),
                               rtol=1e-5, atol=1e-6)
    rows = w[torch.as_tensor(rng.integers(0, 70, (20, 5)))]
    np.testing.assert_allclose(plain_rows(a, rows, DEFAULT).numpy(),
                               torch.einsum("bd,bld->bl", bf16_f64(a), bf16_f64(rows)).numpy(),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(plain_mm(bf16_rows(a), bf16_rows(w), DEFAULT).numpy(),
                                  got.numpy())
    halves = bf16_rows(a, halves=True)
    assert halves.shape == (20, 32) and not halves[:, 9:16].any() and not halves[:, 25:].any()
    assert torch.equal(halves[:, 16:25], to_bf16(a[:, 9:]))


def test_plain_default_matches_float64_definition(inputs):
    """(a) Each plain default version's counts against the float64
    evaluation of the definition: within the entities whose float64 score
    lies within 1e-5 (1 + |t2|) of t2."""
    kind, x, _ = inputs
    s_def, _ = score_interval(kind, x, rounded=True)
    if kind == "chyp":
        np.testing.assert_allclose(
            KC.chyp_contract_plain(x["lhs2"], x["rhs"], DEFAULT).numpy(),
            (bf16_f64(x["lhs2"]) @ bf16_f64(x["rhs"]).T).numpy(), rtol=1e-6, atol=0)
        plain = KC.chyp_scores_plain(*[x[k] for k in SCORE_ARGS[kind]], precision=DEFAULT)
    elif kind == "attrh":
        plain = KH.attrh_scores_plain(*[x[k] for k in SCORE_ARGS[kind]], precision=DEFAULT)
    else:
        plain = KH.hyp_scores_plain(*[x[k] for k in SCORE_ARGS[kind]], family=kind,
                                    precision=DEFAULT)
    near = near_threshold(s_def, s_def, x["t2"])
    # the float32 epilogue on the same contraction: the counts tell
    assert plain.dtype == torch.float32 and plain.shape == s_def.shape
    masked, sweep, sub, _ = plain_counts(kind, x)
    for got, want in zip((masked, sweep, sub), counts_of(s_def, x)):
        assert got.dtype == torch.int32 and ((got - want).abs() <= near).all()
    assert masked.sum() > 0  # the thresholds sit inside the score range
    # the default instance is not the exact one: some scores move
    exact, _ = score_interval(kind, x)
    assert (s_def[:, :N] != exact[:, :N]).any()


def test_plain_default_maskless_equals_masked_exactly(inputs):
    """(b) masked == maskless sweep - subtraction, exactly, in default mode
    (the golds are filtered)."""
    kind, x, _ = inputs
    masked, sweep, sub, maskless = plain_counts(kind, x)
    assert torch.equal(masked, sweep - sub) and torch.equal(masked, maskless)


def test_plain_default_takes_bf16_operands_alike(inputs):
    """The kernels' bf16 operands (bf16_rows, zero-padded to 16 features,
    AttRH's halves each) give the plain default versions the same counts
    as the float32 operands they were rounded from."""
    kind, x, _ = inputs
    y = dict(x)
    if kind == "chyp":
        y["lhs2"], y["rhs"] = bf16_rows(x["lhs2"]), bf16_rows(x["rhs"])
    else:
        y["lhs"], y["rhs"] = (bf16_rows(x[k], halves=kind == "attrh") for k in ("lhs", "rhs"))
        assert y["lhs"].shape[1] == (32 if kind == "attrh" else 16)
    for got, want in zip(plain_counts(kind, y), plain_counts(kind, x)):
        assert torch.equal(got, want)


# -------------------------------------- (c) ---------------------------------------


def jax_counts(kind, j, masked):
    kw = dict(tile_n=NP, interpret=True, precision=DEFAULT)
    if kind == "chyp":
        a = (j["lhs2"], j["zn"], j["t2"], j["rhs"], j["bt"])
        if masked:
            return JC.chyp_rank_counts(*a, j["mask"], **kw)
        return JC.chyp_rank_counts_nomask(*a, j["fidx"], None, j["gold"], **kw)
    if kind == "attrh":
        a = (j["lrot"], j["lref"], j["x2r"], j["x2f"], j["c"], j["w0"], j["w1"], j["t2"],
             j["rrot"], j["rref"], j["bt"])
        if masked:
            return JH.attrh_rank_counts(*a, j["mask"], **kw)
        return JH.attrh_rank_counts_nomask(*a, j["fidx"], None, j["gold"], **kw)
    a = (j["lhs"], j["x2"], j["c"], j["t2"], j["rhs"], j["bt"])
    if masked:
        return JH.hyp_rank_counts(*a, j["mask"], family=kind, **kw)
    return JH.hyp_rank_counts_nomask(*a, j["fidx"], None, j["gold"], family=kind, **kw)


@pytest.mark.parametrize("masked", [True, False])
def test_plain_default_matches_jax_pallas_default(inputs, masked):
    """(c) The port's default counts against JAX's Pallas kernels in
    interpret mode at precision="default" (full float32 on the CPU): per
    query within the entities whose exact score interval (EPS) holds t2."""
    kind, x, j = inputs
    want = np.asarray(jax_counts(kind, j, masked))
    got = plain_counts(kind, x)[0 if masked else 3]
    lo, hi = score_interval(kind, x, rel=REL)
    near = near_threshold(lo, hi, x["t2"]).numpy()
    assert (np.abs(got.numpy() - want) <= near).all()
    assert near.mean() < NP / 4  # the bound is a sandwich, not the whole table


# -------------------------------------- (d) ---------------------------------------


@pytest.fixture(scope="module")
def kgs():
    kg = dict(n_entities=N, n_train=1500, n_valid=120, n_test=120, seed=3)
    return synthetic_kg(**kg), jax_synthetic_kg(**kg)


GNN_ARGS = argparse.Namespace(hidden_dim=8, layers=2, edge_dropout=0.0, dropout=0.0,
                              opn="mult", interaction="distmult", basis=0, gnn_agg_method=1)


def model_pair(name, kg_pair, dtype="float32", rank=8, scale=0.3):
    """(JAX model, its params: init plus N(0, scale) noise, the port model
    holding them)."""
    tdata, jdata = kg_pair
    cfg = dict(n_entities=tdata.n_entities, n_relations=tdata.n_predicates, rank=rank,
               bias="learn", gamma=0.7, multi_c=True, dtype=dtype)
    gnn = name == "CompGCN"
    jm = jax_get_model(name)(JaxConfig(**cfg), *((GNN_ARGS, jdata) if gnn else ()))
    rng = np.random.default_rng(7)
    init = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    npp = jax.tree.map(lambda v: (v + rng.normal(0, scale, np.shape(v))).astype(dtype)
                       if np.ndim(v) else v, init)
    if name == "HyboNet":  # its init's scale column: time^2 > 1 in _lorentz_linear
        npp["rel_diag"][:, -1] = 1.0
    tm = get_model(name)(ModelConfig(**cfg), *((GNN_ARGS, tdata) if gnn else ()))
    tm.load_state_dict(params_from_jax(npp, "cpu"))
    return jm, jax.tree.map(jnp.asarray, npp), tm


def ranker_near(tm, q, f):
    """Per query: the entities whose exact score interval holds the fused
    ranker's threshold, from the exact ranker's float32 inputs."""
    r = TEV.make_best_ranker(tm, 64, "auto")
    x = r.kernel_inputs(q, f)
    kind = "chyp" if isinstance(r, KC.ChypRanker) else getattr(r, "family", "attrh")
    lo, hi = score_interval(kind, x, rel=REL)
    n = tm.cfg.n_entities
    return near_threshold(lo[:, :n], hi[:, :n], x["t2"])


@pytest.mark.parametrize("name,rank,scale", [("FFTRotH", 9, 0.1), ("RotH", 8, 0.3),
                                             ("RotLH", 8, 0.3), ("AttRH", 8, 0.3)])
def test_best_ranker_default_matches_jax(kgs, name, rank, scale):
    """(d) make_best_ranker(precision="default"), masked and maskless,
    against JAX's make_best_ranker(..., "default") (its dense ranker on the
    CPU, at full float32): ranks within the interval sandwich, MRR within
    the mean of min(near, 1); the two fused forms rank alike exactly."""
    tdata, jdata = kgs
    jm, jp, tm = model_pair(name, kgs, rank=rank, scale=scale)
    jr = JEV.make_best_ranker(jm, 64, "auto", precision=DEFAULT)
    for direction in ("rhs", "lhs"):
        pack = tdata.eval_pack("test", direction)
        q = torch.as_tensor(pack.queries, dtype=torch.int64)
        f = torch.as_tensor(pack.filter_idx, dtype=torch.int64)
        want = JEV.get_ranking(jm, jp, jdata.eval_pack("test", direction), 64, rank_fn=jr)
        near = ranker_near(tm, q, f).numpy()
        got = {}
        for backend in ("auto", "pallas_maskless"):
            r = TEV.make_best_ranker(tm, 64, backend, precision=DEFAULT)
            assert r.precision == DEFAULT and r.masked == (backend == "auto")
            got[backend] = TEV.get_ranking(tm, pack, 64, rank_fn=r)
            assert (np.abs(got[backend] - want) <= near).all()
            bound = np.minimum(near, 1).mean()
            assert abs(np.mean(1 / got[backend]) - np.mean(1 / want)) <= bound + 1e-7
        np.testing.assert_array_equal(got["auto"], got["pallas_maskless"])


def test_default_ranker_tables_hold_the_bf16_copy(kgs):
    """A default ranker's cache holds the float32 tables and a bfloat16
    copy of the padded entity table (rows padded to 16 features with
    zeros); wn comes from the unrounded rows, and the batch's query rows
    are rounded."""
    tdata, _ = kgs
    _, _, tm = model_pair("FFTRotH", kgs, rank=9, scale=0.1)
    exact, default = KC.ChypRanker(tm), KC.ChypRanker(tm, precision=DEFAULT)
    q = torch.as_tensor(tdata.eval_pack("test", "rhs").queries[:8], dtype=torch.int64)
    f = torch.full((8, 3), tdata.n_entities, dtype=torch.int64)
    xe, xd = exact.kernel_inputs(q, f), default.kernel_inputs(q, f)
    n, d = tm.entity.shape
    assert xd["rhs"].dtype == torch.bfloat16 and xd["rhs"].shape == (xe["rhs"].shape[0], 32)
    assert torch.equal(xd["rhs"][:n, :d], to_bf16(tm.entity.detach()))
    assert not xd["rhs"][:, d:].any() and not xd["rhs"][n:].any()
    assert torch.equal(xd["lhs2"], bf16_rows(xe["lhs2"]))
    for k in ("wn", "bt", "zn", "t2"):
        assert torch.equal(xd[k], xe[k])
    assert len(default._get_tables()) == len(exact._get_tables()) + 1
    with pytest.raises(ValueError, match="unknown eval precision"):
        TEV.make_best_ranker(tm, 64, "auto", precision="bf16")
    with pytest.raises(ValueError, match="unknown eval precision"):
        TEV.make_ranker(tm, precision="fast")


# -------------------------------------- (e) ---------------------------------------


class _RoundingJnp:
    """jax.numpy, except that matmul and einsum at precision "default"
    round their operands to bfloat16 first and contract them exactly: the
    definition of JAX's DEFAULT, which its CPU backend does not apply."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def _args(args, kw):
        if kw.get("precision") in ("default", jax.lax.Precision.DEFAULT):
            kw = {**kw, "precision": "highest"}
            args = [a.astype(jnp.bfloat16).astype(a.dtype) if hasattr(a, "astype") else a
                    for a in args]
        return args, kw

    def matmul(self, *args, **kw):
        args, kw = self._args(args, kw)
        return jnp.matmul(*args, **kw)

    def einsum(self, spec, *args, **kw):
        args, kw = self._args(args, kw)
        return jnp.einsum(spec, *args, **kw)


@pytest.fixture()
def jax_rounding(monkeypatch):
    """JAX's score sites that read mm_precision() inside score_all, with
    their default contractions as the definition has them."""
    import complexhyperbolickge_tpu.models.base as jb
    import complexhyperbolickge_tpu.models.hyperbolic as jmh
    import complexhyperbolickge_tpu.ops.chyperbolic as joc
    import complexhyperbolickge_tpu.ops.hyperbolic as joh

    for mod in (jb, jmh, joc, joh):
        monkeypatch.setattr(mod, "jnp", _RoundingJnp())


DENSE = [("FFTRotH", 5, 0.1), ("RotH", 6, 0.3), ("HyboNet", 6, 0.3), ("RotE", 6, 0.3),
         ("CompGCN", 6, 0.3)]


@pytest.mark.parametrize("name,rank,scale", DENSE)
def test_dense_default_scores_equal_jax_definition(kgs, jax_rounding, name, rank, scale):
    """(e) Dense score_all inside eval_matmul_precision("default") equals
    JAX's with the operands of its mm_precision() sites rounded to bfloat16,
    in float64 (the GNN encodes outside the scope, exact); outside the
    context the scores are bit-identical to the exact ones, and the dense
    ranker's ranks are those of JAX's filtered count over JAX's scores."""
    tdata, _ = kgs
    jm, jp, tm = model_pair(name, kgs, dtype="float64", rank=rank, scale=scale)
    pack = tdata.eval_pack("test", "rhs")
    q = pack.queries[:40].astype(np.int64)
    fidx = pack.filter_idx[:40].astype(np.int64)
    gnn = getattr(tm, "is_gnn", False)
    kw_t = dict(cache=tm.cached_encode()) if gnn else {}
    kw_j = dict(cache=jm.encode(jp)) if gnn else {}
    qt = torch.as_tensor(q)
    with torch.no_grad():
        exact = tm.score_all(qt[:, :2], **kw_t)
        with eval_matmul_precision(DEFAULT):
            got = tm.score_all(qt[:, :2], **kw_t)
        with eval_matmul_precision("highest"):
            assert torch.equal(tm.score_all(qt[:, :2], **kw_t), exact)
        assert torch.equal(tm.score_all(qt[:, :2], **kw_t), exact)
    # traced inside the scope, as JAX's rankers; the cache is an argument (an
    # XLA constant's bf16 rounding would fold at compile time, directly
    # from float64 instead of through float32 as at run time)
    with JM.eval_matmul_precision(DEFAULT):
        want = np.asarray(jax.jit(lambda p, qq, kw: jm.score_all(p, qq, **kw))(
            jp, jnp.asarray(q[:, :2]), kw_j))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-12)
    assert not np.allclose(got.numpy(), exact.numpy(), rtol=1e-6, atol=0)
    target = want[np.arange(len(q)), q[:, 2]][:, None]
    want_ranks = 1 + np.asarray(JEV.filtered_rank_counts(
        jnp.asarray(want), jnp.asarray(target), jnp.asarray(fidx), tdata.n_entities))
    got_ranks = TEV.make_ranker(tm, precision=DEFAULT)(qt, torch.as_tensor(fidx))
    np.testing.assert_array_equal(got_ranks.numpy(), want_ranks)


def test_precision_context_restores_itself():
    assert mm_precision() == "highest"
    with pytest.raises(RuntimeError, match="inside"):
        with eval_matmul_precision(DEFAULT):
            assert mm_precision() == DEFAULT
            with eval_matmul_precision("highest"):  # a no-op, as in JAX
                assert mm_precision() == DEFAULT
            raise RuntimeError("inside")
    assert mm_precision() == "highest"
    with eval_matmul_precision(None):
        assert mm_precision() == "highest"
    with pytest.raises(ValueError, match="unknown eval precision"):
        eval_matmul_precision("tf32")
