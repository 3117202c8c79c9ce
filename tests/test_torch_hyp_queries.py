"""RotH's ranker query prep as one kernel (kernels/hyp_queries.py,
csrc/hyp_queries.cu) against HypRanker's eager query prep.

On the CPU: the plain version against the eager ops in float64 (to a few
ulps) and in float32 (a few float32 ulps of the scale where the threshold
is well conditioned, and never further from the float64 definition than
the eager ops), with and without multi_c, in the three bias modes, at ranks
2, 8 and 32, on rows that project clips and on zero rows (the MIN_NORM
floors).  The route: every other HypRanker family, and RotH on CPU,
float64 and bfloat16 tables, runs the parent's eager code bit for bit and
launches nothing; the kernel branch takes the model's tables and the
ranker's curvatures; a shard's threshold equals one device's where the
shard does not hold the gold row.  The kernel itself is held to the plain
version on a card in tests/test_torch_kernels_cuda.py.
"""

from __future__ import annotations

import copy

import pytest
import torch

from complexhyperbolickge_torch.kernels import hyp_queries as HQ
from complexhyperbolickge_torch.kernels._ranker import near_threshold, score_interval
from complexhyperbolickge_torch.kernels.hyp_rank import HypRanker, _curvature_ids
from complexhyperbolickge_torch.models import ModelConfig, get_model
from complexhyperbolickge_torch.ops import math as OM
from complexhyperbolickge_torch.parallel import Mesh, shard_model_
from complexhyperbolickge_torch.parallel.mesh import call_with_tables
from complexhyperbolickge_torch.parallel.ranking import (
    ShardedHypRanker,
    _head_gold_part,
    _mini_tables,
    run_shards,
)

N_ENT, N_REL, B = 60, 5, 40
OUTPUTS = ("lhs", "x2", "cid", "c", "t2")
CASES = ["spread", "clip", "zero_rows"]
BIASES = ["learn", "constant", "none"]


def make_model(name="RotH", case="spread", rank=8, multi_c=True, bias="learn",
               dtype="float32", seed=0):
    """A model with a trained spread of weights (`case` "spread"); "clip":
    heads and relation halves large enough that project clips them;
    "zero_rows": all-zero rows for the first query's head and gold and its
    relation, which hit the MIN_NORM floors; and its queries (B, 3)."""
    cfg = ModelConfig(n_entities=N_ENT, n_relations=N_REL, rank=rank, multi_c=multi_c,
                      bias=bias, gamma=0.7, init_size=0.1, dtype=dtype)
    model = get_model(name)(cfg, generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    q = torch.stack([torch.randint(0, N_ENT, (B,), generator=g),
                     torch.randint(0, N_REL, (B,), generator=g),
                     torch.randint(0, N_ENT, (B,), generator=g)], 1)
    with torch.no_grad():
        for k in ("entity", "rel", "bt"):
            p = getattr(model, k)
            p.copy_(torch.randn(p.shape, generator=g) * (0.01 if k == "bt" else 0.05))
        model.c.copy_(1.0 + 0.2 * torch.randn(model.c.shape, generator=g))
        if case == "clip":
            model.entity.mul_(200.0)  # also beyond float64's margin, 1 - 1e-5
            model.rel.mul_(200.0)
        elif case == "zero_rows":
            model.entity[q[0, 0]] = 0.0
            model.entity[q[0, 2]] = 0.0
            model.rel[q[0, 1]] = 0.0
    return model, q


def curvatures(model):
    """The ranker's cvals in the model's dtype: model.curvature over every
    relation."""
    return model.curvature(torch.arange(N_REL)).reshape(-1).detach()


def eager_phase(model, q, cvals):
    """HypRanker._queries_core's operations in the model's dtype (the
    ranker's own casts them to float32)."""
    b = q.shape[0]
    (lhs, c), _ = model.get_queries(q[:, :2])
    c = c.expand(b, 1)
    gold = q[:, 2]
    sim = model.sim((lhs, c), model.entity[gold][:, None, :], all_pairs=False)[:, 0]
    if model.cfg.bias == "learn":
        sim = sim + model.bt[gold, 0]
    cid = _curvature_ids(model, q[:, 1])
    return lhs, torch.sum(lhs * lhs, dim=-1), cid, cvals[cid.long()], sim


def parent_queries_core(ranker, q, tables):
    """HypRanker._queries_core as the parent ran it for every family: what
    the eager route must still run, bit for bit."""
    m = ranker.model
    b = q.shape[0]
    (lhs, c), _ = m.get_queries(q[:, :2])
    lhs = lhs.to(torch.float32).contiguous()
    c = c.to(torch.float32).expand(b, 1)
    gold = q[:, 2]
    sim = m.sim((lhs, c), m.entity[gold].to(torch.float32)[:, None, :], all_pairs=False)[:, 0]
    cid = _curvature_ids(m, q[:, 1])
    return (lhs, torch.sum(lhs * lhs, dim=-1), cid, tables[3][cid.long()],
            ranker._gold_threshold(sim, gold))


def plain(model, q, cvals):
    return HQ.roth_rank_queries_plain(model.entity, model.rel, model.rel_diag, model.bt, cvals,
                                      q, model.cfg.multi_c, model.cfg.bias == "learn")


def case_engaged(case, model, q) -> bool:
    """Whether the weights reach what the case names: project clips a head
    and a relation half; a zero head, gold and relation row."""
    if case == "spread":
        return True
    c = curvatures(model)[_curvature_ids(model, q[:, 1]).long()][:, None]
    limit = (1 - OM.ball_eps(model.entity.dtype)) / torch.sqrt(c)
    heads = model.entity[q[:, 0]]
    if case == "clip":  # expmap0's radius tanh(s |u|) / s above project's limit
        def clipped(u):
            r = torch.tanh((torch.sqrt(c) * u.norm(dim=1, keepdim=True)).clamp(-15, 15))
            return bool((r / torch.sqrt(c) > limit).any())
        return clipped(heads) and clipped(model.rel[q[:, 1]][:, : heads.shape[1]])
    return (not heads[0].any() and not model.entity[q[0, 2]].any()
            and not model.rel[q[0, 1]].any())


@torch.no_grad()
@pytest.mark.parametrize("rank", [2, 8, 32])
@pytest.mark.parametrize("bias", BIASES)
@pytest.mark.parametrize("multi_c", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_plain_float64_matches_the_eager_ops(case, multi_c, bias, rank):
    model, q = make_model(case=case, rank=rank, multi_c=multi_c, bias=bias, dtype="float64")
    assert case_engaged(case, model, q)
    cvals = curvatures(model)
    want = eager_phase(model, q, cvals)
    got = plain(model, q, cvals)
    for name, a, e in zip(OUTPUTS, got, want):
        assert a.shape == e.shape and a.dtype == e.dtype, name
        if name == "cid":
            assert torch.equal(a, e)
            continue
        # the rounding of two summation orders, and of <x, v> / |v| against
        # <x, v / |v|>
        tol = 8 * torch.finfo(torch.float64).eps * float(e.abs().max())
        torch.testing.assert_close(a, e, rtol=0.0, atol=tol, msg=name)


@torch.no_grad()
@pytest.mark.parametrize("rank", [2, 8, 32])
@pytest.mark.parametrize("case", CASES)
def test_plain_float32_stays_within_the_eager_ops_rounding(case, rank, monkeypatch):
    """Against HypRanker's eager query prep on a float32 model: the curvatures
    and ids equal; each output no further from the float64 definition (the
    float32 ball's margin, in float64) than the eager ops' plus 2 float32
    ulps of its scale; where the threshold is well conditioned ("spread")
    within 8 float32 ulps of the eager ops."""
    model, q = make_model(case=case, rank=rank)
    assert case_engaged(case, model, q)
    ranker = HypRanker(model)
    tables = ranker._get_tables()
    with torch.no_grad():
        eager = ranker._queries_core(q, tables)
        got = plain(model, q, tables[3])
        ref_model = copy.deepcopy(model).double()
        monkeypatch.setitem(OM._BALL_EPS, torch.float64, OM.ball_eps(torch.float32))
        ref = eager_phase(ref_model, q, curvatures(ref_model))
    ulp = torch.finfo(torch.float32).eps
    for name, a, e, r in zip(OUTPUTS, got, eager, ref):
        assert a.shape == e.shape and a.dtype == e.dtype, name
        if name in ("cid", "c"):
            assert torch.equal(a, e), name
            continue
        scale = float(r.abs().max())
        err_plain = float((a.double() - r).abs().max())
        err_eager = float((e.double() - r).abs().max())
        assert err_plain <= err_eager + 2 * ulp * scale, (name, err_plain, err_eager)
        if case == "spread":
            assert float((a - e).abs().max()) <= 8 * ulp * scale, name


OTHER_FAMILIES = ["RefH", "AttH", "IsoH", "IFFTH", "RotLH", "HyboNet"]


@torch.no_grad()
@pytest.mark.parametrize("name,dtype", [*((n, "float32") for n in OTHER_FAMILIES),
                                        ("RotH", "float32"), ("RotH", "float64"),
                                        ("RotH", "bfloat16")])
def test_other_families_and_tables_keep_the_eager_ops_bit_for_bit(name, dtype):
    model, q = make_model(name, rank=6, dtype=dtype)  # IFFTH: rank / 2 + 1 even
    assert not HQ.use_kernel(model)
    HQ.reset_launches()
    ranker = HypRanker(model)
    tables = ranker._get_tables()
    got = ranker._queries_core(q, tables)
    want = parent_queries_core(ranker, q, tables)
    for k, a, e in zip(OUTPUTS, got, want):
        assert a.dtype == e.dtype and torch.equal(a, e), k
    assert HQ.launches["roth_rank_queries"] == 0


@torch.no_grad()
@pytest.mark.parametrize("multi_c", [True, False])
@pytest.mark.parametrize("bias", BIASES)
def test_kernel_branch_takes_the_model_tables_and_the_rankers_curvatures(bias, multi_c,
                                                                      monkeypatch):
    """With the route forced on a CPU RotH the wrapper runs the plain version:
    the ranker's query inputs are the plain version's on the model's tables
    and the ranker's cvals, and its ranks (masked and maskless) equal the
    eager route's except on the entities near the threshold."""
    model, q = make_model(rank=8, multi_c=multi_c, bias=bias)
    fidx = torch.cat([q[:, 2:3], torch.randint(0, N_ENT, (B, 4),
                                               generator=torch.Generator().manual_seed(3))], 1)
    eager = {m: HypRanker(model, masked=m) for m in (True, False)}
    want_ranks = {m: r(q, fidx) for m, r in eager.items()}
    monkeypatch.setattr(HQ, "use_kernel", lambda m: True)
    for masked in (True, False):
        ranker = HypRanker(model, masked=masked)
        tables = ranker._get_tables()
        got = ranker._queries_core(q, tables)
        want = plain(model, q, tables[3])
        assert all(torch.equal(a, e) for a, e in zip(got, want))
        x = ranker.kernel_inputs(q, fidx)
        near = near_threshold(*score_interval("poincare", x), x["t2"])
        diff = (ranker(q, fidx) - want_ranks[masked]).abs()
        assert bool((diff <= near).all()), (diff, near)


@torch.no_grad()
@pytest.mark.parametrize("masked", [True, False])
def test_shard_threshold_equals_one_device_where_the_gold_is_not_held(masked, monkeypatch):
    """Two shards of one model group, each holding its own rows, on the
    kernel branch: each shard's query inputs (from the mini-tables of the
    gathered head and gold rows) equal one device's bit for bit, also for
    the queries whose gold the shard does not hold; the shards' ranks equal
    one device's."""
    from complexhyperbolickge_torch.parallel.mesh import padded_rows

    monkeypatch.setattr(HQ, "use_kernel", lambda m: True)
    model, q = make_model(rank=8)
    fidx = q[:, 2:3].clone()
    one = HypRanker(model, masked=masked)
    tables = one._get_tables()
    want = one._queries_core(q, tables)
    shards = []
    for i in range(2):
        local = copy.deepcopy(model)
        shard_model_(local, i, 2)
        shards.append(ShardedHypRanker(local, Mesh((1, 2), i), N_ENT, masked=masked))
    rows = sum(_head_gold_part(s, q) for s in shards)
    mini, q_mini = _mini_tables(rows, q)
    s_rows = padded_rows(N_ENT, 2) // 2
    for i, s in enumerate(shards):
        got = call_with_tables(s.model, mini, s._queries_core, q_mini, s._get_tables())
        held = (q[:, 2] >= i * s_rows) & (q[:, 2] < (i + 1) * s_rows)
        assert bool((~held).any())
        for k, a, e in zip(OUTPUTS, got, want):
            assert torch.equal(a, e), (i, k)
    assert torch.equal(run_shards(shards, q, fidx), one(q, fidx))
