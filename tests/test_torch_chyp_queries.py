"""FFTRotH's fused query chain (kernels/chyp_queries.py, csrc/chyp_queries.cu)
against the model's eager chain.

On the CPU: the plain versions of the kernels' forward and analytic
backward against the eager chain and its autograd in float64 at rank 33,
over the chain's clamps and branches; the Function's wiring; the CPU,
float64 and bfloat16 routes, which keep the eager chain bit for bit.

On a card (the `cuda` marker; these skip without one): the kernels against
their plain versions at WN18RR's shapes, the backward's bits over two runs,
a double_neg training step's launches, a 1x2 mesh's steps against one
process's eager chain, and a re-initialised model training on the kernels.

    python -m pytest --noconftest -q -m cuda tests/test_torch_chyp_queries.py
"""

from __future__ import annotations

import pytest
import torch

from complexhyperbolickge_torch.kernels import chyp_queries as CQ
from complexhyperbolickge_torch.models.base import ModelConfig, _softplus
from complexhyperbolickge_torch.models.chyperbolic import FFTRotH
from complexhyperbolickge_torch.ops import chyperbolic as CH
from complexhyperbolickge_torch.ops.euclidean import givens_rotations
from complexhyperbolickge_torch.ops.fft import irfft_matrix, irfft_packed, rfft_matrix, rfft_packed

RANK, N_REL = 33, 22
TABLES = ("entity", "rel", "rel_diag", "c", "bh")


def parent_chain(model, queries):
    """The eager chain as the model ran it before the kernels: what CPU,
    float64 and bfloat16 tables must still run, bit for bit."""
    h, r = queries[..., 0], queries[..., 1]
    c = model.curvature(r)
    head = irfft_packed(model.entity[h])
    head = CH.expmap0(head, c)
    rel1, rel2 = torch.chunk(model.rel[r], 2, dim=-1)
    rel1 = CH.expmap0(rel1, c)
    rel2 = CH.expmap0(rel2, c)
    lhs = CH.project(CH.real_mobius_add(head, rel1, c), c)
    res1 = givens_rotations(model.rel_diag[r], lhs)
    res2 = CH.real_mobius_add(res1, rel2, c)
    return (rfft_packed(res2),), model.bh[h]


def make_model(case: str, multi_c: bool, dtype="float64", n=40, b=24, seed=0):
    """A rank-33 FFTRotH with weights set up for `case` and its queries
    (b, 2): "inactive" (every project a no-op), "project" (the head's and
    the first sum's project clip, inside the tanh clamp), "tanh" (the
    relation rows beyond the tanh clamp), "zero_row" (an all-zero entity
    and relation row: the MIN_NORM clamps), "zero_givens" (a zero Givens
    pair: the tiny clamp), "duplicates" (repeated h, r and (h, r))."""
    cfg = ModelConfig(n_entities=n, n_relations=N_REL, rank=RANK, multi_c=multi_c,
                      init_size=0.1, dtype=dtype)
    model = FFTRotH(cfg, generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    q = torch.stack([torch.randint(0, n, (b,), generator=g),
                     torch.randint(0, N_REL, (b,), generator=g)], 1)
    with torch.no_grad():
        model.c.copy_(0.6 + torch.rand(model.c.shape, generator=g))
        model.bh.copy_(torch.randn(model.bh.shape, generator=g))
        if case == "project":
            model.entity.mul_(8.0)
        elif case == "tanh":
            model.rel.mul_(40.0)
        elif case == "zero_row":
            model.entity[q[0, 0]] = 0.0
            model.rel[q[1, 1]] = 0.0
        elif case == "zero_givens":
            model.rel_diag[q[2, 1], 4:6] = 0.0
        elif case == "duplicates":
            q[5:9] = q[4]
            q[10, 0] = q[4, 0]
            q[11, 1] = q[4, 1]
    return model, q


def tables(model):
    return [getattr(model, k) for k in TABLES]


def case_engaged(case: str, model, q) -> bool:
    """Whether the weights reach the branch the case names."""
    with torch.no_grad():
        st = CQ._chain(*[t.detach() for t in tables(model)[:4]], q[:, 0], q[:, 1],
                       model.cfg.multi_c)
    if case == "inactive":
        return not any(bool(st[k][3].any()) for k in ("pu", "pra", "prb", "pl"))
    if case == "project":
        return bool(st["pu"][3].any()) and bool((st["eu"][2].abs() <= 15).all())
    if case == "tanh":
        return bool((st["era"][2] > 15).all())
    if case == "zero_row":
        return bool((st["eu"][0] < 1e-30).any()) and bool((st["era"][0] < 1e-30).any())
    if case == "zero_givens":
        return bool((st["gv"][0] < torch.finfo(torch.float64).tiny).any())
    return len(set(q[:, 0].tolist())) < len(q) and len(set(q[:, 1].tolist())) < len(q)


CASES = ["inactive", "project", "tanh", "zero_row", "zero_givens", "duplicates"]


@pytest.mark.parametrize("multi_c", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_backward_plain_matches_autograd_of_the_eager_chain(case, multi_c):
    model, q = make_model(case, multi_c)
    assert case_engaged(case, model, q)
    (res,), bias = parent_chain(model, q)
    g = torch.Generator().manual_seed(7)
    g_res = torch.randn(res.shape, generator=g, dtype=res.dtype)
    g_bias = torch.randn(bias.shape, generator=g, dtype=bias.dtype)
    want = torch.autograd.grad([res, bias], tables(model), [g_res, g_bias])
    with torch.no_grad():
        got = CQ.fftroth_queries_backward_plain(g_res, g_bias, *tables(model)[:4], q, multi_c)
    for name, a, e in zip(TABLES, got, want):
        assert a.shape == e.shape and a.dtype == e.dtype, name
        # float64 rounding of two formulas of one derivative
        torch.testing.assert_close(a, e, rtol=1e-9, atol=1e-9 * float(e.abs().max()),
                                   msg=name)


@pytest.mark.parametrize("multi_c", [True, False])
@pytest.mark.parametrize("case", ["inactive", "project", "tanh"])
def test_forward_plain_equals_the_eager_chain(case, multi_c):
    model, q = make_model(case, multi_c)
    with torch.no_grad():
        (want,), want_b = parent_chain(model, q)
        got, got_b = CQ.fftroth_queries_forward_plain(*tables(model), q, multi_c)
    torch.testing.assert_close(got, want, rtol=1e-13, atol=1e-14)
    assert torch.equal(got_b, want_b)


def test_forward_plain_in_float32_stays_within_the_eager_chains_rounding():
    model, q = make_model("inactive", True)
    with torch.no_grad():
        (ref,), _ = parent_chain(model, q)
        m32 = model.float()
        (eager,), _ = parent_chain(m32, q)
        got, _ = CQ.fftroth_queries_forward_plain(*tables(m32), q, True)
    scale = float(ref.abs().max())
    err_plain = float((got.double() - ref).abs().max()) / scale
    err_eager = float((eager.double() - ref).abs().max()) / scale
    assert err_plain < 1e-6 and err_eager < 1e-6
    assert err_plain <= 1.5 * err_eager


@pytest.mark.parametrize("unused_bias", [False, True])
def test_function_plain_grads_equal_the_eager_chain(unused_bias):
    """The autograd Function on the plain passes: its outputs and the
    gradients it returns to the five tables; an unused bias output gives
    the tables no bias term (and bh a zero gradient)."""
    model, q = make_model("duplicates", True)
    (res, ), bias = parent_chain(model, q)
    (got, ), got_b = CQ.fftroth_queries_plain(*tables(model), q, True)
    torch.testing.assert_close(got, res, rtol=1e-13, atol=1e-14)
    g = torch.Generator().manual_seed(3)
    w = torch.randn(res.shape, generator=g, dtype=res.dtype)
    loss = (res * w).sum() + (0.0 if unused_bias else (bias**2).sum())
    loss_f = (got * w).sum() + (0.0 if unused_bias else (got_b**2).sum())
    want = torch.autograd.grad(loss, tables(model), allow_unused=True)
    have = torch.autograd.grad(loss_f, tables(model), allow_unused=True)
    for name, a, e in zip(TABLES, have, want):
        if e is None:
            assert a is None or not a.any(), name
            continue
        torch.testing.assert_close(a, e, rtol=1e-9, atol=1e-9 * float(e.abs().max()),
                                   msg=name)


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
def test_cpu_and_other_dtypes_take_the_eager_chain_bit_for_bit(dtype):
    model, q = make_model("inactive", True, dtype=dtype)
    assert not CQ.use_kernel(*tables(model))
    CQ.reset_launches()
    (got,), got_b = model.get_queries(q)
    (want,), want_b = parent_chain(model, q)
    assert got.dtype == want.dtype == model.entity.dtype
    assert torch.equal(got, want) and torch.equal(got_b, want_b)
    g = torch.ones_like(got)
    grads = torch.autograd.grad([got, got_b], tables(model), [g, torch.ones_like(got_b)])
    want_g = torch.autograd.grad([want, want_b], tables(model), [g, torch.ones_like(want_b)])
    assert all(torch.equal(a, e) for a, e in zip(grads, want_g))
    assert set(CQ.launches.values()) == {0}


def test_cpu_wrappers_are_the_plain_versions_and_launch_nothing():
    model, q = make_model("duplicates", False, dtype="float32")
    t = [x.detach() for x in tables(model)]
    CQ.reset_launches()
    fwd = CQ.fftroth_queries_forward(*t, q, False)
    assert all(torch.equal(a, b) for a, b in
               zip(fwd, CQ.fftroth_queries_forward_plain(*t, q, False)))
    g_res, g_bias = torch.ones_like(fwd[0]), torch.ones_like(fwd[1])
    bwd = CQ.fftroth_queries_backward(g_res, g_bias, *t[:4], q, False)
    want = CQ.fftroth_queries_backward_plain(g_res, g_bias, *t[:4], q, False)
    assert all(torch.equal(a, b) for a, b in zip(bwd, want))
    assert set(CQ.launches.values()) == {0}


def test_backward_plain_sums_each_table_row_in_float64_once():
    """A table row's gradient is the fp64 sum of its rows' float32
    gradients, rounded once; a row no query names gets zeros."""
    model, q = make_model("duplicates", True, dtype="float32")
    t = [x.detach() for x in tables(model)]
    g = torch.Generator().manual_seed(2)
    g_res = torch.randn((len(q), 2 * RANK), generator=g)
    rows = CQ.fftroth_queries_rows_plain(g_res, *t[:4], q, True)
    d_entity, d_rel, d_rd, d_c, d_bh = CQ.fftroth_queries_backward_plain(
        g_res, None, *t[:4], q, True)
    h, r = q[:, 0], q[:, 1]

    def ascending_sum(x):
        acc = torch.zeros(x.shape[1:], dtype=torch.float64)
        for row in x:
            acc = acc + row.double()
        return acc.float()

    e, j = int(q[4, 0]), int(q[4, 1])
    assert torch.equal(d_entity[e], ascending_sum(rows[0][h == e]))
    assert torch.equal(d_rel[j], ascending_sum(rows[1][r == j]))
    assert torch.equal(d_rd[j], ascending_sum(rows[2][r == j]))
    unnamed = [i for i in range(model.cfg.n_entities) if i not in set(h.tolist())]
    assert not d_entity[unnamed].any() and not d_bh.any()
    # the softplus' gradient after the sum
    want_c = ascending_sum(rows[3][r == j]) / (1 + torch.exp(0 - t[3][j]))
    torch.testing.assert_close(d_c[j], want_c, rtol=2**-22, atol=0.0)


def test_dft_matrices_are_the_fft_modules():
    d = 2 * RANK
    mats = CQ.dft_matrices(d, "cpu")
    dn = d * (d - 2)
    mi, mf = irfft_matrix(RANK, dtype=torch.float64), rfft_matrix(d - 2, dtype=torch.float64)
    assert torch.equal(mats[:dn].reshape(d, d - 2), mi)
    assert torch.equal(mats[dn:2 * dn].reshape(d - 2, d), mf)
    assert torch.equal(mats[2 * dn:3 * dn].reshape(d, d - 2), mf.T)
    assert torch.equal(mats[3 * dn:].reshape(d - 2, d), mi.T)


def test_curvature_matches_the_model():
    for multi_c in (True, False):
        model, q = make_model("inactive", multi_c)
        cv = CQ._curvature(model.c, q[:, 1], multi_c)
        assert torch.equal(cv.expand(len(q), 1), model.curvature(q[:, 1]).expand(len(q), 1))
    assert torch.equal(_softplus(model.c), torch.logaddexp(model.c, torch.zeros_like(model.c)))


# ---------------------------------- on a card ----------------------------------

WN18RR_N, B = 40943, 500


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


def wn18rr_model(scale: float, multi_c: bool, device, seed=0):
    """FFTRotH at WN18RR's shapes in float32: the published init (scale 0)
    or rows drawn at `scale` (a trained spread; 0.5 clips in project)."""
    cfg = ModelConfig(n_entities=WN18RR_N, n_relations=N_REL, rank=RANK, multi_c=multi_c,
                      init_size=1e-3, dtype="float32")
    model = FFTRotH(cfg, device=device, generator=torch.Generator().manual_seed(seed))
    if scale:
        g = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for name in ("entity", "rel", "bh"):
                p = getattr(model, name)
                p.copy_(torch.randn(p.shape, generator=g) * scale)
            model.c.copy_(1.0 + 0.05 * torch.randn(model.c.shape, generator=g))
    return model


def wn18rr_queries(device, seed=5):
    g = torch.Generator().manual_seed(seed)
    q = torch.stack([torch.randint(0, WN18RR_N, (B,), generator=g),
                     torch.randint(0, N_REL, (B,), generator=g),
                     torch.randint(0, WN18RR_N, (B,), generator=g)], 1)
    q[7, :2] = q[3, :2]  # repeated (h, r), h and r
    q[9, 0] = q[3, 0]
    return q.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("multi_c", [True, False])
@pytest.mark.parametrize("scale", [0.0, 0.1, 0.5])
def test_kernels_match_plain_on_card(scale, multi_c):
    """Limits: the forward within 4 float32 ulps of the output's largest
    entry of the plain version on the card (fp64 sums in another order
    may round once the other way, and the DFTs' fp64 order differs); the
    gradients within 1e-5 of each table's largest entry (a rounding the
    other way early in the chain carries through the backward's f32
    steps)."""
    dev = _cuda_or_skip()
    model = wn18rr_model(scale, multi_c, dev)
    t = [x.detach() for x in tables(model)]
    q = wn18rr_queries(dev)[:, :2]
    res, bias = CQ.fftroth_queries_forward(*t, q, multi_c)
    want, want_b = CQ.fftroth_queries_forward_plain(*t, q, multi_c)
    assert torch.equal(bias, want_b)
    assert float((res - want).abs().max()) <= 4 * 2**-23 * float(want.abs().max())
    g = torch.Generator(device=dev).manual_seed(3)
    g_res = torch.randn(res.shape, device=dev, generator=g)
    g_bias = torch.randn(bias.shape, device=dev, generator=g)
    got = CQ.fftroth_queries_backward(g_res, g_bias, *t[:4], q, multi_c)
    want = CQ.fftroth_queries_backward_plain(g_res, g_bias, *t[:4], q, multi_c)
    for name, a, e in zip(TABLES, got, want):
        assert a.shape == e.shape, name
        assert float((a - e).abs().max()) <= 1e-5 * float(e.abs().max()), name


@pytest.mark.cuda
def test_backward_gives_the_same_bits_twice():
    dev = _cuda_or_skip()
    model = wn18rr_model(0.1, True, dev)
    t = [x.detach() for x in tables(model)]
    q = wn18rr_queries(dev)[:, :2]
    g = torch.Generator(device=dev).manual_seed(4)
    g_res = torch.randn((B, 2 * RANK), device=dev, generator=g)
    g_bias = torch.randn((B, 1), device=dev, generator=g)
    one = CQ.fftroth_queries_backward(g_res, g_bias, *t[:4], q, True)
    two = CQ.fftroth_queries_backward(g_res, g_bias, *t[:4], q, True)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


def _trainer(model, double_neg=True, **kw):
    from complexhyperbolickge_torch.train.trainer import TrainConfig, Trainer

    cfg = TrainConfig(optimizer="Adam", learning_rate=3e-4, neg_sample_size=100,
                      double_neg=double_neg, batch_size=B)
    return Trainer(model, cfg, model.cfg.n_entities, model.cfg.n_relations, **kw)


@pytest.mark.cuda
def test_double_neg_step_launches_the_pair_twice_and_no_fft():
    from torch.profiler import ProfilerActivity, profile

    dev = _cuda_or_skip()
    model = wn18rr_model(0.0, True, dev)
    trainer = _trainer(model)
    batch = wn18rr_queries(dev, seed=11).cpu().numpy()[None]
    weights = torch.ones((1, B)).numpy()
    gen = torch.Generator(device=dev).manual_seed(0)
    trainer.run_epoch(batch, weights, gen)  # warm-up: builds and loads
    CQ.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.run_epoch(batch, weights, gen)
        torch.cuda.synchronize()
    assert CQ.launches == {"fftroth_queries_fwd": 2, "fftroth_queries_bwd": 2,
                           "fftroth_queries_sum": 2}
    names = {e.name for e in prof.events()}
    # cuFFT's kernels and aten's FFT ops are gone (the Function's own
    # autograd nodes and kernels carry "FFTRotH" / "fftroth" in their names)
    assert not [n for n in names if "fft" in n.lower() and "fftroth" not in n.lower()]
    for kernel in ("fftroth_queries_fwd_kernel", "fftroth_queries_bwd_kernel",
                   "fftroth_queries_sum_kernel"):
        assert any(kernel in n for n in names), kernel


@pytest.mark.cuda
def test_reinitialised_model_trains_on_the_kernels():
    """Trainer.init() draws fresh tables and a fresh optimizer; the next
    steps run the fused chain and move every table the chain reads."""
    dev = _cuda_or_skip()
    model = wn18rr_model(0.0, True, dev)
    trainer = _trainer(model)
    trainer.init(torch.Generator().manual_seed(9))
    before = {k: getattr(model, k).detach().clone() for k in TABLES}
    batch = wn18rr_queries(dev, seed=12).cpu().numpy()[None]
    CQ.reset_launches()
    loss = trainer.run_epoch(batch, torch.ones((1, B)).numpy(),
                             torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    assert CQ.launches["fftroth_queries_fwd"] == 2 and CQ.launches["fftroth_queries_bwd"] == 2
    assert torch.isfinite(torch.as_tensor(loss))
    assert all(not torch.equal(getattr(model, k), before[k]) for k in TABLES)


def _mesh_rank(rank, world, steps, negs):
    """Two SGD steps of a 1x2 mesh (entity rows split; the tables gathered
    and swapped in through call_with_tables) on the card; returns the
    gathered params and the fused chain's launches on this rank."""
    from complexhyperbolickge_torch.parallel.mesh import gather_entity_tree, make_mesh

    return _sgd_steps(steps, negs, mesh=make_mesh((1, 2), device="cuda"),
                      gather=gather_entity_tree)


def _sgd_steps(steps, negs, mesh=None, gather=None):
    from complexhyperbolickge_torch.train.trainer import TrainConfig, Trainer

    dev = torch.device("cuda")
    model = wn18rr_model(0.1, True, dev)
    it = iter([torch.as_tensor(n, device=dev) for n in negs])
    cfg = TrainConfig(optimizer="SGD", learning_rate=0.5, neg_sample_size=negs[0].shape[1],
                      double_neg=True, batch_size=steps.shape[1])
    trainer = Trainer(model, cfg, WN18RR_N, N_REL, mesh=mesh, sampler=lambda *a: next(it))
    CQ.reset_launches()
    trainer.run_epoch(steps, torch.ones(steps.shape[:2]).numpy(), None)
    torch.cuda.synchronize()
    params = model.state_dict()
    if mesh is not None:
        params = gather(params, WN18RR_N, mesh)
    return {k: v.detach().cpu() for k, v in params.items()}, dict(CQ.launches)


@pytest.mark.cuda
def test_mesh_through_call_with_tables_matches_the_eager_chain(tmp_path):
    """A 1x2 mesh (two ranks sharing the card under gloo) trains through
    the fused chain on the gathered tables; one process on the eager
    chain takes the same steps.  SGD makes the change of the params the
    gradients, so the limit is the gradients' float32 rounding."""
    from torch_parallel_util import spawn_group

    _cuda_or_skip()
    g = torch.Generator().manual_seed(21)
    steps = torch.stack([torch.randint(0, WN18RR_N, (2, B), generator=g),
                         torch.randint(0, N_REL, (2, B), generator=g),
                         torch.randint(0, WN18RR_N, (2, B), generator=g)], -1).numpy()
    negs = [torch.randint(0, WN18RR_N, (B, 100), generator=g) for _ in range(4)]
    ranks = spawn_group(_mesh_rank, 2, (steps, negs), tmp_path, timeout=600.0)
    real = CQ.use_kernel
    CQ.use_kernel = lambda *a: False
    try:
        eager, eager_launches = _sgd_steps(steps, negs)
    finally:
        CQ.use_kernel = real
    assert set(eager_launches.values()) == {0}
    for params, launches in ranks:
        assert launches["fftroth_queries_fwd"] == 4 and launches["fftroth_queries_bwd"] == 4
        for k, v in eager.items():
            torch.testing.assert_close(params[k], v, rtol=1e-5, atol=1e-6, msg=k)
