"""The chyp_rank (K1, K2), hyp_rank (K5-K8), segsum (K9) and gather (K10)
CUDA kernels against their plain PyTorch versions.

Needs a CUDA card, the CUDA toolkit and no JAX; on a machine without a card
every test skips (they carry the `cuda` marker).  On one with a card:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerance: kernel and plain version sum the contraction (the Hermitian
form, <x, v>) in different orders, so a query's count may differ by at
most the number of entities whose plain score lies within
1e-5 * (1 + |t2|) of its threshold t2.
Between the kernels the scores are bit-identical, so the maskless count
(sweep - subtraction) equals the masked count exactly.
"""

from functools import partial

import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.kernels import chyp_rank as K
from complexhyperbolickge_torch.kernels import hyp_rank as K5

pytestmark = pytest.mark.cuda

# (B, N, D, L): the ragged edges of every tile shape — queries not a
# multiple of 32, entities not of 128, features below / across / above one
# 32-wide chunk
SHAPES = [(48, 300, 18, 6), (37, 1000, 66, 9), (5, 129, 70, 3), (500, 4000, 66, 12)]


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


def make_inputs(b, n, d, l, seed=0):
    """Ranking inputs on the CPU: thresholds at each query's gold score,
    filter rows holding the gold once, pad = n."""
    rng = np.random.default_rng(seed)
    np_ = -(-(n + 1) // 128) * 128
    lhs = torch.as_tensor(rng.normal(0, 0.15, (b, d)), dtype=torch.float32)
    r = d // 2
    lhs2 = torch.cat([lhs, torch.cat([lhs[:, r:], -lhs[:, :r]], 1)]).contiguous()
    rhs = torch.zeros((np_, d), dtype=torch.float32)
    rhs[:n] = torch.as_tensor(rng.normal(0, 0.15, (n, d)), dtype=torch.float32)
    bt = torch.full((np_,), -1e30, dtype=torch.float32)
    bt[:n] = torch.as_tensor(rng.normal(0, 0.3, n), dtype=torch.float32)
    eps = 4e-3
    zn = (torch.sum(lhs * lhs, -1) - 1.0).clamp(-1.0, -eps)
    wn = (torch.sum(rhs * rhs, -1) - 1.0).clamp(-1.0, -eps)
    gold = rng.integers(0, n, b)
    fidx = np.full((b, l), n, np.int32)
    for i in range(b):
        others = rng.choice(np.setdiff1d(np.arange(n), [gold[i]]), rng.integers(0, l), False)
        fidx[i, :len(others)] = others
        fidx[i, len(others)] = gold[i]
    scores = K.chyp_scores_plain(lhs2, zn, rhs, wn, bt)
    t2 = scores[torch.arange(b), torch.as_tensor(gold)].contiguous()
    mask = torch.zeros((b, np_), dtype=torch.int8)
    mask[:, n:] = 1
    mask.scatter_(1, torch.as_tensor(fidx, dtype=torch.int64), 1)
    near = ((scores - t2[:, None]).abs() <= (1e-5 * (1 + t2.abs()))[:, None]).sum(1)
    return dict(lhs2=lhs2, zn=zn, t2=t2, rhs=rhs, wn=wn, bt=bt, mask=mask,
                gold=torch.as_tensor(gold, dtype=torch.int32),
                fidx=torch.as_tensor(fidx)), near


BASE = ("lhs2", "zn", "t2", "rhs", "wn", "bt")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kernel", ["masked", "nomask", "filtered_sub"])
def test_kernel_matches_plain(kernel, shape):
    dev = _cuda_or_skip()
    t, near = make_inputs(*shape)
    c = {k: v.to(dev) for k, v in t.items()}
    fn, plain, extra = {
        "masked": (K.chyp_rank_counts, K.chyp_rank_counts_plain, ("mask",)),
        "nomask": (K.chyp_rank_sweep_nomask, K.chyp_rank_sweep_nomask_plain, ("gold",)),
        "filtered_sub": (K.chyp_rank_filtered_sub, K.chyp_rank_filtered_sub_plain,
                         ("fidx", "gold")),
    }[kernel]
    got = fn(*[c[k] for k in BASE + extra])
    torch.cuda.synchronize()
    want = plain(*[t[k] for k in BASE + extra])
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert ((got.cpu() - want).abs() <= near).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_maskless_equals_masked_exactly(shape):
    dev = _cuda_or_skip()
    t, _ = make_inputs(*shape)
    c = {k: v.to(dev) for k, v in t.items()}
    masked = K.chyp_rank_counts(*[c[k] for k in BASE], c["mask"])
    nomask = K.chyp_rank_counts_nomask(*[c[k] for k in BASE], c["fidx"], c["gold"])
    assert torch.equal(masked, nomask)


def test_wrappers_check_inputs_and_count_launches():
    dev = _cuda_or_skip()
    t, _ = make_inputs(*SHAPES[0])
    c = {k: v.to(dev) for k, v in t.items()}
    K.reset_launches()
    K.chyp_rank_counts(*[c[k] for k in BASE], c["mask"])
    assert K.launches["chyp_rank_sweep_masked"] == 1
    with pytest.raises(TypeError, match="dtype"):
        K.chyp_rank_counts(*[c[k] for k in BASE], c["mask"].to(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        K.chyp_rank_counts(c["lhs2"], c["zn"], c["t2"], c["rhs"].T.contiguous().T,
                           c["wn"], c["bt"], c["mask"])
    with pytest.raises(ValueError, match="is on"):
        K.chyp_rank_counts(*[c[k] for k in BASE], t["mask"])
    assert K.launches["chyp_rank_sweep_masked"] == 1


# ---------------------- hyp_rank: K5-K8 (csrc/hyp_rank.cu) ----------------------

HYP_KINDS = ("poincare", "lorentz", "attrh")
# (B, N, D, L): D = 8 below one 32-wide chunk, 32 the main path's, 40 across
# two chunks (AttRH's halves then split inside the second); ragged B and N
HYP_SHAPES = [(48, 300, 8, 6), (37, 1000, 32, 9), (5, 129, 40, 3), (500, 4000, 32, 12)]


def hyp_inputs(kind, b, n, d, l, seed=0):
    """K5-K8 inputs on the CPU: thresholds at each query's gold score,
    filter rows holding the gold once, pad = n; returns (args, extras,
    near) with args the wrappers' leading inputs in order."""
    rng = np.random.default_rng(seed)
    np_ = -(-(n + 1) // 128) * 128
    f32 = torch.float32
    lhs = torch.as_tensor(rng.normal(0, 0.2, (b, d)), dtype=f32)
    rhs = torch.zeros((np_, d), dtype=f32)
    rhs[:n] = torch.as_tensor(rng.normal(0, 0.4, (n, d)), dtype=f32)
    bt = torch.full((np_,), -1e30, dtype=f32)
    bt[:n] = torch.as_tensor(rng.normal(0, 0.3, n), dtype=f32)
    c = torch.as_tensor(rng.uniform(0.5, 1.5, b), dtype=f32)

    def norm(rows):
        return torch.sqrt(torch.sum(rows * rows, -1).clamp_min(1e-30))

    if kind == "attrh":
        h = d // 2
        w = torch.softmax(torch.as_tensor(rng.normal(0, 1, (b, 2)), dtype=f32), -1)
        per_query = [torch.sum(lhs[:, :h] ** 2, -1), torch.sum(lhs[:, h:] ** 2, -1), c,
                     w[:, 0].contiguous(), w[:, 1].contiguous()]
        per_row = [norm(rhs[:, :h]), norm(rhs[:, h:]), bt]
        scores = K5.attrh_scores_plain(lhs, *per_query, rhs, *per_row)
    else:
        per_query = [torch.sum(lhs * lhs, -1), c]
        per_row = [norm(rhs), bt]
        scores = K5.hyp_scores_plain(lhs, *per_query, rhs, *per_row, family=kind)
    gold = rng.integers(0, n, b)
    t2 = scores[torch.arange(b), torch.as_tensor(gold)].contiguous()
    fidx = np.full((b, l), n, np.int32)
    for i in range(b):
        others = rng.choice(np.setdiff1d(np.arange(n), [gold[i]]), rng.integers(0, l), False)
        fidx[i, :len(others)] = others
        fidx[i, len(others)] = gold[i]
    mask = torch.zeros((b, np_), dtype=torch.int8)
    mask[:, n:] = 1
    mask.scatter_(1, torch.as_tensor(fidx, dtype=torch.int64), 1)
    near = ((scores - t2[:, None]).abs() <= (1e-5 * (1 + t2.abs()))[:, None]).sum(1)
    args = [lhs, *per_query, t2, rhs, *per_row]
    extras = dict(mask=mask, gold=torch.as_tensor(gold, dtype=torch.int32),
                  fidx=torch.as_tensor(fidx))
    return args, extras, near


def hyp_fns(kind):
    """name -> (kernel wrapper, plain version, extra input names)."""
    if kind == "attrh":
        return {"masked": (K5.attrh_rank_counts, K5.attrh_rank_counts_plain, ("mask",)),
                "nomask": (K5.attrh_rank_sweep_nomask, K5.attrh_rank_sweep_nomask_plain,
                           ("gold",)),
                "filtered_sub": (K5.attrh_rank_filtered_sub,
                                 K5.attrh_rank_filtered_sub_plain, ("fidx", "gold"))}
    fam = {"family": kind}
    return {"masked": (partial(K5.hyp_rank_counts, **fam),
                       partial(K5.hyp_rank_counts_plain, **fam), ("mask",)),
            "nomask": (partial(K5.hyp_rank_sweep_nomask, **fam),
                       partial(K5.hyp_rank_sweep_nomask_plain, **fam), ("gold",)),
            "filtered_sub": (partial(K5.hyp_rank_filtered_sub, **fam),
                             partial(K5.hyp_rank_filtered_sub_plain, **fam),
                             ("fidx", "gold"))}


@pytest.mark.parametrize("shape", HYP_SHAPES)
@pytest.mark.parametrize("kernel", ["masked", "nomask", "filtered_sub"])
@pytest.mark.parametrize("kind", HYP_KINDS)
def test_hyp_kernel_matches_plain(kind, kernel, shape):
    dev = _cuda_or_skip()
    args, extras, near = hyp_inputs(kind, *shape)
    fn, plain, extra = hyp_fns(kind)[kernel]
    got = fn(*[a.to(dev) for a in args], *[extras[k].to(dev) for k in extra])
    torch.cuda.synchronize()
    want = plain(*args, *[extras[k] for k in extra])
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert ((got.cpu() - want).abs() <= near).all()


@pytest.mark.parametrize("shape", HYP_SHAPES)
@pytest.mark.parametrize("kind", HYP_KINDS)
def test_hyp_maskless_equals_masked_exactly(kind, shape):
    dev = _cuda_or_skip()
    args, extras, _ = hyp_inputs(kind, *shape)
    a = [t.to(dev) for t in args]
    e = {k: v.to(dev) for k, v in extras.items()}
    if kind == "attrh":
        masked = K5.attrh_rank_counts(*a, e["mask"])
        nomask = K5.attrh_rank_counts_nomask(*a, e["fidx"], e["gold"])
    else:
        masked = K5.hyp_rank_counts(*a, e["mask"], family=kind)
        nomask = K5.hyp_rank_counts_nomask(*a, e["fidx"], e["gold"], family=kind)
    assert torch.equal(masked, nomask)


def test_hyp_wrappers_check_inputs_and_count_launches():
    dev = _cuda_or_skip()
    args, extras, _ = hyp_inputs("lorentz", *HYP_SHAPES[0])
    a = [t.to(dev) for t in args]
    mask = extras["mask"].to(dev)
    K5.reset_launches()
    K5.hyp_rank_counts(*a, mask, family="lorentz")
    assert K5.launches["hyp_rank_sweep_masked"] == 1
    with pytest.raises(ValueError, match="unknown hyp_rank family"):
        K5.hyp_rank_counts(*a, mask, family="klein")
    with pytest.raises(TypeError, match="dtype"):
        K5.hyp_rank_counts(*a, mask.to(torch.int32), family="lorentz")
    with pytest.raises(ValueError, match="is on"):
        K5.hyp_rank_counts(*a, extras["mask"], family="lorentz")
    odd = [t[:, :7].contiguous() if t.dim() == 2 else t for t in a]
    with pytest.raises(ValueError, match="halves"):
        K5.attrh_rank_counts(odd[0], a[1], a[1], a[2], a[2], a[2], a[3], odd[4], a[5],
                             a[5], a[6], mask)
    assert K5.launches["hyp_rank_sweep_masked"] == 1
    assert sum(K5.launches.values()) == 1


# ------------------- GNN: K9 (csrc/segsum.cu), K10 (csrc/gather.cu) -------------------

from complexhyperbolickge_torch.kernels import gather as G  # noqa: E402
from complexhyperbolickge_torch.kernels import segsum as S  # noqa: E402

# (E, N, H): H = 1 (32 rows a warp), 3 (no 16-byte vectors), 32 and 200 (the
# encoder's widths), 66 (16-byte vectors in float64 only); N = 1000 > E
# leaves rows without edges
GNN_SHAPES = [(1000, 300, 1), (777, 500, 3), (5000, 777, 32), (86_835, 40_943, 200),
              (300, 1000, 66)]
# K9 against index_add_: another summation order
GNN_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6), torch.float64: dict(rtol=1e-12, atol=1e-13)}


def gnn_inputs(e, n, h, dtype, seed=0):
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n, e))
    msgs = torch.as_tensor(rng.normal(size=(e, h)), dtype=dtype)
    x = torch.as_tensor(rng.normal(size=(n, h)), dtype=dtype)
    ids = rng.integers(0, n, e)
    return dst, msgs, x, ids


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", GNN_SHAPES)
def test_segsum_matches_plain_forward_and_backward(shape, dtype):
    dev = _cuda_or_skip()
    e, n, h = shape
    dst, msgs, _, _ = gnn_inputs(e, n, h, dtype)
    seg, seg_cpu = S.make_sorted_segment_sum(dst, n, dev), S.make_sorted_segment_sum(dst, n, "cpu")
    m = msgs.to(dev).requires_grad_()
    out = seg(m)
    g = torch.randn(out.shape, dtype=dtype, generator=torch.Generator().manual_seed(1))
    (out * g.to(dev)).sum().backward()
    torch.cuda.synchronize()
    mc = msgs.clone().requires_grad_()
    want = S.sorted_segment_sum_plain(mc, seg_cpu)
    (want * g).sum().backward()
    torch.testing.assert_close(out.detach().cpu(), want.detach(), **GNN_TOL[dtype])
    assert torch.equal(m.grad.cpu(), mc.grad)  # a gather: exact


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", GNN_SHAPES)
def test_row_gather_matches_plain_forward_and_backward(shape, dtype):
    dev = _cuda_or_skip()
    e, n, h = shape
    _, _, x, ids = gnn_inputs(e, n, h, dtype)
    gth = G.make_row_gather(ids, n, dev)
    xc = x.to(dev).requires_grad_()
    out = gth(xc)
    g = torch.randn(out.shape, dtype=dtype, generator=torch.Generator().manual_seed(2))
    (out * g.to(dev)).sum().backward()
    torch.cuda.synchronize()
    xr = x.clone().requires_grad_()
    want = G.row_gather_plain(xr, torch.as_tensor(ids))
    (want * g).sum().backward()
    assert torch.equal(out.detach().cpu(), want.detach())
    # the backward is a K9 sum over the sorted ids
    torch.testing.assert_close(xc.grad.cpu(), xr.grad, **GNN_TOL[dtype])
    # and it is deterministic
    again = torch.autograd.grad((gth(xc) * g.to(dev)).sum(), xc)[0]
    assert torch.equal(again, xc.grad)


def test_gnn_wrappers_check_inputs_and_count_launches():
    dev = _cuda_or_skip()
    dst, msgs, x, ids = gnn_inputs(500, 100, 8, torch.float32)
    seg = S.make_sorted_segment_sum(dst, 100, dev)
    gth = G.make_row_gather(ids, 100, dev)
    S.reset_launches()
    G.reset_launches()
    seg(msgs.to(dev))
    gth(x.to(dev))
    assert S.launches["sorted_segment_sum"] == 1 and G.launches["row_gather"] == 1
    with pytest.raises(TypeError, match="float32 and float64"):
        seg(msgs.to(dev, torch.bfloat16))
    with pytest.raises(TypeError, match="float32 and float64"):
        gth(x.to(dev, torch.float16))
    with pytest.raises(ValueError, match="shape"):
        seg(msgs[:-1].to(dev))
    with pytest.raises(ValueError, match="rows"):
        gth(x[:-1].to(dev))
    with pytest.raises(TypeError, match="int32"):
        G.row_gather(x.to(dev), torch.as_tensor(ids, device=dev))
    assert S.launches["sorted_segment_sum"] == 1 and G.launches["row_gather"] == 1
