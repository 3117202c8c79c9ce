"""The chyp_rank (K1, K2), hyp_rank (K5-K8), segsum (K9), gather (K10) and
relgrad (the relation tables' gradient) CUDA kernels against their plain
PyTorch versions.

Needs a CUDA card, the CUDA toolkit and no JAX; on a machine without a card
every test skips (they carry the `cuda` marker).  On one with a card:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerance: kernel and plain version sum the contraction (the Hermitian
form, <x, v>) in different orders, so a query's count may differ by at
most the number of entities whose plain score lies within
1e-5 * (1 + |t2|) of its threshold t2.
Between the kernels the scores are bit-identical, so the maskless count
(sweep - subtraction) equals the masked count exactly.  The same holds for
the rankers' bf16 tensor-core instances (precision "default"), held
against their plain default versions on the same bf16 operands.
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


def make_inputs(b, n, d, l, seed=0, np_=None, ld=None):
    """Ranking inputs on the CPU: thresholds at each query's gold score,
    filter rows holding the gold once, pad = n, Np rows (default n + 1
    rounded up to 128) of ld >= d floats (default d), zero past d."""
    rng = np.random.default_rng(seed)
    np_ = np_ or -(-(n + 1) // 128) * 128
    lhs = torch.as_tensor(rng.normal(0, 0.15, (b, d)), dtype=torch.float32)
    r = d // 2
    lhs2 = torch.cat([lhs, torch.cat([lhs[:, r:], -lhs[:, :r]], 1)]).contiguous()
    rhs = torch.zeros((np_, ld or d), dtype=torch.float32)
    rhs[:n, :d] = torch.as_tensor(rng.normal(0, 0.15, (n, d)), dtype=torch.float32)
    bt = torch.full((np_,), -1e30, dtype=torch.float32)
    bt[:n] = torch.as_tensor(rng.normal(0, 0.3, n), dtype=torch.float32)
    eps = 4e-3
    zn = (torch.sum(lhs * lhs, -1) - 1.0).clamp(-1.0, -eps)
    wn = (torch.sum(rhs[:, :d] ** 2, -1) - 1.0).clamp(-1.0, -eps)
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
    with pytest.raises(ValueError, match="fewer than"):
        K.chyp_rank_counts(c["lhs2"], c["zn"], c["t2"], c["rhs"][:, :-1].contiguous(),
                           c["wn"], c["bt"], c["mask"])
    with pytest.raises(ValueError, match="16-byte"):
        K.chyp_rank_counts(c["lhs2"], c["zn"], c["t2"], c["rhs"],
                           torch.cat([c["wn"][:1], c["wn"]])[1:], c["bt"], c["mask"])
    assert K.launches["chyp_rank_sweep_masked"] == 1


# (B, N, D, L, Np, ld): the main path's shape with the table's rows padded
# to 68 floats (more (query tile, entity tile) items than resident blocks);
# B = 5 at Np = 129 (fewer items than blocks; byte-wise mask copies);
# unpadded rows of D = 66 (4-byte row copies); D = 70 in rows of 72 (two
# feature chunks); D = 18 in rows of 20; D = 400 (the query tile too wide
# to stage whole: its rows staged a chunk a stage)
CHYP_RAGGED = [(500, 40_000, 66, 5, None, 68), (5, 128, 66, 3, 129, 68),
               (37, 1000, 66, 9, 1005, 66), (20, 500, 70, 5, 520, 72),
               (48, 300, 18, 6, None, 20), (37, 600, 400, 5, None, 400)]


def _on(dev, t):
    return {k: v.to(dev) for k, v in t.items()}


@pytest.mark.parametrize("shape", CHYP_RAGGED)
def test_chyp_ragged_matches_plain_and_maskless(shape):
    """K1, K2's sweep and its subtraction at ragged B, Np and table strides,
    with every 5th gold -1: within the near-threshold count of the plain
    versions, and K1 == K2 sweep - subtraction exactly (a gold of -1: the
    sweep counts the gold row and the subtraction its filter slot)."""
    dev = _cuda_or_skip()
    b, n, d, l, np_, ld = shape
    t, near = make_inputs(b, n, d, l, np_=np_, ld=ld)
    t["gold"][::5] = -1
    c = _on(dev, t)
    base = [c[k] for k in BASE]
    got = {"masked": K.chyp_rank_counts(*base, c["mask"]),
           "nomask": K.chyp_rank_sweep_nomask(*base, c["gold"]),
           "filtered_sub": K.chyp_rank_filtered_sub(*base, c["fidx"], c["gold"])}
    torch.cuda.synchronize()
    plain = [t[k] for k in BASE]
    want = {"masked": K.chyp_rank_counts_plain(*plain, t["mask"]),
            "nomask": K.chyp_rank_sweep_nomask_plain(*plain, t["gold"]),
            "filtered_sub": K.chyp_rank_filtered_sub_plain(*plain, t["fidx"], t["gold"])}
    for name in got:
        assert got[name].dtype == torch.int32 and got[name].shape == (b,)
        assert ((got[name].cpu() - want[name]).abs() <= near).all(), name
    assert torch.equal(got["masked"], got["nomask"] - got["filtered_sub"])


@pytest.mark.parametrize("shape", CHYP_RAGGED)
def test_chyp_unfiltered_golds(shape):
    """A batch whose golds are not filtered: K1 within the near-threshold
    count of the plain version, and K1 == K2 sweep - subtraction + the
    gold's own count (the subtraction over the gold alone, gold -1), which
    is what the ranker's +1 stands for."""
    dev = _cuda_or_skip()
    b, n, d, l, np_, ld = shape
    t, near = make_inputs(b, n, d, l, np_=np_, ld=ld)
    gold = t["gold"]
    t["fidx"] = torch.where(t["fidx"] == gold[:, None], n, t["fidx"])
    t["mask"] = torch.zeros_like(t["mask"])
    t["mask"][:, n:] = 1
    t["mask"].scatter_(1, t["fidx"].long(), 1)
    c = _on(dev, t)
    base = [c[k] for k in BASE]
    masked = K.chyp_rank_counts(*base, c["mask"])
    torch.cuda.synchronize()
    want = K.chyp_rank_counts_plain(*[t[k] for k in BASE], t["mask"])
    assert ((masked.cpu() - want).abs() <= near).all()
    own = K.chyp_rank_filtered_sub(*base, c["gold"][:, None].contiguous(),
                                   torch.full_like(c["gold"], -1))
    maskless = K.chyp_rank_counts_nomask(*base, c["fidx"], c["gold"])
    assert torch.equal(masked, maskless + own)


@pytest.mark.parametrize("masked", [True, False])
def test_chyp_sweep_info(masked):
    """The sweeps at the main path's D = 66: resident, no spills."""
    dev = _cuda_or_skip()
    info = K.sweep_info(dev, 66, masked=masked)
    assert info["blocks_per_sm"] >= 1 and info["local_bytes"] == 0
    assert info["regs_per_thread"] > 0 and info["smem_bytes"] > 48 * 1024


# ---------------------- hyp_rank: K5-K8 (csrc/hyp_rank.cu) ----------------------

HYP_KINDS = ("poincare", "lorentz", "attrh")
# (B, N, D, L): D = 8 below one 32-wide chunk, 32 the main path's, 40 across
# two chunks (AttRH's halves then split inside the second); ragged B and N
HYP_SHAPES = [(48, 300, 8, 6), (37, 1000, 32, 9), (5, 129, 40, 3), (500, 4000, 32, 12)]
# (B, N, D, L, Np): tables whose row count is not a multiple of the 128-row
# tile (Np % 16 == 0: 16-byte mask copies; else byte loads), D = 32 and
# D = 64 (two feature chunks), D = 18 (rows copied 4 bytes at a time)
HYP_RAGGED = [(37, 1000, 32, 9, 1005), (45, 2000, 64, 7, 2016), (300, 3000, 64, 11, 3001),
              (20, 500, 18, 5, 520)]


def hyp_inputs(kind, b, n, d, l, np_=None, seed=0, curvatures=None):
    """K5-K8 inputs on the CPU: thresholds at each query's gold score,
    filter rows holding the gold once, pad = n, Np rows (default n + 1
    rounded up to 128), c = cvals[cid] for curvatures = (cvals, cid);
    returns (args, extras, near) with args the maskless wrappers' leading
    inputs in order."""
    rng = np.random.default_rng(seed)
    np_ = np_ or -(-(n + 1) // 128) * 128
    f32 = torch.float32
    lhs = torch.as_tensor(rng.normal(0, 0.2, (b, d)), dtype=f32)
    rhs = torch.zeros((np_, d), dtype=f32)
    rhs[:n] = torch.as_tensor(rng.normal(0, 0.4, (n, d)), dtype=f32)
    bt = torch.full((np_,), -1e30, dtype=f32)
    bt[:n] = torch.as_tensor(rng.normal(0, 0.3, n), dtype=f32)
    c = torch.as_tensor(rng.uniform(0.5, 1.5, b), dtype=f32)
    if curvatures is not None:
        c = curvatures[0][curvatures[1].long()]

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


def tabled_call(kind, fn, cid=None, cvals=None):
    """A sweep (masked or maskless), the maskless count or a plain version
    `fn`, called with the subtractions' inputs (c in place of cid and
    cvals) and then its own extra inputs: by default each query its own
    curvature, cid = arange(B), cvals = c; the radius table from
    hyp_rank_radii on the inputs' device."""
    fam = {} if kind == "attrh" else {"family": kind}

    def call(lhs, *rest):
        if kind == "attrh":
            (x2r, x2f, c, w0, w1, t2, rhs, un_rot, un_ref, bt), extra = rest[:10], rest[10:]
        else:
            (x2, c, t2, rhs, un, bt), extra = rest[:6], rest[6:]
        ids = torch.arange(len(c), dtype=torch.int32) if cid is None else cid
        ids, cv = ids.to(c.device), (c if cvals is None else cvals.to(c.device))
        if kind == "attrh":
            radii = K5.hyp_rank_radii(cv, un_rot, "attrh", un_ref)
            return fn(lhs, x2r, x2f, ids, cv, w0, w1, t2, rhs, un_rot, un_ref, bt, radii, *extra)
        radii = K5.hyp_rank_radii(cv, un, kind)
        return fn(lhs, x2, ids, cv, t2, rhs, un, bt, radii, *extra, **fam)
    return call


def hyp_fns(kind):
    """name -> (kernel wrapper, plain version, extra input names)."""
    if kind == "attrh":
        return {"masked": (tabled_call(kind, K5.attrh_rank_counts),
                           tabled_call(kind, K5.attrh_rank_counts_plain), ("mask",)),
                "nomask": (tabled_call(kind, K5.attrh_rank_sweep_nomask),
                           tabled_call(kind, K5.attrh_rank_sweep_nomask_plain), ("gold",)),
                "filtered_sub": (K5.attrh_rank_filtered_sub,
                                 K5.attrh_rank_filtered_sub_plain, ("fidx", "gold"))}
    fam = {"family": kind}
    return {"masked": (tabled_call(kind, K5.hyp_rank_counts),
                       tabled_call(kind, K5.hyp_rank_counts_plain), ("mask",)),
            "nomask": (tabled_call(kind, K5.hyp_rank_sweep_nomask),
                       tabled_call(kind, K5.hyp_rank_sweep_nomask_plain), ("gold",)),
            "filtered_sub": (partial(K5.hyp_rank_filtered_sub, **fam),
                             partial(K5.hyp_rank_filtered_sub_plain, **fam),
                             ("fidx", "gold"))}


def maskless_fn(kind):
    return K5.attrh_rank_counts_nomask if kind == "attrh" else K5.hyp_rank_counts_nomask


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
    masked = hyp_fns(kind)["masked"][0](*a, e["mask"])
    nomask = tabled_call(kind, maskless_fn(kind))(*a, e["fidx"], e["gold"])
    assert torch.equal(masked, nomask)


def test_hyp_wrappers_check_inputs_and_count_launches():
    dev = _cuda_or_skip()
    args, extras, _ = hyp_inputs("lorentz", *HYP_SHAPES[0])
    lhs, x2, c, t2, rhs, un, bt = [t.to(dev) for t in args]
    mask = extras["mask"].to(dev)
    cid = torch.arange(len(c), dtype=torch.int32, device=dev)
    K5.reset_launches()
    radii = K5.hyp_rank_radii(c, un, "lorentz")
    K5.hyp_rank_counts(lhs, x2, cid, c, t2, rhs, un, bt, radii, mask, family="lorentz")
    assert K5.launches["hyp_rank_sweep_masked"] == 1 and K5.launches["hyp_rank_radii"] == 1

    def masked(**over):
        kw = dict(lhs=lhs, x2=x2, cid=cid, cvals=c, t2=t2, rhs=rhs, un=un, bt=bt, radii=radii,
                  mask=mask, family="lorentz")
        kw.update(over)
        return K5.hyp_rank_counts(**kw)

    with pytest.raises(ValueError, match="unknown hyp_rank family"):
        masked(family="klein")
    with pytest.raises(TypeError, match="dtype"):
        masked(mask=mask.to(torch.int32))
    with pytest.raises(ValueError, match="is on"):
        masked(mask=extras["mask"])
    with pytest.raises(TypeError, match="int32"):
        masked(cid=cid.long())
    with pytest.raises(ValueError, match="shape"):
        masked(cid=cid[:-1].contiguous())
    with pytest.raises(ValueError, match="shape"):
        masked(radii=K5.hyp_rank_radii(c, un, "poincare"))
    with pytest.raises(ValueError, match="16-byte"):
        masked(un=torch.cat([un[:1], un])[1:])
    odd = lhs[:, :7].contiguous()
    with pytest.raises(ValueError, match="halves"):
        K5.attrh_rank_counts(odd, x2, x2, cid, c, c, c, t2, rhs[:, :7].contiguous(), un, un,
                             bt, K5.hyp_rank_radii(c, un, "attrh", un), mask)
    assert K5.launches["hyp_rank_sweep_masked"] == 1
    assert sum(K5.launches.values()) == 4  # and three radius tables
    gold = extras["gold"].to(dev)
    K5.hyp_rank_sweep_nomask(lhs, x2, cid, c, t2, rhs, un, bt, radii, gold, family="lorentz")
    K5.hyp_rank_sweep_nomask(lhs, x2, cid, c, t2, rhs, un, bt, radii, gold, family="lorentz")
    assert K5.launches["hyp_rank_sweep_nomask"] == 2
    with pytest.raises(TypeError, match="int32"):
        K5.hyp_rank_sweep_nomask(lhs, x2, cid, c, t2, rhs, un, bt, radii, gold.long(),
                                 family="lorentz")
    with pytest.raises(ValueError, match="shape"):
        K5.hyp_rank_sweep_nomask(lhs, x2, cid, c, t2, rhs, un, bt,
                                 K5.hyp_rank_radii(c, un, "poincare"), gold, family="lorentz")
    assert K5.launches["hyp_rank_sweep_nomask"] == 2


@pytest.mark.parametrize("shape", HYP_SHAPES[1:] + [(500, 40_000, 32, 5)])
@pytest.mark.parametrize("kind", HYP_KINDS)
def test_hyp_radii_matches_plain(kind, shape):
    """The radius launcher against its plain version on the same card:
    within 2 ulp (torch's CUDA tanh / sinh and the kernel's tanhf / sinhf
    are both libdevice's, so they agree exactly on the H100); and within the
    compounded rounding of the CPU's vectorized tanh / sinh (1 ulp each)."""
    dev = _cuda_or_skip()
    args, _, _ = hyp_inputs(kind, *shape)
    un, un2 = (args[8], args[9]) if kind == "attrh" else (args[5], None)
    cvals = torch.as_tensor(np.random.default_rng(3).uniform(0.2, 2.5, 22), dtype=torch.float32)
    on_card = [cvals.to(dev), un.to(dev), kind, None if un2 is None else un2.to(dev)]
    got = K5.hyp_rank_radii(*on_card).cpu()
    want = K5.hyp_rank_radii_plain(*on_card).cpu()
    assert got.shape == want.shape == (22, un.shape[0], K5.RADII_WIDTH[kind])
    assert torch.isfinite(got).all() and (torch.sign(got) == torch.sign(want)).all()
    ulps = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs()
    assert int(ulps.max()) <= 2
    torch.testing.assert_close(got, K5.hyp_rank_radii_plain(cvals, un, kind, un2),
                               rtol=2e-6, atol=0)


def ragged_inputs(kind, shape, bad_cid=False):
    """K5-K8 inputs at a ragged shape with 7 curvatures shared through cid;
    bad_cid: every 7th query's cid outside [0, 7) (a NaN curvature) and
    every 5th query's gold -1.  Returns (cid, cvals, args, extras, near)."""
    rng = np.random.default_rng(5)
    cvals = torch.as_tensor(rng.uniform(0.5, 1.5, 7), dtype=torch.float32)
    cid = torch.as_tensor(rng.integers(0, 7, shape[0]), dtype=torch.int32)
    args, extras, near = hyp_inputs(kind, *shape, curvatures=(cvals, cid))
    if bad_cid:
        cid[3::7] = torch.as_tensor([-1, 7, 1 << 20])[torch.arange(len(cid[3::7])) % 3].int()
        extras["gold"][::5] = -1
    return cid, cvals, args, extras, near


@pytest.mark.parametrize("shape", HYP_RAGGED)
@pytest.mark.parametrize("kind", HYP_KINDS)
def test_hyp_masked_ragged_matches_plain_and_maskless(kind, shape):
    """The masked sweeps at ragged B, Np and D, with 7 curvatures shared
    through cid: within the near-threshold count of the plain version, and
    exactly the maskless count (sweep - subtraction) at c = cvals[cid]."""
    dev = _cuda_or_skip()
    cid, cvals, args, extras, near = ragged_inputs(kind, shape)
    b = shape[0]
    kernel = tabled_call(kind, K5.attrh_rank_counts if kind == "attrh" else K5.hyp_rank_counts,
                         cid, cvals)
    plain = tabled_call(kind, K5.attrh_rank_counts_plain if kind == "attrh"
                        else K5.hyp_rank_counts_plain, cid, cvals)
    a = [x.to(dev) for x in args]
    e = {k: v.to(dev) for k, v in extras.items()}
    got = kernel(*a, e["mask"])
    torch.cuda.synchronize()
    want = plain(*args, extras["mask"])
    assert got.dtype == torch.int32 and got.shape == (b,)
    assert ((got.cpu() - want).abs() <= near).all()
    nomask = tabled_call(kind, maskless_fn(kind), cid, cvals)(*a, e["fidx"], e["gold"])
    assert torch.equal(got, nomask)


@pytest.mark.parametrize("shape", HYP_RAGGED)
@pytest.mark.parametrize("kind", HYP_KINDS)
def test_hyp_maskless_ragged_matches_plain_and_masked(kind, shape):
    """The maskless sweeps K6/K8 at ragged B, Np and D, with cids outside
    [0, n_c) and golds of -1: within the near-threshold count of the plain
    version (the bad cids count 0), and sweep - subtraction equal to the
    masked count exactly."""
    dev = _cuda_or_skip()
    cid, cvals, args, extras, near = ragged_inputs(kind, shape, bad_cid=True)
    b = shape[0]
    sweep = K5.attrh_rank_sweep_nomask if kind == "attrh" else K5.hyp_rank_sweep_nomask
    plain = (K5.attrh_rank_sweep_nomask_plain if kind == "attrh"
             else K5.hyp_rank_sweep_nomask_plain)
    a = [x.to(dev) for x in args]
    e = {k: v.to(dev) for k, v in extras.items()}
    got = tabled_call(kind, sweep, cid, cvals)(*a, e["gold"])
    torch.cuda.synchronize()
    want = tabled_call(kind, plain, cid, cvals)(*args, extras["gold"])
    bad = (cid < 0) | (cid >= 7)
    assert got.dtype == torch.int32 and got.shape == (b,)
    assert ((got.cpu() - want).abs() <= near).all()
    assert (got.cpu()[bad] == 0).all() and (want[bad] == 0).all()
    # the masked count of the same queries (with gold -1 the sweep counts
    # the gold row and the subtraction removes its filter slot)
    masked_fn = K5.attrh_rank_counts if kind == "attrh" else K5.hyp_rank_counts
    masked = tabled_call(kind, masked_fn, cid, cvals)(*a, e["mask"])
    maskless = tabled_call(kind, maskless_fn(kind), cid, cvals)(*a, e["fidx"], e["gold"])
    assert torch.equal(masked, maskless)


# ------------------- GNN: K9 (csrc/segsum.cu), K10 (csrc/gather.cu) -------------------

from complexhyperbolickge_torch.kernels import gather as G  # noqa: E402
from complexhyperbolickge_torch.kernels import segsum as S  # noqa: E402

# (E, N, H): H = 1 (32 rows a warp), 3 (no 16-byte vectors), 32 and 200 (the
# encoder's widths), 66 (16-byte vectors in float64 only); N = 1000 > E
# leaves rows without edges
GNN_SHAPES = [(1000, 300, 1), (777, 500, 3), (5000, 777, 32), (86_835, 40_943, 200),
              (300, 1000, 66)]
# K9 against index_add_: another summation order; in bfloat16 both sum in
# float32 and round once, so they differ by at most one bfloat16 ulp (2^-7
# relative) where the float32 sums straddle a rounding boundary
GNN_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6), torch.float64: dict(rtol=1e-12, atol=1e-13),
           torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}
GNN_DTYPES = [torch.float32, torch.float64, torch.bfloat16]


def gnn_inputs(e, n, h, dtype, seed=0):
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n, e))
    msgs = torch.as_tensor(rng.normal(size=(e, h)), dtype=dtype)
    x = torch.as_tensor(rng.normal(size=(n, h)), dtype=dtype)
    ids = rng.integers(0, n, e)
    return dst, msgs, x, ids


@pytest.mark.parametrize("dtype", GNN_DTYPES)
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


@pytest.mark.parametrize("dtype", GNN_DTYPES)
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
    # the plain version's backward sums the cotangent rows (index_put_); in
    # bfloat16 it sums in float32 and rounds once, as K9 does
    wide = dtype == torch.bfloat16
    xr = (x.float() if wide else x).clone().requires_grad_()
    want = G.row_gather_plain(xr, torch.as_tensor(ids))
    (want * (g.float() if wide else g)).sum().backward()
    assert torch.equal(out.detach().cpu(), want.detach().to(dtype))
    # the backward is a K9 sum over the sorted ids
    torch.testing.assert_close(xc.grad.cpu(), xr.grad.to(dtype), **GNN_TOL[dtype])
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
    seg(msgs.to(dev, torch.bfloat16))  # the bfloat16 instances
    gth(x.to(dev, torch.bfloat16))
    assert S.launches["sorted_segment_sum"] == 2 and G.launches["row_gather"] == 2
    with pytest.raises(TypeError, match="float32, float64 and bfloat16"):
        seg(msgs.to(dev, torch.float16))
    with pytest.raises(TypeError, match="float32, float64 and bfloat16"):
        gth(x.to(dev, torch.float16))
    with pytest.raises(ValueError, match="shape"):
        seg(msgs[:-1].to(dev))
    with pytest.raises(ValueError, match="rows"):
        gth(x[:-1].to(dev))
    with pytest.raises(TypeError, match="int32"):
        G.row_gather(x.to(dev), torch.as_tensor(ids, device=dev))
    assert S.launches["sorted_segment_sum"] == 2 and G.launches["row_gather"] == 2


@pytest.mark.parametrize("width", [100, 200])
def test_relation_rows_gradient_is_plain_indexing_on_the_card(width):
    """message.relation_rows at the encoder's shape (86,835 edges into 22
    relation rows, two of them with no edges) with its static layout: the
    forward is plain indexing's bits; the gradient, through the
    split-segment kernels (kernels/relgrad.py), is a float64 index_add_'s
    within the sum's rounding: each chunk's at most C rows summed in
    float32 (at most C 2^-24 of the sum of their magnitudes), the partials
    in float64, one rounding (2^-24 of the value; 2^-23 taken).  float64
    tables to 1e-12 of the largest entry.  Two backward passes give the same
    bits, and a card bfloat16 table keeps autograd's accumulate."""
    from complexhyperbolickge_torch.kernels import relgrad as R
    from complexhyperbolickge_torch.models.gnn.message import relation_rows

    dev = _cuda_or_skip()
    gen = torch.Generator().manual_seed(width)
    ids = torch.randint(0, 20, (86835,), generator=gen)
    ids = ids + (ids >= 7)  # rows 7 and 21 get no edges
    lay = R.RelationLayout(ids, dev)
    ids = ids.to(dev)
    for dtype in (torch.float32, torch.float64):
        table = torch.randn((22, width), generator=gen, dtype=dtype).to(dev)
        g = torch.randn((86835, width), generator=gen, dtype=dtype).to(dev)
        a = table.clone().requires_grad_()
        R.reset_launches()
        out = relation_rows(a, ids, lay)
        assert torch.equal(out, table[ids])
        got = torch.autograd.grad(out, a, g)[0]
        assert R.launches == {"relation_grad": 1, "relation_grad_accumulate": 0}
        assert torch.equal(torch.autograd.grad(relation_rows(a, ids, lay), a, g)[0], got)
        want = torch.zeros((22, width), dtype=torch.float64, device=dev).index_add_(
            0, ids, g.double())
        assert not got[7].any() and not got[21].any()
        if dtype == torch.float32:
            mags = torch.zeros_like(want).index_add_(0, ids, g.double().abs())
            tol = lay.chunk_rows * 2.0**-24 * mags + 2.0**-23 * want.abs()
            assert bool(((got.double() - want).abs() <= tol).all())
        else:
            assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    b = table.to(torch.bfloat16).requires_grad_()
    R.reset_launches()
    torch.autograd.grad(relation_rows(b, ids, lay), b, g.to(torch.bfloat16))
    assert R.launches == {"relation_grad": 0, "relation_grad_accumulate": 1}


def test_relation_grad_refuses_misuse_on_the_card():
    from complexhyperbolickge_torch.kernels import relgrad as R

    dev = _cuda_or_skip()
    ids = torch.tensor([0, 3, 3, 1])
    lay = R.RelationLayout(ids, dev)
    g = torch.randn((4, 8), device=dev)
    with pytest.raises(TypeError, match="float32 and float64"):
        R.relation_grad(g.half(), lay, 4)
    with pytest.raises(ValueError, match="the layout on"):
        R.relation_grad(g.cpu(), lay, 4)  # a CPU g against the card's layout
    with pytest.raises(ValueError, match="shape"):
        R.relation_grad(g[:3], lay, 4)
    with pytest.raises(ValueError, match="outside"):
        R.relation_grad(g, lay, 3)
    with pytest.raises(ValueError, match="contiguous"):
        R.relation_grad(torch.randn((8, 4), device=dev).t(), lay, 4)
    # the card's kernels equal the plain version's split within the rounding
    # of their float32 chunk sums (summed in another order by index_add_)
    torch.testing.assert_close(R.relation_grad(g, lay, 4), R.relation_grad_plain(g, lay, 4))


def test_a_compgcn_full_graph_step_takes_the_relation_gradient_kernel():
    """One CompGCN training step on the card (full graph, one layer, BCE):
    both directions' relation gradients run the split-segment kernels and
    none falls back to the accumulate."""
    import argparse

    from complexhyperbolickge_torch.data.dataset import epoch_batches, synthetic_kg
    from complexhyperbolickge_torch.kernels import relgrad as R
    from complexhyperbolickge_torch.models import ModelConfig, get_model
    from complexhyperbolickge_torch.train.trainer import TrainConfig, Trainer

    dev = _cuda_or_skip()
    kg = synthetic_kg(n_entities=500, n_relations=11, n_train=3000, n_valid=20, n_test=20,
                      seed=7)
    n_ent, n_rel, _ = kg.get_shape()
    cfg = ModelConfig(n_entities=n_ent, n_relations=n_rel, rank=100, bias="learn",
                      multi_c=True, dtype="float32")
    args = argparse.Namespace(hidden_dim=200, layers=1, edge_dropout=0.0, dropout=0.0,
                              opn="mult", interaction="distmult", basis=0, gnn_agg_method=1)
    model = get_model("CompGCN")(cfg, args, kg, device=dev,
                                 generator=torch.Generator().manual_seed(3))
    trainer = Trainer(model, TrainConfig(optimizer="Adam", batch_size=128, neg_sample_size=0,
                                         loss="binarycrossentropy", smoothing=0.1), n_ent, n_rel)
    _, labels = kg.label_pack("train")
    b, w, lab = epoch_batches(kg.get_examples("train"), 128, None, labels)
    R.reset_launches()
    loss = trainer.train_step(torch.as_tensor(b[0], dtype=torch.int64, device=dev),
                              torch.as_tensor(w[0], device=dev), None,
                              labels=torch.as_tensor(lab[0], dtype=torch.int64, device=dev))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss))
    assert R.launches == {"relation_grad": 2, "relation_grad_accumulate": 0}


# ------------- the bf16 tensor-core instances (precision "default") -------------
#
# Each bf16 instance against its plain default version on the same bf16
# operands (bf16_rows: rounded to nearest even, zero-padded to a multiple of
# 16 features, AttRH's halves each on its own): the two sum the same exact
# products, the card's tensor cores in float32 (their accumulator truncates
# within a k-step), the plain version exactly (float64) then rounded once.
# So a count may differ by the entities whose score, with the contraction
# moved by TC_REL sum_k |q_k w_k| either way, comes within 1e-5 (1 + |t2|)
# of t2 (score_interval, near_threshold; a cancelling contraction near the
# ball's edge moves a score further than its own rounding).  Between the
# bf16 sweep and its subtraction the scores are bit-identical (one mma
# chain per pair), so maskless == masked exactly.

from complexhyperbolickge_torch.kernels._ranker import (  # noqa: E402
    TC_REL,
    bf16_rows,
    near_threshold,
    score_interval,
)

DEFAULT = "default"


# (B, N, D, L, Np, ld) with the bf16 widths D = 32, 80 (the main path's 66),
# 80 (70), 400 (the query tile staged a chunk a stage)
BF16_CHYP = [(48, 300, 18, 6, None, 20), (37, 1000, 66, 9, 1005, 68),
             (500, 40_000, 66, 5, None, 68), (5, 128, 70, 3, 129, 72), (37, 600, 400, 5, None, 400)]


def chyp_bf16_inputs(shape):
    b, n, d, l, np_, ld = shape
    t, _ = make_inputs(b, n, d, l, np_=np_, ld=ld)
    t["lhs2"], t["rhs"] = bf16_rows(t["lhs2"]), bf16_rows(t["rhs"][:, :d])
    return t, near_threshold(*score_interval("chyp", t, TC_REL), t["t2"])


@pytest.mark.parametrize("shape", BF16_CHYP)
def test_chyp_bf16_matches_plain_and_maskless(shape):
    """K1, K2's sweep and its subtraction, bf16 instances: within the
    near-threshold count of the plain default versions, and K1 == K2 sweep
    - subtraction exactly (every 5th gold -1)."""
    dev = _cuda_or_skip()
    t, near = chyp_bf16_inputs(shape)
    t["gold"][::5] = -1
    c = _on(dev, t)
    base, plain = [c[k] for k in BASE], [t[k] for k in BASE]
    K.reset_launches()
    got = {"masked": K.chyp_rank_counts(*base, c["mask"], precision=DEFAULT),
           "nomask": K.chyp_rank_sweep_nomask(*base, c["gold"], precision=DEFAULT),
           "filtered_sub": K.chyp_rank_filtered_sub(*base, c["fidx"], c["gold"],
                                                    precision=DEFAULT)}
    torch.cuda.synchronize()
    want = {"masked": K.chyp_rank_counts_plain(*plain, t["mask"], DEFAULT),
            "nomask": K.chyp_rank_sweep_nomask_plain(*plain, t["gold"], DEFAULT),
            "filtered_sub": K.chyp_rank_filtered_sub_plain(*plain, t["fidx"], t["gold"],
                                                           DEFAULT)}
    for name in got:
        assert ((got[name].cpu() - want[name]).abs() <= near).all(), name
    assert torch.equal(got["masked"], got["nomask"] - got["filtered_sub"])
    assert {k: v for k, v in K.launches.items() if v} == {
        "chyp_rank_sweep_masked_bf16": 1, "chyp_rank_sweep_nomask_bf16": 1,
        "chyp_rank_filtered_sub_bf16": 1}


def test_chyp_bf16_wrappers_refuse_other_operands():
    """precision "default" on the card launches the bf16 instance or raises:
    float32 operands, or rows not padded to 16, never fall back."""
    dev = _cuda_or_skip()
    c = _on(dev, make_inputs(48, 300, 32, 6)[0])
    with pytest.raises(TypeError, match="bfloat16"):
        K.chyp_rank_counts(*[c[k] for k in BASE], c["mask"], precision=DEFAULT)
    c = _on(dev, make_inputs(*SHAPES[0])[0])
    odd = {**c, "lhs2": c["lhs2"].bfloat16(), "rhs": c["rhs"].bfloat16()}
    with pytest.raises(ValueError, match="multiple of 16"):
        K.chyp_rank_counts(*[odd[k] for k in BASE], c["mask"], precision=DEFAULT)
    with pytest.raises(ValueError, match="unknown eval precision"):
        K.chyp_rank_counts(*[c[k] for k in BASE], c["mask"], precision="bf16")


@pytest.mark.parametrize("masked", [True, False])
def test_chyp_bf16_sweep_info(masked):
    """K1/K2 bf16's sweep at the main path's 80 bf16 features: compiled for
    3 resident blocks an SM (256 threads, up to 80 registers) with no
    spill, and the shared memory lets all three reside."""
    dev = _cuda_or_skip()
    info = K.sweep_info(dev, 80, masked=masked, precision=DEFAULT)
    assert info["blocks_per_sm"] >= 3 and info["local_bytes"] == 0
    assert info["regs_per_thread"] <= 80


def hyp_bf16_args(kind, args):
    """hyp_inputs' args with lhs and rhs as bf16 rows."""
    i = 7 if kind == "attrh" else 4
    halves = kind == "attrh"
    out = list(args)
    out[0], out[i] = bf16_rows(args[0], halves), bf16_rows(args[i], halves)
    return out


# (B, N, D, L, Np): D = 8 (one k-step), 32 (the main path), 40 and 64
# (AttRH halves of 20 and 32: two k-steps a half), ragged Np with byte-wise
# mask copies, D = 200 (two staged chunks: AttRH's halves of 112 one each)
# and D = 280 (three chunks of 96 features: AttRH's second half starts
# inside the second chunk)
BF16_HYP = [(48, 300, 8, 6, None), (37, 1000, 32, 9, 1005), (500, 40_000, 32, 5, None),
            (300, 3000, 64, 11, 3001), (5, 129, 40, 3, None), (37, 700, 200, 5, 701),
            (21, 517, 280, 4, 530)]


@pytest.mark.parametrize("shape", BF16_HYP)
@pytest.mark.parametrize("kind", HYP_KINDS)
def test_hyp_bf16_matches_plain_and_maskless(kind, shape):
    """K5/K7, K6/K8's sweeps and their subtractions, bf16 instances, with
    7 curvatures shared through cid: within the near-threshold count of the
    plain default versions, and masked == maskless sweep - subtraction
    exactly."""
    dev = _cuda_or_skip()
    b, n, d, l, np_ = shape
    rng = np.random.default_rng(5)
    cvals = torch.as_tensor(rng.uniform(0.5, 1.5, 7), dtype=torch.float32)
    cid = torch.as_tensor(rng.integers(0, 7, b), dtype=torch.int32)
    args, extras, _ = hyp_inputs(kind, b, n, d, l, np_=np_, curvatures=(cvals, cid))
    args = hyp_bf16_args(kind, args)
    names = ("lhs", "x2r", "x2f", "c", "w0", "w1", "t2", "rhs", "un_rot", "un_ref", "bt") \
        if kind == "attrh" else ("lhs", "x2", "c", "t2", "rhs", "un", "bt")
    x = dict(zip(names, args))
    near = near_threshold(*score_interval(kind, x, TC_REL), x["t2"])
    g = "attrh" if kind == "attrh" else "hyp"
    fam = {} if kind == "attrh" else {"family": kind}
    fns = {}
    for name, extra in (("masked", ("mask",)), ("nomask", ("gold",)),
                        ("filtered_sub", ("fidx", "gold"))):
        wrapper = {"masked": f"{g}_rank_counts", "nomask": f"{g}_rank_sweep_nomask",
                   "filtered_sub": f"{g}_rank_filtered_sub"}[name]
        fn, plain = (partial(getattr(K5, w), precision=DEFAULT, **fam)
                     for w in (wrapper, wrapper + "_plain"))
        if name != "filtered_sub":
            fn, plain = tabled_call(kind, fn, cid, cvals), tabled_call(kind, plain, cid, cvals)
        fns[name] = (fn, plain, extra)
    on = [a.to(dev) for a in args]
    e_dev = {k: v.to(dev) for k, v in extras.items()}
    K5.reset_launches()
    got = {}
    for name, (fn, plain, extra) in fns.items():
        got[name] = fn(*on, *[e_dev[k] for k in extra])
        torch.cuda.synchronize()
        want = plain(*args, *[extras[k] for k in extra])
        assert ((got[name].cpu() - want).abs() <= near).all(), name
    assert torch.equal(got["masked"], got["nomask"] - got["filtered_sub"])
    prefix = "attrh" if kind == "attrh" else "hyp"
    assert {k: v for k, v in K5.launches.items() if v and k != "hyp_rank_radii"} == {
        f"{prefix}_rank_sweep_masked_bf16": 1, f"{prefix}_rank_sweep_nomask_bf16": 1,
        f"{prefix}_rank_filtered_sub_bf16": 1}


@pytest.mark.parametrize("kind", HYP_KINDS)
def test_hyp_bf16_sweep_info(kind):
    dev = _cuda_or_skip()
    info = K5.sweep_info(kind, dev, 32, masked=True, precision=DEFAULT)
    assert info["blocks_per_sm"] >= 1 and info["local_bytes"] == 0


# ------------- the bf16 sweeps' epilogue: its bits against IEEE's -------------


def chyp_scores_bitwise(shape, dev):
    """K1/K2 bf16's scores through the batched epilogue against
    chyp_score()'s, with queries 0 and 1 scaled by 1e9 and 1e12 so that
    their pairs leave the fast path's range (x >= 2^50; 2 a2 >= 2^60 and
    x^2 overflowing) and are scored again through IEEE."""
    b, n, d, l, np_ = shape
    t, _ = make_inputs(b, n, d, l, np_=np_)
    t["lhs2"][[0, b]] *= 1e9
    t["lhs2"][[1, b + 1]] *= 1e12
    lhs2, rhs = bf16_rows(t["lhs2"]).to(dev), bf16_rows(t["rhs"]).to(dev)
    args = (lhs2, t["zn"].to(dev), rhs, t["wn"].to(dev), t["bt"].to(dev))
    (fast, flagged), (ieee, none) = K.chyp_scores_bf16(*args), K.chyp_scores_bf16(*args, ieee=True)
    torch.cuda.synchronize()
    assert fast.shape == (b, rhs.shape[0]) and none == 0
    assert torch.equal(fast.view(torch.int32), ieee.view(torch.int32))
    assert flagged >= n // 2  # most of the planted queries' real rows
    assert torch.isfinite(fast[2:, :n]).all()


# (B, N, D, L, Np); the FFT family's D is the bf16 rows' width: 32, 64,
# 280 (three staged chunks), 80 (the main path's 66) and 208 (200: two)
@pytest.mark.parametrize("shape", [(37, 1000, 32, 9, 1005), (500, 4000, 32, 5, None),
                                   (45, 600, 64, 5, 601), (21, 517, 280, 4, 530),
                                   (37, 1000, 66, 9, 1005), (21, 517, 200, 4, 530)])
@pytest.mark.parametrize("kind", [*HYP_KINDS, "chyp"])
def test_bf16_scores_bitwise(kind, shape):
    """K5/K6 (poincare, lorentz), K7/K8 (attrh) and K1/K2 (chyp) bf16's
    scores through the batched epilogue (FastArith, the flagged pairs again
    through IEEE) equal score_from_radii's / chyp_score()'s for every pair,
    pad rows, ragged tiles and queries past B included, at D 32, 64
    (AttRH: two k-steps a half), 66, 200 and 280 (two and three staged
    chunks); the real rows' scores are finite.  (Their counts against the
    plain default version: test_hyp_bf16_matches_plain_and_maskless,
    test_chyp_bf16_matches_plain_and_maskless.)"""
    dev = _cuda_or_skip()
    if kind == "chyp":
        chyp_scores_bitwise(shape, dev)
        return
    b, n, d, l, np_ = shape
    rng = np.random.default_rng(3)
    cvals = torch.as_tensor(rng.uniform(0.5, 1.5, 7), dtype=torch.float32)
    cid = torch.as_tensor(rng.integers(0, 7, b), dtype=torch.int32)
    args, _, _ = hyp_inputs(kind, b, n, d, l, np_=np_, curvatures=(cvals, cid))
    args = [a.to(dev) for a in hyp_bf16_args(kind, args)]
    cv, ids = cvals.to(dev), cid.to(dev)
    if kind == "attrh":
        lhs, x2r, x2f, _, w0, w1, _, rhs, un_rot, un_ref, bt = args
        radii = K5.hyp_rank_radii(cv, un_rot, "attrh", un_ref)
        call = partial(K5.attrh_scores_bf16, lhs, x2r, x2f, ids, cv, w0, w1, rhs, un_rot, un_ref,
                       bt, radii)
    else:
        lhs, x2, _, _, rhs, un, bt = args
        radii = K5.hyp_rank_radii(cv, un, kind)
        call = partial(K5.hyp_scores_bf16, lhs, x2, ids, cv, rhs, un, bt, radii, family=kind)
    fast, ieee = call(), call(ieee=True)
    torch.cuda.synchronize()
    assert fast.shape == (b, rhs.shape[0])
    assert torch.equal(fast.view(torch.int32), ieee.view(torch.int32))
    assert torch.isfinite(fast[:, :n]).all()


def test_fast_arith_matches_ieee_on_edge_sample():
    """The epilogue's division and square root (the fast path where its
    range flag is clear, else __fdiv_rn / __fsqrt_rn) equal __fdiv_rn and
    __fsqrt_rn bit for bit: the square root over every non-negative finite
    float32, the division over 10^6 pairs drawn edge-heavy (the
    epilogue's operand ranges, both fast ranges' edges, any bits, zeros,
    subnormals, overflow, infinities and NaN); the fast path takes most of
    both."""
    dev = _cuda_or_skip()
    out = K5.fast_arith_sweep(dev, 10 ** 6, seed=11)
    assert out["sqrt_mismatches"] == 0 and out["quot_mismatches"] == 0
    assert out["sqrt_fast"] > out["sqrt_inputs"] // 2 and out["quot_fast"] > 10 ** 6 // 2


# ------------- hyp_queries: RotH's ranker query prep (csrc/hyp_queries.cu) -------------

from complexhyperbolickge_torch.kernels import hyp_queries as HQ  # noqa: E402
from complexhyperbolickge_torch.kernels.hyp_rank import HypRanker  # noqa: E402
from complexhyperbolickge_torch.models import ModelConfig, get_model  # noqa: E402

ROTH_N, ROTH_REL, ROTH_B = 40943, 22, 500


def roth_model(dev, rank=32, multi_c=True, bias="learn", scale=0.05, name="RotH",
               dtype="float32", seed=0):
    """A model at WN18RR's shapes on `dev` with a trained spread of weights
    drawn on the CPU (scale 3: heads and relation halves that project
    clips)."""
    cfg = ModelConfig(n_entities=ROTH_N, n_relations=ROTH_REL, rank=rank, multi_c=multi_c,
                      bias=bias, gamma=0.7, init_size=1e-3, dtype=dtype)
    model = get_model(name)(cfg, device=dev, generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for k in ("entity", "rel", "bt"):
            p = getattr(model, k)
            p.copy_(torch.randn(p.shape, generator=g) * (0.01 if k == "bt" else scale))
        model.c.copy_(1.0 + 0.05 * torch.randn(model.c.shape, generator=g))
    return model


def roth_batch(dev, l=8, seed=5):
    """Queries (B, 3) with repeated (h, r), and filter rows (B, l) holding
    the gold first."""
    g = torch.Generator().manual_seed(seed)
    q = torch.stack([torch.randint(0, ROTH_N, (ROTH_B,), generator=g),
                     torch.randint(0, ROTH_REL, (ROTH_B,), generator=g),
                     torch.randint(0, ROTH_N, (ROTH_B,), generator=g)], 1)
    q[7, :2] = q[3, :2]
    fidx = torch.cat([q[:, 2:3], torch.randint(0, ROTH_N, (ROTH_B, l - 1), generator=g)], 1)
    return q.to(dev), fidx.to(dev)


def roth_args(model, cvals):
    return (model.entity, model.rel, model.rel_diag, model.bt, cvals)


@pytest.mark.parametrize("rank,multi_c,bias,scale", [
    (32, True, "learn", 0.05), (32, False, "constant", 0.05), (8, True, "none", 0.05),
    (2, True, "learn", 0.05), (64, False, "learn", 0.05), (32, True, "learn", 3.0)])
@torch.no_grad()
def test_roth_queries_kernel_matches_plain(rank, multi_c, bias, scale):
    """The kernel against its plain version on the card, one launch: cid and
    c equal; lhs, x2 and t2 within 4 float32 ulps of each output's largest
    entry (fp64 sums in another order may round once the other way)."""
    dev = _cuda_or_skip()
    model = roth_model(dev, rank, multi_c, bias, scale)
    q, _ = roth_batch(dev)
    cvals = HypRanker(model)._get_tables()[3]
    HQ.reset_launches()
    got = HQ.roth_rank_queries(*roth_args(model, cvals), q, multi_c, bias == "learn")
    want = HQ.roth_rank_queries_plain(*roth_args(model, cvals), q, multi_c, bias == "learn")
    torch.cuda.synchronize()
    assert HQ.launches["roth_rank_queries"] == 1
    for name, a, e in zip(("lhs", "x2", "cid", "c", "t2"), got, want):
        assert a.shape == e.shape and a.dtype == e.dtype, name
        if name in ("cid", "c"):
            assert torch.equal(a, e), name
            continue
        assert torch.isfinite(a).all(), name
        tol = 4 * torch.finfo(torch.float32).eps * float(e.abs().max())
        assert float((a - e).abs().max()) <= tol, (name, float((a - e).abs().max()), tol)


@torch.no_grad()
def test_roth_queries_route_and_refusals():
    """The route: RotH at float32 and width <= 64 on the card; RotH at width
    66, float64 or bfloat16 and every other HypRanker family keep the eager
    ops.  The wrapper refuses a width above 64 and tables that do not fit."""
    dev = _cuda_or_skip()
    assert HQ.use_kernel(roth_model(dev))
    assert HQ.use_kernel(roth_model(dev, rank=64))
    assert not HQ.use_kernel(roth_model(dev, rank=66))
    for dtype in ("float64", "bfloat16"):
        assert not HQ.use_kernel(roth_model(dev, dtype=dtype))
    for name in ("RefH", "AttH", "IsoH", "IFFTH", "RotLH", "HyboNet"):
        assert not HQ.use_kernel(roth_model(dev, rank=6, name=name)), name
    wide = roth_model(dev, rank=66)
    q, _ = roth_batch(dev)
    cvals = HypRanker(wide)._get_tables()[3]
    with pytest.raises(ValueError):
        HQ.roth_rank_queries(*roth_args(wide, cvals), q, True, True)
    model = roth_model(dev)
    with pytest.raises(ValueError):  # multi_c needs one curvature a relation
        HQ.roth_rank_queries(*roth_args(model, cvals[:1]), q, True, True)
    with pytest.raises(TypeError):
        HQ.roth_rank_queries(*roth_args(model, cvals.double()), q, True, True)


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("masked", [True, False])
def test_roth_ranker_on_the_kernel_ranks_as_the_eager_route(masked, precision, monkeypatch):
    """A RotH HypRanker's ranks through the kernel against the eager query
    prep (use_kernel patched off): equal but on the entities that
    _ranker.near_threshold flags; the kernel launches once a call, and not
    on the eager route."""
    dev = _cuda_or_skip()
    model = roth_model(dev)
    q, fidx = roth_batch(dev)
    ranker = HypRanker(model, masked=masked, precision=precision)
    HQ.reset_launches()
    got = ranker(q, fidx)
    got2 = ranker(q, fidx)
    torch.cuda.synchronize()
    assert HQ.launches["roth_rank_queries"] == 2
    assert torch.equal(got, got2)
    x = ranker.kernel_inputs(q, fidx)
    monkeypatch.setattr(HQ, "use_kernel", lambda m: False)
    want = HypRanker(model, masked=masked, precision=precision)(q, fidx)
    torch.cuda.synchronize()
    assert HQ.launches["roth_rank_queries"] == 3  # kernel_inputs' launch only
    # at "default" x holds the bf16 rows the sweep contracts
    rel, rounded = (TC_REL, True) if precision == "default" else (0.0, False)
    near = near_threshold(*score_interval("poincare", x, rel, rounded), x["t2"])
    diff = (got - want).abs()
    assert torch.isfinite(got).all()
    assert bool((diff <= near.to(diff.dtype)).all()), (float(diff.max()), int(near.max()))


@pytest.mark.parametrize("masked", [True, False])
def test_roth_two_shard_mesh_ranks_as_one_device(masked):
    """Two shards of one model group on the card (run_shards), each on the
    kernel through the mini-tables of the gathered rows: the ranks equal one
    device's, and each shard launches the kernel once."""
    import copy

    from complexhyperbolickge_torch.parallel import Mesh, shard_model_
    from complexhyperbolickge_torch.parallel.ranking import ShardedHypRanker, run_shards

    dev = _cuda_or_skip()
    model = roth_model(dev)
    q, fidx = roth_batch(dev)
    want = HypRanker(model, masked=masked)(q, fidx)
    shards = []
    for i in range(2):
        local = copy.deepcopy(model)
        shard_model_(local, i, 2)
        shards.append(ShardedHypRanker(local, Mesh((1, 2), i, dev), ROTH_N, masked=masked))
    HQ.reset_launches()
    got = run_shards(shards, q, fidx)
    torch.cuda.synchronize()
    assert HQ.launches["roth_rank_queries"] == 2
    assert torch.equal(got, want)
