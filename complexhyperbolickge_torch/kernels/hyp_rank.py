"""Fused filtered ranking for the real-hyperbolic families.

Port of complexhyperbolickge_tpu/kernels/hyp_rank.py.  Filtered ranking
scores every query against ALL entities; materialized, that is a (B, N)
score matrix written and re-read per batch (82 MB at WN18RR, B = 500).  The
CUDA kernels in csrc/hyp_rank.cu fuse, per entity tile,

    <x, v> -> family epilogue -> score = bt - dist^2
    -> count of {score >= t2} over the kept entities

so the only outputs are (B,) int32 counts.  Seven kernels, one wrapper each:

  * hyp_rank_counts          (K5, TPU hyp_rank_counts): masked sweep; an
    int8 (B, Np) mask marks filtered entities and pad rows.  `family`
    picks the epilogue: "poincare" (BaseH but AttRH: the double-folded
    expmap0 Poincare distance) or "lorentz" (BaseLorentz: folded
    expmap0_lorentz and the hyperboloid distance).
  * hyp_rank_sweep_nomask    (K6, TPU hyp_rank_counts_nomask's kernel):
    counts every row except the gold, with no mask.
  * hyp_rank_radii: the sweeps' radius table, radii (n_c, Np, 4) for
    poincare or (n_c, Np, 2) for lorentz and attrh, from the curvatures
    cvals (n_c,) and un: per (curvature, entity) the part of each
    distance that depends on the pair only through them; built once per
    params version by the rankers.
  * hyp_rank_filtered_sub    (K6's subtraction): re-scores each query's
    filtered ids with the same arithmetic, for subtraction.
  * attrh_rank_counts, attrh_rank_sweep_nomask, attrh_rank_filtered_sub
    (K7, K8 and K8's subtraction): the same three for AttRH, whose score is
    bt - w0 d(rot)^2 - w1 d(ref)^2 over the two halves of the features,
    each a single-fold Poincare distance.
The four sweeps are one CUDA kernel template (masked or not): each takes
each query's curvature as cvals[cid[b]] and reads the radius part from
the table.  A cid outside [0, n_c) gives a NaN curvature, so its query
counts 0.

Inputs, all float32 and contiguous.  Per query (B,): x2 = |lhs|^2 (x2r, x2f
per half for AttRH), cid int32 into cvals (n_c,) for the sweeps, c the
curvature for the subtractions, t2 the gold-target score minus the lhs
bias, and w0, w1 AttRH's weights.  lhs (B, D).  The table
rhs (Np, D) with >= 1 zero pad row; un (Np,) = sqrt(max(|v|^2,
MIN_NORM^2)) (un_rot, un_ref per half for AttRH), built once per params
version; bt (Np,) tail biases with -1e30 on pad rows.  The pad rows' un is
the MIN_NORM floor, so <x, v> / un = 0 there and nothing is NaN.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
`launches`; for CPU tensors it runs the plain PyTorch version beside it,
which repeats the arithmetic with a matmul (a different summation order, so
counts may differ on scores within float rounding of t2).  The plain
sweeps take the same inputs as the kernels, radii included, and
recompute the radius part inline.

precision="default" (--eval_precision default, kernels/_ranker.py) takes
each kernel's bf16 tensor-core instance (launch counters `<name>_bf16`):
lhs (B, Dp) and rhs (Np, Dp) bfloat16, Dp a multiple of 16, zero past D
(bf16_rows; AttRH: each half padded on its own, so Dp = 2 round_up(D / 2,
16)); every other input stays float32, un from the unrounded rows.  The
radius tables do not change: they depend on un and c only.  The plain
versions also take float32 operands and round them.  The bf16 sweeps of
every family score from a shared-memory tile with a branch-free epilogue
whose divisions and square roots give __fdiv_rn's / __fsqrt_rn's bits
(csrc/hyp_rank.cu, bf16 namespace); hyp_scores_bf16, attrh_scores_bf16
and fast_arith_sweep prove that on the card and are not path kernels.
"""

from __future__ import annotations

import torch

from complexhyperbolickge_torch.kernels import hyp_queries
from complexhyperbolickge_torch.kernels._build import check_aligned
from complexhyperbolickge_torch.kernels._build import check_tensor as _check
from complexhyperbolickge_torch.kernels._build import kernel_info, launch
from complexhyperbolickge_torch.kernels._ranker import (
    BF16_K,
    ROW_TILE,
    FusedRanker,
    plain_mm,
    plain_rows,
)
from complexhyperbolickge_torch.ops.math import MIN_NORM, ball_eps, check_precision, round_up

KERNELS = ("hyp_rank_sweep_masked", "hyp_rank_sweep_nomask", "hyp_rank_filtered_sub",
           "attrh_rank_sweep_masked", "attrh_rank_sweep_nomask", "attrh_rank_filtered_sub")
# launches of each CUDA kernel since the last reset_launches(): the exact
# instances, the bf16 ones (precision "default") and the radius launcher
launches = {**{k + sfx: 0 for sfx in ("", "_bf16") for k in KERNELS}, "hyp_rank_radii": 0,
            # the proofs of the bf16 sweeps' epilogue (hyp_scores_bf16,
            # attrh_scores_bf16, fast_arith_sweep)
            "hyp_rank_scores_bf16": 0, "attrh_rank_scores_bf16": 0,
            "hyp_rank_fast_arith_sweep": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


# the epilogue instantiations of the K5/K6 kernels
FAMILIES = {"poincare": 0, "lorentz": 1}
# the radius tables' families, and the floats of one table entry
RADII_FAMILIES = {**FAMILIES, "attrh": 2}
RADII_WIDTH = {"poincare": 4, "lorentz": 2, "attrh": 2}
# project()'s clip radius times sqrt(c): the fused rankers score in float32
# whatever the model dtype, so the float32 ball eps; passed to the kernels
# as one f32 value so kernel and plain versions round it identically
ONE_MINUS_EPS = 1.0 - ball_eps(torch.float32)


# ------------------------------ plain versions --------------------------------
#
# Every operation below is one rounding in the order the kernels take it
# (csrc/hyp_rank.cu), so the plain versions differ from the kernels only in
# the contraction's summation order and the transcendental functions' ulps.


def _tanh15(x):
    return torch.tanh(x.clamp(-15.0, 15.0))


def _artanh(x):
    x = x.clamp(-1 + 1e-5, 1 - 1e-5)
    return 0.5 * (torch.log1p(x) - torch.log1p(-x))


def _ball_dist(xv, gamma, c, sqrt_c, x2):
    """Poincare distance from x to the point of direction v and radius
    gamma (ops/hyperbolic.py::_hyp_dist_multi_c_from_parts after its tanh),
    with the MIN_NORM floors under the sqrt and the denominator."""
    c1 = 1.0 - 2.0 * c * gamma * xv + c * gamma * gamma
    c2 = 1.0 - c * x2
    num = torch.sqrt((c1 * c1 * x2 + c2 * c2 * gamma * gamma
                      - 2.0 * c1 * c2 * gamma * xv).clamp_min(MIN_NORM))
    denom = 1.0 - 2.0 * c * gamma * xv + c * c * gamma * gamma * x2
    return 2.0 * _artanh(sqrt_c * (num / denom.clamp_min(MIN_NORM))) / sqrt_c


def _poincare_radius(un, c, sqrt_c):
    """BaseH: the radius of expmap0(v), tanh(sqrt_c un) / sqrt_c clipped
    by project(), folded once more as the distance does."""
    m = _tanh15(sqrt_c * un) / sqrt_c
    m = torch.minimum(m, torch.full_like(sqrt_c, ONE_MINUS_EPS) / sqrt_c)
    return _tanh15(sqrt_c * m) / sqrt_c


def _poincare_dist(xv, un, c, x2):
    """BaseH: distance to expmap0(v), whose radius the distance folds once
    more."""
    sqrt_c = torch.sqrt(c)
    return _ball_dist(xv, _poincare_radius(un, c, sqrt_c), c, sqrt_c, x2)


def _lorentz_radius(un, c, sqrt_c):
    """BaseLorentz: expmap0_lorentz(v)'s space radius s = sinh(sqrt_c un) /
    (sqrt_c un) * un and time part v0 = sqrt(s^2 + 1 / c).  sinh is taken
    as it is: the TPU kernel's exp-and-Taylor form works around a missing
    TPU lowering."""
    alpha = sqrt_c * un
    s = torch.sinh(alpha) / alpha * un
    return s, torch.sqrt(s * s + 1.0 / c)


def _lorentz_dist(xv, un, c, x2):
    """BaseLorentz: hyperboloid distance to expmap0_lorentz(v); arcosh as
    log(z + sqrt(z^2 - 1)) with the clamp z >= 1 + 1e-6."""
    sqrt_c = torch.sqrt(c)
    s, v0 = _lorentz_radius(un, c, sqrt_c)
    x0 = torch.sqrt(x2 + 1.0 / c)
    z = (-c * (xv * s - x0 * v0)).clamp_min(1 + 1e-6)
    return torch.log(z + torch.sqrt(z * z - 1.0)) / sqrt_c


_DISTS = {"poincare": _poincare_dist, "lorentz": _lorentz_dist}


def _half_radius(un, sqrt_c):
    """AttRH: the single fold of a raw half."""
    return _tanh15(sqrt_c * un) / sqrt_c


def _half_dist_sq(xv, un, c, x2):
    """AttRH: single-fold Poincare distance^2 to the raw half v."""
    sqrt_c = torch.sqrt(c)
    d = _ball_dist(xv, _half_radius(un, sqrt_c), c, sqrt_c, x2)
    return d * d


def hyp_rank_radii_plain(cvals, un, family: str, un2=None):
    """The radius table in plain PyTorch: per (curvature, entity) the part
    of a distance that does not depend on the query point, float32 (n_c,
    Np, W).  poincare: (gamma, 2 c gamma, c gamma^2, c^2 gamma^2), the
    folded radius and the ball distance's products as _ball_dist
    associates them; lorentz: (s, v0); attrh: (gamma_rot, gamma_ref) from
    un = un_rot and un2 = un_ref."""
    c = cvals[:, None]
    sqrt_c = torch.sqrt(c)
    if family == "poincare":
        g = _poincare_radius(un[None, :], c, sqrt_c)
        parts = (g, 2.0 * c * g, c * g * g, c * c * g * g)
    elif family == "lorentz":
        parts = _lorentz_radius(un[None, :], c, sqrt_c)
    elif family == "attrh":
        parts = (_half_radius(un[None, :], sqrt_c), _half_radius(un2[None, :], sqrt_c))
    else:
        raise ValueError(f"unknown hyp_rank family {family!r}")
    return torch.stack(parts, dim=-1)


def hyp_scores_plain(lhs, x2, c, rhs, un, bt, family: str = "poincare",
                     precision: str = "highest"):
    """All-entity scores (B, Np) in plain PyTorch: bt - dist^2."""
    xv = plain_mm(lhs, rhs, precision) / un[None, :]
    d = _DISTS[family](xv, un[None, :], c[:, None], x2[:, None])
    return bt[None, :] - d * d


def _count(scores, t2, keep):
    return ((scores >= t2[:, None]) & keep).sum(1, dtype=torch.int32)


def _not_gold(np_, gold):
    return torch.arange(np_, device=gold.device)[None, :] != gold[:, None]


def _filtered_rows(fidx, gold, np_):
    """The kept filtered ids (in range, not the gold) and the clamped ids."""
    ok = (fidx >= 0) & (fidx < np_) & (fidx != gold[:, None])
    return ok, fidx.long().clamp(0, np_ - 1)


def query_curvature(cid, cvals):
    """c (B,) = cvals[cid], NaN where cid lies outside [0, n_c): the
    curvature the sweeps take for each query."""
    ok = (cid >= 0) & (cid < cvals.shape[0])
    c = cvals[cid.long().clamp(0, cvals.shape[0] - 1)]
    return torch.where(ok, c, torch.full_like(c, float("nan")))


def hyp_rank_counts_plain(lhs, x2, cid, cvals, t2, rhs, un, bt, radii, mask,
                          family="poincare", precision="highest"):
    """K5's plain version: the curvature cvals[cid], the radius part
    recomputed inline (radii is the kernel's copy of it)."""
    scores = hyp_scores_plain(lhs, x2, query_curvature(cid, cvals), rhs, un, bt, family,
                              precision)
    return _count(scores, t2, mask == 0)


def hyp_rank_sweep_nomask_plain(lhs, x2, cid, cvals, t2, rhs, un, bt, radii, gold,
                                family="poincare", precision="highest"):
    """K6's plain version, as hyp_rank_counts_plain."""
    scores = hyp_scores_plain(lhs, x2, query_curvature(cid, cvals), rhs, un, bt, family,
                              precision)
    return _count(scores, t2, _not_gold(rhs.shape[0], gold))


def hyp_rank_filtered_sub_plain(lhs, x2, c, t2, rhs, un, bt, fidx, gold,
                                family="poincare", precision="highest"):
    ok, f = _filtered_rows(fidx, gold, rhs.shape[0])
    xv = plain_rows(lhs, rhs[f], precision) / un[f]
    d = _DISTS[family](xv, un[f], c[:, None], x2[:, None])
    return _count(bt[f] - d * d, t2, ok)


def attrh_scores_plain(lhs, x2r, x2f, c, w0, w1, rhs, un_rot, un_ref, bt,
                       precision="highest"):
    """All-entity AttRH scores (B, Np): bt - w0 d_rot^2 - w1 d_ref^2.  The
    halves are the two halves of the columns (each padded on its own in
    the bf16 operands)."""
    h = lhs.shape[1] // 2
    xr = plain_mm(lhs[:, :h], rhs[:, :h], precision) / un_rot[None, :]
    xf = plain_mm(lhs[:, h:], rhs[:, h:], precision) / un_ref[None, :]
    c = c[:, None]
    d2r = _half_dist_sq(xr, un_rot[None, :], c, x2r[:, None])
    d2f = _half_dist_sq(xf, un_ref[None, :], c, x2f[:, None])
    return bt[None, :] - w0[:, None] * d2r - w1[:, None] * d2f


def attrh_rank_counts_plain(lhs, x2r, x2f, cid, cvals, w0, w1, t2, rhs, un_rot, un_ref, bt,
                            radii, mask, precision="highest"):
    """K7's plain version, as hyp_rank_counts_plain."""
    scores = attrh_scores_plain(lhs, x2r, x2f, query_curvature(cid, cvals), w0, w1, rhs,
                                un_rot, un_ref, bt, precision)
    return _count(scores, t2, mask == 0)


def attrh_rank_sweep_nomask_plain(lhs, x2r, x2f, cid, cvals, w0, w1, t2, rhs, un_rot, un_ref,
                                  bt, radii, gold, precision="highest"):
    """K8's plain version, as hyp_rank_counts_plain."""
    scores = attrh_scores_plain(lhs, x2r, x2f, query_curvature(cid, cvals), w0, w1, rhs,
                                un_rot, un_ref, bt, precision)
    return _count(scores, t2, _not_gold(rhs.shape[0], gold))


def attrh_rank_filtered_sub_plain(lhs, x2r, x2f, c, w0, w1, t2, rhs, un_rot, un_ref,
                                  bt, fidx, gold, precision="highest"):
    ok, f = _filtered_rows(fidx, gold, rhs.shape[0])
    h = lhs.shape[1] // 2
    rows = rhs[f]  # (B, L, D)
    xr = plain_rows(lhs[:, :h], rows[..., :h], precision) / un_rot[f]
    xf = plain_rows(lhs[:, h:], rows[..., h:], precision) / un_ref[f]
    c = c[:, None]
    d2r = _half_dist_sq(xr, un_rot[f], c, x2r[:, None])
    d2f = _half_dist_sq(xf, un_ref[f], c, x2f[:, None])
    return _count(bt[f] - w0[:, None] * d2r - w1[:, None] * d2f, t2, ok)


# --------------------------------- wrappers -----------------------------------


def _check_common(lhs, per_query, rhs, per_row, precision="highest", k_align=BF16_K):
    """Validate the shared inputs of a CUDA launch: lhs (B, D), the (B,)
    per-query and (Np,) per-row vectors, rhs (Np, D); returns (B, Np, D).
    precision "default": lhs and rhs bfloat16, D a multiple of k_align."""
    dev = lhs.device
    if dev.type != "cuda":
        raise ValueError(f"hyp_rank kernels take CPU or CUDA tensors, got {dev}")
    if lhs.dim() != 2 or rhs.dim() != 2:
        raise ValueError("lhs must be (B, D) and rhs (Np, D)")
    (b, d), np_ = lhs.shape, rhs.shape[0]
    f32, op = torch.float32, torch.float32
    if check_precision(precision) == "default":
        op = torch.bfloat16
        if d % k_align:
            raise ValueError(f"the bf16 kernels take rows padded to a multiple of {k_align} "
                             f"features (bf16_rows), got {d}")
        check_aligned(lhs=lhs, rhs=rhs)
    _check("lhs", lhs, op, (b, d), dev)
    _check("rhs", rhs, op, (np_, d), dev)
    for i, v in enumerate(per_query):
        _check(f"per-query input {i}", v, f32, (b,), dev)
    for i, v in enumerate(per_row):
        _check(f"per-row input {i}", v, f32, (np_,), dev)
    return b, np_, d


def _check_filters(fidx, gold, b):
    if fidx.dim() != 2:
        raise ValueError("fidx must be (B, L)")
    _check("fidx", fidx, torch.int32, (b, fidx.shape[1]), gold.device)
    _check("gold", gold, torch.int32, (b,), gold.device)


def _launch(name, device, *args, precision="highest"):
    """Launch `name`'s instance for `precision` (both take the same
    arguments)."""
    if precision == "default":
        name += "_bf16"
    launch("hyp_rank", name, device, *args)
    launches[name] += 1


def _family(family: str) -> int:
    try:
        return FAMILIES[family]
    except KeyError:
        raise ValueError(f"unknown hyp_rank family {family!r}") from None


def _check_sweep(b, np_, cid, cvals, radii, family, device):
    """cid int32 (B,), cvals float32 (n_c,), radii float32 (n_c, Np, W);
    returns n_c."""
    if cvals.dim() != 1 or cvals.shape[0] < 1:
        raise ValueError("cvals must be (n_c,) with n_c >= 1")
    n_c = cvals.shape[0]
    _check("cid", cid, torch.int32, (b,), device)
    _check("cvals", cvals, torch.float32, (n_c,), device)
    _check("radii", radii, torch.float32, (n_c, np_, RADII_WIDTH[family]), device)
    return n_c


def hyp_rank_counts(lhs, x2, cid, cvals, t2, rhs, un, bt, radii, mask,
                    family: str = "poincare", precision: str = "highest"):
    """K5: #{j : mask[b, j] == 0 and score(b, j) >= t2[b]} per query, int32
    (B,), at the curvature cvals[cid[b]].  mask is int8 (B, Np), 1 =
    filtered out (and on pad rows); radii = hyp_rank_radii(cvals, un,
    family)."""
    if lhs.device.type == "cpu":
        return hyp_rank_counts_plain(lhs, x2, cid, cvals, t2, rhs, un, bt, radii, mask,
                                     family, precision)
    fam = _family(family)
    b, np_, d = _check_common(lhs, (x2, t2), rhs, (un, bt), precision)
    n_c = _check_sweep(b, np_, cid, cvals, radii, family, lhs.device)
    _check("mask", mask, torch.int8, (b, np_), lhs.device)
    check_aligned(un=un, bt=bt, radii=radii)
    counts = torch.zeros(b, dtype=torch.int32, device=lhs.device)
    _launch("hyp_rank_sweep_masked", lhs.device, lhs, x2, cid, cvals, t2, rhs, un, bt, radii,
            mask, counts, b, np_, d, n_c, fam, precision=precision)
    return counts


def hyp_rank_radii(cvals, un, family: str, un2=None):
    """The sweeps' radius table (hyp_rank_radii_plain), float32 (n_c, Np,
    4) for poincare, (n_c, Np, 2) for lorentz and attrh (un = un_rot, un2 =
    un_ref)."""
    if cvals.device.type == "cpu":
        return hyp_rank_radii_plain(cvals, un, family, un2)
    try:
        fam = RADII_FAMILIES[family]
    except KeyError:
        raise ValueError(f"unknown hyp_rank family {family!r}") from None
    dev = cvals.device
    if dev.type != "cuda":
        raise ValueError(f"hyp_rank kernels take CPU or CUDA tensors, got {dev}")
    if cvals.dim() != 1 or un.dim() != 1:
        raise ValueError("cvals must be (n_c,) and un (Np,)")
    n_c, np_ = cvals.shape[0], un.shape[0]
    _check("cvals", cvals, torch.float32, (n_c,), dev)
    _check("un", un, torch.float32, (np_,), dev)
    if family == "attrh":
        _check("un2", un2, torch.float32, (np_,), dev)
    out = torch.empty((n_c, np_, RADII_WIDTH[family]), dtype=torch.float32, device=dev)
    _launch("hyp_rank_radii", dev, cvals, un, un2 if family == "attrh" else None, out, n_c,
            np_, fam, ONE_MINUS_EPS)
    return out


def sweep_info(family: str, device, d: int, masked: bool = True,
               precision: str = "highest") -> dict:
    """Registers and local (spill) bytes a thread, shared bytes a block and
    resident blocks per SM of the sweep of `family` ("poincare", "lorentz"
    or "attrh"), masked or not (its bf16 instance for precision "default",
    d then the padded width), at feature width d on `device`, as the CUDA
    runtime reports them."""
    fn = "hyp_rank_sweep_bf16_info" if precision == "default" else "hyp_rank_sweep_info"
    vals = kernel_info("hyp_rank", fn, device, RADII_FAMILIES[family], int(masked), d)
    return dict(zip(("regs_per_thread", "local_bytes", "smem_bytes", "blocks_per_sm"), vals))


def hyp_rank_sweep_nomask(lhs, x2, cid, cvals, t2, rhs, un, bt, radii, gold,
                          family: str = "poincare", precision: str = "highest"):
    """K6 sweep: #{j != gold[b] : score(b, j) >= t2[b]} per query, int32
    (B,), at the curvature cvals[cid[b]].  gold is int32 (B,), a row of
    this table or -1; radii as hyp_rank_counts takes it."""
    if lhs.device.type == "cpu":
        return hyp_rank_sweep_nomask_plain(lhs, x2, cid, cvals, t2, rhs, un, bt, radii, gold,
                                           family, precision)
    fam = _family(family)
    b, np_, d = _check_common(lhs, (x2, t2), rhs, (un, bt), precision)
    n_c = _check_sweep(b, np_, cid, cvals, radii, family, lhs.device)
    _check("gold", gold, torch.int32, (b,), lhs.device)
    check_aligned(un=un, bt=bt, radii=radii)
    counts = torch.zeros(b, dtype=torch.int32, device=lhs.device)
    _launch("hyp_rank_sweep_nomask", lhs.device, lhs, x2, cid, cvals, t2, rhs, un, bt, radii,
            gold, counts, b, np_, d, n_c, fam, precision=precision)
    return counts


def hyp_rank_filtered_sub(lhs, x2, c, t2, rhs, un, bt, fidx, gold,
                          family: str = "poincare", precision: str = "highest"):
    """K6 subtraction: #{l : fidx[b, l] in [0, Np), != gold[b], score >=
    t2[b]} per query, int32 (B,), at the curvature c[b].  fidx is int32
    (B, L), rows deduplicated (data/dataset.py::eval_pack)."""
    if lhs.device.type == "cpu":
        return hyp_rank_filtered_sub_plain(lhs, x2, c, t2, rhs, un, bt, fidx, gold,
                                           family, precision)
    fam = _family(family)
    b, np_, d = _check_common(lhs, (x2, c, t2), rhs, (un, bt), precision)
    _check_filters(fidx, gold, b)
    sub = torch.empty(b, dtype=torch.int32, device=lhs.device)
    _launch("hyp_rank_filtered_sub", lhs.device, lhs, x2, c, t2, rhs, un, bt, fidx,
            gold, sub, b, np_, d, fidx.shape[1], fam, ONE_MINUS_EPS, precision=precision)
    return sub


def hyp_rank_counts_nomask(lhs, x2, cid, cvals, t2, rhs, un, bt, radii, fidx, gold,
                           family: str = "poincare", precision: str = "highest"):
    """K6: #{non-filtered, non-gold j : score >= t2} without a (B, Np) mask:
    the sweep counts every non-gold row and the filtered ids it counted are
    subtracted, at c = query_curvature(cid, cvals).  Both kernels share one
    score routine (in the bf16 instances: one mma chain per pair, tile
    against tile) and the table holds the inline radius part bit for bit,
    so a filtered id is subtracted exactly when the sweep counted it."""
    c = query_curvature(cid, cvals)
    return (hyp_rank_sweep_nomask(lhs, x2, cid, cvals, t2, rhs, un, bt, radii, gold, family,
                                  precision)
            - hyp_rank_filtered_sub(lhs, x2, c, t2, rhs, un, bt, fidx, gold, family,
                                    precision))


def _check_attrh(lhs, per_query, rhs, per_row, precision="highest"):
    b, np_, d = _check_common(lhs, per_query, rhs, per_row, precision, k_align=2 * BF16_K)
    if d % 2:
        raise ValueError(f"AttRH's features split in two halves, got D = {d}")
    return b, np_, d


def attrh_rank_counts(lhs, x2r, x2f, cid, cvals, w0, w1, t2, rhs, un_rot, un_ref, bt, radii,
                      mask, precision: str = "highest"):
    """K7: the masked AttRH count, as hyp_rank_counts; radii =
    hyp_rank_radii(cvals, un_rot, "attrh", un_ref)."""
    if lhs.device.type == "cpu":
        return attrh_rank_counts_plain(lhs, x2r, x2f, cid, cvals, w0, w1, t2, rhs, un_rot,
                                       un_ref, bt, radii, mask, precision)
    b, np_, d = _check_attrh(lhs, (x2r, x2f, w0, w1, t2), rhs, (un_rot, un_ref, bt), precision)
    n_c = _check_sweep(b, np_, cid, cvals, radii, "attrh", lhs.device)
    _check("mask", mask, torch.int8, (b, np_), lhs.device)
    check_aligned(un_rot=un_rot, un_ref=un_ref, bt=bt, radii=radii)
    counts = torch.zeros(b, dtype=torch.int32, device=lhs.device)
    _launch("attrh_rank_sweep_masked", lhs.device, lhs, x2r, x2f, cid, cvals, w0, w1, t2, rhs,
            un_rot, un_ref, bt, radii, mask, counts, b, np_, d, n_c, precision=precision)
    return counts


def attrh_rank_sweep_nomask(lhs, x2r, x2f, cid, cvals, w0, w1, t2, rhs, un_rot, un_ref, bt,
                            radii, gold, precision: str = "highest"):
    """K8 sweep, as hyp_rank_sweep_nomask."""
    if lhs.device.type == "cpu":
        return attrh_rank_sweep_nomask_plain(lhs, x2r, x2f, cid, cvals, w0, w1, t2, rhs,
                                             un_rot, un_ref, bt, radii, gold, precision)
    b, np_, d = _check_attrh(lhs, (x2r, x2f, w0, w1, t2), rhs, (un_rot, un_ref, bt), precision)
    n_c = _check_sweep(b, np_, cid, cvals, radii, "attrh", lhs.device)
    _check("gold", gold, torch.int32, (b,), lhs.device)
    check_aligned(un_rot=un_rot, un_ref=un_ref, bt=bt, radii=radii)
    counts = torch.zeros(b, dtype=torch.int32, device=lhs.device)
    _launch("attrh_rank_sweep_nomask", lhs.device, lhs, x2r, x2f, cid, cvals, w0, w1, t2, rhs,
            un_rot, un_ref, bt, radii, gold, counts, b, np_, d, n_c, precision=precision)
    return counts


def attrh_rank_filtered_sub(lhs, x2r, x2f, c, w0, w1, t2, rhs, un_rot, un_ref, bt,
                            fidx, gold, precision: str = "highest"):
    """K8 subtraction, as hyp_rank_filtered_sub."""
    if lhs.device.type == "cpu":
        return attrh_rank_filtered_sub_plain(lhs, x2r, x2f, c, w0, w1, t2, rhs, un_rot,
                                             un_ref, bt, fidx, gold, precision)
    b, np_, d = _check_attrh(lhs, (x2r, x2f, c, w0, w1, t2), rhs, (un_rot, un_ref, bt),
                             precision)
    _check_filters(fidx, gold, b)
    sub = torch.empty(b, dtype=torch.int32, device=lhs.device)
    _launch("attrh_rank_filtered_sub", lhs.device, lhs, x2r, x2f, c, w0, w1, t2, rhs,
            un_rot, un_ref, bt, fidx, gold, sub, b, np_, d, fidx.shape[1], precision=precision)
    return sub


def attrh_rank_counts_nomask(lhs, x2r, x2f, cid, cvals, w0, w1, t2, rhs, un_rot, un_ref, bt,
                             radii, fidx, gold, precision: str = "highest"):
    """K8: the AttRH sweep minus its filtered subtraction, as
    hyp_rank_counts_nomask."""
    c = query_curvature(cid, cvals)
    sweep = attrh_rank_sweep_nomask(lhs, x2r, x2f, cid, cvals, w0, w1, t2, rhs, un_rot, un_ref,
                                    bt, radii, gold, precision)
    return sweep - attrh_rank_filtered_sub(lhs, x2r, x2f, c, w0, w1, t2, rhs, un_rot, un_ref,
                                           bt, fidx, gold, precision)


# --------------------- proofs of the bf16 sweeps' epilogue ---------------------

# the non-negative finite float32 values, 0 .. 0x7f7fffff
ROOT_INPUTS = 0x7F800000


def hyp_scores_bf16(lhs, x2, cid, cvals, rhs, un, bt, radii, family: str = "poincare",
                    ieee: bool = False):
    """Every pair's score of `family` ("poincare" or "lorentz"), float32
    (B, Np), from K5/K6's bf16 sweep (inputs as hyp_rank_sweep_nomask
    takes them at precision "default", without t2 and gold): through its
    batched epilogue, or (ieee) through score_from_radii's __fdiv_rn /
    __fsqrt_rn on the same score tile.  The two are equal bit for bit.  A
    proof of the card's kernel: a CPU tensor raises."""
    if lhs.device.type != "cuda":
        raise ValueError(f"hyp_scores_bf16 proves the card's kernel, got {lhs.device}")
    fam = _family(family)
    b, np_, d = _check_common(lhs, (x2,), rhs, (un, bt), "default")
    n_c = _check_sweep(b, np_, cid, cvals, radii, family, lhs.device)
    check_aligned(un=un, bt=bt, radii=radii)
    scores = torch.empty((b, np_), dtype=torch.float32, device=lhs.device)
    launch("hyp_rank", "hyp_rank_scores_bf16", lhs.device, lhs, x2, cid, cvals, rhs, un, bt,
           radii, scores, b, np_, d, n_c, fam, int(ieee))
    launches["hyp_rank_scores_bf16"] += 1
    return scores


def attrh_scores_bf16(lhs, x2r, x2f, cid, cvals, w0, w1, rhs, un_rot, un_ref, bt, radii,
                      ieee: bool = False):
    """Every pair's AttRH score, float32 (B, Np), from K7/K8's bf16 sweep
    (inputs as attrh_rank_sweep_nomask takes them at precision "default",
    without t2 and gold): through its batched epilogue, or (ieee) through
    score_from_radii's __fdiv_rn / __fsqrt_rn on the same score tile.  The
    two are equal bit for bit.  A proof of the card's kernel: a CPU tensor
    raises."""
    if lhs.device.type != "cuda":
        raise ValueError(f"attrh_scores_bf16 proves the card's kernel, got {lhs.device}")
    b, np_, d = _check_attrh(lhs, (x2r, x2f, w0, w1), rhs, (un_rot, un_ref, bt), "default")
    n_c = _check_sweep(b, np_, cid, cvals, radii, "attrh", lhs.device)
    check_aligned(un_rot=un_rot, un_ref=un_ref, bt=bt, radii=radii)
    scores = torch.empty((b, np_), dtype=torch.float32, device=lhs.device)
    launch("hyp_rank", "attrh_rank_scores_bf16", lhs.device, lhs, x2r, x2f, cid, cvals, w0, w1,
           rhs, un_rot, un_ref, bt, radii, scores, b, np_, d, n_c, int(ieee))
    launches["attrh_rank_scores_bf16"] += 1
    return scores


def fast_arith_sweep(device, n_quot: int = 2 ** 32, seed: int = 0) -> dict:
    """The proof of the epilogue's fast paths on the card: the square root
    as the epilogue takes it against __fsqrt_rn over every non-negative
    finite float32, and the division against __fdiv_rn over n_quot pairs
    drawn from `seed` across the epilogue's operand ranges, zeros,
    subnormals, the ranges' edges, overflow, infinities and NaN.  Returns
    the inputs, the mismatches (bits) and the inputs the fast path took."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"fast_arith_sweep proves the card's fast paths, got {dev}")
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    launch("hyp_rank", "hyp_rank_fast_arith_sweep", dev, n_quot, seed, counts)
    launches["hyp_rank_fast_arith_sweep"] += 1
    c = counts.tolist()
    return {"sqrt_inputs": ROOT_INPUTS, "sqrt_mismatches": c[0], "sqrt_fast": c[1],
            "quot_pairs": n_quot, "quot_mismatches": c[2], "quot_fast": c[3]}


# ---------------------------------- rankers -----------------------------------


def _padded_table(ent):
    """ent (n, D) -> float32 (Np, D) with Np = round_up(n + 1, ROW_TILE):
    at least one zero pad row, where the masked form's filter ids outside
    the held rows land (FusedRanker._filter); bt = -1e30 on every pad row
    keeps them below the thresholds in K6/K8."""
    n, d = ent.shape
    rhs = torch.zeros((round_up(n + 1, ROW_TILE), d), dtype=torch.float32,
                      device=ent.device)
    rhs[:n] = ent
    return rhs


def _row_norm(rows):
    return torch.sqrt(torch.sum(rows * rows, dim=-1).clamp_min(MIN_NORM * MIN_NORM))


def _curvatures(model, device):
    """cvals (n_c,) float32, the model's curvatures: one per relation with
    multi_c, else the shared one."""
    r = torch.arange(model.cfg.n_relations, device=device)
    return model.curvature(r).detach().to(torch.float32).reshape(-1).contiguous()


def _curvature_ids(model, rel):
    """cid (B,) int32: the relation with multi_c, else 0."""
    if model.cfg.multi_c:
        return rel.to(torch.int32).contiguous()
    return torch.zeros(rel.shape, dtype=torch.int32, device=rel.device)


class HypRanker(FusedRanker):
    """Filtered ranker for the BaseH family (not AttRH) and the BaseLorentz
    family; the counterpart of the JAX PallasHypRanker (interface:
    kernels/_ranker.py).  masked=True streams an int8 (B, Np) mask through
    K5; masked=False runs K6 (sweep + filtered subtraction) with no mask.
    The tables hold the curvatures cvals and the sweeps' radius table,
    rebuilt when the entities, biases or curvatures change; a query's
    curvature is cvals[cid] for K5 and K6 alike, and c = cvals[cid] for
    the subtraction."""

    TABLES = ("rhs", "un", "bt", "cvals", "radii")
    QUERIES = ("lhs", "x2", "cid", "c", "t2")
    TABLE_PARAMS = ("entity", "bt", "c")

    def __init__(self, model, masked: bool = True, precision: str = "highest"):
        from complexhyperbolickge_torch.models.hyperbolic import AttRH, BaseH, BaseLorentz

        if isinstance(model, AttRH) or not isinstance(model, (BaseH, BaseLorentz)):
            raise TypeError("HypRanker ranks BaseH (not AttRH) and BaseLorentz models, "
                            f"got {type(model).__name__}")
        super().__init__(model, masked, precision)
        self.family = "poincare" if isinstance(model, BaseH) else "lorentz"

    def _prepare_tables(self):
        rhs = _padded_table(self.model.entity.detach().to(torch.float32))
        un = _row_norm(rhs)
        cvals = _curvatures(self.model, rhs.device)
        return (rhs, un, self._padded_bias(rhs.shape[0], rhs.device), cvals,
                hyp_rank_radii(cvals, un, self.family))

    def _queries_core(self, q, tables):
        """(lhs, x2, cid, c, t2) of a batch; c = cvals[cid] (cvals from
        `tables`), the curvature get_queries took; t2 as the JAX ranker
        takes it, the model's own train-shape sim of the gold tail plus
        bt[gold].  A RotH on float32 tables on the card, at most 64 wide,
        takes one launch (kernels/hyp_queries.py); every other model and
        table the eager ops."""
        m = self.model
        if hyp_queries.use_kernel(m):
            return hyp_queries.roth_rank_queries(m.entity, m.rel, m.rel_diag, m.bt, tables[3], q,
                                                 m.cfg.multi_c, m.cfg.bias == "learn")
        b = q.shape[0]
        (lhs, c), _ = m.get_queries(q[:, :2])
        lhs = lhs.to(torch.float32).contiguous()
        c = c.to(torch.float32).expand(b, 1)  # a shared (1, 1) curvature broadcasts
        gold = q[:, 2]
        sim = m.sim((lhs, c), m.entity[gold].to(torch.float32)[:, None, :],
                    all_pairs=False)[:, 0]
        cid = _curvature_ids(m, q[:, 1])
        return (lhs, torch.sum(lhs * lhs, dim=-1), cid, tables[3][cid.long()],
                self._gold_threshold(sim, gold))

    def _counts(self, x, masked):
        kw = dict(family=self.family, precision=self.precision)
        if masked:
            return hyp_rank_counts(*(x[k] for k in ("lhs", "x2", "cid", "cvals", "t2", "rhs",
                                                    "un", "bt", "radii", "mask")), **kw)
        # K6 with the batch's c = cvals[cid], which the queries already hold
        sweep = hyp_rank_sweep_nomask(*(x[k] for k in (
            "lhs", "x2", "cid", "cvals", "t2", "rhs", "un", "bt", "radii", "gold")), **kw)
        return sweep - hyp_rank_filtered_sub(*(x[k] for k in (
            "lhs", "x2", "c", "t2", "rhs", "un", "bt", "fidx", "gold")), **kw)


class AttRHRanker(FusedRanker):
    """Filtered ranker for AttRH, whose score splits the features in two
    halves (the counterpart of the JAX PallasAttRHRanker): K7 masked, K8
    maskless.  The halves are column ranges of one table, not two tables.
    Curvatures and the radius table as in HypRanker."""

    TABLES = ("rhs", "un_rot", "un_ref", "bt", "cvals", "radii")
    QUERIES = ("lhs", "x2r", "x2f", "cid", "c", "w0", "w1", "t2")
    TABLE_PARAMS = ("entity", "bt", "c")
    BF16_HALVES = True

    def __init__(self, model, masked: bool = True, precision: str = "highest"):
        from complexhyperbolickge_torch.models.hyperbolic import AttRH

        if not isinstance(model, AttRH):
            raise TypeError(f"AttRHRanker ranks AttRH only, got {type(model).__name__}")
        super().__init__(model, masked, precision)

    def _prepare_tables(self):
        rhs = _padded_table(self.model.entity.detach().to(torch.float32))
        h = rhs.shape[1] // 2
        un_rot, un_ref = _row_norm(rhs[:, :h]), _row_norm(rhs[:, h:])
        cvals = _curvatures(self.model, rhs.device)
        return (rhs, un_rot, un_ref, self._padded_bias(rhs.shape[0], rhs.device), cvals,
                hyp_rank_radii(cvals, un_rot, "attrh", un_ref))

    def _queries_core(self, q, tables):
        m = self.model
        b = q.shape[0]
        (lhs, c, w), _ = m.get_queries(q[:, :2])
        lhs = lhs.to(torch.float32).contiguous()
        c = c.to(torch.float32).expand(b, 1)  # a shared (1, 1) curvature broadcasts
        w = w.to(torch.float32)
        gold = q[:, 2]
        sim = m.sim((lhs, c, w), m.entity[gold].to(torch.float32)[:, None, :],
                    all_pairs=False)[:, 0]
        h = lhs.shape[1] // 2
        cid = _curvature_ids(m, q[:, 1])
        return (lhs, torch.sum(lhs[:, :h] ** 2, dim=-1), torch.sum(lhs[:, h:] ** 2, dim=-1),
                cid, tables[4][cid.long()], w[:, 0].contiguous(),
                w[:, 1].contiguous(), self._gold_threshold(sim, gold))

    def _counts(self, x, masked):
        p = self.precision
        if masked:
            return attrh_rank_counts(*(x[k] for k in (
                "lhs", "x2r", "x2f", "cid", "cvals", "w0", "w1", "t2", "rhs", "un_rot",
                "un_ref", "bt", "radii", "mask")), precision=p)
        # K8 with the batch's c = cvals[cid], which the queries already hold
        sweep = attrh_rank_sweep_nomask(*(x[k] for k in (
            "lhs", "x2r", "x2f", "cid", "cvals", "w0", "w1", "t2", "rhs", "un_rot", "un_ref",
            "bt", "radii", "gold")), precision=p)
        return sweep - attrh_rank_filtered_sub(*(x[k] for k in (
            "lhs", "x2r", "x2f", "c", "w0", "w1", "t2", "rhs", "un_rot", "un_ref", "bt", "fidx",
            "gold")), precision=p)
