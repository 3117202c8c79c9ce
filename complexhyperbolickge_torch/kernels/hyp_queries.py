"""RotH's ranker query prep as one CUDA launch.

kernels/hyp_rank.py HypRanker._queries_core, eager, runs RotH.get_queries
(the gathers, three expmap0 with their project, two mobius_add, project and
the Givens rotation), BaseH.sim of the gold tail in its broadcast form
(expmap0, project, hyp_distance_multi_c, artanh), |lhs|^2 and the
threshold: ~190 kernel launches a call.  `roth_rank_queries(entity, rel,
rel_diag, bt, cvals, queries, multi_c, learn_bias)` returns the same
(lhs, x2, cid, c, t2) from one launch (`roth_rank_queries` in
csrc/hyp_queries.cu), counted in `launches`.  Each query's curvature is
cvals[cid], the ranker's table of the model's curvatures (the bits
get_queries takes).  The chain's norms and dots accumulate in fp64 and
round once to float32, the rest of it is float32 in the order of the
PyTorch expressions, project's margin the float32 ball's 1 - ball_eps.
The threshold t2, the gold tail's -d^2 plus bt[gold] under bias "learn",
is ill-conditioned near the ball's edge, so its distance runs in fp64 from
the unrounded sums and t2 rounds once: closer to the float64 definition
than the eager float32 ops.  The tables are the model's (on a shard, the
mini-tables of the gathered rows), never the ranker's padded ones.

The plain PyTorch version beside the kernel (`roth_rank_queries_plain`)
computes the same formulas in the same order on any device and dtype,
with the margin of its dtype, from the plain pieces of chyp_queries.py (as
the kernel takes the pieces of csrc/chyp_chain.cuh).  `use_kernel` decides the route from the
model: a RotH whose tables are float32 on the card, at most MAX_D wide
(one coordinate pair a lane); every other family, device, dtype and width
keeps the eager ops.
"""

from __future__ import annotations

import torch

from complexhyperbolickge_torch.kernels._build import check_tensor, launch
from complexhyperbolickge_torch.kernels.chyp_queries import (
    _exp0,
    _givens,
    _ids,
    _mobius,
    _project,
    _sum64,
)
from complexhyperbolickge_torch.ops.math import MIN_NORM, artanh, ball_eps, tanh

# launches of the CUDA kernel since the last reset_launches()
launches = {"roth_rank_queries": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


MAX_D = 64  # real coordinates: one pair a lane of a warp


def use_kernel(model) -> bool:
    """Whether HypRanker's query prep for `model` runs the CUDA kernel: a
    RotH whose entity, rel, rel_diag and bt are float32 on the card, at
    most MAX_D wide."""
    from complexhyperbolickge_torch.models.hyperbolic import RotH

    if not isinstance(model, RotH):
        return False
    tables = (model.entity, model.rel, model.rel_diag, model.bt)
    return (all(t.device.type == "cuda" and t.dtype == torch.float32 for t in tables)
            and model.entity.shape[-1] <= MAX_D)


# ------------------------------- plain version ---------------------------------


def _neg_sq_dist(x2, xv, vn, c, s):
    """-d^2 of ops/hyperbolic.py::_hyp_dist_multi_c_from_parts at x2 = |x|^2,
    xv = <x, v / |v|> and the radius vn = |v|, in the kernel's order (which
    takes it in float64)."""
    gamma = tanh(s * vn) / s
    one_t = 1 - 2 * c * gamma * xv
    c1 = one_t + c * (gamma * gamma)
    c2 = 1 - c * x2
    sq = (c1 * c1) * x2 + (c2 * c2) * (gamma * gamma) - (2 * c1 * c2) * gamma * xv
    num = torch.sqrt(sq.clamp_min(MIN_NORM))
    den = one_t + (c * c) * (gamma * gamma) * x2
    d = 2 * artanh(s * (num / den.clamp_min(MIN_NORM))) / s
    return -(d * d)


def roth_rank_queries_plain(entity, rel, rel_diag, bt, cvals, queries, multi_c: bool,
                            learn_bias: bool):
    """(lhs (B, D), x2 (B,), cid int32 (B,), c (B,), t2 (B,)) of the queries
    (B, 3) [h, r, gold] in plain PyTorch: the kernel's formulas, in its
    order, in entity's dtype (project's margin that dtype's)."""
    h, r, g = queries[:, 0], queries[:, 1], queries[:, 2]
    d = entity.shape[1]
    cid = (r.to(torch.int32) if multi_c
           else torch.zeros(r.shape, dtype=torch.int32, device=r.device))
    c = cvals[cid.long()].to(entity.dtype)[:, None]
    s = torch.sqrt(c)
    rs = torch.reciprocal(s)
    margin = 1 - ball_eps(entity.dtype)

    def expmap0(u):
        return _project(_exp0(u, s)[0], rs, margin)[0]

    rows = rel[r]
    r1, r2 = expmap0(rows[:, :d]), expmap0(rows[:, d:])
    l = _project(_mobius(expmap0(entity[h]), r1, c)[0], rs, margin)[0]
    lhs = _mobius(_givens(rel_diag[r], l)[0], r2, c)[0]
    # the threshold in float64 from the unrounded sums, rounded once
    x, v = lhs.double(), expmap0(entity[g]).double()
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    vn = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True).clamp_min(MIN_NORM * MIN_NORM))
    c64 = c.double()
    t2 = _neg_sq_dist(x2, torch.sum(x * v, dim=-1, keepdim=True) / vn, vn, c64, torch.sqrt(c64))
    if learn_bias:
        t2 = t2 + bt[g].double()
    return lhs, x2[:, 0].to(lhs.dtype), cid, c[:, 0], t2[:, 0].to(lhs.dtype)


# --------------------------------- wrapper -------------------------------------


def roth_rank_queries(entity, rel, rel_diag, bt, cvals, queries, multi_c: bool,
                      learn_bias: bool):
    """HypRanker's query inputs (lhs, x2, cid, c, t2) of a RotH batch from
    the model's tables and the ranker's curvatures cvals (n_c,): the CUDA
    kernel (CPU tables: the plain version).  Raises on what the kernel does
    not take: other dtypes or devices, widths odd or above MAX_D, tables
    that do not fit each other or start off an 8-byte boundary."""
    if entity.device.type == "cpu":
        return roth_rank_queries_plain(entity, rel, rel_diag, bt, cvals, queries, multi_c,
                                       learn_bias)
    dev = entity.device
    (n_rows, d), n_rel = entity.shape, rel.shape[0]
    if d % 2 or d < 2 or d > MAX_D:
        raise ValueError(f"the RotH query kernel takes an even width 2 <= D <= {MAX_D}, "
                         f"got {d}")
    check_tensor("entity", entity, torch.float32, (n_rows, d), dev)
    check_tensor("rel", rel, torch.float32, (n_rel, 2 * d), dev)
    check_tensor("rel_diag", rel_diag, torch.float32, (n_rel, d), dev)
    check_tensor("bt", bt, torch.float32, (n_rows, 1), dev)
    n_c = n_rel if multi_c else 1
    check_tensor("cvals", cvals, torch.float32, (n_c,), dev)
    for name, t in (("entity", entity), ("rel", rel), ("rel_diag", rel_diag)):
        if t.data_ptr() % 8:
            raise ValueError(f"{name} must start on an 8-byte boundary")
    if queries.dim() != 2 or queries.shape[1] < 3 or queries.device != dev:
        raise ValueError(f"queries must be (B, >= 3) on {dev}, got {tuple(queries.shape)} "
                         f"on {queries.device}")
    q, qs = _ids(queries, 3)
    b = q.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    lhs, x2, c, t2 = (torch.empty(shape, **f32) for shape in ((b, d), (b,), (b,), (b,)))
    cid = torch.empty((b,), dtype=torch.int32, device=dev)
    if b:
        launch("hyp_queries", "roth_rank_queries", dev, entity, rel, rel_diag, bt, cvals, q, qs,
               lhs, x2, cid, c, t2, b, n_rows, n_rel, n_c, d, int(multi_c), int(learn_bias),
               1 - ball_eps(torch.float32))
        launches["roth_rank_queries"] += 1
    return lhs, x2, cid, c, t2
