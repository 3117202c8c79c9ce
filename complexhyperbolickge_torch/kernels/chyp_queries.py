"""FFTRotH's query chain as one CUDA forward and one CUDA backward.

models/chyperbolic.py FFTRotH.get_queries, eager, is irfft_packed, three
expmap0, two real_mobius_add, project, givens_rotations, rfft_packed, the
multi_c softplus and the row gathers: ~150 kernel launches forward and
~370 backward.  `fftroth_queries(entity, rel, rel_diag, c, bh, queries,
multi_c)` is a torch.autograd.Function that returns the same
((res,), bh[h]) from one launch (`fftroth_queries_fwd` in
csrc/chyp_queries.cu) and back-propagates into the five tables with two
(`fftroth_queries_bwd`, which recomputes each row's chain and writes its
gradients, and `fftroth_queries_sum`, which sums them into the dense
tables); each launch is counted in `launches`.  The DFTs are products with
ops/fft.py's matrices in fp64; every sum (the DFTs, the norms and dots of
a row, a table row's gradient over the batch) accumulates in fp64 and
rounds once to float32, and the rest is float32 in the order of the
PyTorch expressions.  The backward is the analytic one of the eager chain,
autograd's subgradient at every clamp and torch.where; each table row's
gradient is the sum of its rows' in ascending row order: the same bits on
every run.

The plain PyTorch versions beside the kernels (`fftroth_queries_forward_plain`,
`fftroth_queries_backward_plain`) compute the same formulas in the same
order on any device and dtype; `fftroth_queries_plain` is the Function on
them.  `use_kernel` decides the route from the tables alone: CUDA float32
tables of width D <= 66 (rank <= 33, one coordinate pair a lane) take the
kernels; CPU, float64 and bfloat16 tables keep the model's eager chain.
"""

from __future__ import annotations

import torch

from complexhyperbolickge_torch.kernels._build import check_tensor, launch
from complexhyperbolickge_torch.ops.fft import irfft_matrix, rfft_matrix
from complexhyperbolickge_torch.ops.math import MIN_NORM

# launches of each CUDA kernel since the last reset_launches()
launches = {"fftroth_queries_fwd": 0, "fftroth_queries_bwd": 0, "fftroth_queries_sum": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


MAX_D = 66  # 64 real coordinates: one pair a lane of a warp
_MARGIN = 1 - 1e-5  # project's (ops/chyperbolic.py _PROJECT_EPS)


def use_kernel(entity, rel, rel_diag, c, bh) -> bool:
    """Whether FFTRotH's chain on these tables runs the CUDA kernels: all
    five float32 on the card, entity at most MAX_D wide."""
    return (all(t.device.type == "cuda" and t.dtype == torch.float32
                for t in (entity, rel, rel_diag, c, bh))
            and entity.shape[-1] <= MAX_D)


_dft_cache: dict = {}  # (device, D) -> the fp64 matrices the kernels stage


def dft_matrices(d: int, device) -> torch.Tensor:
    """Mi (D, n), Mf (n, D), Mf^T and Mi^T of ops/fft.py in fp64, one after
    another in one tensor (n = D - 2)."""
    key = (str(device), d)
    if key not in _dft_cache:
        mi = irfft_matrix(d // 2, dtype=torch.float64)
        mf = rfft_matrix(d - 2, dtype=torch.float64)
        _dft_cache[key] = torch.cat([m.contiguous().reshape(-1) for m in
                                     (mi, mf, mf.T, mi.T)]).to(device)
    return _dft_cache[key]


# ------------------------------ plain versions --------------------------------


def _sum64(x, y):
    """sum(x * y) over the last axis with keepdim, accumulated in fp64 and
    rounded once to x's dtype."""
    return torch.sum(x.double() * y.double(), dim=-1, keepdim=True).to(x.dtype)


def _curvature(c, r, multi_c: bool):
    """Each query's curvature, (B, 1) with multi_c (the softplus over the
    whole table before the gather, as models/base.py::curvature takes it)
    and the raw (1, 1) c[0] otherwise."""
    if multi_c:
        return torch.logaddexp(c, torch.zeros_like(c))[r]
    return c[0][None, :]


def _exp0(u, s):
    sq = _sum64(u, u)
    nu = torch.sqrt(sq.clamp_min(MIN_NORM * MIN_NORM))
    a = s * nu
    t = torch.tanh(a.clamp(-15, 15))
    return t * u / a, (sq, nu, a, t)


def _project(x, rs, margin: float = _MARGIN):
    sx = _sum64(x, x)
    nx = torch.sqrt(sx.clamp_min(MIN_NORM * MIN_NORM))
    mx = rs * margin
    on = nx > mx
    return torch.where(on, x / nx * mx, x), (sx, nx, mx, on)


def _mobius(x, y, c):
    x2, y2, xy = _sum64(x, x), _sum64(y, y), _sum64(x, y)
    one_t1 = 1 + 2 * c * xy
    a = one_t1 + c * y2
    bc = 1 - c * x2
    den = one_t1 + c * c * x2 * y2
    denc = den.clamp_min(MIN_NORM)
    return (a * x + bc * y) / denc, (x2, y2, xy, a, bc, den, denc)


def _givens(g, x):
    g0, g1, x0, x1 = g[:, 0::2], g[:, 1::2], x[:, 0::2], x[:, 1::2]
    q = g0 * g0 + g1 * g1
    nq = torch.sqrt(q.clamp_min(torch.finfo(g.dtype).tiny))
    cs, sn = g0 / nq, g1 / nq
    y = torch.stack([cs * x0 - sn * x1, sn * x0 + cs * x1], dim=-1)
    return y.reshape(x.shape), (q, nq, cs, sn)


def _chain(entity, rel, rel_diag, c, h, r, multi_c: bool):
    """The forward of every row up to m2, with what the backward takes."""
    d = entity.shape[1]
    n = d - 2
    mi = dft_matrices(d, entity.device)[: d * n].reshape(d, n)
    st = {"u": (entity[h].double() @ mi).to(entity.dtype)}
    st["cv"] = cv = _curvature(c, r, multi_c)
    st["s"] = s = torch.sqrt(cv)
    st["rs"] = rs = torch.reciprocal(s)
    st["ra"], st["rb"] = rel[r][:, :n], rel[r][:, n:]
    st["rd"] = rel_diag[r]
    for v, out in (("u", "hh"), ("ra", "r1"), ("rb", "r2")):
        st["g" + v], st["e" + v] = _exp0(st[v], s)
        st[out], st["p" + v] = _project(st["g" + v], rs)
    st["m1"], st["mo1"] = _mobius(st["hh"], st["r1"], cv)
    st["l"], st["pl"] = _project(st["m1"], rs)
    st["gq"], st["gv"] = _givens(st["rd"], st["l"])
    st["m2"], st["mo2"] = _mobius(st["gq"], st["r2"], cv)
    return st


def fftroth_queries_forward_plain(entity, rel, rel_diag, c, bh, queries, multi_c: bool):
    """(res (B, D), bias (B, 1)) of the queries (B, 2) [h, r] in plain
    PyTorch: the kernel's formulas, in its order."""
    h, r = queries[:, 0], queries[:, 1]
    st = _chain(entity, rel, rel_diag, c, h, r, multi_c)
    d = entity.shape[1]
    mf = dft_matrices(d, entity.device)[d * (d - 2): 2 * d * (d - 2)].reshape(d - 2, d)
    res = (st["m2"].double() @ mf).to(entity.dtype)
    return res, bh[h]


def _exp0_vjp(u, gam, s, e, gg):
    """(the gradient of u, of s) of expmap0 before its project."""
    sq, nu, a, t = e
    gtu = gg / a
    g_ac = _sum64(gtu, u) * (1 - t * t)
    inside = (a >= -15) & (a <= 15)
    g_a = -_sum64(gtu, gam) + torch.where(inside, g_ac, torch.zeros_like(g_ac))
    g_sq = (g_a * s) / (2 * nu)
    g_sq = torch.where(sq >= MIN_NORM * MIN_NORM, g_sq, torch.zeros_like(g_sq))
    return gtu * t + 2 * u * g_sq, g_a * nu


def _project_vjp(x, p, go):
    """(the gradient of x, of rs = 1 / s) of project."""
    sx, nx, mx, on = p
    g_mx = _sum64(go, x / nx)
    g_nx = -(g_mx * mx) / nx
    g_sx = g_nx / (2 * nx)
    g_sx = torch.where(sx >= MIN_NORM * MIN_NORM, g_sx, torch.zeros_like(g_sx))
    gx = (go * mx) / nx + 2 * x * g_sx
    zero = torch.zeros_like(g_mx)
    return torch.where(on, gx, go), torch.where(on, g_mx * _MARGIN, zero)


def _mobius_vjp(x, y, c, m, go):
    """(the gradients of x, y and c) of real_mobius_add."""
    x2, y2, xy, a, bc, den, denc = m
    num = a * x + bc * y
    gn = go / denc
    g_a, g_b = _sum64(gn, x), _sum64(gn, y)
    g_den = -_sum64(go, num) / (denc * denc)
    g_den = torch.where(den >= MIN_NORM, g_den, torch.zeros_like(g_den))
    g_t1 = g_a + g_den
    g_xy = 2 * c * g_t1
    g_w = y2 * g_den
    g_y2 = c * g_a + c * c * x2 * g_den
    g_x2 = c * c * g_w - c * g_b
    g_c = 2 * xy * g_t1 + y2 * g_a - x2 * g_b + 2 * c * (x2 * g_w)
    gx = a * gn + 2 * x * g_x2 + y * g_xy
    gy = bc * gn + 2 * y * g_y2 + x * g_xy
    return gx, gy, g_c


def _givens_vjp(g, x, v, gy):
    """(the gradients of x and g) of the Givens rotation."""
    q, nq, cs, sn = v
    g0, g1, x0, x1 = g[:, 0::2], g[:, 1::2], x[:, 0::2], x[:, 1::2]
    gy0, gy1 = gy[:, 0::2], gy[:, 1::2]
    g_cs = gy0 * x0 + gy1 * x1
    g_sn = gy1 * x0 - gy0 * x1
    g_nq = -(g_cs * cs + g_sn * sn) / nq
    g_q = g_nq / (2 * nq)
    g_q = torch.where(q >= torch.finfo(g.dtype).tiny, g_q, torch.zeros_like(g_q))
    gg = torch.stack([g_cs / nq + 2 * g0 * g_q, g_sn / nq + 2 * g1 * g_q], dim=-1)
    gx = torch.stack([cs * gy0 + sn * gy1, cs * gy1 - sn * gy0], dim=-1)
    return gx.reshape(x.shape), gg.reshape(g.shape)


def fftroth_queries_rows_plain(g_res, entity, rel, rel_diag, c, queries, multi_c: bool):
    """Each row's gradients before the sums over the batch: of its entity
    row (B, D), rel row (B, 2 n), rel_diag row (B, n) and curvature (B, 1),
    the last after the softplus."""
    h, r = queries[:, 0], queries[:, 1]
    st = _chain(entity, rel, rel_diag, c, h, r, multi_c)
    d = entity.shape[1]
    dn = d * (d - 2)
    mats = dft_matrices(d, entity.device)
    mf_t = mats[2 * dn: 3 * dn].reshape(d, d - 2)
    mi_t = mats[3 * dn:].reshape(d - 2, d)
    cv, s, rs = st["cv"], st["s"], st["rs"]
    g_m2 = (g_res.double() @ mf_t).to(entity.dtype)
    g_gq, g_r2, g_c = _mobius_vjp(st["gq"], st["r2"], cv, st["mo2"], g_m2)
    g_l, g_rd = _givens_vjp(st["rd"], st["l"], st["gv"], g_gq)
    g_m1, g_rs = _project_vjp(st["m1"], st["pl"], g_l)
    g_hh, g_r1, g_c2 = _mobius_vjp(st["hh"], st["r1"], cv, st["mo1"], g_m1)
    g_c = g_c + g_c2
    g_s = torch.zeros_like(g_c)
    grads = {}
    for v, g_out in (("u", g_hh), ("ra", g_r1), ("rb", g_r2)):
        g_gam, g_rs_v = _project_vjp(st["g" + v], st["p" + v], g_out)
        g_rs = g_rs + g_rs_v
        grads[v], g_s_v = _exp0_vjp(st[v], st["g" + v], s, st["e" + v], g_gam)
        g_s = g_s + g_s_v
    g_s = g_s + -g_rs * (rs * rs)
    g_c = g_c + (g_s * 0.5) / s
    g_x0 = (grads["u"].double() @ mi_t).to(entity.dtype)
    return g_x0, torch.cat([grads["ra"], grads["rb"]], dim=1), g_rd, g_c


def fftroth_queries_backward_plain(g_res, g_bias, entity, rel, rel_diag, c, queries,
                                   multi_c: bool):
    """(d_entity, d_rel, d_rel_diag, d_c, d_bh), each the table's shape, for
    the cotangents g_res (B, D) and g_bias (B, 1) (None: zero) in plain
    PyTorch: each row's gradients (fftroth_queries_rows_plain) index_add_-ed
    in fp64 into zeros in ascending row order and rounded once; the softplus'
    gradient after the sum."""
    h, r = queries[:, 0], queries[:, 1]
    g_x0, g_rel, g_rd, g_c = fftroth_queries_rows_plain(g_res, entity, rel, rel_diag, c,
                                                        queries, multi_c)

    def table_sum(shape, idx, rows):
        out = torch.zeros(shape, dtype=torch.float64, device=rows.device)
        return out.index_add_(0, idx, rows.double()).to(rows.dtype)

    d_bh = torch.zeros((entity.shape[0], 1), dtype=entity.dtype, device=entity.device)
    if g_bias is not None:
        d_bh = table_sum(d_bh.shape, h, g_bias.reshape(-1, 1).to(entity.dtype))
    if multi_c:
        d_c = table_sum(c.shape, r, g_c)
        d_c = d_c / (1 + torch.exp(0 - c))  # logaddexp(c, 0)'s backward
    else:
        d_c = g_c.double().sum().to(c.dtype).reshape(c.shape)
    return (table_sum(entity.shape, h, g_x0), table_sum(rel.shape, r, g_rel),
            table_sum(rel_diag.shape, r, g_rd), d_c, d_bh)


# --------------------------------- wrappers -----------------------------------


def _ids(queries, cols: int = 2):
    """queries (B, >= cols) as the kernels read them: an int64 view whose
    last axis is contiguous (h, r, and for the ranker's query prep the gold,
    its first columns), and its row stride."""
    if queries.dtype != torch.int64 or queries.stride(1) != 1:
        queries = queries[:, :cols].to(torch.int64).contiguous()
    return queries, queries.stride(0)


def _check_tables(entity, rel, rel_diag, c, bh, multi_c: bool):
    """Validate the CUDA launch's tables (bh None: not read); returns N,
    nR, D."""
    dev = entity.device
    (n_rows, d), n_rel = entity.shape, rel.shape[0]
    if d % 2 or d < 4 or d > MAX_D:
        raise ValueError(f"the chain kernels take an even width 4 <= D <= {MAX_D}, got {d}")
    check_tensor("entity", entity, torch.float32, (n_rows, d), dev)
    check_tensor("rel", rel, torch.float32, (n_rel, 2 * (d - 2)), dev)
    check_tensor("rel_diag", rel_diag, torch.float32, (n_rel, d - 2), dev)
    check_tensor("c", c, torch.float32, (n_rel if multi_c else 1, 1), dev)
    if bh is not None:
        check_tensor("bh", bh, torch.float32, (n_rows, 1), dev)
    return n_rows, n_rel, d


def fftroth_queries_forward(entity, rel, rel_diag, c, bh, queries, multi_c: bool):
    """The forward kernel: (res (B, D), bias (B, 1)); the plain version for
    CPU tables."""
    if entity.device.type == "cpu":
        return fftroth_queries_forward_plain(entity, rel, rel_diag, c, bh, queries, multi_c)
    n_rows, n_rel, d = _check_tables(entity, rel, rel_diag, c, bh, multi_c)
    q, qs = _ids(queries)
    b, dev = q.shape[0], entity.device
    res = torch.empty((b, d), dtype=torch.float32, device=dev)
    bias = torch.empty((b, 1), dtype=torch.float32, device=dev)
    if b:
        launch("chyp_queries", "fftroth_queries_fwd", dev, entity, rel, rel_diag, c, bh, q, qs,
               dft_matrices(d, dev), res, bias, b, n_rows, n_rel, d, int(multi_c))
        launches["fftroth_queries_fwd"] += 1
    return res, bias


def fftroth_queries_backward(g_res, g_bias, entity, rel, rel_diag, c, queries, multi_c: bool):
    """The backward kernels: (d_entity, d_rel, d_rel_diag, d_c, d_bh) as the
    plain version; the plain version for CPU tables."""
    if entity.device.type == "cpu":
        return fftroth_queries_backward_plain(g_res, g_bias, entity, rel, rel_diag, c, queries,
                                              multi_c)
    n_rows, n_rel, d = _check_tables(entity, rel, rel_diag, c, None, multi_c)
    q, qs = _ids(queries)
    b, dev, n = q.shape[0], entity.device, d - 2
    check_tensor("g_res", g_res, torch.float32, (b, d), dev)
    if g_bias is not None:
        check_tensor("g_bias", g_bias, torch.float32, (b, 1), dev)
    if b == 0:
        return (*(torch.zeros_like(t) for t in (entity, rel, rel_diag, c)),
                torch.zeros((n_rows, 1), dtype=torch.float32, device=dev))
    f32 = dict(dtype=torch.float32, device=dev)
    d_entity, d_bh = torch.empty((n_rows, d), **f32), torch.empty((n_rows, 1), **f32)
    d_rel, d_rd = torch.empty((n_rel, 2 * n), **f32), torch.empty((n_rel, n), **f32)
    d_c = torch.empty(c.shape, **f32)
    rows = torch.empty(b * (d + 3 * n + 1), **f32)  # each row's gradients
    gx, grel, grd, gcv = rows.split([b * d, b * 2 * n, b * n, b])
    slot = torch.empty(n_rows, dtype=torch.int32, device=dev)  # needs no fill
    launch("chyp_queries", "fftroth_queries_bwd", dev, entity, rel, rel_diag, c, q, qs,
           dft_matrices(d, dev), g_res, g_bias, gx, grel, grd, gcv, slot, d_entity, d_bh,
           d_rel, d_rd, d_c, b, n_rows, n_rel, d, int(multi_c))
    launches["fftroth_queries_bwd"] += 1
    launches["fftroth_queries_sum"] += 1
    return d_entity, d_rel, d_rd, d_c, d_bh


class _FFTRotHQueries(torch.autograd.Function):
    @staticmethod
    def forward(ctx, entity, rel, rel_diag, c, bh, queries, multi_c: bool, use_kernel: bool):
        entity, rel, rel_diag, c, bh = (t.contiguous() for t in (entity, rel, rel_diag, c, bh))
        fwd = fftroth_queries_forward if use_kernel else fftroth_queries_forward_plain
        res, bias = fwd(entity, rel, rel_diag, c, bh, queries, multi_c)
        ctx.save_for_backward(entity, rel, rel_diag, c, queries)
        ctx.multi_c, ctx.use_kernel = multi_c, use_kernel
        ctx.set_materialize_grads(False)  # an unused bias needs no zeros
        return res, bias

    @staticmethod
    def backward(ctx, g_res, g_bias):
        entity, rel, rel_diag, c, queries = ctx.saved_tensors
        if g_res is None:
            g_res = torch.zeros((queries.shape[0], entity.shape[1]), dtype=entity.dtype,
                                device=entity.device)
        bwd = fftroth_queries_backward if ctx.use_kernel else fftroth_queries_backward_plain
        grads = bwd(g_res.contiguous(), None if g_bias is None else g_bias.contiguous(),
                    entity, rel, rel_diag, c, queries, ctx.multi_c)
        grads = [g if need else None for g, need in zip(grads, ctx.needs_input_grad)]
        return (*grads, None, None, None)


def fftroth_queries(entity, rel, rel_diag, c, bh, queries, multi_c: bool):
    """FFTRotH.get_queries on the tables: ((res (B, D),), bias (B, 1)) for
    the queries (B, 2) [h, r], differentiable in the five tables; the CUDA
    kernels (CPU tables: the plain versions)."""
    res, bias = _FFTRotHQueries.apply(entity, rel, rel_diag, c, bh, queries, multi_c, True)
    return (res,), bias


def fftroth_queries_plain(entity, rel, rel_diag, c, bh, queries, multi_c: bool):
    """The same function, forward and backward in plain PyTorch on any
    device and dtype: what the kernels are held against."""
    res, bias = _FFTRotHQueries.apply(entity, rel, rel_diag, c, bh, queries, multi_c, False)
    return (res,), bias
