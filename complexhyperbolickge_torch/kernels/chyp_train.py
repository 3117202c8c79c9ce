"""Train-mode complex-hyperbolic distance: CUDA kernels K3 and K4.

Port of complexhyperbolickge_tpu/kernels/chyp_train.py composed with the
candidate gather the JAX model does in XLA.  Per-query negative sampling
scores each query lhs (B, D) against its own candidates, the rows ids
(B, K) of the entity table (N, D), without gathering them: K3
(`chyp_train_fwd` in csrc/chyp_train.cu) reads the rows by id and keeps
only (B, K) residuals sr, si, wn, x and the (B,) clamped norm zn; K4
(`chyp_train_bwd`) evaluates the reference's analytic backward, with its
clamped denominator, and writes d_lhs and the dense (N, D) table gradient,
each row the fp64 sum of its pairs' terms in ascending pair order.  Its
index preparation `chyp_train_lists` (the launcher of the same name) lists
each table row's pairs in ascending order, a stable counting sort of the
ids into CSR offsets, with each pair's three table-side coefficients.  The
semantics are those of ops.chyperbolic.ChypDistanceCore on table[ids].

`chyp_train_distance_ids(lhs, table, ids)` is a torch.autograd.Function:
K3 in forward, K4 in backward, for CUDA float32 tensors; each launch is
counted in `launches`.  For CPU tensors both passes run the plain PyTorch
versions beside them (`chyp_train_ids_forward_plain`,
`chyp_train_ids_backward_plain`), which `chyp_train_distance_ids_plain`
also runs on any device.  Both accumulate the dot products and every sum
in float64 and round once, and take acosh as log(x + sqrt(x^2 - 1)), so
kernel and plain version agree to the ulp whatever their summation order.
`ids=None` is the identity form: the table is the gathered block rhs
(B, K, D) as (B K, D) and pair p reads row p (row p's only pair);
`chyp_train_distance(lhs, rhs)` and `chyp_train_distance_plain` take that
block.  models.chyperbolic.FFTUnitBall.score_ids routes the float32 CUDA
training pair to the id form, ops.chyperbolic.chyp_distance the gathered
train-shape pair to the identity form.
"""

from __future__ import annotations

import torch

from complexhyperbolickge_torch.kernels._build import check_tensor, kernel_info, launch
from complexhyperbolickge_torch.ops.chyperbolic import (
    clamped_coefficients,
    chyp_core_grads,
    chyp_core_residuals,
)
from complexhyperbolickge_torch.ops.math import ball_eps

# launches of each CUDA kernel since the last reset_launches()
launches = {"chyp_train_fwd": 0, "chyp_train_bwd": 0, "chyp_train_lists": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


_EPS = ball_eps(torch.float32)
# lower clamp of x, passed to the kernel as one f32 value so kernel and
# plain version round it identically
X_MIN = 1.0 + _EPS


def _rows(table, ids, b: int):
    """The candidate block (B, K, D): table[ids], or the table itself
    reshaped in the identity form (ids None)."""
    return table.reshape(b, -1, table.shape[1]) if ids is None else table[ids]


# ------------------------------ plain versions --------------------------------


def chyp_train_ids_forward_plain(lhs, table, ids):
    """(d (B, K), (sr, si, wn, x (B, K), zn (B, 1))) in plain PyTorch."""
    sr, si, wn, x, zn = chyp_core_residuals(lhs, _rows(table, ids, lhs.shape[0]))
    return torch.log(x + torch.sqrt(x * x - 1.0)), (sr, si, wn, x, zn)


def chyp_train_ids_backward_plain(g, lhs, table, ids, sr, si, wn, x, zn):
    """(d_lhs (B, D), d_table (N, D)) in plain PyTorch: the gathered form's
    d_rhs, in float64 and index_add_-ed into zeros in ascending pair order,
    rounded once (the identity form: d_rhs itself)."""
    d_lhs, d_rhs = chyp_core_grads(g, lhs, _rows(table, ids, lhs.shape[0]),
                                   sr, si, wn, x, zn)
    if ids is None:
        return d_lhs, d_rhs.reshape(table.shape)
    d_table = torch.zeros(table.shape, dtype=torch.float64, device=table.device)
    d_table.index_add_(0, ids.reshape(-1), d_rhs.reshape(-1, table.shape[1]).to(torch.float64))
    return d_lhs, d_table.to(table.dtype)


def chyp_train_lists_plain(g, ids, sr, si, wn, x, zn, n_rows: int):
    """K4's index preparation in plain PyTorch: (offsets (N + 1) int32,
    lists (P, 4) float32).  Row e's pairs, in ascending order, hold
    lists[offsets[e]:offsets[e + 1]], one record a pair: the pair index's
    int32 bits, then ca_w, cb_w, cw.  ids (P,) int64 outside [0, N) are
    left out (the last records are zeros); ids None: the identity form,
    pair p is row p's only pair."""
    coef = clamped_coefficients(g, sr, si, zn, wn, x)[3:]  # ca_w, cb_w, cw (B, K)
    if ids is None:
        order = torch.arange(g.numel(), device=g.device)
        offsets = torch.arange(n_rows + 1, device=g.device)
    else:
        valid = (ids >= 0) & (ids < n_rows)
        offsets = torch.zeros(n_rows + 1, dtype=torch.int64, device=g.device)
        offsets[1:] = torch.cumsum(torch.bincount(ids[valid], minlength=n_rows), 0)
        order = torch.sort(ids, stable=True).indices
        order = order[valid[order]]
    lists = torch.zeros((g.numel(), 4), dtype=torch.float32, device=g.device)
    lists[:order.numel()] = torch.stack(
        [order.to(torch.int32).view(torch.float32)] + [c.reshape(-1)[order] for c in coef], 1)
    return offsets.to(torch.int32), lists


# --------------------------------- wrappers -----------------------------------

_lists_blocks: dict = {}  # device index -> the lists launcher's largest grid


def chyp_train_lists(g, ids, sr, si, wn, x, zn, n_rows: int):
    """K4's index preparation on the card, as chyp_train_lists_plain (the
    records past offsets[N], for ids outside [0, N), unspecified); the
    caller has checked the residuals."""
    if g.device.type == "cpu":
        return chyp_train_lists_plain(g, ids, sr, si, wn, x, zn, n_rows)
    dev, p = g.device, g.numel()
    if ids is not None:
        check_tensor("ids", ids, torch.int64, (p,), dev)
    if max(p, n_rows) >= 2**31:
        raise ValueError(f"chyp_train_lists takes P, N < 2^31, got P = {p}, N = {n_rows}")
    if dev.index not in _lists_blocks:
        _lists_blocks[dev.index] = kernel_info("chyp_train", "chyp_train_lists_blocks", dev,
                                               n=1)[0]
    blocks = _lists_blocks[dev.index]
    offsets = torch.empty(n_rows + 1, dtype=torch.int32, device=dev)
    lists = torch.empty((p, 4), dtype=torch.float32, device=dev)
    scratch = torch.empty(n_rows + p + blocks, dtype=torch.int32, device=dev)
    cursor, unsorted, totals = scratch.split([n_rows, p, blocks])
    launch("chyp_train", "chyp_train_lists", dev, ids, g, sr, si, wn, x, zn, offsets, lists,
           cursor, unsorted, totals, p, n_rows, g.shape[-1], blocks, _EPS)
    launches["chyp_train_lists"] += 1
    return offsets, lists


def _check_launch(lhs, table, ids):
    """Validate a CUDA launch's lhs (B, D), table (N, D) and ids (B, K)
    int64 (None: N = B K); returns B, K, D, N."""
    dev = lhs.device
    if dev.type != "cuda":
        raise ValueError(f"chyp_train kernels take CPU or CUDA tensors, got {dev}")
    if lhs.dim() != 2 or table.dim() != 2 or lhs.shape[1] % 2:
        raise ValueError("lhs must be (B, D) with D even and table (N, D)")
    (b, d), n = lhs.shape, table.shape[0]
    check_tensor("lhs", lhs, torch.float32, (b, d), dev)
    check_tensor("table", table, torch.float32, (n, d), dev)
    if ids is None:
        if b == 0 or n % b:
            raise ValueError(f"the identity form needs a table of B K rows, got {n} for B = {b}")
        k = n // b
    else:
        k = ids.shape[-1] if ids.dim() == 2 else -1
        check_tensor("ids", ids, torch.int64, (b, k), dev)
    if b * k == 0 or n == 0:
        raise ValueError(f"no pairs to score: B = {b}, K = {k}, N = {n}")
    if lhs.data_ptr() % 8 or table.data_ptr() % 8:
        raise ValueError("lhs and table must start on an 8-byte boundary")
    return b, k, d, n


def chyp_train_ids_forward(lhs, table, ids):
    """K3: distances d (B, K) of lhs against table[ids] and the residuals
    (sr, si, wn, x, zn)."""
    if lhs.device.type == "cpu":
        return chyp_train_ids_forward_plain(lhs, table, ids)
    b, k, d, n = _check_launch(lhs, table, ids)
    outs = torch.empty((5, b, k), dtype=torch.float32, device=lhs.device)
    zn = torch.empty((b, 1), dtype=torch.float32, device=lhs.device)
    launch("chyp_train", "chyp_train_fwd", lhs.device, lhs, table, ids, *outs, zn,
           b, k, d, n, _EPS, X_MIN)
    launches["chyp_train_fwd"] += 1
    dist, sr, si, wn, x = outs.unbind(0)
    return dist, (sr, si, wn, x, zn)


def chyp_train_ids_backward(g, lhs, table, ids, sr, si, wn, x, zn):
    """K4: (d_lhs (B, D), d_table (N, D)) for the cotangent g (B, K); its
    index preparation chyp_train_lists runs first."""
    if lhs.device.type == "cpu":
        return chyp_train_ids_backward_plain(g, lhs, table, ids, sr, si, wn, x, zn)
    b, k, d, n = _check_launch(lhs, table, ids)
    for name, t in (("g", g), ("sr", sr), ("si", si), ("wn", wn), ("x", x)):
        check_tensor(name, t, torch.float32, (b, k), lhs.device)
    check_tensor("zn", zn, torch.float32, (b, 1), lhs.device)
    offsets, lists = chyp_train_lists(g, None if ids is None else ids.reshape(-1),
                                      sr, si, wn, x, zn, n)
    d_lhs = torch.empty_like(lhs)
    d_table = torch.empty_like(table)
    launch("chyp_train", "chyp_train_bwd", lhs.device, g, lhs, table, ids, offsets, lists,
           sr, si, wn, x, zn, d_lhs, d_table, b, k, d, n, _EPS)
    launches["chyp_train_bwd"] += 1
    return d_lhs, d_table


class _ChypTrainDistanceIds(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, table, ids, use_kernel: bool):
        lhs, table = lhs.contiguous(), table.contiguous()
        ids = None if ids is None else ids.contiguous()
        fwd = chyp_train_ids_forward if use_kernel else chyp_train_ids_forward_plain
        dist, res = fwd(lhs, table, ids)
        ctx.use_kernel = use_kernel
        ctx.save_for_backward(lhs, table, ids, *res)
        return dist

    @staticmethod
    def backward(ctx, g):
        # g can arrive expanded or strided (e.g. from (-d**2).sum())
        bwd = chyp_train_ids_backward if ctx.use_kernel else chyp_train_ids_backward_plain
        d_lhs, d_table = bwd(g.contiguous(), *ctx.saved_tensors)
        return d_lhs, d_table, None, None


def chyp_train_distance_ids(lhs, table, ids):
    """Train-mode distance of lhs (B, D) against the table (N, D) rows ids
    (B, K) int64 -> (B, K), differentiable in lhs and table: K3 forward
    and K4 backward for CUDA float32 tensors, the plain versions for CPU
    tensors.  ids None: the identity form (table (B K, D))."""
    return _ChypTrainDistanceIds.apply(lhs, table, ids, True)


def chyp_train_distance_ids_plain(lhs, table, ids):
    """The same function, forward and backward in plain PyTorch on any
    device: what the kernels are held against."""
    return _ChypTrainDistanceIds.apply(lhs, table, ids, False)


def chyp_train_distance(lhs, rhs):
    """The gathered form, lhs (B, D) vs rhs (B, K, D) -> (B, K): the
    identity form of chyp_train_distance_ids on rhs as a (B K, D) table."""
    return chyp_train_distance_ids(lhs, rhs.reshape(-1, rhs.shape[-1]), None)


def chyp_train_distance_plain(lhs, rhs):
    """The gathered form's plain version."""
    return chyp_train_distance_ids_plain(lhs, rhs.reshape(-1, rhs.shape[-1]), None)
