"""Train-mode complex-hyperbolic distance: CUDA kernels K3 and K4.

Port of complexhyperbolickge_tpu/kernels/chyp_train.py.  Per-query
negative sampling scores each query lhs (B, D) against its own gathered
candidates rhs (B, K, D).  K3 (`chyp_train_fwd` in csrc/chyp_train.cu)
computes the distances in one pass over rhs and keeps only (B, K)
residuals sr, si, wn, x and the (B,) clamped norm zn; K4
(`chyp_train_bwd`) evaluates the reference's analytic backward, with its
clamped denominator, in one more pass and writes d_rhs and the assembled
d_lhs.  The semantics are those of ops.chyperbolic.ChypDistanceCore.

`chyp_train_distance` is a torch.autograd.Function: K3 in forward, K4 in
backward, for CUDA float32 tensors; each launch is counted in `launches`.
For CPU tensors both passes run the plain PyTorch versions beside them
(`chyp_train_forward_plain`, `chyp_train_backward_plain`), which
`chyp_train_distance_plain` also runs on any device.  Both accumulate the
dot products and the sums over K in float64 and round once, and take acosh
as log(x + sqrt(x^2 - 1)), so kernel and plain version agree to the ulp
whatever their summation order.  ops.chyperbolic.chyp_distance routes the
train-shape float32 CUDA pair here.
"""

from __future__ import annotations

import torch

from complexhyperbolickge_torch.kernels._build import check_tensor, launch
from complexhyperbolickge_torch.ops.chyperbolic import (
    chyp_core_grads,
    chyp_core_residuals,
)
from complexhyperbolickge_torch.ops.math import ball_eps

# launches of each CUDA kernel since the last reset_launches()
launches = {"chyp_train_fwd": 0, "chyp_train_bwd": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


_EPS = ball_eps(torch.float32)
# lower clamp of x, passed to the kernel as one f32 value so kernel and
# plain version round it identically
X_MIN = 1.0 + _EPS


# ------------------------------ plain versions --------------------------------


def chyp_train_forward_plain(lhs, rhs):
    """(d (B, K), (sr, si, wn, x (B, K), zn (B, 1))) in plain PyTorch."""
    sr, si, wn, x, zn = chyp_core_residuals(lhs, rhs)
    return torch.log(x + torch.sqrt(x * x - 1.0)), (sr, si, wn, x, zn)


# (g, lhs, rhs, sr, si, wn, x, zn) -> (d_lhs (B, D), d_rhs (B, K, D))
chyp_train_backward_plain = chyp_core_grads


# --------------------------------- wrappers -----------------------------------


def _check_pair(lhs, rhs):
    """Validate a CUDA launch's lhs (B, D) and rhs (B, K, D); returns B, K, D."""
    dev = lhs.device
    if dev.type != "cuda":
        raise ValueError(f"chyp_train kernels take CPU or CUDA tensors, got {dev}")
    if lhs.dim() != 2 or rhs.dim() != 3 or lhs.shape[1] % 2:
        raise ValueError("lhs must be (B, D) with D even and rhs (B, K, D)")
    b, d = lhs.shape
    k = rhs.shape[1]
    check_tensor("lhs", lhs, torch.float32, (b, d), dev)
    check_tensor("rhs", rhs, torch.float32, (b, k, d), dev)
    return b, k, d


def chyp_train_forward(lhs, rhs):
    """K3: distances d (B, K) and the residuals (sr, si, wn, x, zn)."""
    if lhs.device.type == "cpu":
        return chyp_train_forward_plain(lhs, rhs)
    b, k, d = _check_pair(lhs, rhs)
    outs = torch.empty((5, b, k), dtype=torch.float32, device=lhs.device)
    zn = torch.empty((b, 1), dtype=torch.float32, device=lhs.device)
    launch("chyp_train", "chyp_train_fwd", lhs.device, lhs, rhs, *outs, zn,
           b, k, d, _EPS, X_MIN)
    launches["chyp_train_fwd"] += 1
    dist, sr, si, wn, x = outs.unbind(0)
    return dist, (sr, si, wn, x, zn)


def chyp_train_backward(g, lhs, rhs, sr, si, wn, x, zn):
    """K4: (d_lhs (B, D), d_rhs (B, K, D)) for the cotangent g (B, K)."""
    if lhs.device.type == "cpu":
        return chyp_train_backward_plain(g, lhs, rhs, sr, si, wn, x, zn)
    b, k, d = _check_pair(lhs, rhs)
    for name, t in (("g", g), ("sr", sr), ("si", si), ("wn", wn), ("x", x)):
        check_tensor(name, t, torch.float32, (b, k), lhs.device)
    check_tensor("zn", zn, torch.float32, (b, 1), lhs.device)
    d_lhs = torch.empty_like(lhs)
    d_rhs = torch.empty_like(rhs)
    launch("chyp_train", "chyp_train_bwd", lhs.device, g, lhs, rhs, sr, si, wn,
           x, zn, d_lhs, d_rhs, b, k, d, _EPS)
    launches["chyp_train_bwd"] += 1
    return d_lhs, d_rhs


class _ChypTrainDistance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lhs, rhs, use_kernel: bool):
        lhs, rhs = lhs.contiguous(), rhs.contiguous()
        fwd = chyp_train_forward if use_kernel else chyp_train_forward_plain
        dist, res = fwd(lhs, rhs)
        ctx.use_kernel = use_kernel
        ctx.save_for_backward(lhs, rhs, *res)
        return dist

    @staticmethod
    def backward(ctx, g):
        # g can arrive expanded or strided (e.g. from (-d**2).sum())
        bwd = chyp_train_backward if ctx.use_kernel else chyp_train_backward_plain
        d_lhs, d_rhs = bwd(g.contiguous(), *ctx.saved_tensors)
        return d_lhs, d_rhs, None


def chyp_train_distance(lhs, rhs):
    """Train-mode distance lhs (B, D) vs rhs (B, K, D) -> (B, K): K3
    forward and K4 backward for CUDA float32 tensors, the plain versions for
    CPU tensors."""
    return _ChypTrainDistance.apply(lhs, rhs, True)


def chyp_train_distance_plain(lhs, rhs):
    """The same function, forward and backward in plain PyTorch on any
    device: what the kernels are held against."""
    return _ChypTrainDistance.apply(lhs, rhs, False)
