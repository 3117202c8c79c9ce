"""Complex-hyperbolic unit-ball ops.

Port of complexhyperbolickge_tpu/ops/chyperbolic.py.  A complex vector z of
dimension R is stored as 2R reals [Re(z) | Im(z)], so the Hermitian form of
the implicit PU(n,1) lift is plain real arithmetic:

    <z, w>  = sum_j z_j conj(w_j) - 1
    x       = 2 |<z,w>|^2 / (<z,z> <w,w>) - 1
    dist    = acosh(x)

with <z,z>, <w,w> clamped into [-1, -eps] and x clamped to >= 1 + eps.

Gradients follow the reference's Distance.backward: the analytic unclamped
gradient at the clamped values, with each side's denominator clamped to at
most -eps.  `chyp_distance` dispatches on shape:
  * train shape (B, 1, D) x (B, K, D): a float32 CUDA pair
    (`use_train_kernel`) goes to the CUDA kernels K3/K4 in their identity
    form (kernels/chyp_train.py), any other pair to ChypDistanceCore; both
    carry the analytic backward.  The FFT models' training scores take the
    kernels' id form instead (models/chyperbolic.py, FFTUnitBall.score_ids),
    with no gathered block.
  * any other broadcast shape: autograd with straight-through clamps.
`chyp_distance_all` (B, D) x (N, D) carries the same backward in matmul form.
"""

from __future__ import annotations

import torch

from complexhyperbolickge_torch.ops.math import (
    MIN_NORM,
    artanh,
    ball_eps,
    mm_operands,
    safe_norm,
    st_clip,
    tanh,
)

# The reference's complex-hyperbolic `project` uses a fixed eps = 1e-5
# whatever the dtype (JAX ops/chyperbolic.py:42).
_PROJECT_EPS = 1e-5


def project(x, c):
    """Clip into the unit ball of curvature c."""
    norm = safe_norm(x)
    maxnorm = (1 - _PROJECT_EPS) / (c**0.5)
    projected = x / norm * maxnorm
    return torch.where(norm > maxnorm, projected, x)


def expmap0(u, c):
    """Exponential map at the origin."""
    sqrt_c = c**0.5
    u_norm = safe_norm(u)
    gamma_1 = tanh(sqrt_c * u_norm) * u / (sqrt_c * u_norm)
    return project(gamma_1, c)


def logmap0(y, c):
    """Logarithmic map at the origin."""
    sqrt_c = c**0.5
    y_norm = safe_norm(y)
    return y / y_norm / sqrt_c * artanh(sqrt_c * y_norm)


def real_mobius_add(x, y, c):
    """Mobius addition (Poincare formula) on real vectors."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    y2 = torch.sum(y * y, dim=-1, keepdim=True)
    xy = torch.sum(x * y, dim=-1, keepdim=True)
    num = (1 + 2 * c * xy + c * y2) * x + (1 - c * x2) * y
    denom = 1 + 2 * c * xy + c**2 * x2 * y2
    return num / denom.clamp_min(MIN_NORM)


def mobius_add_complex(x, y):
    """Complex Mobius addition on the unit disk: (x + y) / (1 + conj(x) y)."""
    return (x + y) / (1 + torch.conj(x) * y)


# ------------------------- packed-real complex helpers -----------------------


def split_re_im(v):
    """Split the packed [Re | Im] layout into (re, im), each (..., R)."""
    r = v.shape[-1] // 2
    return v[..., :r], v[..., r:]


def swap_neg(v):
    """[Re | Im] -> [Im | -Re]: Im(z conj w) as one contraction."""
    re, im = split_re_im(v)
    return torch.cat([im, -re], dim=-1)


def hermitian_sqnorm_lifted(v):
    """<z, z> - 1 = ||z||^2 - 1 for packed-real z (implicit lift)."""
    return torch.sum(v * v, dim=-1) - 1.0


def _chyp_x(sr, si, znorm, wnorm, eps: float):
    """Cross-ratio argument x from the Hermitian pieces, with
    straight-through clamps (see ops.math.st_clip)."""
    znorm = st_clip(znorm, -1.0, -eps)
    wnorm = st_clip(wnorm, -1.0, -eps)
    x = 2 * (sr * sr + si * si) / (znorm * wnorm) - 1.0
    return st_clip(x, 1 + eps, None)


def _chyp_distance_ad(lhs, rhs):
    """Autograd form of the broadcast distance (straight-through clamps),
    for the shapes that are neither the train shape nor all-pairs.  Its
    gradients match the reference only away from the unit-ball boundary:
    it lacks the denominator clamp of the analytic backward."""
    eps = ball_eps(lhs.dtype)
    zr, zi = split_re_im(lhs)
    wr, wi = split_re_im(rhs)
    sr = torch.sum(zr * wr + zi * wi, dim=-1) - 1.0
    si = torch.sum(zi * wr - zr * wi, dim=-1)
    x = _chyp_x(sr, si, hermitian_sqnorm_lifted(lhs),
                hermitian_sqnorm_lifted(rhs), eps)
    return torch.acosh(x)


def chyp_core_residuals(lhs, rhs):
    """Train-shape pieces, lhs (B, D) vs rhs (B, K, D): sr, si, wn, x (B, K)
    and zn (B, 1), clamps applied (JAX `_chyp_core_fwd`).  The dot products
    accumulate in float64 and round once to the input dtype, as the CUDA
    kernels do, so the two agree whatever their summation order."""
    dtype, eps = lhs.dtype, ball_eps(lhs.dtype)
    l64, r64 = lhs.to(torch.float64), rhs.to(torch.float64)
    sr = (torch.sum(l64[:, None, :] * r64, dim=-1) - 1.0).to(dtype)
    si = torch.sum(swap_neg(l64)[:, None, :] * r64, dim=-1).to(dtype)
    zn = (torch.sum(l64 * l64, dim=-1) - 1.0).to(dtype).clamp(-1.0, -eps)[:, None]
    wn = (torch.sum(r64 * r64, dim=-1) - 1.0).to(dtype).clamp(-1.0, -eps)
    x = (2 * (sr * sr + si * si) / (zn * wn) - 1.0).clamp_min(1 + eps)
    return sr, si, wn, x, zn


def clamped_coefficients(g, sr, si, zn, wn, x):
    """The six coefficients of the analytic backward (JAX `_chyp_core_bwd`):
    the reference divides each side's gradient by p = sqrt(x^2 - 1) *
    norm_self^2 * norm_other clamped to at most -eps, which bounds |1/p| by
    1/eps near the unit-ball boundary."""
    eps = ball_eps(sr.dtype)
    a2 = sr * sr + si * si
    sq = torch.sqrt(x * x - 1.0)
    p_z = (sq * zn * zn * wn).clamp_max(-eps)
    p_w = (sq * wn * wn * zn).clamp_max(-eps)
    return (g * 4.0 * sr * zn / p_z, g * 4.0 * si * zn / p_z,
            g * (-4.0) * a2 / p_z, g * 4.0 * sr * wn / p_w,
            g * 4.0 * si * wn / p_w, g * (-4.0) * a2 / p_w)


def chyp_core_grads(g, lhs, rhs, sr, si, wn, x, zn):
    """(d_lhs (B, D), d_rhs (B, K, D)) of the train-shape distance for the
    cotangent g (B, K), from the residuals of chyp_core_residuals."""
    ca_z, cb_z, cz, ca_w, cb_w, cw = clamped_coefficients(g, sr, si, zn, wn, x)
    d_rhs = (ca_w[..., None] * lhs[:, None, :]
             + cb_w[..., None] * swap_neg(lhs)[:, None, :]
             + cw[..., None] * rhs)
    # the sums over k accumulate in float64 and round once (see
    # chyp_core_residuals); d si / d lhs = -swap(rhs): swap is linear, so
    # sum first and swap once
    dtype, r64 = lhs.dtype, rhs.to(torch.float64)
    m_a = torch.einsum("bk,bkd->bd", ca_z.to(torch.float64), r64).to(dtype)
    m_b = torch.einsum("bk,bkd->bd", cb_z.to(torch.float64), r64).to(dtype)
    cz_sum = torch.sum(cz.to(torch.float64), dim=1, keepdim=True).to(dtype)
    d_lhs = m_a - swap_neg(m_b) + cz_sum * lhs
    return d_lhs, d_rhs


class ChypDistanceCore(torch.autograd.Function):
    """Train-mode distance lhs (B, D) vs rhs (B, K, D) -> (B, K) with the
    analytic backward.  Saves only (B, K) residuals besides its inputs."""

    @staticmethod
    def forward(ctx, lhs, rhs):
        sr, si, wn, x, zn = chyp_core_residuals(lhs, rhs)
        ctx.save_for_backward(lhs, rhs, sr, si, wn, x, zn)
        return torch.acosh(x)

    @staticmethod
    def backward(ctx, g):
        return chyp_core_grads(g, *ctx.saved_tensors)


def use_train_kernel(lhs, rhs) -> bool:
    """Whether a train-shape pair runs the CUDA kernels K3/K4: a float32
    pair on the card (JAX's `lhs.dtype == float32` test)."""
    return (lhs.device.type == "cuda" and lhs.dtype == torch.float32
            and rhs.dtype == torch.float32)


def chyp_distance(lhs, rhs):
    """Broadcast complex-hyperbolic distance on packed-real inputs.

    lhs, rhs: (..., 2R) with broadcasting across leading dims, e.g.
    (B, 1, 2R) vs (B, K, 2R) in training or (B, 2R) vs (B, 2R) for the
    gold-tail distance of the rankers.  See the module docstring for the
    dispatch.
    """
    if (lhs.dim() == 3 and rhs.dim() == 3 and lhs.shape[1] == 1
            and lhs.shape[0] == rhs.shape[0]):
        if use_train_kernel(lhs, rhs):
            from complexhyperbolickge_torch.kernels import chyp_train

            return chyp_train.chyp_train_distance(lhs[:, 0, :], rhs)
        return ChypDistanceCore.apply(lhs[:, 0, :], rhs)
    return _chyp_distance_ad(lhs, rhs)


class _ChypDistanceAll(torch.autograd.Function):
    """All-pairs distance with the analytic backward in matmul form (JAX
    `_chyp_all_fwd` / `_chyp_all_bwd`): rhs rows are shared across the
    queries, so their contributions sum over the batch in transposed
    matmuls."""

    @staticmethod
    def forward(ctx, lhs, rhs):
        eps = ball_eps(lhs.dtype)
        lhs_m, rhs_m = mm_operands(lhs, rhs)  # bf16-rounded under "default"
        sr = torch.matmul(lhs_m, rhs_m.T) - 1.0
        si = torch.matmul(swap_neg(lhs_m), rhs_m.T)
        zn = hermitian_sqnorm_lifted(lhs).clamp(-1.0, -eps)[:, None]
        wn = hermitian_sqnorm_lifted(rhs).clamp(-1.0, -eps)[None, :]
        x = (2 * (sr * sr + si * si) / (zn * wn) - 1.0).clamp_min(1 + eps)
        ctx.save_for_backward(lhs, rhs, sr, si, zn, wn, x)
        return torch.acosh(x)

    @staticmethod
    def backward(ctx, g):
        lhs, rhs, sr, si, zn, wn, x = ctx.saved_tensors
        ca_z, cb_z, cz, ca_w, cb_w, cw = clamped_coefficients(g, sr, si, zn, wn, x)
        d_lhs = (ca_z @ rhs - swap_neg(cb_z @ rhs)
                 + torch.sum(cz, dim=1, keepdim=True) * lhs)
        d_rhs = (ca_w.T @ lhs + cb_w.T @ swap_neg(lhs)
                 + torch.sum(cw, dim=0)[:, None] * rhs)
        return d_lhs, d_rhs


def chyp_distance_all(lhs, rhs):
    """All-pairs distance: lhs (B, 2R) vs rhs (N, 2R) -> (B, N).

    The Hermitian form over the packed layout is two matmuls:
        Re<z,w> + 1 = lhs @ rhs^T
        Im<z,w>     = swap_neg(lhs) @ rhs^T
    followed by the elementwise epilogue.
    """
    return _ChypDistanceAll.apply(lhs, rhs)


# ----------------------------- explicit lift ---------------------------------


def lift(v):
    """Explicit PU(n,1) lift of packed-real v: [re | im] -> [re, 1 | im, 0]."""
    re, im = split_re_im(v)
    ones = torch.ones((*v.shape[:-1], 1), dtype=v.dtype, device=v.device)
    zeros = torch.zeros_like(ones)
    return torch.cat([re, ones, im, zeros], dim=-1)


def chyp_distance_explicit(lhs_lifted, rhs_lifted):
    """Distance on explicitly lifted inputs with signature (+,...,+,-); equal
    to the implicit-lift form when the last coordinate is the lift's 1."""
    eps = ball_eps(lhs_lifted.dtype)
    zr, zi = split_re_im(lhs_lifted)
    wr, wi = split_re_im(rhs_lifted)
    sig = torch.ones(zr.shape[-1], dtype=lhs_lifted.dtype,
                     device=lhs_lifted.device)
    sig[-1] = -1.0
    sr = torch.sum(sig * (zr * wr + zi * wi), dim=-1)
    si = torch.sum(sig * (zi * wr - zr * wi), dim=-1)
    znorm = torch.sum(sig * (zr * zr + zi * zi), dim=-1)
    wnorm = torch.sum(sig * (wr * wr + wi * wi), dim=-1)
    return torch.acosh(_chyp_x(sr, si, znorm, wnorm, eps))
