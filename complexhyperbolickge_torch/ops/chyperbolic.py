"""Complex-hyperbolic unit-ball ops, forward only.

Port of complexhyperbolickge_tpu/ops/chyperbolic.py.  A complex vector z of
dimension R is stored as 2R reals [Re(z) | Im(z)], so the Hermitian form of
the implicit PU(n,1) lift is plain real arithmetic:

    <z, w>  = sum_j z_j conj(w_j) - 1
    x       = 2 |<z,w>|^2 / (<z,z> <w,w>) - 1
    dist    = acosh(x)

with <z,z>, <w,w> clamped into [-1, -eps] and x clamped to >= 1 + eps.
The clamps here are plain clamps: their straight-through gradients and the
analytic distance backward come with the training slice.
"""

from __future__ import annotations

import torch

from complexhyperbolickge_torch.ops.math import (
    MIN_NORM,
    artanh,
    ball_eps,
    safe_norm,
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
    """Cross-ratio argument x from the Hermitian pieces, clamped."""
    znorm = znorm.clamp(-1.0, -eps)
    wnorm = wnorm.clamp(-1.0, -eps)
    x = 2 * (sr * sr + si * si) / (znorm * wnorm) - 1.0
    return x.clamp_min(1 + eps)


def chyp_distance(lhs, rhs):
    """Broadcast complex-hyperbolic distance on packed-real inputs.

    lhs, rhs: (..., 2R) with broadcasting across leading dims, e.g.
    (B, 1, 2R) vs (B, K, 2R) in training or (B, 2R) vs (B, 2R) for the
    gold-tail distance of the rankers.
    """
    eps = ball_eps(lhs.dtype)
    zr, zi = split_re_im(lhs)
    wr, wi = split_re_im(rhs)
    sr = torch.sum(zr * wr + zi * wi, dim=-1) - 1.0
    si = torch.sum(zi * wr - zr * wi, dim=-1)
    x = _chyp_x(sr, si, hermitian_sqnorm_lifted(lhs),
                hermitian_sqnorm_lifted(rhs), eps)
    return torch.acosh(x)


def chyp_distance_all(lhs, rhs):
    """All-pairs distance: lhs (B, 2R) vs rhs (N, 2R) -> (B, N).

    The Hermitian form over the packed layout is two matmuls:
        Re<z,w> + 1 = lhs @ rhs^T
        Im<z,w>     = swap_neg(lhs) @ rhs^T
    followed by the elementwise epilogue.
    """
    eps = ball_eps(lhs.dtype)
    sr = torch.matmul(lhs, rhs.T) - 1.0
    si = torch.matmul(swap_neg(lhs), rhs.T)
    znorm = hermitian_sqnorm_lifted(lhs)[:, None]
    wnorm = hermitian_sqnorm_lifted(rhs)[None, :]
    return torch.acosh(_chyp_x(sr, si, znorm, wnorm, eps))


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
