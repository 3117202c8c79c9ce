"""Poincare-ball and Lorentz-hyperboloid ops.

Port of complexhyperbolickge_tpu/ops/hyperbolic.py (`hyp_distance`,
`hyp_plain_sim_expmap_all` and `explicit_lorentz` serve the GNN encoders and
decoders only).  Every distance comes in two forms:

  * broadcast form: x (..., d) vs v (..., d), the training shape
    (B, 1, d) vs (B, K, d) and the rankers' gold-tail scores;
  * `*_all` form: queries (B, d) against a whole candidate table (N, d),
    with the one cross term as a matmul, so no (B, N, d) tensor exists.

Gradients are plain autograd; the clamps are the reference's (`jnp.maximum`
and `torch.clamp_min` agree except on exact ties, where JAX splits the
gradient in half).
"""

from __future__ import annotations

import torch

from complexhyperbolickge_torch.ops.math import (
    MIN_NORM,
    arcosh,
    artanh,
    ball_eps,
    pinned_mm,
    safe_norm,
    tanh,
)

# ------------------------------- Poincare ball -------------------------------


def project(x, c):
    """Clip points into the ball of curvature c, with the per-dtype margin
    ball_eps (4e-3 in float32, 1e-5 in float64)."""
    norm = safe_norm(x)
    maxnorm = (1 - ball_eps(x.dtype)) / (c**0.5)
    return torch.where(norm > maxnorm, x / norm * maxnorm, x)


def expmap0(u, c):
    """Exponential map at the origin of the Poincare ball."""
    sqrt_c = c**0.5
    u_norm = safe_norm(u)
    gamma_1 = tanh(sqrt_c * u_norm) * u / (sqrt_c * u_norm)
    return project(gamma_1, c)


def logmap0(y, c):
    """Logarithmic map at the origin of the Poincare ball."""
    sqrt_c = c**0.5
    y_norm = safe_norm(y)
    return y / y_norm / sqrt_c * artanh(sqrt_c * y_norm)


def mobius_add(x, y, c):
    """Mobius addition on the Poincare ball."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    y2 = torch.sum(y * y, dim=-1, keepdim=True)
    xy = torch.sum(x * y, dim=-1, keepdim=True)
    num = (1 + 2 * c * xy + c * y2) * x + (1 - c * x2) * y
    denom = 1 + 2 * c * xy + c**2 * x2 * y2
    return num / denom.clamp_min(MIN_NORM)


def hyp_distance(x, y, c):
    """Poincare distance between ball points x and y, shared curvature,
    broadcast form (the single-c PoincareGCN decoder)."""
    sqrt_c = c**0.5
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    y2 = torch.sum(y * y, dim=-1, keepdim=True)
    xy = torch.sum(x * y, dim=-1, keepdim=True)
    c1 = 1 - 2 * c * xy + c * y2
    c2 = 1 - c * x2
    num = torch.sqrt(((c1**2) * x2 + (c2**2) * y2 - (2 * c1 * c2) * xy).clamp_min(MIN_NORM))
    denom = 1 - 2 * c * xy + c**2 * x2 * y2
    return 2 * artanh(sqrt_c * (num / denom.clamp_min(MIN_NORM))) / sqrt_c


def _hyp_dist_multi_c_from_parts(x2, xv, vnorm, c):
    """Distance from x to the ball point of direction v and radius
    tanh(sqrt_c vnorm) / sqrt_c, from the reductions x2 = |x|^2 and
    xv = <x, v/|v|>; every argument broadcasts to the output shape.  The
    expanded quadratic under the sqrt is >= 0 exactly but rounds negative at
    coincident points: the MIN_NORM floor goes under the sqrt (it also keeps
    the sqrt's gradient finite)."""
    sqrt_c = c**0.5
    gamma = tanh(sqrt_c * vnorm) / sqrt_c
    c1 = 1 - 2 * c * gamma * xv + c * gamma**2
    c2 = 1 - c * x2
    num = torch.sqrt(((c1**2) * x2 + (c2**2) * (gamma**2)
                      - (2 * c1 * c2) * gamma * xv).clamp_min(MIN_NORM))
    denom = 1 - 2 * c * gamma * xv + (c**2) * (gamma**2) * x2
    pairwise_norm = num / denom.clamp_min(MIN_NORM)
    return 2 * artanh(sqrt_c * pairwise_norm) / sqrt_c


def hyp_distance_multi_c(x, v, c):
    """Poincare distance with per-example curvature, broadcast form.  `v`
    enters through its norm and direction only: the distance to
    expmap0(v, c), evaluated analytically as the reference does."""
    vnorm = safe_norm(v)
    xv = torch.sum(x * v / vnorm, dim=-1, keepdim=True)
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    return _hyp_dist_multi_c_from_parts(x2, xv, vnorm, c)


def hyp_distance_multi_c_all(x, v, c):
    """All-pairs form: x (B, d) queries vs v (N, d) candidates, c (B, 1) or
    (1, 1) -> (B, N)."""
    vnorm = safe_norm(v)  # (N, 1)
    xv = pinned_mm(x, (v / vnorm).T)  # (B, N)
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    return _hyp_dist_multi_c_from_parts(x2, xv, vnorm[:, 0][None, :], c)


# ------------------------------ Lorentz model --------------------------------


def expmap0_lorentz(u, c):
    """Exponential map at the origin of the hyperboloid (space-like
    coordinates)."""
    alpha = c**0.5 * safe_norm(u)
    return (torch.sinh(alpha) / alpha) * u


def logmap0_lorentz(y, c):
    """Logarithmic map at the origin of the hyperboloid.  The arcosh's
    argument beta has beta^2 - 1 == c |y|^2 exactly; computing the
    denominator as sqrt(beta^2 - 1) cancels catastrophically in float32 (beta
    rounds to 1 for sqrt_c |y| < ~3e-4), so it is sqrt_c |y|."""
    sqrt_c = c**0.5
    y_norm = safe_norm(y)
    beta = sqrt_c * torch.sqrt(y_norm**2 + 1 / c)
    return (arcosh(beta) / (sqrt_c * y_norm)) * y


def lorentz_boost(y, v, c):
    """Lorentz boost of hyperboloid points by the velocity parameter v,
    tanh-normalized below the speed of light, with gamma clamped to <= 15.
    In float32 tanh saturates to 1 for |v| > ~10 and g = |v|^2 can round to
    >= 1, so g is clamped below 1 before the gamma clamp (which it cannot
    change: gamma = 15 at g ~ 0.9956)."""
    norm_v = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True).clamp_min(1e-24))
    v = tanh(norm_v) * v / norm_v
    y0 = torch.sqrt(torch.sum(y**2, dim=-1, keepdim=True) + 1 / c)
    g = torch.sum(v**2, dim=-1, keepdim=True).clamp_max(1.0 - 1e-7)
    gamma = (1 / torch.sqrt(1 - g)).clamp_max(15.0)
    factor = gamma**2 / (1 + gamma)
    vy = torch.sum(v * y, dim=-1, keepdim=True)
    return -gamma * y0 * v + y + factor * vy * v


def hyp_distance_multi_c_lorentz(x, v, c):
    """Hyperboloid distance with per-example curvature, broadcast form; the
    time coordinates follow from the hyperboloid constraint."""
    x0 = torch.sqrt(torch.sum(x**2, dim=-1, keepdim=True) + 1 / c)
    v0 = torch.sqrt(torch.sum(v**2, dim=-1, keepdim=True) + 1 / c)
    res = torch.sum(x * v, dim=-1, keepdim=True) - x0 * v0
    return arcosh(-c * res) / (c**0.5)


def hyp_distance_multi_c_lorentz_all(x, v, c):
    """All-pairs hyperboloid distance: x (B, d) vs v (N, d), c (B, 1) ->
    (B, N)."""
    x0 = torch.sqrt(torch.sum(x**2, dim=-1, keepdim=True) + 1 / c)  # (B, 1)
    v2 = torch.sum(v**2, dim=-1)[None, :]  # (1, N)
    v0 = torch.sqrt(v2 + 1 / c)  # (B, N)
    res = pinned_mm(x, v.T) - x0 * v0
    return arcosh(-c * res) / (c**0.5)


# --------------------- folded all-pairs model distances ----------------------
#
# The BaseH / BaseLorentz similarity expmaps every candidate with the query's
# curvature, then takes the distance.  expmap0 keeps the direction and only
# changes the radius, so in all-pairs form the table contributes one
# direction matmul plus per-(query, candidate) radius arithmetic.  These give
# dist(x, expmap0(v, c)) for x (B, d), v (N, d), c (B, 1) -> (B, N).


def hyp_sim_expmap_all(x, v, c):
    """hyp_distance_multi_c(x, expmap0(v, c), c) in folded all-pairs form."""
    un = safe_norm(v)  # (N, 1), clamped as expmap0's u_norm
    xv = pinned_mm(x, (v / un).T)  # (B, N)
    sqrt_c = c**0.5
    m = tanh(sqrt_c * un[:, 0][None, :]) / sqrt_c  # radius after expmap0
    m = torch.minimum(m, (1 - ball_eps(v.dtype)) / sqrt_c)  # project()'s clip
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    return _hyp_dist_multi_c_from_parts(x2, xv, m, c)


def hyp_plain_sim_expmap_all(x, v, c):
    """hyp_distance(x, expmap0(v, c), c) in folded all-pairs form, x (B, d),
    v (N, d), c (1, 1) -> (B, N): the plain distance takes its second
    argument as a ball point, so expmap0 is folded once."""
    sqrt_c = c**0.5
    un = safe_norm(v)  # (N, 1)
    xv_dir = pinned_mm(x, (v / un).T)  # (B, N)
    m = tanh(sqrt_c * un[:, 0][None, :]) / sqrt_c  # ball radius
    m = torch.minimum(m, (1 - ball_eps(v.dtype)) / sqrt_c)  # project()'s clip
    x2 = torch.sum(x * x, dim=-1, keepdim=True)  # (B, 1)
    y2 = m**2
    xy = m * xv_dir
    c1 = 1 - 2 * c * xy + c * y2
    c2 = 1 - c * x2
    num = torch.sqrt(((c1**2) * x2 + (c2**2) * y2 - (2 * c1 * c2) * xy).clamp_min(MIN_NORM))
    denom = 1 - 2 * c * xy + c**2 * x2 * y2
    return 2 * artanh(sqrt_c * (num / denom.clamp_min(MIN_NORM))) / sqrt_c


def lorentz_sim_expmap_all(x, v, c):
    """hyp_distance_multi_c_lorentz(x, expmap0_lorentz(v, c), c), folded."""
    un = safe_norm(v)  # (N, 1)
    xdir = pinned_mm(x, (v / un).T)  # (B, N)
    sqrt_c = c**0.5
    alpha = sqrt_c * un[:, 0][None, :]
    s = torch.sinh(alpha) / alpha * un[:, 0][None, :]  # radius after expmap0
    x0 = torch.sqrt(torch.sum(x**2, dim=-1, keepdim=True) + 1 / c)
    v0 = torch.sqrt(s**2 + 1 / c)
    return arcosh(-c * (xdir * s - x0 * v0)) / sqrt_c


def explicit_lorentz(x, c):
    """Prepend the time-like coordinate sqrt(|x|^2 + 1/c) (the Lorentz GNN's
    centroid mixing)."""
    x0 = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1 / c)
    return torch.cat([x0, x], dim=-1)
