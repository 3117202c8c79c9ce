"""Plain reference of RotH (Chami et al., Low-Dimensional Hyperbolic
Knowledge Graph Embeddings, ACL 2020; KGEmb): the head is mapped into the
Poincare ball of the relation's curvature c, translated by the relation's
first vector (Mobius addition), projected, rotated by the relation's Givens
rotations and translated by its second vector; the score of a tail is minus
the squared distance from that point to the tail's own map into the ball,
taken through the distance's analytic form (which maps its second argument
once more: the double tanh of the KGEmb code), plus both biases.

Every contraction (matrix and dot products) goes through `ar`, so the
control (TF32) reaches them all.  The constants are those of the float32
model: the ball's margin 4e-3 in project, the distance's clamps MIN_NORM
and artanh's 1 - 1e-5.
"""

from __future__ import annotations

import torch

from kgbench.reference.protocol import (
    MIN_NORM,
    Artanh,
    givens_rotations,
    mobius_add,
    safe_norm,
    softplus,
    tanh,
)

BALL_EPS = 4e-3


def PARAMS(cfg) -> dict:
    n, nr, rank = cfg["n_entities"], cfg["n_relations"], cfg["rank"]
    return {"entity": (n, rank), "rel": (nr, 2 * rank), "rel_diag": (nr, rank),
            "c": (nr if cfg["multi_c"] else 1, 1), "bh": (n, 1), "bt": (n, 1)}


def INIT(cfg) -> dict:
    """The model's initial distributions."""
    s = cfg["init_size"]
    return {"entity": ["normal", 0.0, s], "rel": ["normal", 0.0, s],
            "rel_diag": ["uniform", -1.0, 1.0], "c": ["const", 1.0],
            "bh": ["const", 0.0], "bt": ["const", 0.0]}


def _project(x, c, ar):
    norm = safe_norm(x, ar)
    maxnorm = (1 - BALL_EPS) / c ** 0.5
    return torch.where(norm > maxnorm, x / norm * maxnorm, x)


def _expmap0(u, c, ar):
    sqrt_c = c ** 0.5
    u_norm = safe_norm(u, ar)
    return _project(tanh(sqrt_c * u_norm) * u / (sqrt_c * u_norm), c, ar)


def curvature(P, r, cfg):
    c = softplus(P["c"])
    return c[r] if cfg["multi_c"] else c[0][None, :]


def queries(P, h, r, cfg, ar):
    """((query points (B, d), curvatures (B, 1)), head biases (B, 1))."""
    c = curvature(P, r, cfg)
    head = _expmap0(P["entity"][h], c, ar)
    rel1, rel2 = torch.chunk(P["rel"][r], 2, dim=-1)
    lhs = _project(mobius_add(head, _expmap0(rel1, c, ar), c, ar), c, ar)
    res = mobius_add(givens_rotations(P["rel_diag"][r], lhs), _expmap0(rel2, c, ar), c, ar)
    return (res, c), P["bh"][h]


def _distance(x2, xv, vnorm, c):
    """Distance from points of squared norm x2 to the ball points of
    direction v / |v| (xv = <x, v / |v|>) and radius tanh(sqrt_c vnorm) /
    sqrt_c."""
    sqrt_c = c ** 0.5
    gamma = tanh(sqrt_c * vnorm) / sqrt_c
    c1 = 1 - 2 * c * gamma * xv + c * gamma ** 2
    c2 = 1 - c * x2
    num = torch.sqrt((c1 ** 2 * x2 + c2 ** 2 * gamma ** 2
                      - 2 * c1 * c2 * gamma * xv).clamp_min(MIN_NORM))
    denom = 1 - 2 * c * gamma * xv + c ** 2 * gamma ** 2 * x2
    return 2 * Artanh.apply(sqrt_c * (num / denom.clamp_min(MIN_NORM))) / sqrt_c


def score_ids(P, q, lb, ids, cfg, ar):
    """Scores (B, K) of the queries against the entities ids (B, K)."""
    x, c = q
    y = _expmap0(P["entity"][ids], c[:, :, None], ar)  # (B, K, d)
    vnorm = safe_norm(y, ar)[..., 0]
    xv = ar.mm(y / vnorm[..., None], x[:, :, None])[..., 0]
    d = _distance(ar.dot(x, x), xv, vnorm, c)
    return lb + P["bt"][ids][..., 0] - d * d


def score_all(P, q, cfg, ar):
    """Scores (B, N) of the queries against every entity, without the head
    bias: each entity's map into the ball of the query's curvature keeps
    its direction, so the distance takes its radius, clipped as project
    clips it, and one product with the unit directions."""
    x, c = q
    v = P["entity"]
    un = safe_norm(v, ar)  # (N, 1)
    xv = ar.mm(x, (v / un).T)  # (B, N)
    sqrt_c = c ** 0.5
    m = torch.minimum(tanh(sqrt_c * un[:, 0][None, :]) / sqrt_c, (1 - BALL_EPS) / sqrt_c)
    d = _distance(ar.dot(x, x), xv, m, c)
    return P["bt"][:, 0][None, :] - d * d
