"""Plain reference of FFTRotH (Complex Hyperbolic Knowledge Graph
Embeddings with Fast Fourier Transform, EMNLP 2022, arXiv 2211.03635):
entities are complex frequency vectors of R bins stored [Re | Im]; a query
maps its head to real coordinates with the orthonormal inverse real DFT
(n = 2 (R - 1)), applies the relation's Mobius translation, Givens rotation
and second translation in the Poincare ball of its curvature, and maps back
with the real DFT; the score is minus the squared complex-hyperbolic
distance to the tail under the implicit PU(n, 1) lift, plus both biases.

The transforms are products with the DFT matrices, and every contraction
(matrix and dot products) goes through `ar`, so the control (TF32) reaches
them all.  The
constants are those of the float32 model: the distance's ball margin 4e-3
(its norms clamped to [-1, -4e-3], its argument to >= 1 + 4e-3) and the
projection's fixed 1e-5.  The distance's gradient is the paper code's
analytic one (its Distance.backward): the unclamped formula at the clamped
values, each side's denominator clamped to at most -4e-3.
"""

from __future__ import annotations

import numpy as np
import torch

from kgbench.reference.protocol import givens_rotations, mobius_add, safe_norm, softplus, tanh

BALL_EPS = 4e-3
PROJECT_EPS = 1e-5


def PARAMS(cfg) -> dict:
    n, nr, rank = cfg["n_entities"], cfg["n_relations"], cfg["rank"]
    dim = 2 * (rank - 1)
    return {"entity": (n, 2 * rank), "rel": (nr, 2 * dim), "rel_diag": (nr, dim),
            "c": (nr if cfg["multi_c"] else 1, 1), "bh": (n, 1), "bt": (n, 1)}


def INIT(cfg) -> dict:
    """The model's initial distributions."""
    s = cfg["init_size"]
    return {"entity": ["normal", 0.0, s], "rel": ["normal", 0.0, s],
            "rel_diag": ["uniform", -1.0, 1.0], "c": ["const", 1.0],
            "bh": ["const", 0.0], "bt": ["const", 0.0]}


def _dft(rank: int, dtype, device):
    """(2R, n) inverse and (n, 2R) forward real DFT matrices (orthonormal)
    over the packed [Re | Im] layout."""
    n = 2 * (rank - 1)
    eye_r, eye_n = np.eye(rank), np.eye(n)
    inv = np.zeros((2 * rank, n))
    for j in range(rank):
        inv[j] = np.fft.irfft(eye_r[j], n=n, norm="ortho")
        inv[rank + j] = np.fft.irfft(1j * eye_r[j], n=n, norm="ortho")
    fwd = np.zeros((n, 2 * rank))
    for j in range(n):
        z = np.fft.rfft(eye_n[j], n=n, norm="ortho")
        fwd[j, :rank], fwd[j, rank:] = z.real, z.imag
    return (torch.as_tensor(inv, dtype=dtype, device=device),
            torch.as_tensor(fwd, dtype=dtype, device=device))


def _project(x, c, ar):
    norm = safe_norm(x, ar)
    maxnorm = (1 - PROJECT_EPS) / c ** 0.5
    return torch.where(norm > maxnorm, x / norm * maxnorm, x)


def _expmap0(u, c, ar):
    sqrt_c = c ** 0.5
    u_norm = safe_norm(u, ar)
    return _project(tanh(sqrt_c * u_norm) * u / (sqrt_c * u_norm), c, ar)


def curvature(P, r, cfg):
    return softplus(P["c"])[r] if cfg["multi_c"] else P["c"][0][None, :]


def queries(P, h, r, cfg, ar):
    """(query rows (B, 2R), head biases (B, 1))."""
    inv, fwd = _dft(cfg["rank"], ar.dtype, P["entity"].device)
    c = curvature(P, r, cfg)
    head = _expmap0(ar.mm(P["entity"][h], inv), c, ar)
    rel1, rel2 = torch.chunk(P["rel"][r], 2, dim=-1)
    lhs = _project(mobius_add(head, _expmap0(rel1, c, ar), c, ar), c, ar)
    res = mobius_add(givens_rotations(P["rel_diag"][r], lhs), _expmap0(rel2, c, ar), c, ar)
    return ar.mm(res, fwd), P["bh"][h]


def _swap(v):
    """[Re | Im] -> [Im | -Re]: Im(z conj w) as one contraction."""
    re, im = torch.chunk(v, 2, dim=-1)
    return torch.cat([im, -re], dim=-1)


def _coefficients(g, sr, si, zn, wn, x):
    a2 = sr * sr + si * si
    sq = torch.sqrt(x * x - 1.0)
    p_z = (sq * zn * zn * wn).clamp_max(-BALL_EPS)
    p_w = (sq * wn * wn * zn).clamp_max(-BALL_EPS)
    return (g * 4.0 * sr * zn / p_z, g * 4.0 * si * zn / p_z, g * -4.0 * a2 / p_z,
            g * 4.0 * sr * wn / p_w, g * 4.0 * si * wn / p_w, g * -4.0 * a2 / p_w)


class _Distance(torch.autograd.Function):
    """lhs (B, D) against rows (B, K, D) -> (B, K) distances, with the
    analytic backward; contractions through ar.mm."""

    @staticmethod
    def forward(ctx, lhs, rows, ar):
        sr = ar.mm(rows, lhs[:, :, None])[..., 0] - 1.0
        si = ar.mm(rows, _swap(lhs)[:, :, None])[..., 0]
        zn = (ar.dot(lhs, lhs) - 1.0).clamp(-1.0, -BALL_EPS)
        wn = (ar.dot(rows, rows)[..., 0] - 1.0).clamp(-1.0, -BALL_EPS)
        x = (2 * (sr * sr + si * si) / (zn * wn) - 1.0).clamp_min(1 + BALL_EPS)
        ctx.save_for_backward(lhs, rows, sr, si, zn, wn, x)
        ctx.ar = ar
        return torch.acosh(x)

    @staticmethod
    def backward(ctx, g):
        lhs, rows, sr, si, zn, wn, x = ctx.saved_tensors
        ar = ctx.ar
        ca_z, cb_z, cz, ca_w, cb_w, cw = _coefficients(g, sr, si, zn, wn, x)
        d_rows = (ca_w[..., None] * lhs[:, None, :] + cb_w[..., None] * _swap(lhs)[:, None, :]
                  + cw[..., None] * rows)
        m_a = ar.mm(ca_z[:, None, :], rows)[:, 0]
        m_b = ar.mm(cb_z[:, None, :], rows)[:, 0]
        d_lhs = m_a - _swap(m_b) + torch.sum(cz, dim=1, keepdim=True) * lhs
        return d_lhs, d_rows, None


def score_ids(P, lhs, lb, ids, cfg, ar):
    """Scores (B, K) of the query rows against the entities ids (B, K)."""
    d = _Distance.apply(lhs, P["entity"][ids], ar)
    return lb + P["bt"][ids][..., 0] - d * d


def score_all(P, lhs, cfg, ar):
    """Scores (B, N) of the query rows against every entity, without the
    head bias (the same for a query's every candidate)."""
    w = P["entity"]
    sr = ar.mm(lhs, w.T) - 1.0
    si = ar.mm(_swap(lhs), w.T)
    zn = (ar.dot(lhs, lhs) - 1.0).clamp(-1.0, -BALL_EPS)
    wn = (ar.dot(w, w)[:, 0] - 1.0).clamp(-1.0, -BALL_EPS)[None, :]
    x = (2 * (sr * sr + si * si) / (zn * wn) - 1.0).clamp_min(1 + BALL_EPS)
    d = torch.acosh(x)
    return P["bt"][:, 0][None, :] - d * d

