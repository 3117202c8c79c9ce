"""Euclidean ops: Givens-block transforms and row gathers.

Port of complexhyperbolickge_tpu/ops/euclidean.py (the parts the FFT family
uses).  Shapes are polymorphic over leading batch dims; the trailing
feature axis holds d/2 consecutive pairs.
"""

from __future__ import annotations

import torch

from complexhyperbolickge_torch.ops.math import safe_norm


def _pairs(v):
    """View (..., d) as (..., d//2, 2)."""
    return v.reshape(*v.shape[:-1], -1, 2)


def _unit_pairs(g):
    """Normalize (cos, sin) pairs to unit 2-vectors, NaN-free at exact zero:
    the squared norm is clamped at the dtype's tiny, which equals the
    reference's unclamped division for every pair of norm >= sqrt(tiny)."""
    sq = torch.sum(g * g, dim=-1, keepdim=True)
    return g / torch.sqrt(sq.clamp_min(torch.finfo(g.dtype).tiny))


def givens_rotations(r, x, scale=None, inverse: bool = False):
    """Block-diagonal 2x2 rotations parameterized by unnormalized (cos, sin)
    pairs of `r`, applied to the pairs of `x`; `scale` adds a per-block
    scaling (IsoH / RotLH form)."""
    g = _unit_pairs(_pairs(r))
    xp = _pairs(x)
    cos, sin = g[..., 0], g[..., 1]
    x0, x1 = xp[..., 0], xp[..., 1]
    if scale is not None:
        scaler = scale.reshape(*r.shape[:-1], -1)
        scaler = scaler / (torch.abs(scaler) + 1e-3)
        abs_scaler = torch.abs(scaler)
        if inverse:
            y0 = (1 / abs_scaler) * (cos * x0 + sin * x1)
            y1 = (1 / scaler) * (cos * x1 - sin * x0)
        else:
            y0 = abs_scaler * cos * x0 - scaler * sin * x1
            y1 = abs_scaler * sin * x0 + scaler * cos * x1
    else:
        if inverse:
            sin = -sin
        y0 = cos * x0 - sin * x1
        y1 = sin * x0 + cos * x1
    return torch.stack([y0, y1], dim=-1).reshape(x.shape)


def givens_reflection(r, x):
    """Block-diagonal 2x2 reflections [[cos, sin], [sin, -cos]] per pair (the
    true involution, as in the JAX package and upstream KGEmb)."""
    g = _unit_pairs(_pairs(r))
    xp = _pairs(x)
    cos, sin = g[..., 0], g[..., 1]
    x0, x1 = xp[..., 0], xp[..., 1]
    y0 = cos * x0 + sin * x1
    y1 = sin * x0 - cos * x1
    return torch.stack([y0, y1], dim=-1).reshape(x.shape)


def givens_unitary(a, b, angle, z, lift: bool = False):
    """Block-diagonal 2x2 complex unitary transforms.

    Per complex pair (z0, z1) the matrix is
        [ a                b          ]
        [ -e^{i\\theta} b*   e^{i\\theta} a* ]
    with (a, b) normalized so |a|^2 + |b|^2 = 1 and e^{i\\theta} of unit
    modulus.  a, b, angle: (..., d) reals whose halves are Re/Im; z: (..., d)
    complex.  lift=True also returns conj(prod e^{i\\theta}) normalized.
    """
    d2 = a.shape[-1] // 2
    a_ = torch.complex(a[..., :d2], a[..., d2:])
    b_ = torch.complex(b[..., :d2], b[..., d2:])
    norm = torch.sqrt(torch.abs(a_) ** 2 + torch.abs(b_) ** 2)
    a_ = a_ / norm
    b_ = b_ / norm
    if angle is not None:
        eit = torch.complex(angle[..., :d2], angle[..., d2:])
        eit = eit / torch.abs(eit)
    else:
        eit = torch.ones_like(a_)
    zp = z.reshape(*a_.shape, 2)
    z0, z1 = zp[..., 0], zp[..., 1]
    o0 = a_ * z0 + b_ * z1
    o1 = -eit * torch.conj(b_) * z0 + eit * torch.conj(a_) * z1
    out = torch.stack([o0, o1], dim=-1).reshape(z.shape)
    if not lift:
        return out
    det = torch.conj(torch.prod(eit, dim=-1, keepdim=True))
    det = det / torch.abs(det)
    return out, det


def multi_index_select(source, indices):
    """Rows of `source` gathered by an arbitrarily shaped index tensor."""
    return source[indices]


def safe_normalize(x, dim: int = -1):
    """x / max(||x||, MIN_NORM)."""
    return x / safe_norm(x, dim=dim, keepdim=True)
