"""Scalar math primitives with the reference numerics, forward only.

Port of complexhyperbolickge_tpu/ops/math.py.  Constants are the same:
  * MIN_NORM = 1e-15
  * artanh input clamp ±(1 - 1e-5)
  * tanh input clamp ±15
  * arcosh input clamp_min 1 + 1e-6
  * per-dtype ball eps {bf16: 4e-2, f32: 4e-3, f64: 1e-5}

The straight-through clamp (st_clip) and the custom backward of artanh
belong to the training slice.  The JAX `mm_precision` / `pinned_mm` pair
has no counterpart: with TF32 off (package __init__) every fp32 matmul is
exact fp32.
"""

from __future__ import annotations

import torch

MIN_NORM = 1e-15

_BALL_EPS = {
    torch.bfloat16: 4e-2,
    torch.float32: 4e-3,
    torch.float64: 1e-5,
}


def round_up(x: int, m: int) -> int:
    """Smallest multiple of m >= x (kernel tile padding helper)."""
    return -(-x // m) * m


def ball_eps(dtype: torch.dtype) -> float:
    """Per-dtype boundary margin of the (complex-)hyperbolic unit ball."""
    return _BALL_EPS[dtype]


def artanh(x):
    x = x.clamp(-1 + 1e-5, 1 - 1e-5)
    return 0.5 * (torch.log1p(x) - torch.log1p(-x))


def tanh(x):
    """tanh with the reference's ±15 input clamp."""
    return torch.tanh(x.clamp(-15, 15))


def arcosh(x):
    """acosh with clamp_min 1 + 1e-6."""
    return torch.acosh(x.clamp_min(1 + 1e-6))


def clamp_min(x, lo):
    """max(x, lo) for a scalar or tensor `lo` (jnp.maximum semantics)."""
    if isinstance(lo, torch.Tensor):
        return torch.maximum(x, lo)
    return x.clamp_min(lo)


def safe_sqrt(sq):
    """sqrt of a nonnegative quantity that is exactly 0 at 0 (the JAX form's
    double where keeps a NaN cotangent out of the training slice's backward)."""
    nz = sq > 0
    return torch.where(nz, torch.sqrt(torch.where(nz, sq, torch.ones_like(sq))),
                       torch.zeros_like(sq))


def safe_norm(x, dim: int = -1, keepdim: bool = True):
    """L2 norm clamped below by MIN_NORM (clamp on the squared norm)."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    return torch.sqrt(sq.clamp_min(MIN_NORM * MIN_NORM))
