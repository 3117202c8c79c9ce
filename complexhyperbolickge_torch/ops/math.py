"""Scalar math primitives with the reference numerics.

Port of complexhyperbolickge_tpu/ops/math.py.  Constants are the same:
  * MIN_NORM = 1e-15
  * artanh input clamp ±(1 - 1e-5)
  * tanh input clamp ±15
  * arcosh input clamp_min 1 + 1e-6
  * per-dtype ball eps {bf16: 4e-2, f32: 4e-3, f64: 1e-5}

The reference's Artanh is a custom autograd Function whose backward is
g / (1 - x_clamped^2): gradient still flows where the input was clamped.
`artanh` reproduces it; `st_clip` is a clamp with an identity gradient.  With TF32 off (package
__init__) every fp32 matmul is exact fp32.

`eval_matmul_precision` / `mm_precision` / `mm_operands` are the
counterpart of the JAX pair `eval_matmul_precision` / `mm_precision`: the
dense rankers score under `eval_matmul_precision("default")` for
--eval_precision default, and each all-pairs score contraction of the
models (the sites where JAX reads mm_precision() inside score_all) takes its
operands through `mm_operands`, which then rounds both to bfloat16
(round-to-nearest-even); the contraction itself stays in the operands'
float type, so the products of the rounded operands (exact in float32) are
summed in float32 (float64 for a float64 model).  That is the definition
of JAX's single-pass bf16 contraction with f32 accumulation, on every
device; norms and epilogues keep the unrounded values.
"""

from __future__ import annotations

import threading

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


class _Artanh(torch.autograd.Function):
    """artanh with the input clamp ±(1 - 1e-5); backward g / (1 - xc^2) at
    the clamped input xc (JAX ops/math.py `_artanh_fwd` / `_artanh_bwd`)."""

    @staticmethod
    def forward(ctx, x):
        xc = x.clamp(-1 + 1e-5, 1 - 1e-5)
        ctx.save_for_backward(xc)
        return 0.5 * (torch.log1p(xc) - torch.log1p(-xc))

    @staticmethod
    def backward(ctx, g):
        (xc,) = ctx.saved_tensors
        return g / (1 - xc**2)


def artanh(x):
    return _Artanh.apply(x)


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


def st_clip(x, lo=None, hi=None):
    """Clamp with a straight-through (identity) gradient.

    The reference's Distance.backward evaluates the analytic unclamped
    gradient at the clamped values, so its clamps are straight-through.  At
    the init scale (1e-3), or in f32 where the ball eps is 4e-3, the
    distance clamps saturate for every pair and autograd through a plain
    clamp returns exactly zero: training would freeze."""
    return x + (x.clamp(lo, hi) - x).detach()


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


# ----------------------- eval matmul precision override ----------------------

# The precision of the all-pairs eval contractions: "highest" (exact) unless
# inside eval_matmul_precision("default").  Per thread: a serving thread's
# scope never leaks into a training thread's contractions.
_EVAL_MM = threading.local()
PRECISIONS = ("highest", "default")


def check_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown eval precision {precision!r}; expected one of {PRECISIONS}")
    return precision


class eval_matmul_precision:
    """Context manager: inside `with eval_matmul_precision("default"):`
    mm_precision() is "default" and mm_operands rounds to bfloat16.
    "highest" (or None) is a no-op; the previous value is restored on exit,
    exceptions included."""

    def __init__(self, precision: str | None):
        self._p = None if precision is None else check_precision(precision)

    def __enter__(self):
        self._old = getattr(_EVAL_MM, "precision", None)
        if self._p == "default":
            _EVAL_MM.precision = self._p
        return self

    def __exit__(self, *exc):
        _EVAL_MM.precision = self._old
        return False


def mm_precision() -> str:
    """"default" inside eval_matmul_precision("default"), else "highest"."""
    return getattr(_EVAL_MM, "precision", None) or "highest"


def round_bf16(x):
    """x rounded to bfloat16 (round-to-nearest-even) and back to its dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def mm_operands(*xs):
    """The operands of an all-pairs score contraction as mm_precision()
    asks: unchanged under "highest", rounded to bfloat16 under "default"."""
    if mm_precision() == "highest":
        return xs
    return tuple(round_bf16(x) for x in xs)


def pinned_mm(a, b):
    """a @ b at mm_precision(): the all-pairs contraction of the dense
    score sites."""
    return torch.matmul(*mm_operands(a, b))
