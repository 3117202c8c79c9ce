"""Embedding regularizers.

Port of complexhyperbolickge_tpu/train/regularizers.py: F2, L2 and N3 (the
nuclear 3-norm of Lacroix et al.) over the model's factor tuple.  `weights`
masks padded batch rows; a factor wrapped in models.base.NoMask (the whole
entity table) is always summed unmasked, since shape alone cannot tell it
from a batch when n_entities == batch size.
"""

from __future__ import annotations

import torch

from complexhyperbolickge_torch.models.base import NoMask


def _masked_sum(v, weights):
    """Sum v over all axes, zeroing padded batch rows when shapes allow."""
    if weights is not None and v.dim() >= 1 and v.shape[0] == weights.shape[0]:
        v = v * weights.reshape(weights.shape[0], *([1] * (v.dim() - 1)))
    return torch.sum(v)


def _terms(factors, weights):
    """(tensor, weights-or-None) per factor; NoMask factors are never masked."""
    return [(f.value, None) if isinstance(f, NoMask) else (f, weights)
            for f in factors]


def f2(factors, weight, batch_count, weights=None):
    total = 0.0
    for f, w in _terms(factors, weights):
        total += weight * _masked_sum(f**2, w)
    return total / batch_count


def l2(factors, weight, batch_count, weights=None):
    if weight <= 0:
        return torch.tensor(0.0)
    total = 0.0
    for f, w in _terms(factors, weights):
        total += weight * _masked_sum(f**2, w)
    return total


def n3(factors, weight, batch_count, weights=None):
    total = 0.0
    for f, w in _terms(factors, weights):
        total += weight * _masked_sum(torch.abs(f) ** 3, w)
    return total / batch_count


_REGISTRY = {"F2": f2, "L2": l2, "N3": n3}


def get_regularizer(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown regularizer {name!r}; available: "
                         f"{sorted(_REGISTRY)}") from None
