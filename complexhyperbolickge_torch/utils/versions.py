"""The version of a parameter list, for caches that must never be served
stale: each parameter object with its `_version` counter, which every
in-place update (an optimizer step, load_state_dict, a write under
no_grad) bumps.  A cache keeps one slot, its key and its value written at
once, and rebuilds when `is_current` says the key is old."""

from __future__ import annotations


def params_key(params) -> list:
    """The version key of the parameters (any iterable of tensors)."""
    return [(p, p._version) for p in params]


def is_current(old, key) -> bool:
    """Whether a stored key `old` (None: nothing stored yet) is `key`: the
    same parameter objects at the same counters."""
    return (old is not None and len(old) == len(key)
            and all(a is c and v == w for (a, v), (c, w) in zip(old, key)))
