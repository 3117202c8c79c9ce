"""Filter construction (the part of complexhyperbolickge_tpu/data/preprocess.py
that KGData needs; the raw-text preprocessing CLI is not ported yet)."""

from __future__ import annotations

import collections

import numpy as np


def build_filters(examples: np.ndarray, n_relations: int):
    """Filtered-setting skip lists over ALL splits' triples.

    rhs[(h, r)] = sorted true tails; lhs[(t, r + n_relations)] = sorted true
    heads (inverse-relation keying).
    """
    lhs = collections.defaultdict(set)
    rhs = collections.defaultdict(set)
    for h, r, t in examples:
        rhs[(int(h), int(r))].add(int(t))
        lhs[(int(t), int(r) + n_relations)].add(int(h))
    return (
        {k: sorted(v) for k, v in lhs.items()},
        {k: sorted(v) for k, v in rhs.items()},
    )
