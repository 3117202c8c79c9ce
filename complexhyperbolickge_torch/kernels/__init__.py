"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

chyp_rank.py ports complexhyperbolickge_tpu/kernels/chyp_rank.py (K1, K2);
chyp_train.py ports complexhyperbolickge_tpu/kernels/chyp_train.py (K3,
K4); hyp_rank.py ports complexhyperbolickge_tpu/kernels/hyp_rank.py (K5-K8);
segsum.py and gather.py port the GNN's kernels/segsum.py (K9) and
kernels/gather.py (K10); chyp_queries.py fuses FFTRotH's query chain and
hyp_queries.py RotH's ranker query prep, which the JAX package runs
eagerly; relgrad.py sums the GNN relation
tables' gradient, which JAX leaves to XLA's scatter.  Sources live in csrc/ and are compiled at first
use (_build.py); importing this package builds nothing.
"""

from complexhyperbolickge_torch.kernels import (
    chyp_queries,
    chyp_rank,
    chyp_train,
    gather,
    hyp_queries,
    hyp_rank,
    relgrad,
    segsum,
)

_MODULES = (chyp_rank, chyp_train, chyp_queries, hyp_rank, hyp_queries, segsum, gather,
            relgrad)


def reset_launches():
    """Set every kernel's launch count to 0."""
    for m in _MODULES:
        m.reset_launches()


def launches() -> dict:
    """kernel name -> launches since the last reset_launches()."""
    return {k: v for m in _MODULES for k, v in m.launches.items()}
