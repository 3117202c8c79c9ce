"""rank.queries_busy_ms: the card's busy milliseconds a ranker call in the
program's kge.rank.queries phase (the query embeddings, their norms and
the gold threshold): the union of the device operations launched inside
the phase's ranges, over the kge.rank.call ranges of the profiled
sub-window (kgbench/phases.py).  Moves rank_queries_per_s."""

from kgbench import phases


def read(r):
    return phases.busy_ms(r, "rank.queries")
