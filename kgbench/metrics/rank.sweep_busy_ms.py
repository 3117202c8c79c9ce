"""rank.sweep_busy_ms: the card's busy milliseconds a ranker call in the
program's kge.rank.sweep phase (the sweep kernel (K1, K5, ...) and,
maskless, the filtered subtraction): the union of the device operations
launched inside the phase's ranges, over the kge.rank.call ranges of the
profiled sub-window (kgbench/phases.py).  Moves rank_queries_per_s."""

from kgbench import phases


def read(r):
    return phases.busy_ms(r, "rank.sweep")
