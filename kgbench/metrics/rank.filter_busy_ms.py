"""rank.filter_busy_ms: the card's busy milliseconds a ranker call in the
program's kge.rank.filter phase (the filter ids' clamp and the int8 mask,
or the maskless form's int32 ids): the union of the device operations
launched inside the phase's ranges, over the kge.rank.call ranges of the
profiled sub-window (kgbench/phases.py).  Moves rank_queries_per_s."""

from kgbench import phases


def read(r):
    return phases.busy_ms(r, "rank.filter")
