"""rank.filter_idle_ms: the card's idle milliseconds a ranker call charged to
the program's kge.rank.filter phase (the filter ids' clamp and the int8
mask, or the maskless form's int32 ids): each gap before a device
operation launched in the phase, clipped at the start of its kge.rank.call
range, over the kge.rank.call ranges of the profiled sub-window
(kgbench/phases.py).  Moves rank_queries_per_s."""

from kgbench import phases


def read(r):
    return phases.idle_ms(r, "rank.filter")
