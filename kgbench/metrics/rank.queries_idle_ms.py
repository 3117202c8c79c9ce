"""rank.queries_idle_ms: the card's idle milliseconds a ranker call charged
to the program's kge.rank.queries phase (the query embeddings, their norms
and the gold threshold): each gap before a device operation launched in
the phase, clipped at the start of its kge.rank.call range, over the
kge.rank.call ranges of the profiled sub-window (kgbench/phases.py).
Moves rank_queries_per_s."""

from kgbench import phases


def read(r):
    return phases.idle_ms(r, "rank.queries")
