"""rank.ranker_busy_ms: the card's busy milliseconds a ranker call (the
fused ranker's table check, query prep, sweep and count: the union of the
device operations each profiled call launched).  Moves
rank_queries_per_s."""

from kgbench.trace import busy_us


def read(r):
    calls = r.profiled("ranker", kernels_only=False)
    busy = [busy_us(found) for _, found in calls if found]
    if not busy or len(busy) != len(calls):
        return None
    return sum(busy) / 1e3 / len(calls)
