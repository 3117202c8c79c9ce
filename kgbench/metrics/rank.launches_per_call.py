"""rank.launches_per_call: kernels the card ran a ranker call in the
profiled passes.  Moves rank_queries_per_s."""


def read(r):
    calls = r.profiled("ranker")
    kernels = sum(len(found) for _, found in calls)
    if not calls or not kernels:
        return None
    return kernels / len(calls)
