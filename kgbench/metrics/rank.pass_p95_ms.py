"""rank.pass_p95_ms: the 95th percentile of the host clock's wall time of
each whole-split pass (a compute_metrics call: the wait of a kge-test or
model-selection user) in the traced run's window outside the profiled
sub-window; None under 20 passes.  Moves rank_queries_per_s."""

from kgbench.harness import p95


def read(r):
    passes = [s.seconds for s in r.window_spans("pass")]
    if len(passes) < 20 or not r.on_card:
        return None
    return 1e3 * p95(passes)
