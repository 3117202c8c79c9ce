"""The end-to-end arithmetic on the CPU at the tiny size: a rate is every
unit of work of the window over its whole wall time, the pass tail is the
95th percentile of every pass, and a stall inside the window moves both."""

import statistics
import time

import pytest

from kgbench import harness
from kgbench.trace import Spans


def test_p95():
    xs = list(range(1, 101))
    assert harness.p95(xs) == pytest.approx(95.95)
    assert harness.p95(xs[:-10] + [1000] * 10) > harness.p95(xs)


@pytest.fixture(scope="module")
def rank_session(tiny_dir):
    cell = harness.Cell.load("fftroth-wn18rr.rank", 7, "cpu", [tiny_dir])
    spans = Spans()
    return harness.load_module("traffic", cell.traffic).Session(cell, spans), spans


def test_rate_is_the_whole_window_and_a_stall_moves_rate_and_tail(rank_session):
    s, spans = rank_session
    n_base = len(spans.records)
    base = s.window(1.0)
    n0 = len(spans.records)
    inner = s._compute_metrics
    calls = []

    def stalled(*a, **k):  # every third pass waits 150 ms more
        calls.append(1)
        if len(calls) % 3 == 0:
            time.sleep(0.15)
        return inner(*a, **k)

    s._compute_metrics = stalled
    try:
        slow = s.window(1.0)
    finally:
        s._compute_metrics = inner
    for w in (base, slow):
        info = w["info"]
        assert w["end_to_end"]["rank_queries_per_s"] == pytest.approx(
            info["passes"] * info["n_queries"] / info["wall_s"])
        assert w["attempted"] == info["passes"] * info["n_queries"]
    # the window's wall time covers every pass: no pass is left out of it
    passes = [x.seconds for x in spans.records[n0:] if x.name == "pass"]
    assert len(passes) == slow["info"]["passes"]
    assert sum(passes) <= slow["info"]["wall_s"]
    assert slow["end_to_end"]["rank_queries_per_s"] < base["end_to_end"]["rank_queries_per_s"]
    before = [x.seconds for x in spans.records[n_base:n0] if x.name == "pass"]
    assert harness.p95(passes) > statistics.median(before) + 0.1


def test_train_rate_counts_examples_not_padding(tiny_dir):
    cell = harness.Cell.load("fftroth-wn18rr.train", 7, "cpu", [tiny_dir])
    s = harness.load_module("traffic", cell.traffic).Session(cell, Spans())
    w = s.window(0.5)
    info = w["info"]
    assert info["examples"] <= info["steps"] * cell.config["batch_size"]
    assert w["end_to_end"]["train_triples_per_s"] == pytest.approx(
        info["examples"] / info["wall_s"])
