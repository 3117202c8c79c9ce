"""Busy time, idle share, the kernels of a span and the idle gaps, from
synthetic trace records."""

import pytest

from kgbench.metrics_api import Reading
from kgbench.trace import Op, Span, Spans, Trace, busy_us, idle_gaps, merge, ops_of


def trace(kernels, launches, annotations, host=(), wall_s=1e-3):
    return Trace(list(kernels), list(kernels), list(launches), list(host),
                 list(annotations), wall_s)


def test_busy_is_the_union_of_intervals():
    assert merge([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    ops = [Op("a", 0, 2), Op("b", 1, 2), Op("c", 10, 5)]
    assert busy_us(ops) == 8


def test_idle_share_from_busy_and_wall():
    k = [Op("k", 100, 200), Op("k", 400, 100)]
    t = trace(k, [], [Op("kgbench.ranker", 0, 1000)], wall_s=1000e-6)
    r = Reading(None, t, Spans(), {"kind": "rank"}, "NVIDIA H100 80GB HBM3")
    assert r.device_idle_share() == pytest.approx(70.0)
    assert Reading(None, t, Spans(), {}, "cpu").device_idle_share() is None


def test_kernels_go_to_the_span_that_launched_them():
    kernels = [Op("k1", 50, 10, corr=1), Op("k2", 300, 10, corr=2), Op("k3", 320, 5, corr=3)]
    launches = [Op("cudaLaunchKernel", 5, 1, corr=1), Op("cudaLaunchKernel", 210, 1, corr=2),
                Op("cudaLaunchKernel", 260, 1, corr=3)]
    ann = [Op("kgbench.ranker", 0, 100), Op("kgbench.ranker", 200, 50),
           Op("kgbench.other", 255, 10)]
    got = ops_of(trace(kernels, launches, ann), "ranker")
    assert [[o.name for o in v] for v in got.values()] == [["k1"], ["k2"]]


def test_idle_gaps_are_labelled_by_the_launching_host_op():
    kernels = [Op("k", 0, 10, corr=1), Op("k", 50, 10, corr=2), Op("k", 70, 10, corr=3)]
    launches = [Op("cudaLaunchKernel", 0, 1, corr=1, tid=1),
                Op("cudaLaunchKernel", 45, 1, corr=2, tid=1),
                Op("cudaLaunchKernel", 65, 1, corr=3, tid=1)]
    host = [Op("aten::mul", 40, 10, tid=1), Op("aten::add", 60, 10, tid=1)]
    gaps = dict(idle_gaps(trace(kernels, launches, [Op("kgbench.run_epoch", 0, 100)], host)))
    assert gaps["aten::mul"] == pytest.approx(40e-6)
    assert gaps["aten::add"] == pytest.approx(10e-6)
    assert gaps["(after the last device operation)"] == pytest.approx(20e-6)


def test_profiled_spans_pair_with_their_kernels():
    spans = Spans()
    spans.records = [Span("ranker", 0.0, 1.0, {"queries": 500, "profiled": True}),
                     Span("ranker", 2.0, 3.0, {"queries": 134, "profiled": True}),
                     Span("ranker", 4.0, 5.0, {"queries": 500})]
    kernels = [Op("k", 50, 10, corr=1), Op("k", 300, 10, corr=2)]
    launches = [Op("cudaLaunchKernel", 5, 1, corr=1), Op("cudaLaunchKernel", 210, 1, corr=2)]
    ann = [Op("kgbench.ranker", 0, 100), Op("kgbench.ranker", 200, 50)]
    r = Reading(None, trace(kernels, launches, ann), spans, {}, "NVIDIA H100 80GB HBM3")
    got = r.profiled("ranker")
    assert [(s.meta["queries"], len(k)) for s, k in got] == [(500, 1), (134, 1)]
