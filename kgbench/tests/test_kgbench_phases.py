"""The program's phases (kgbench/phases.py) from synthetic trace records:
launches matched to their phase on any thread, idle clipped at the step
or call, busy split without a remainder, and the benchmark's other
readings unchanged by the program's ranges."""

import pytest

from kgbench import harness, phases
from kgbench.metrics_api import Reading
from kgbench.trace import Op, Span, Spans, Trace, idle_gaps, top_device_ops

CARD = "NVIDIA H100 80GB HBM3"
MAIN, AUTOGRAD = 1, 2
NEW = [m["name"] for m in harness.benchmark_spec()["per_layer"]
       if "from kgbench import phases" in (harness.KGBENCH / "metrics" / f"{m['name']}.py").read_text()]
OLD = [m["name"] for m in harness.benchmark_spec()["per_layer"] if m["name"] not in NEW]


class Builder:
    """Trace records: program ranges, aten operators, and kernels with the
    runtime call that launched each (one correlation id apiece)."""

    def __init__(self):
        self.ranges, self.host, self.kernels, self.launches = [], [], [], []

    def range(self, name, ts, dur, tid=MAIN):
        self.ranges.append(Op("kge." + name, ts, dur, tid=tid))

    def kernel(self, name, host_ts, dev_ts, dur, tid=MAIN, op="aten::mul"):
        corr = len(self.kernels) + 1
        if op is not None:
            self.host.append(Op(op, host_ts - 1, 3, tid=tid))
        self.launches.append(Op("cudaLaunchKernel", host_ts, 1, corr=corr, tid=tid))
        self.kernels.append(Op(name, dev_ts, dur, corr=corr))

    def trace(self, annotations, program=True, wall_s=1e-3):
        host = self.host + (self.ranges if program else [])
        lists = [sorted(x, key=lambda o: o.ts) for x in (self.kernels, self.launches, host)]
        return Trace(lists[0], list(lists[0]), lists[1], lists[2], list(annotations), wall_s)


def read(name, reading):
    return harness.load_module("metrics", name).read(reading)


def reading(trace, cell="fftroth-wn18rr.train", spans=None, info=None, device=CARD):
    return Reading(harness.Cell.load(cell, 1, "cpu"), trace, spans or Spans(), info or {},
                   device)


def train_step(b, t0, k3=False):
    """One step at host time t0 (100 us long): a loss kernel, a backward
    kernel launched from the autograd thread, an optimizer kernel."""
    b.range("train.step", t0, 100)
    b.range("train.loss", t0 + 5, 25)
    b.range("train.backward", t0 + 35, 30)
    b.range("train.optimizer", t0 + 70, 25)
    b.kernel("chyp_train_fwd_kernel" if k3 else "elementwise", t0 + 10, t0 + 20, 8)
    b.kernel("elementwise_backward", t0 + 45, t0 + 50, 6, tid=AUTOGRAD,
             op="autograd::engine::evaluate_function: MulBackward0")
    b.kernel("multi_tensor_apply_kernel", t0 + 75, t0 + 80, 4)


def train_case():
    b = Builder()
    b.kernel("upload", 2, 3, 2)  # run_epoch's upload, outside any step
    for i in range(2):
        train_step(b, 10 + 100 * i, k3=True)
    spans = Spans()
    spans.records = [Span("run_epoch", 0.0, 1.0, {"steps": 2, "profiled": True})]
    info = {"kind": "train", "steps": 40, "n_params": 3_000_000, "wall_s": 1.0}
    return b, [Op("kgbench.run_epoch", 0, 300)], spans, info


def rank_call(b, t0, sweep="chyp_sweep_kernel<true>"):
    """One ranker call at host time t0 (100 us long)."""
    b.range("rank.call", t0, 100)
    b.range("rank.queries", t0 + 5, 20)
    b.range("rank.filter", t0 + 30, 20)
    b.range("rank.sweep", t0 + 55, 30)
    b.kernel("norms", t0 + 10, t0 + 15, 5)
    b.kernel("scatter", t0 + 35, t0 + 40, 5, op="aten::scatter_")
    b.kernel(sweep, t0 + 60, t0 + 62, 20, op="aten::empty")
    b.kernel("epilogue", t0 + 90, t0 + 92, 3, op="aten::add")


def rank_case():
    b = Builder()
    for i in range(2):
        rank_call(b, 10 + 100 * i)
    spans = Spans()
    spans.records = ([Span("ranker", 0.0, 1.0, {"queries": 500, "profiled": True}),
                      Span("ranker", 1.0, 2.0, {"queries": 134, "profiled": True})]
                     + [Span("pass", 10.0 + i, 10.5 + i, {"queries": 6268}) for i in range(25)])
    info = {"kind": "rank", "passes": 25, "n_queries": 6268, "wall_s": 12.5,
            "window_start": 5.0}
    ann = [Op("kgbench.ranker", 5, 104), Op("kgbench.ranker", 109, 101)]
    return b, ann, spans, info


def test_a_backward_kernel_from_the_autograd_thread_is_charged_to_backward():
    b = Builder()
    train_step(b, 0)
    r = reading(b.trace([]))
    assert read("train.backward_busy_ms", r) == pytest.approx(6e-3)
    # the gap from the loss kernel's end (28) to the backward kernel (50)
    assert read("train.backward_idle_ms", r) == pytest.approx(22e-3)
    assert read("train.loss_idle_ms", r) == pytest.approx(20e-3)  # from the step's start
    assert read("train.optimizer_idle_ms", r) == pytest.approx(24e-3)
    assert [read(f"train.{p}_busy_ms", r) for p in ("loss", "optimizer")] == pytest.approx(
        [8e-3, 4e-3])


def test_a_gap_that_began_before_its_call_is_clipped_at_the_call():
    b = Builder()
    b.kernel("before", 1, 2, 3)  # compute_metrics' work, ends at 5
    rank_call(b, 100)
    r = reading(b.trace([]), "fftroth-wn18rr.rank")
    # the queries kernel starts at 115; the call at 100
    assert read("rank.queries_idle_ms", r) == pytest.approx(15e-3)
    assert read("rank.sweep_busy_ms", r) == pytest.approx(20e-3)
    assert read("rank.filter_idle_ms", r) == pytest.approx(20e-3)


@pytest.mark.parametrize("case", [train_case, rank_case])
def test_busy_by_phase_sums_to_the_step_or_call(case):
    b, ann, spans, info = case()
    cell = "fftroth-wn18rr.train" if case is train_case else "fftroth-wn18rr.rank"
    r = reading(b.trace(ann), cell, spans, info)
    if case is train_case:
        whole = read("train.step_busy_ms", r) - 2e-3 / 2  # the upload, in no step
        parts = ["train.loss", "train.backward", "train.optimizer"]
    else:
        whole = read("rank.ranker_busy_ms", r) - 3e-3  # the call's own epilogue
        parts = ["rank.queries", "rank.filter", "rank.sweep"]
    assert sum(read(p + "_busy_ms", r) for p in parts) == pytest.approx(whole)


@pytest.mark.parametrize("case", [train_case, rank_case])
def test_the_other_readings_are_the_same_with_and_without_the_program_ranges(case):
    b, ann, spans, info = case()
    cell = "fftroth-wn18rr.train" if case is train_case else "fftroth-wn18rr.rank"
    with_ranges, without = b.trace(ann), b.trace(ann, program=False)
    got = {}
    for t in (with_ranges, without):
        r = reading(t, cell, spans, info)
        got[id(t)] = ({m: read(m, r) for m in OLD}, idle_gaps(t), top_device_ops(t))
    assert got[id(with_ranges)] == got[id(without)]
    found = {m for m, v in got[id(without)][0].items() if v is not None}
    want = ({"train.step_busy_ms", "train.launches_per_step", "k3k4.roofline_share",
             "train.mfu"} if case is train_case else
            {"rank.ranker_busy_ms", "rank.launches_per_call", "k1.roofline_share",
             "rank.mfu", "rank.pass_p95_ms"})
    assert want <= found
    assert all(read(m, reading(without, cell, spans, info)) is None for m in NEW)


def test_idle_gaps_label_a_launch_outside_every_operator_by_its_phase():
    b = Builder()
    b.kernel("k", 5, 6, 2)
    b.range("rank.call", 10, 50)
    b.range("rank.sweep", 20, 30)
    b.kernel("sweep", 25, 30, 10, op=None)  # launched through ctypes
    ann = [Op("kgbench.ranker", 0, 60)]
    assert dict(idle_gaps(b.trace(ann, program=False)))[
        "(no launching operator in the trace)"] == pytest.approx(22e-6)
    assert dict(idle_gaps(b.trace(ann)))["kge.rank.sweep"] == pytest.approx(22e-6)


def test_no_phase_reading_off_the_card_or_without_a_trace():
    b, ann, spans, info = train_case()
    for r in (reading(b.trace(ann), spans=spans, info=info, device="cpu"),
              reading(None, spans=spans, info=info)):
        assert all(read(m, r) is None for m in NEW)
    assert len(NEW) == 12 and phases.ranges(b.trace(ann))[0].name == "kge.train.step"
