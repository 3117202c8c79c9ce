"""Host spans around the calls into each layer, and a profiled sub-window
reduced to device intervals.

`Spans` records (name, start, end, meta) on the host clock around each call
the traffic makes into the program; inside a profiled sub-window each span
is also a `torch.profiler.record_function` range named `kgbench.<name>`,
so the device work it launched can be told apart.  `Profiled` runs such a
sub-window under torch.profiler (CPU and CUDA activities) and, once the
window has closed, reads its chrome trace back as a `Trace`: device operations
(kernels, copies, fills), the host's runtime launch calls, its operators
and the annotation ranges, all in microseconds on the profiler's clock.
The reductions (busy time as the union of device intervals, the kernels of
a span, idle gaps labelled by what the host was doing) work on those plain
records, so tests can feed them synthetic ones.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import tempfile
import time

ANNOTATION_PREFIX = "kgbench."
# runtime and driver calls that put an operation on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel", "cudaMemcpyAsync",
                "cudaMemsetAsync", "cudaMemcpy", "cudaMemset")


@dataclasses.dataclass
class Span:
    name: str
    start: float  # host clock, seconds
    end: float
    meta: dict

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Spans:
    """Host spans of the calls into the program; `annotate` also opens a
    profiler range per span (inside a profiled sub-window only)."""

    def __init__(self):
        self.records: list[Span] = []
        self.annotate = False

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        if self.annotate:
            import torch

            meta["profiled"] = True
            rf = torch.profiler.record_function(ANNOTATION_PREFIX + name)
        else:
            rf = contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            yield meta
        self.records.append(Span(name, t0, time.perf_counter(), meta))

    def named(self, name: str, profiled: bool | None = None) -> list[Span]:
        """The spans called `name`; profiled True / False keeps only those
        inside / outside a profiled sub-window (meta "profiled")."""
        out = [s for s in self.records if s.name == name]
        if profiled is not None:
            out = [s for s in out if bool(s.meta.get("profiled")) == profiled]
        return out


@dataclasses.dataclass
class Op:
    name: str
    ts: float  # microseconds, profiler clock
    dur: float
    corr: int | None = None
    tid: object = None

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclasses.dataclass
class Trace:
    """A profiled sub-window: device operations (kernels, copies and
    fills), kernels alone, runtime launch calls, host operators, the
    benchmark's annotation ranges on the host, and the host clock's length
    of the sub-window in seconds."""

    device_ops: list[Op]
    kernels: list[Op]
    launches: list[Op]
    host_ops: list[Op]
    annotations: list[Op]
    wall_s: float

    @classmethod
    def from_chrome(cls, data: dict, wall_s: float) -> "Trace":
        events = data.get("traceEvents", data) if isinstance(data, dict) else data
        dev, kern, launch, host, ann = [], [], [], [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            corr = (e.get("args") or {}).get("correlation")
            op = Op(name, float(e["ts"]), float(e["dur"]), corr, e.get("tid"))
            if cat == "kernel":
                dev.append(op)
                kern.append(op)
            elif cat in ("gpu_memcpy", "gpu_memset"):
                dev.append(op)
            elif cat in ("cuda_runtime", "cuda_driver"):
                if name in LAUNCH_CALLS:
                    launch.append(op)
            elif cat == "cpu_op":
                host.append(op)
            elif cat == "user_annotation" and name.startswith(ANNOTATION_PREFIX):
                ann.append(op)
        for xs in (dev, kern, launch, host, ann):
            xs.sort(key=lambda o: o.ts)
        return cls(dev, kern, launch, host, ann, wall_s)


class Profiled:
    """A profiled sub-window: run(fn) runs fn() under torch.profiler (CPU
    and CUDA activities) with the spans annotated, synchronizing before
    and after; read() exports the chrome trace to a temporary file, reads
    it back and returns the Trace (do that after the window: it takes
    seconds).  wall_s: the host clock's length of the sub-window, from
    before fn to the synchronize after it."""

    def __init__(self, spans: Spans, cuda: bool = True):
        self.spans = spans
        self.cuda = cuda
        self.prof = None
        self.wall_s = 0.0

    def _sync(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize()

    def run(self, fn):
        import torch
        from torch.profiler import ProfilerActivity

        self._sync()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = torch.profiler.profile(activities=activities)
        self.prof.start()
        self.spans.annotate = True
        try:
            t0 = time.perf_counter()
            fn()
            self._sync()
            self.wall_s = time.perf_counter() - t0
        finally:
            self.spans.annotate = False
            self.prof.stop()

    def read(self) -> Trace:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        self.prof = None
        return Trace.from_chrome(data, self.wall_s)


# --------------------------------- reductions ---------------------------------


def merge(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(ops) -> float:
    """Microseconds in which at least one of `ops` ran."""
    return sum(e - s for s, e in merge((o.ts, o.end) for o in ops))


class _Ranges:
    """Ranges sorted by start, for the innermost one around an instant."""

    def __init__(self, ranges: list[Op]):
        self.ranges = ranges
        self.starts = [r.ts for r in ranges]

    def innermost(self, t: float, tid=None, look_back: int = 4096) -> Op | None:
        """The latest-starting range that holds the instant t (of thread
        tid, when given), among the look_back ranges that start last
        before t."""
        i = bisect.bisect_right(self.starts, t)
        for r in reversed(self.ranges[max(0, i - look_back):i]):
            if r.end >= t and (tid is None or r.tid == tid):
                return r
        return None


def launch_calls(trace: Trace) -> dict:
    """correlation id -> the runtime call that launched it."""
    return {o.corr: o for o in trace.launches if o.corr is not None}


def ops_of(trace: Trace, name: str, ops=None) -> dict[int, list[Op]]:
    """The device operations (default: the kernels) launched inside each
    annotation range `kgbench.<name>`, keyed by the range's index among
    those ranges in time order: the range that holds the host time of the
    runtime call that launched the operation (the trace correlates them)."""
    ops = trace.kernels if ops is None else ops
    ranges = [a for a in trace.annotations if a.name == ANNOTATION_PREFIX + name]
    index = {id(r): i for i, r in enumerate(ranges)}
    out: dict[int, list[Op]] = {i: [] for i in range(len(ranges))}
    calls, host = launch_calls(trace), _Ranges(ranges)
    for o in ops:
        call = calls.get(o.corr)
        r = host.innermost(call.ts) if call is not None else None
        if r is not None:
            out[index[id(r)]].append(o)
    return out


def idle_gaps(trace: Trace, top: int = 10) -> list[list]:
    """The device's idle time inside the sub-window's annotated extent,
    by what the host was doing: each gap between device operations is
    labelled with the innermost host operator around the launch of the
    operation that ended it; the labels with the most idle seconds."""
    if not trace.device_ops or not trace.annotations:
        return []
    lo = min(a.ts for a in trace.annotations)
    hi = max(a.end for a in trace.annotations)
    merged = merge((o.ts, o.end) for o in trace.device_ops)
    calls, host_ops = launch_calls(trace), _Ranges(trace.host_ops)
    first_after = {}
    for o in trace.device_ops:
        first_after.setdefault(o.ts, o)
    by_label: dict[str, float] = {}
    prev = lo
    for s, e in merged:
        if s > prev and s > lo and prev < hi:
            gap = min(s, hi) - max(prev, lo)
            nxt = first_after.get(s)
            call = calls.get(nxt.corr) if nxt is not None else None
            host = host_ops.innermost(call.ts, call.tid) if call is not None else None
            label = host.name if host is not None else "(no launching operator in the trace)"
            by_label[label] = by_label.get(label, 0.0) + gap / 1e6
        prev = max(prev, e)
    if hi > prev:
        by_label["(after the last device operation)"] = (
            by_label.get("(after the last device operation)", 0.0) + (hi - prev) / 1e6)
    return [[k[:120], v] for k, v in sorted(by_label.items(), key=lambda kv: -kv[1])[:top]]


def top_device_ops(trace: Trace, top: int = 10) -> list[list]:
    """The device operations with the most seconds, by name."""
    by: dict[str, float] = {}
    for o in trace.device_ops:
        by[o.name] = by.get(o.name, 0.0) + o.dur / 1e6
    return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
