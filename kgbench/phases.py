"""The program's phases in a profiled sub-window: the busy and idle
milliseconds of each phase, a training step or a ranker call.

The port marks the phases of `Trainer.train_step` and of
`FusedRanker.__call__` as profiler ranges (its `utils/profiling.py::span`):

    kge.train.step   holds  kge.train.loss, kge.train.backward, kge.train.optimizer
    kge.rank.call    holds  kge.rank.queries, kge.rank.filter, kge.rank.sweep

They are recorded at operator scope, so the Chrome trace lists them as
`cpu_op` events beside the aten operators they enclose, on the trace's
clock, and `Trace.from_chrome` keeps them among `host_ops`; `ranges`
picks them out by their prefix.  A phase's step or call is the
`kge.train.step` / `kge.rank.call` range that holds it: the names carry
no id.  A program without the ranges (an older checkout) gives a trace
without them, and every reader of a phase then returns None.

- **Launch attribution.**  A device operation belongs to the innermost
  `kge.*` range whose interval holds the host instant of the runtime call
  that launched it (the correlation id gives that call), matched by time
  on any thread: backward kernels are launched from the autograd engine's
  thread while `kge.train.backward` is open on the calling thread.
- **Busy.**  The union of a phase's device operations, over the number of
  `kge.train.step` (or `kge.rank.call`) ranges in the sub-window.
- **Idle.**  Each gap between merged device-busy intervals whose ending
  operation belongs to phase P is charged to P, clipped to start no earlier
  than the step or call range around that operation's launch; idle time
  between steps or calls is charged to no phase.  This is the rule of
  `trace.idle_gaps`, with the program's phase in place of the aten
  operator.  Per step or call, like busy.
- **Values.**  Milliseconds; None off the card, without a trace, or when
  the trace holds no range of the phase or of its step or call; 0.0 is a
  valid reading.

Since the ranges are host operators, `trace.idle_gaps` labels a gap whose
launch no aten operator holds (a launch through ctypes, say) by the
innermost `kge.*` range around it, where a trace without the ranges says
"(no launching operator in the trace)"; a launch inside an aten operator
keeps that operator's label.
"""

from __future__ import annotations

import dataclasses

from kgbench.trace import Op, Trace, _Ranges, busy_us, launch_calls, merge

PREFIX = "kge."
# the range that holds each layer's phases: a step or a call
PARENTS = {"train": PREFIX + "train.step", "rank": PREFIX + "rank.call"}


def ranges(trace: Trace) -> list[Op]:
    """The program's `kge.*` ranges among the trace's host operators, in
    time order."""
    return [o for o in trace.host_ops if o.name.startswith(PREFIX)]


@dataclasses.dataclass
class Split:
    """Per range name (`kge.train.loss`, ...): how many ranges the trace
    holds, and the busy and idle microseconds charged to it in all."""

    count: dict[str, int]
    busy_us: dict[str, float]
    idle_us: dict[str, float]


def split(trace: Trace) -> Split:
    """Busy and idle microseconds by the innermost `kge.*` range around
    each device operation's launch (the module's rules)."""
    rs = ranges(trace)
    count: dict[str, int] = {}
    for r in rs:
        count[r.name] = count.get(r.name, 0) + 1
    inner = _Ranges(rs)
    outer = _Ranges([r for r in rs if r.name in PARENTS.values()])
    calls = launch_calls(trace)
    owner: dict[int, tuple[str, Op | None]] = {}
    ops: dict[str, list[Op]] = {}
    for o in trace.device_ops:
        call = calls.get(o.corr)
        r = inner.innermost(call.ts) if call is not None else None
        if r is not None:
            owner[id(o)] = (r.name, outer.innermost(call.ts))
            ops.setdefault(r.name, []).append(o)
    first_after: dict[float, Op] = {}
    for o in trace.device_ops:
        first_after.setdefault(o.ts, o)
    idle: dict[str, float] = {}
    prev = float("-inf")
    for s, e in merge((o.ts, o.end) for o in trace.device_ops):
        nxt = first_after.get(s)
        name, parent = owner.get(id(nxt), (None, None)) if nxt is not None else (None, None)
        if parent is not None:
            gap = s - max(prev, parent.ts)
            if gap > 0:
                idle[name] = idle.get(name, 0.0) + gap
        prev = max(prev, e)
    return Split(count, {k: busy_us(v) for k, v in ops.items()}, idle)


def _per_parent(r, phase: str, kind: str):
    """kind ("busy" or "idle") ms of phase `<layer>.<name>` a step or call
    of reading r; None as the module says."""
    if r.trace is None or not r.on_card:
        return None
    name, parent = PREFIX + phase, PARENTS[phase.split(".")[0]]
    got = split(r.trace)
    if not got.count.get(name) or not got.count.get(parent):
        return None
    us = (got.busy_us if kind == "busy" else got.idle_us).get(name, 0.0)
    return us / 1e3 / got.count[parent]


def busy_ms(r, phase: str):
    """The card's busy ms a step or call in `phase` (e.g. "train.loss")."""
    return _per_parent(r, phase, "busy")


def idle_ms(r, phase: str):
    """The card's idle ms a step or call charged to `phase`."""
    return _per_parent(r, phase, "idle")
