"""What a per-layer metric's reader (`metrics/<name>.py`, a function
`read(reading) -> float | None`) is given: the cell, the profiled
sub-window's Trace (None when the run profiled nothing), the host spans of
the whole window, what the window counted (`info`), and the card's name
and peak rates.  A reader that finds nothing to read returns None and the
metric is left out of the result line."""

from __future__ import annotations

import dataclasses

from kgbench import roofline
from kgbench.trace import Spans, Trace, busy_us, ops_of


@dataclasses.dataclass
class Reading:
    cell: object
    trace: Trace | None
    spans: Spans
    info: dict
    device_name: str

    @property
    def on_card(self) -> bool:
        """Whether the run measured a card: a CPU run gives no device
        metric."""
        return self.device_name != "cpu"

    @property
    def peaks(self):
        return roofline.peak_rates(self.device_name)

    def profiled(self, name: str, kernels_only: bool = True) -> list:
        """(span, the kernels it launched, or with kernels_only False every
        device operation) for each span `name` inside the profiled
        sub-window, in time order; [] without a trace."""
        if self.trace is None:
            return []
        spans = self.spans.named(name, profiled=True)
        ops = ops_of(self.trace, name, None if kernels_only else self.trace.device_ops)
        if len(ops) != len(spans):
            return []
        return [(s, ops[i]) for i, s in enumerate(spans)]

    def window_spans(self, name: str) -> list:
        """The spans `name` of the window outside its profiled sub-window
        (not those of set-up)."""
        t0 = self.info.get("window_start", float("-inf"))
        return [s for s in self.spans.named(name, profiled=False) if s.start >= t0]

    def device_idle_share(self):
        """100 x the share of the profiled sub-window in which no operation
        ran on the device; None without device operations."""
        if self.trace is None or not self.trace.device_ops or not self.on_card:
            return None
        return 100.0 * (1.0 - busy_us(self.trace.device_ops) / 1e6 / self.trace.wall_s)
