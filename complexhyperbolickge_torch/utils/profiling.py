"""Observability: phase ranges in a torch.profiler trace, a torch.profiler
trace of a block, and the --debug_nans check.

Port of complexhyperbolickge_tpu/utils/profiling.py.  trace() writes a
torch.profiler trace (CPU and, on a machine with a card, CUDA activity)
where JAX writes a jax.profiler one.  NanCheck is the port's form of JAX's
jax_debug_nans: JAX fails fast with FloatingPointError on the first NaN of
any computation; here the training loop runs under
torch.autograd.detect_anomaly() and each step's loss is checked on the host
before its backward, so the error names the epoch and the step.

span(name) marks a phase of the program (a training step's loss, backward
and optimizer; a fused ranker call's query prep, filter and sweep) as a
range `kge.<name>` in whatever torch.profiler is recording: trace()'s
--profile_dir trace, or a profiler a caller runs.  The ranges are recorded
into the profiler itself, so they share the trace's clock with its host
operators, its runtime calls and, through those calls' correlation ids, the
device operations each phase launched; the profiler keeps them in memory
and writes them with the trace.  They are operator-scope ranges (category
`cpu_op` in the Chrome trace), not user annotations, so a reader that
keeps a trace's host operators finds them nested with the aten operators
they enclose.  A phase's range and the step's or call's range that
holds it are told apart by containment and order in the trace, so the
names are fixed strings and a trace aggregates by name.

With no profiler recording, span() reads one flag and returns a shared
no-op context: about 0.3 us an enter and exit on a CPU core, where a
torch.profiler.record_function costs ~11 us even with no profiler running.
With a profiler recording, a range costs ~1.3 us (record_function: ~14).
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import torch


PREFIX = "kge."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range `kge.<name>` while a torch.profiler records, else
    the one shared no-op context.  The flag is read through its module on
    every call (a name imported from it would stay False)."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(PREFIX + name)
    return _OFF


@contextlib.contextmanager
def trace(log_dir: str | None):
    """torch.profiler over the block, written on exit as a Chrome trace
    (<host>_<pid>.<ns>.pt.trace.json, the name TensorBoard's profiler plugin
    reads) into log_dir; a no-op for None.  The trace holds the span()
    ranges of every step and ranker call the block runs."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"))


class NanCheck:
    """--debug_nans for one epoch of a training loop: the loop runs inside
    it (under torch.autograd.detect_anomaly()) and calls backward(loss) in
    place of loss.backward().  A non-finite loss, or a NaN that anomaly
    mode finds in the backward, raises FloatingPointError naming the epoch
    and the step (1-based).  Costs a host sync a step.

    On a mesh of several ranks no rank may raise alone (the others would
    wait in a collective forever): the loss flag is OR-ed over the ranks
    before the backward, which runs without anomaly mode, and the NaN flag
    of `params`' gradients after it, so every rank raises together."""

    def __init__(self, epoch: int, mesh=None, params=()):
        self.epoch = epoch
        self.step = 0
        self.mesh = mesh if mesh is not None and mesh.collective else None
        self.params = params
        self._anomaly = (torch.autograd.detect_anomaly() if self.mesh is None
                         else contextlib.nullcontext())

    def __enter__(self):
        self._anomaly.__enter__()
        return self

    def __exit__(self, *exc):
        return self._anomaly.__exit__(*exc)

    def backward(self, loss):
        self.step += 1
        bad = not bool(torch.isfinite(loss).all())
        if self.mesh is not None:
            bad = self.mesh.any(bad)
        if bad:
            raise FloatingPointError(f"non-finite training loss {loss.item()} at epoch "
                                     f"{self.epoch}, step {self.step} (--debug_nans)")
        if self.mesh is not None:
            loss.backward()
            if self.mesh.any(any(bool(torch.isnan(p.grad).any()) for p in self.params
                                 if p.grad is not None)):
                raise FloatingPointError(f"NaN in the backward at epoch {self.epoch}, "
                                         f"step {self.step} (--debug_nans)")
            return
        try:
            loss.backward()
        except RuntimeError as e:
            if "nan" not in str(e).lower():
                raise
            raise FloatingPointError(f"NaN in the backward at epoch {self.epoch}, step "
                                     f"{self.step} (--debug_nans): {e}") from e


def nan_check(enabled: bool, epoch: int, mesh=None, model=None):
    """A NanCheck for `epoch` when enabled, else a context that yields None
    (the loop then calls loss.backward() itself).  mesh (with the model
    whose gradients to check): a parallel/mesh.py Mesh of several ranks."""
    if not enabled:
        return contextlib.nullcontext()
    return NanCheck(epoch, mesh, () if model is None else tuple(model.parameters()))
