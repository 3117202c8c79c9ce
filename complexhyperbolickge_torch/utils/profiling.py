"""Observability: a throughput meter, a torch.profiler trace, and the
--debug_nans check.

Port of complexhyperbolickge_tpu/utils/profiling.py.  StepTimer is the JAX
package's; trace() writes a torch.profiler trace (CPU and, on a machine
with a card, CUDA activity) where JAX writes a jax.profiler one.  NanCheck
is the port's form of JAX's jax_debug_nans: JAX fails fast with
FloatingPointError on the first NaN of any computation; here the training
loop runs under torch.autograd.detect_anomaly() and each step's loss is
checked on the host before its backward, so the error names the epoch and
the step.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import torch


class StepTimer:
    """Wall-clock throughput meter with warmup-discarding averages."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.times: list[float] = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    def rate(self, units_per_step: float) -> float:
        steady = self.times[self.warmup:] or self.times
        return units_per_step * len(steady) / sum(steady)

    @property
    def mean_ms(self) -> float:
        steady = self.times[self.warmup:] or self.times
        return 1000.0 * sum(steady) / len(steady)


@contextlib.contextmanager
def trace(log_dir: str | None):
    """torch.profiler over the block, written on exit as a Chrome trace
    (<host>_<pid>.<ns>.pt.trace.json, the name TensorBoard's profiler plugin
    reads) into log_dir; a no-op for None."""
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
