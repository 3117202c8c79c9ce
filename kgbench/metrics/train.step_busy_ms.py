"""train.step_busy_ms: the card's busy milliseconds a training step (the
union of the device operations that the profiled Trainer.run_epoch call
launched, over its steps).  Moves train_triples_per_s."""

from kgbench.trace import busy_us


def read(r):
    calls = r.profiled("run_epoch", kernels_only=False)
    steps = sum(s.meta["steps"] for s, _ in calls)
    ops = [o for _, found in calls for o in found]
    if not steps or not ops:
        return None
    return busy_us(ops) / 1e3 / steps
