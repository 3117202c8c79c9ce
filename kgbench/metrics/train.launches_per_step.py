"""train.launches_per_step: kernels the card ran a training step in the
profiled Trainer.run_epoch call (every launch of the host's launch path).
Moves train_triples_per_s."""


def read(r):
    calls = r.profiled("run_epoch")
    steps = sum(s.meta["steps"] for s, _ in calls)
    kernels = sum(len(found) for _, found in calls)
    if not steps or not kernels:
        return None
    return kernels / steps
