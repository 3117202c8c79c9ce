"""train.loss_busy_ms: the card's busy milliseconds a training step in the
program's kge.train.loss phase (the negative draws, get_queries, the
scores, the loss and the regularizer): the union of the device operations
launched inside the phase's ranges, over the kge.train.step ranges of the
profiled sub-window (kgbench/phases.py).  Moves train_triples_per_s."""

from kgbench import phases


def read(r):
    return phases.busy_ms(r, "train.loss")
