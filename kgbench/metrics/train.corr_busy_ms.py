"""train.corr_busy_ms: the card's busy milliseconds a training step in the
program's kge.train.corr phase (each circular-correlation composition's
forward in CompGCN's encoder: the edges' and the self loop's, inside
kge.train.encode): the union of the device operations launched inside the
phase's ranges, over the kge.train.step ranges of the profiled sub-window
(kgbench/phases.py).  None where the program has no such range.  Moves
train_triples_per_s."""

from kgbench.phases import busy_ms


def read(r):
    return busy_ms(r, "train.corr")
