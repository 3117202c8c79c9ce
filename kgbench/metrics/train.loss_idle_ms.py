"""train.loss_idle_ms: the card's idle milliseconds a training step charged
to the program's kge.train.loss phase (the negative draws, get_queries,
the scores, the loss and the regularizer): each gap before a device
operation launched in the phase, clipped at the start of its
kge.train.step range, over the kge.train.step ranges of the profiled
sub-window (kgbench/phases.py).  Moves train_triples_per_s."""

from kgbench import phases


def read(r):
    return phases.idle_ms(r, "train.loss")
