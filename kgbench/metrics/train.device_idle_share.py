"""train.device_idle_share: % of the profiled sub-window (a Trainer.run_epoch
call) in which no operation ran on the card.  Moves train_triples_per_s."""


def read(r):
    if r.info.get("kind") != "train":
        return None
    return r.device_idle_share()
