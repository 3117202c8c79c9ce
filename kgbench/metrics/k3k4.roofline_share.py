"""k3k4.roofline_share: % of their roofline that the FFT family's train
distance kernels reach in the profiled Trainer.run_epoch call: the frozen
bounds of K3 (forward) and K4 (backward with its index preparation) of
every step's candidate blocks (B x (1 + K) ids, and B x K heads under
double_neg), over the device time of the kernels named below.  Moves
train_triples_per_s."""

import re

from kgbench import roofline

KERNELS = re.compile(r"chyp_train_(fwd|lists|bwd)_kernel")


def read(r):
    cfg = r.cell.config
    calls = r.profiled("run_epoch")
    steps = sum(s.meta["steps"] for s, _ in calls)
    us = sum(o.dur for _, found in calls for o in found if KERNELS.search(o.name))
    if not steps or not us or cfg["family"] != "chyp":
        return None
    b, k, n = cfg["batch_size"], cfg["neg_sample_size"], cfg["n_entities"]
    d = roofline.entity_width("chyp", cfg["rank"])
    bound = 0.0
    for kk in [1 + k] + ([k] if cfg["double_neg"] else []):
        for work in (roofline.chyp_train_fwd_work, roofline.chyp_train_bwd_work):
            f32, f64, nbytes = work(b, kk, n, d)
            bound += roofline.bound_ms(r.peaks, nbytes, f32, f64)
    return 100.0 * steps * bound / (us / 1e3)
