"""k9k10.roofline_share: % of their roofline that the GNN kernels K9 (the
sorted segment sum) and K10 (the row gather) reach in the profiled
Trainer.run_epoch call of a full-graph GNN cell: the frozen bytes of every
K9 and K10 launch of each step (kgbench/roofline_gnn.py::k9k10_launches:
the degree and message sums, the tail gathers and their backwards) over
the memory bandwidth, over the device time of the kernels named below.
Moves train_triples_per_s."""

import re

from kgbench import roofline, roofline_gnn

KERNELS = re.compile(r"\b(segsum|row_gather)_kernel\b")


def read(r):
    cfg, info = r.cell.config, r.info
    if cfg.get("family") != "gnn" or info.get("kind") != "train" or not r.on_card:
        return None
    calls = r.profiled("run_epoch")
    steps = sum(s.meta["steps"] for s, _ in calls)
    us = sum(o.dur for _, found in calls for o in found if KERNELS.search(o.name))
    if not steps or not us:
        return None
    launches = roofline_gnn.k9k10_launches(info["encoder_edges"], info["encoder_nodes"],
                                           roofline_gnn.widths(cfg))
    bound = sum(roofline.bound_ms(r.peaks, nbytes) for _, nbytes in launches)
    return 100.0 * steps * bound / (us / 1e3)
