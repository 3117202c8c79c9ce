"""k1.roofline_share: % of its roofline that K1, the FFT family's masked
sweep (csrc/chyp_rank.cu chyp_sweep_kernel<true>, exact fp32), reaches in
the profiled ranker calls: the frozen bound of each call's B queries over
the configuration's N entities (kgbench/roofline.py::chyp_sweep_work;
0.0855 ms at B 500, N 40,943, D 66), over the kernel's device time.
Moves rank_queries_per_s."""

import re

from kgbench import roofline

KERNEL = re.compile(r"(^|[\s:])chyp_sweep_kernel<true>")


def read(r):
    cfg = r.cell.config
    d = roofline.entity_width("chyp", cfg["rank"])
    bound = us = 0.0
    for span, found in r.profiled("ranker"):
        t = sum(o.dur for o in found if KERNEL.search(o.name))
        if t:
            ops, nbytes = roofline.chyp_sweep_work(span.meta["queries"], cfg["n_entities"], d)
            bound += roofline.bound_ms(r.peaks, nbytes, ops)
            us += t
    if not us or cfg["family"] != "chyp":
        return None
    return 100.0 * bound / (us / 1e3)
