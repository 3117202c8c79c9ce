"""k5.roofline_share: % of its roofline that K5, the Poincare masked sweep
(csrc/hyp_rank.cu rank_sweep_kernel<0, true>, exact fp32, over the radius
table that hyp_rank_radii builds once per params version), reaches in the
profiled ranker calls: the frozen bound of each call's B queries over the
configuration's N entities and curvatures (kgbench/roofline.py::
hyp_sweep_work; 0.0361 ms at B 500, N 40,943, D 32, 22 curvatures), over
the kernel's device time.  Moves rank_queries_per_s."""

import re

from kgbench import roofline

KERNEL = re.compile(r"(^|[\s:])rank_sweep_kernel<0, ?true>")


def read(r):
    cfg = r.cell.config
    n_c = cfg["n_relations"] if cfg["multi_c"] else 1
    bound = us = 0.0
    for span, found in r.profiled("ranker"):
        t = sum(o.dur for o in found if KERNEL.search(o.name))
        if t:
            ops, nbytes = roofline.hyp_sweep_work(span.meta["queries"], cfg["n_entities"],
                                                  cfg["rank"], n_c)
            bound += roofline.bound_ms(r.peaks, nbytes, ops)
            us += t
    if not us or cfg["family"] != "poincare":
        return None
    return 100.0 * bound / (us / 1e3)
