"""rank.mfu: % of the card's peak that a whole-split pass's frozen work
count reaches at the measured wall time a pass: every filtered query
against every entity, its contraction and epilogue
(kgbench/roofline.py::rank_pass_work, bound_ms), over the wall
milliseconds a pass of the traced run's window outside the profiled
sub-window.  Moves rank_queries_per_s."""

from kgbench import roofline


def read(r):
    info, cfg = r.info, r.cell.config
    if info.get("kind") != "rank" or not info.get("passes") or not r.on_card:
        return None
    ops, nbytes = roofline.rank_pass_work(cfg["family"], info["n_queries"], cfg["n_entities"],
                                          roofline.entity_width(cfg["family"], cfg["rank"]))
    pass_ms = 1e3 * info["wall_s"] / info["passes"]
    return 100.0 * roofline.bound_ms(r.peaks, nbytes, ops) / pass_ms
