"""gnn_conve.mfu: % of the card's peak that a full-graph CompGCN training
step with the corr composition and the ConvE decoder reaches at the
measured wall time a step: the larger of the step's frozen operations over
the card's fp32 peak and its bytes over its memory bandwidth
(kgbench/roofline_conve.py::conve_step_work: the encoder with corr at its
least work, forward and backward, ConvE, the scores, the BCE's passes and
Adam; roofline.py bound_ms), over the wall milliseconds a step of the
traced run's window outside the profiled sub-window.  Moves
train_triples_per_s."""

from kgbench import roofline, roofline_conve, roofline_gnn


def read(r):
    info, cfg = r.info, r.cell.config
    if (cfg.get("family") != "gnn" or cfg.get("opn") != "corr"
            or cfg.get("interaction") != "conve" or info.get("kind") != "train"
            or not info.get("steps") or not r.on_card):
        return None
    f32, nbytes = roofline_conve.conve_step_work(
        info["encoder_edges"], info["encoder_nodes"], cfg["n_relations"],
        roofline_gnn.widths(cfg), cfg["batch_size"], info["n_params"], cfg["k_w"], cfg["k_h"],
        cfg["num_filt"], cfg["ker_sz"])
    step_ms = 1e3 * info["wall_s"] / info["steps"]
    return 100.0 * roofline.bound_ms(r.peaks, nbytes, f32) / step_ms
