"""train.mfu: % of the card's peak that a training step's frozen work count
reaches at the measured wall time a step: the larger of the step's
operations over the card's peak rates and its bytes over its memory
bandwidth (kgbench/roofline.py::train_step_work, bound_ms), over the wall
milliseconds a step of the traced run's window outside the profiled
sub-window.  Moves train_triples_per_s."""

from kgbench import roofline


def read(r):
    info, cfg = r.info, r.cell.config
    if info.get("kind") != "train" or not info.get("steps") or not r.on_card:
        return None
    d = roofline.entity_width(cfg["family"], cfg["rank"])
    f32, f64, nbytes = roofline.train_step_work(
        cfg["family"], cfg["batch_size"], cfg["neg_sample_size"], cfg["n_entities"], d,
        info["n_params"], cfg["double_neg"])
    step_ms = 1e3 * info["wall_s"] / info["steps"]
    return 100.0 * roofline.bound_ms(r.peaks, nbytes, f32, f64) / step_ms
