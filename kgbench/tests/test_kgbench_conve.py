"""The cell compgcn-conve-fb237.train on the CPU: its configuration and
cell load; the model that train_full_graph builds from the configuration
has the configuration's ConvE shape (the traffic passes only GNN_FLAGS, so
this pins the model's defaults to the file) and a state_dict of exactly
the reference's PARAMS; the reference follows the program at a cut size
(600 entities, 3,000 triples, batch 32, the configuration's widths); its
three new readers on synthetic trace records; the frozen counts by hand."""

import json
import math

import pytest
import torch

from conftest import ROOT
from kgbench import harness, roofline, roofline_conve
from kgbench.metrics_api import Reading
from kgbench.reference import protocol
from kgbench.trace import Op, Span, Spans, Trace

CELL, CONFIG = "compgcn-conve-fb237.train", "compgcn-conve-fb237"
CUT = dict(entities=600, train_triples=3000, valid_triples=50, test_triples=50, batch_size=32)
CARD = "NVIDIA H100 80GB HBM3"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ["train.decode_busy_ms", "train.corr_busy_ms", "gnn_conve.mfu"]
SHARED = ["train.encode_busy_ms", "train.rel_grad_busy_ms", "k9k10.roofline_share"]


@pytest.fixture(scope="module")
def cut_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("conve")
    for kind, name in (("configs", CONFIG), ("workloads", CELL)):
        (d / kind).mkdir()
        spec = harness.load_json(kind, name)
        if kind == "configs":
            spec.update(CUT)
        (d / kind / f"{name}.json").write_text(json.dumps(spec))
    return d


@pytest.fixture(scope="module")
def session(cut_dir):
    cell = harness.Cell.load(CELL, 2**31 + 17, "cpu", [cut_dir])
    s = harness.load_module("traffic", cell.traffic).Session(cell, Spans())
    s.window(0.0)
    return cell, s


def verdict(cell, numbers):
    return harness.check_lines(numbers, cell.limits)[0]


# ------------------------------ layout and model ------------------------------


def test_configuration_and_cell_load_and_state_their_cuts():
    cell = harness.Cell.load(CELL, 1, "cpu")
    cfg = cell.config
    entry = {c["name"]: c for c in BENCH["configs"]}[CONFIG]
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    assert (cfg["model"], cfg["family"], cfg["opn"], cfg["interaction"]) == (
        "CompGCN", "gnn", "corr", "conve")
    assert (cfg["rank"], cfg["hidden_dim"], cfg["layers"], cfg["basis"]) == (100, 200, 1, 0)
    assert (cfg["k_w"], cfg["k_h"], cfg["num_filt"], cfg["ker_sz"]) == (10, 20, 200, 7)
    assert (cfg["n_entities"], cfg["n_relations"], cfg["train_triples"]) == (14541, 474, 272115)
    assert set(cfg["reduced"]) <= set(cfg["assumed"])
    width = ("dim", "rank", "hidden", "size", "head", "factor", "k_", "filt", "ker")
    assert not any(w in k for k in cfg["reduced"] for w in width if k != "batch_size")
    w = {x["name"]: x for x in BENCH["workloads"]}[CELL]
    assert (w["config"], w["traffic"], w["chips"]) == (CONFIG, "train_full_graph", 1)
    assert set(cell.limits) == {"loss_gap", "grad_norm_gap", "change_norm_gap"}


def test_the_entries_list_the_cell_where_it_reports():
    per = {m["name"] for m in harness.cell_metrics(BENCH, CELL, "per_layer")}
    shared = {"train.step_busy_ms", "train.launches_per_step", "train.device_idle_share"} | {
        f"train.{p}_{k}_ms" for p in ("loss", "backward", "optimizer") for k in ("busy", "idle")}
    assert per == shared | set(SHARED) | set(NEW)
    assert not {"gnn.mfu", "train.mfu", "k3k4.roofline_share"} & per
    assert [m["name"] for m in BENCH["per_layer"][-3:]] == NEW
    assert [m["name"] for m in harness.cell_metrics(BENCH, CELL, "end_to_end")] == [
        "train_triples_per_s", "setup_s"]


def test_the_built_model_has_the_configuration_shape_and_params(cut_dir):
    """train_full_graph passes only GNN_FLAGS: ConvE's shape comes from the
    model's defaults, which must be the configuration's."""
    cell = harness.Cell.load(CELL, 3, "cpu", [cut_dir])
    traffic = harness.load_module("traffic", cell.traffic)
    assert not {"k_w", "k_h", "num_filt", "ker_sz"} & set(traffic.GNN_FLAGS)
    _, _, _, model, _ = traffic.build_model(cell, torch.device("cpu"))
    cfg = cell.config
    conve = model.conve
    assert (conve.k_w, conve.k_h, conve.num_filt, conve.ker_sz) == (
        cfg["k_w"], cfg["k_h"], cfg["num_filt"], cfg["ker_sz"])
    assert model.gnn[0].opn == "corr"
    shapes = cell.reference.PARAMS(cfg)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(v) for k, v in shapes.items()}
    full = harness.Cell.load(CELL, 3, "cpu").config
    n = sum(math.prod(s) for s in cell.reference.PARAMS(full).values())
    assert n == 9_461_884  # the configuration's "deployment": 9.46 M


# ------------------------------ traffic and check ------------------------------


def test_the_reference_follows_the_program(session):
    cell, s = session
    numbers = s.check()
    assert verdict(cell, numbers), numbers


def test_control_and_fault_fail(session):
    cell, s = session
    ref = s.reference_steps(protocol.Arith("float64"))
    for got in (s.reference_steps(protocol.Arith("tf32")),
                s.reference_steps(protocol.Arith("float64"), half=True)):
        assert not verdict(cell, s.numbers(*got, ref))


# ------------------------------ readers ------------------------------


def step_trace(t0=10.0):
    """One step's records: its ranges (corr inside encode, decode inside
    loss) and a kernel launched inside each."""
    ranges = [("train.step", t0, 200), ("train.loss", t0 + 5, 80), ("train.encode", t0 + 6, 50),
              ("train.corr", t0 + 8, 10), ("train.corr", t0 + 30, 10),
              ("train.decode", t0 + 60, 20), ("train.backward", t0 + 90, 80),
              ("train.optimizer", t0 + 175, 20)]
    kernels = [("fft_r2c", 9, 12, 4), ("fft_c2r", 31, 31, 3), ("sgemm", 45, 45, 5),
               ("implicit_convolve_sgemm", 62, 62, 6), ("gemm", 70, 70, 7),
               ("elementwise", 100, 100, 8), ("multi_tensor_apply_kernel", 180, 180, 2)]
    host, launches, dev = [], [], []
    for name, ts, dur in ranges:
        host.append(Op("kge." + name, ts, dur, tid=1))
    for i, (name, h, d, dur) in enumerate(kernels, start=1):
        launches.append(Op("cudaLaunchKernel", t0 + h, 1, corr=i, tid=1))
        dev.append(Op(name, t0 + d, dur, corr=i))
    ann = [Op("kgbench.run_epoch", t0 - 5, 300)]
    return Trace(dev, list(dev), launches, sorted(host, key=lambda o: o.ts), ann, 1e-3)


def reading(trace, cell=CELL, device=CARD):
    spans = Spans()
    spans.records = [Span("run_epoch", 0.0, 1.0, {"steps": 1, "profiled": True})]
    info = {"kind": "train", "steps": 100, "wall_s": 1.0, "n_params": 9_461_884,
            "encoder_edges": 544230, "encoder_nodes": 14541}
    return Reading(harness.Cell.load(cell, 1, "cpu"), trace, spans, info, device)


def read(name, r):
    return harness.load_module("metrics", name).read(r)


def test_readers_split_corr_and_decode():
    r = reading(step_trace())
    assert read("train.corr_busy_ms", r) == pytest.approx(7e-3)  # 4 + 3 us
    assert read("train.decode_busy_ms", r) == pytest.approx(13e-3)  # 6 + 7 us
    assert read("train.encode_busy_ms", r) == pytest.approx(5e-3)  # outside the corr ranges
    assert read("train.loss_busy_ms", r) == 0.0


def test_mfu_is_the_frozen_bound_over_the_wall_time_a_step():
    r = reading(step_trace())
    f32, nbytes = roofline_conve.conve_step_work(544230, 14541, 474, [100, 200], 128,
                                                 9_461_884, 10, 20, 200, 7)
    assert read("gnn_conve.mfu", r) == pytest.approx(
        100 * roofline.bound_ms(r.peaks, nbytes, f32) / 10.0)


def test_new_readers_read_nothing_off_the_card_without_ranges_or_in_other_cells():
    t = step_trace()
    assert all(read(m, reading(t, device="cpu")) is None for m in NEW)
    assert all(read(m, reading(None)) is None for m in NEW[:2])  # the mfu reads the window
    no_ranges = Trace(t.device_ops, t.kernels, t.launches,
                      [o for o in t.host_ops if not o.name.startswith("kge.")], t.annotations,
                      t.wall_s)
    assert all(read(m, reading(no_ranges)) is None for m in NEW[:2])
    assert read("gnn_conve.mfu", reading(t, cell="compgcn-wn18rr.train")) is None


# ------------------------------ frozen counts ------------------------------


def test_counts_by_hand_at_a_small_size():
    """e 40 edges, n 10 nodes, r 4 relations, widths 8 -> 8, b 2 queries,
    ConvE k_w 2, k_h 4, 3 filters of 3 x 3, p 50 parameters."""
    e, n, r, d, h, b, p = 40, 10, 4, 8, 8, 2, 50
    corr = 3 * 2.5 * 8 * 3 + 6 * 5  # three real FFTs of 8, 5 conjugate products
    assert roofline_conve.corr_ops(8) == corr
    oh, ow, flat = 2, 2, 12
    assert roofline_conve.conve_shape(2, 4, 3, 3) == (oh, ow, flat)
    encoder = 3 * (6 * n * d * h + 2 * r * d * h) + 2 * (2 * e * d + 10 * n * h) \
        + 3 * (e + n) * corr
    decoder = 3 * (2 * b * 3 * oh * ow * 9 + 2 * b * flat * h) + 2 * 10 * b * (2 * h + flat + h)
    scores = 3 * 2 * b * n * h + 2 * b * n + 15 * b * n
    f32, nbytes = roofline_conve.conve_step_work(e, n, r, [d, h], b, p, 2, 4, 3, 3)
    assert f32 == pytest.approx(encoder + decoder + scores + 13 * p)
    adam = (7 + 1) * 4 * p  # Adam's seven passes and the gradient's write
    assert nbytes == pytest.approx(8 * (n * d + 3 * e + n * h) + 8 * (flat * h + b * flat + b * h)
                                   + 8 * (n * h + b * n) + adam)


def test_the_step_bound_at_the_configuration():
    peaks = roofline.peak_rates(CARD)
    f32, nbytes = roofline_conve.conve_step_work(544230, 14541, 474, [100, 200], 128,
                                                 9_461_884, 10, 20, 200, 7)
    assert f32 / peaks[0] > nbytes / peaks[1]  # compute-bound
    assert roofline.bound_ms(peaks, nbytes, f32) == pytest.approx(0.3645, abs=1e-3)
