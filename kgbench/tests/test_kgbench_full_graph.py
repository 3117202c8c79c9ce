"""The full-graph GNN cell compgcn-wn18rr.train on the CPU: its traffic
kind (train_full_graph) at a cut size (2,000 entities, 4,000 triples,
batch 64, the configuration's widths), what decides its `correct`, its
four new readers on synthetic trace records, its frozen counts, and its
configuration's and entries' layout."""

import json

import pytest
import torch

from conftest import ROOT
from kgbench import harness, roofline, roofline_gnn
from kgbench.metrics_api import Reading
from kgbench.reference import protocol
from kgbench.trace import Op, Span, Spans, Trace

CELL, CONFIG = "compgcn-wn18rr.train", "compgcn-wn18rr"
CUT = dict(entities=2000, train_triples=4000, valid_triples=100, test_triples=100,
           batch_size=64)
CARD = "NVIDIA H100 80GB HBM3"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ["train.encode_busy_ms", "train.rel_grad_busy_ms", "k9k10.roofline_share", "gnn.mfu"]


@pytest.fixture(scope="module")
def cut_dir(tmp_path_factory):
    """The cell's configuration and workload files at the cut size, which
    harness.Cell.load(..., dirs=[it]) finds first."""
    d = tmp_path_factory.mktemp("full_graph")
    for kind, name in (("configs", CONFIG), ("workloads", CELL)):
        (d / kind).mkdir()
        spec = harness.load_json(kind, name)
        if kind == "configs":
            spec.update(CUT)
        (d / kind / f"{name}.json").write_text(json.dumps(spec))
    return d


def run(cut_dir, seed=11, seconds=0.3):
    cell = harness.Cell.load(CELL, seed, "cpu", [cut_dir])
    s = harness.load_module("traffic", cell.traffic).Session(cell, Spans())
    w = s.window(seconds)
    s.free()
    return cell, s, w


def verdict(cell, numbers):
    return harness.check_lines(numbers, cell.limits)[0]


# ------------------------------ traffic and check ------------------------------


def test_sound_run_is_correct_and_counts_examples(cut_dir):
    cell, s, w = run(cut_dir)
    assert verdict(cell, s.check())
    info = w["info"]
    assert info["encoder_edges"] == 2 * CUT["train_triples"]
    assert info["encoder_nodes"] == CUT["entities"]
    assert 0 < info["examples"] <= info["steps"] * CUT["batch_size"]
    assert w["end_to_end"]["train_triples_per_s"] == pytest.approx(
        info["examples"] / info["wall_s"])
    assert w["attempted"] == info["steps"] and w["failed"] == 0


def test_the_window_crosses_epochs_with_their_label_rows(cut_dir):
    cell = harness.Cell.load(CELL, 11, "cpu", [cut_dir])
    s = harness.load_module("traffic", cell.traffic).Session(cell, Spans())
    s.pos = s.nb - 1
    s.window(0.0)  # the epoch's last batch
    s.window(0.0)  # the next epoch's first slice
    assert s.epoch == 1 and s.pos == min(32, s.nb) and s.lab.shape[:2] == s.b.shape[:2]


@pytest.mark.parametrize("mode", ["control_tf32", "fault_half"])
def test_control_and_reference_fault_fail(cut_dir, mode):
    cell, s, _ = run(cut_dir)
    ref = s.reference_steps(protocol.Arith("float64"))
    got = (s.reference_steps(protocol.Arith("tf32")) if mode == "control_tf32"
           else s.reference_steps(protocol.Arith("float64"), half=True))
    assert not verdict(cell, s.numbers(*got, ref))


def test_step_that_leaves_the_state_unchanged_fails(cut_dir, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    cell, s, _ = run(cut_dir)
    assert not verdict(cell, s.check())


def test_half_the_batch_left_out_fails(cut_dir, monkeypatch):
    from complexhyperbolickge_torch.train.trainer import Trainer

    inner = Trainer._local_loss

    def half(self, batch, weights, *a, **k):
        weights = weights.clone()
        weights[batch.shape[0] // 2:] = 0  # the mean over the rest
        return inner(self, batch, weights, *a, **k)

    monkeypatch.setattr(Trainer, "_local_loss", half)
    cell, s, _ = run(cut_dir)
    assert not verdict(cell, s.check())


def test_altered_loss_fails(cut_dir, monkeypatch):
    from complexhyperbolickge_torch.train.trainer import Trainer

    inner = Trainer.run_epoch
    monkeypatch.setattr(Trainer, "run_epoch", lambda self, *a, **k: inner(self, *a, **k) * 1.01)
    cell, s, _ = run(cut_dir)
    assert not verdict(cell, s.check())


def test_labels_left_out_fail(cut_dir, monkeypatch):
    from complexhyperbolickge_torch.train.trainer import Trainer

    inner = Trainer.run_epoch
    monkeypatch.setattr(Trainer, "run_epoch",
                        lambda self, b, w, g, labels=None, **k: inner(self, b, w, g, None, **k))
    cell, s, _ = run(cut_dir)
    assert not verdict(cell, s.check())


# ------------------------------ readers ------------------------------


def step_trace(t0=10.0):
    """One step's records: its program ranges, kernels launched inside them
    (backward ones from autograd's thread), each with its runtime call."""
    ranges = [("train.step", t0, 200), ("train.loss", t0 + 5, 80), ("train.encode", t0 + 6, 50),
              ("train.backward", t0 + 90, 80), ("train.rel_grad", t0 + 100, 30),
              ("train.optimizer", t0 + 175, 20)]
    kernels = [  # name, host launch, device start, duration, thread
        ("void (anonymous namespace)::row_gather_kernel<float4>(...)", 10, 12, 4, 1),
        ("void (anonymous namespace)::segsum_kernel<float4>(...)", 20, 22, 6, 1),
        ("sgemm", 40, 40, 5, 1),  # in encode
        ("elementwise", 70, 70, 3, 1),  # the loss, outside encode
        ("void (anonymous namespace)::indexing_backward_kernel<float, 4>(...)", 105, 105, 20, 2),
        ("void (anonymous namespace)::row_gather_kernel<float4>(...)", 140, 140, 7, 2),
        ("void (anonymous namespace)::segsum_kernel<float4>(...)", 150, 150, 8, 2),
        ("multi_tensor_apply_kernel", 180, 180, 2, 1)]
    host, launches, dev = [], [], []
    for name, ts, dur in ranges:
        host.append(Op("kge." + name, ts, dur, tid=1))
    for i, (name, h, d, dur, tid) in enumerate(kernels, start=1):
        launches.append(Op("cudaLaunchKernel", t0 + h, 1, corr=i, tid=tid))
        dev.append(Op(name, t0 + d, dur, corr=i))
    ann = [Op("kgbench.run_epoch", t0 - 5, 300)]
    return Trace(dev, list(dev), launches, sorted(host, key=lambda o: o.ts), ann, 1e-3)


def reading(trace, cell=CELL, device=CARD, info=None):
    spans = Spans()
    spans.records = [Span("run_epoch", 0.0, 1.0, {"steps": 1, "profiled": True})]
    info = info or {"kind": "train", "steps": 100, "wall_s": 2.0, "n_params": 4_258_886,
                    "encoder_edges": 173670, "encoder_nodes": 40943}
    return Reading(harness.Cell.load(cell, 1, "cpu"), trace, spans, info, device)


def read(name, r):
    return harness.load_module("metrics", name).read(r)


def test_phase_readers_split_encode_and_relation_gradient():
    r = reading(step_trace())
    assert read("train.encode_busy_ms", r) == pytest.approx(15e-3)  # 4 + 6 + 5 us
    assert read("train.rel_grad_busy_ms", r) == pytest.approx(20e-3)
    assert read("train.loss_busy_ms", r) == pytest.approx(3e-3)
    assert read("train.backward_busy_ms", r) == pytest.approx(15e-3)


def test_k9k10_share_is_the_frozen_bound_over_the_kernels_time():
    r = reading(step_trace())
    launches = roofline_gnn.k9k10_launches(173670, 40943, [100, 200])
    bound = sum(roofline.bound_ms(r.peaks, b) for _, b in launches)
    us = 4 + 6 + 7 + 8  # the four K9 / K10 kernels of the step
    assert read("k9k10.roofline_share", r) == pytest.approx(100 * bound / (us / 1e3))


def test_gnn_mfu_is_the_step_bound_over_the_wall_time_a_step():
    r = reading(step_trace())
    f32, nbytes = roofline_gnn.compgcn_step_work(173670, 40943, 22, [100, 200], 128, 4_258_886)
    assert read("gnn.mfu", r) == pytest.approx(100 * roofline.bound_ms(r.peaks, nbytes, f32)
                                               / 20.0)


def test_new_readers_read_nothing_off_the_card_without_ranges_or_in_other_cells():
    t = step_trace()
    assert all(read(m, reading(t, device="cpu")) is None for m in NEW)
    assert all(read(m, reading(None)) is None for m in NEW[:3])  # gnn.mfu reads the window
    no_ranges = Trace(t.device_ops, t.kernels, t.launches,
                      [o for o in t.host_ops if not o.name.startswith("kge.")], t.annotations,
                      t.wall_s)
    r = reading(no_ranges)
    assert read("train.encode_busy_ms", r) is None and read("train.rel_grad_busy_ms", r) is None
    assert read("k9k10.roofline_share", r) is not None  # kernels are matched by name
    other = reading(t, cell="fftroth-wn18rr.train")  # the counts are the GNN family's
    assert read("k9k10.roofline_share", other) is None and read("gnn.mfu", other) is None


# ------------------------------ frozen counts ------------------------------


def test_k9k10_counts_twelve_launches_a_layer_in_the_chip_smoke_convention():
    launches = roofline_gnn.k9k10_launches(173670, 40943, [100, 200])
    assert [k for k, _ in launches].count("K9") == 6 and len(launches) == 12
    # K9: messages, CSR offsets and rows once; K10: the distinct rows read,
    # the ids and the gathered rows once (chip_smoke.py's kernel table)
    assert roofline_gnn.k9_bytes(86835, 40943, 100) == 4 * (86835 * 100 + 40944 + 40943 * 100)
    rows = roofline.distinct_expected(40943, 86835)
    assert roofline_gnn.k10_bytes(86835, rows, 100) == pytest.approx(
        4 * (rows * 100 + 86835 + 86835 * 100))
    two = roofline_gnn.k9k10_launches(173670, 40943, [100, 200, 200])
    assert len(two) == 24


def test_step_bound_is_compute_bound_at_the_configuration():
    peaks = roofline.peak_rates(CARD)
    f32, nbytes = roofline_gnn.compgcn_step_work(173670, 40943, 22, [100, 200], 128, 4_258_886)
    assert f32 / peaks[0] > nbytes / peaks[1]
    assert roofline.bound_ms(peaks, nbytes, f32) == pytest.approx(0.320, abs=1e-3)


# ------------------------------ layout ------------------------------


def test_configuration_states_its_source_cuts_and_departures():
    cfg = harness.load_json("configs", CONFIG)
    entry = {c["name"]: c for c in BENCH["configs"]}[CONFIG]
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    assert (cfg["model"], cfg["family"], cfg["rank"], cfg["hidden_dim"], cfg["layers"]) == (
        "CompGCN", "gnn", 100, 200, 1)
    assert (cfg["opn"], cfg["interaction"], cfg["basis"], cfg["batch_size"]) == (
        "mult", "distmult", 0, 128)
    assert (cfg["loss"], cfg["smoothing"], cfg["neg_sample_size"]) == (
        "binarycrossentropy", 0.1, 0)
    assert (cfg["entities"], cfg["relations"], cfg["train_triples"]) == (40943, 11, 86835)
    width = ("dim", "rank", "hidden", "size", "head", "factor")
    assert not any(w in k for k in cfg["reduced"] for w in width if k != "batch_size")
    assert set(cfg["reduced"]) <= set(cfg["assumed"])
    ref = harness.load_module("reference", CONFIG)
    shapes = ref.PARAMS(dict(cfg, n_entities=40943, n_relations=22))
    assert sum(torch.Size(s).numel() for s in shapes.values()) == 4_258_886


def test_entries_list_the_cell_where_it_reports():
    cell = {w["name"]: w for w in BENCH["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (CONFIG, "train_full_graph", 1)
    assert BENCH["workloads"][-1]["name"] == CELL and BENCH["configs"][-1]["name"] == CONFIG
    e2e = [m["name"] for m in harness.cell_metrics(BENCH, CELL, "end_to_end")]
    assert e2e == ["train_triples_per_s", "setup_s"]
    per = {m["name"] for m in harness.cell_metrics(BENCH, CELL, "per_layer")}
    shared = {"train.step_busy_ms", "train.launches_per_step", "train.device_idle_share"} | {
        f"train.{p}_{k}_ms" for p in ("loss", "backward", "optimizer") for k in ("busy", "idle")}
    assert per == shared | set(NEW)
    assert [m["name"] for m in BENCH["per_layer"][-4:]] == NEW
    w = harness.load_json("workloads", CELL)
    assert w["params"] == {"slice_steps": 32, "checked_steps": 3, "trace_at": 0.4,
                           "trace_steps": 10}
