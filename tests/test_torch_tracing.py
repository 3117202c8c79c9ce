"""The port's phase ranges (utils/profiling.py::span) on the CPU.

With no profiler recording, span() is the one shared no-op and nothing
builds a profiler range.  Under torch.profiler, every Trainer.train_step is
a range kge.train.step holding kge.train.loss, kge.train.backward and (on
the steps that apply gradients) kge.train.optimizer, in that order; every
fused ranker call is a range kge.rank.call holding kge.rank.queries,
kge.rank.filter and kge.rank.sweep.  The ranges are operators of the
Chrome trace (category cpu_op) on its clock: the aten operators each phase
runs lie inside its interval.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from complexhyperbolickge_torch.data.dataset import epoch_batches, synthetic_kg
from complexhyperbolickge_torch.kernels.chyp_rank import ChypRanker
from complexhyperbolickge_torch.kernels.hyp_rank import HypRanker
from complexhyperbolickge_torch.models import ModelConfig, get_model
from complexhyperbolickge_torch.train.trainer import TrainConfig, Trainer
from complexhyperbolickge_torch.utils import profiling

N_ENTITIES = 40
TRAIN_PHASES = ["kge.train.loss", "kge.train.backward", "kge.train.optimizer"]
RANK_PHASES = ["kge.rank.queries", "kge.rank.filter", "kge.rank.sweep"]


@pytest.fixture(scope="module")
def kg():
    return synthetic_kg(n_entities=N_ENTITIES, n_relations=3, n_train=90, n_valid=10,
                        n_test=20, seed=2)


def model_of(kg, name):
    n_ent, n_rel, _ = kg.get_shape()
    return get_model(name)(ModelConfig(n_entities=n_ent, n_relations=n_rel, rank=4,
                                       bias="learn", multi_c=True),
                           generator=torch.Generator().manual_seed(0))


def trainer_of(kg, update_steps=1):
    n_ent, n_rel, _ = kg.get_shape()
    cfg = TrainConfig(optimizer="Adam", learning_rate=1e-2, batch_size=64,
                      update_steps=update_steps, neg_sample_size=4)
    trainer = Trainer(model_of(kg, "FFTRotH"), cfg, n_ent, n_rel)
    batches, weights, _ = epoch_batches(kg.get_examples("train"), 64,
                                        np.random.default_rng(0))
    assert len(batches) == 3
    return trainer, batches, weights


def rank_inputs(kg):
    pack = kg.eval_pack("test", "rhs")
    return (torch.as_tensor(pack.queries[:8], dtype=torch.int64),
            torch.as_tensor(pack.filter_idx[:8], dtype=torch.int64))


def operators(prof, tmp_path):
    """The trace's cpu_op events (name, ts, end) in time order, read back
    from its Chrome export."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ops = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    return sorted(ops, key=lambda o: o[1])


def inside(op, outer):
    return outer[1] <= op[1] and op[2] <= outer[2]


def children(ops, parent_name, phases):
    """For each range parent_name, the phase ranges inside it, in order."""
    parents = [o for o in ops if o[0] == parent_name]
    return [[o for o in ops if o[0] in phases and inside(o, p)] for p in parents]


def assert_in_order(held, names):
    assert [o[0] for o in held] == names
    assert all(a[2] <= b[1] for a, b in zip(held, held[1:]))


def test_span_is_the_shared_no_op_without_a_profiler(kg, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was built with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("train.step") is profiling._OFF
    trainer, batches, weights = trainer_of(kg)
    assert np.isfinite(trainer.run_epoch(batches, weights, torch.Generator().manual_seed(1)))
    q, f = rank_inputs(kg)
    ranks = ChypRanker(trainer.model)(q, f)
    assert ranks.shape == (8,) and bool((ranks >= 1).all())


@pytest.mark.parametrize("update_steps,debug_nans", [(1, False), (2, False), (1, True)])
def test_train_step_ranges_nest_in_order(kg, tmp_path, monkeypatch, update_steps, debug_nans):
    trainer, batches, weights = trainer_of(kg, update_steps)
    monkeypatch.setattr(trainer, "debug_nans", debug_nans)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.run_epoch(batches, weights, torch.Generator().manual_seed(1))
    held = children(operators(prof, tmp_path), "kge.train.step", TRAIN_PHASES)
    assert len(held) == 3
    # update_steps 2: batch 2 applies, and batch 3 as the epoch's last
    applies = [True] * 3 if update_steps == 1 else [False, True, True]
    for step, apply in zip(held, applies):
        assert_in_order(step, TRAIN_PHASES if apply else TRAIN_PHASES[:2])


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("model_name,ranker_cls", [("FFTRotH", ChypRanker),
                                                   ("RotH", HypRanker)])
def test_ranker_call_ranges_nest_in_order(kg, tmp_path, model_name, ranker_cls, masked):
    ranker = ranker_cls(model_of(kg, model_name), masked=masked)
    q, f = rank_inputs(kg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            ranker(q, f)
    held = children(operators(prof, tmp_path), "kge.rank.call", RANK_PHASES)
    assert len(held) == 2
    for call in held:
        assert_in_order(call, RANK_PHASES)


def test_phase_ranges_hold_their_aten_operators_on_the_trace_clock(kg, tmp_path):
    """Every aten operator that starts inside a phase's range ends inside
    it, each phase runs some, and the masked filter's scatter lies in the
    filter phase alone."""
    trainer, batches, weights = trainer_of(kg)
    ranker = ChypRanker(trainer.model, masked=True)
    q, f = rank_inputs(kg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.run_epoch(batches, weights, torch.Generator().manual_seed(1))
        ranker(q, f)
    ops = operators(prof, tmp_path)
    aten = [o for o in ops if o[0].startswith("aten::")]
    for name in TRAIN_PHASES + RANK_PHASES:
        ranges = [o for o in ops if o[0] == name]
        assert ranges, name
        for r in ranges:
            started = [a for a in aten if r[1] <= a[1] <= r[2]]
            assert started and all(a[2] <= r[2] for a in started), name
    scatter = [a for a in aten if a[0] == "aten::scatter_"]
    assert scatter
    for name in RANK_PHASES:
        r = next(o for o in ops if o[0] == name)
        assert all(inside(a, r) == (name == "kge.rank.filter") for a in scatter)
