"""What decides `correct`, on the CPU at the tiny size: the program's
plain path against the plain reference passes under the cells' limits;
the control (the reference with TF32 contractions in the program's place)
and each fault a cell can have, planted in the program under the window,
come out not correct."""

import pytest
import torch

from kgbench import harness
from kgbench.reference import protocol
from kgbench.trace import Spans

TRAIN = ["fftroth-wn18rr.train", "roth-wn18rr.train"]
RANK = ["fftroth-wn18rr.rank", "roth-wn18rr.rank"]


def run(tiny_dir, name, seed=11, seconds=0.3):
    cell = harness.Cell.load(name, seed, "cpu", [tiny_dir])
    s = harness.load_module("traffic", cell.traffic).Session(cell, Spans())
    s.window(seconds)
    s.free()
    return cell, s


def verdict(cell, numbers):
    return harness.check_lines(numbers, cell.limits)[0]


@pytest.mark.parametrize("name", TRAIN + RANK)
def test_sound_run_is_correct(tiny_dir, name):
    cell, s = run(tiny_dir, name)
    assert verdict(cell, s.check())


@pytest.mark.parametrize("name", TRAIN)
def test_train_control_fails(tiny_dir, name):
    cell, s = run(tiny_dir, name)
    ref = s.reference_steps(protocol.Arith("float64"))
    ctrl = s.numbers(*s.reference_steps(protocol.Arith("tf32")), ref)
    assert not verdict(cell, ctrl)


@pytest.mark.parametrize("name", RANK)
def test_rank_control_fails(tiny_dir, name):
    cell, s = run(tiny_dir, name)
    ctrl = s.numbers([(s.control_ranks(protocol.Arith("tf32")), None)])
    assert not verdict(cell, {k: ctrl[k] for k in cell.limits})


@pytest.mark.parametrize("name", TRAIN)
def test_step_that_leaves_the_state_unchanged_fails(tiny_dir, name, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    cell, s = run(tiny_dir, name)
    assert not verdict(cell, s.check())


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch_left_out_fails(tiny_dir, name, monkeypatch):
    from complexhyperbolickge_torch.train.trainer import Trainer

    inner = Trainer._local_loss

    def half(self, batch, weights, *a, **k):
        weights = weights.clone()
        weights[batch.shape[0] // 2:] = 0  # the mean over the rest
        return inner(self, batch, weights, *a, **k)

    monkeypatch.setattr(Trainer, "_local_loss", half)
    cell, s = run(tiny_dir, name)
    assert not verdict(cell, s.check())


@pytest.mark.parametrize("name", TRAIN)
def test_altered_loss_fails(tiny_dir, name, monkeypatch):
    from complexhyperbolickge_torch.train.trainer import Trainer

    inner = Trainer.run_epoch
    monkeypatch.setattr(Trainer, "run_epoch", lambda self, *a, **k: inner(self, *a, **k) * 1.01)
    cell, s = run(tiny_dir, name)
    assert not verdict(cell, s.check())


@pytest.mark.parametrize("name", RANK)
def test_altered_answer_fails(tiny_dir, name, monkeypatch):
    from complexhyperbolickge_torch.kernels._ranker import FusedRanker

    inner = FusedRanker.__call__

    def altered(self, q, fidx):
        ranks = inner(self, q, fidx).clone()
        ranks[0] += 1  # one answer a call, where it is produced
        return ranks

    monkeypatch.setattr(FusedRanker, "__call__", altered)
    cell, s = run(tiny_dir, name)
    assert not verdict(cell, s.check())
