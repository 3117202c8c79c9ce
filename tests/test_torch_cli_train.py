"""The port's training entry point (cli/run.py::train) on the CPU.

A tiny synthetic KG trains end to end; a run stopped after epoch 1 and
resumed equals a continuous run bit for bit (shuffles and negatives derive
from (seed, epoch), the optimizer state rides in the checkpoint); SIGTERM
finishes the epoch and writes latest.pkl; the port-trained checkpoint
evaluates through the port's kge-test and the JAX package's, which agree
within 1e-4 in MRR (the port ranks with K1's plain version, JAX with its
dense ranker).
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from complexhyperbolickge_torch.cli import run as R
from complexhyperbolickge_torch.cli.test import test as torch_test
from complexhyperbolickge_torch.train.checkpoint import load_checkpoint
from complexhyperbolickge_tpu.cli.test import test as jax_test

ROOT = Path(__file__).resolve().parents[1]
# the synthetic split sizes stay at their defaults: the JAX package's
# load_dataset reads only --synthetic_entities
TINY = ["--dataset", "synthetic", "--synthetic_entities", "60", "--model", "FFTRotH",
        "--rank", "5", "--batch_size", "256", "--eval_batch_size", "128",
        "--neg_sample_size", "4", "--optimizer", "Adam", "--learning_rate", "0.01",
        "--bias", "learn", "--multi_c", "--dtype", "float64", "--valid", "1",
        "--device", "cpu", "--seed", "3"]


def run(save_dir, *extra):
    return R.train(R.build_parser().parse_args(TINY + ["--save_dir", str(save_dir), *extra]))


@pytest.fixture(scope="module")
def continuous(tmp_path_factory):
    d = tmp_path_factory.mktemp("continuous")
    return d, run(d, "--max_epochs", "2")


def test_train_runs_and_writes_checkpoints(continuous):
    d, out = continuous
    assert [h["epoch"] for h in out["history"]] == [1, 2]
    assert all(np.isfinite(h["train_loss"]) and h["steps"] == 16 for h in out["history"])
    assert out["history"][1]["train_loss"] < out["history"][0]["train_loss"]
    assert 0.0 < out["test"]["MRR"] <= 1.0
    latest = load_checkpoint(str(d), filename="latest.pkl")
    assert latest["epoch"] == 2 and sorted(latest["opt_state"]) == ["lr", "state"]
    assert (d / "config.json").exists() and (d / "train.log").exists()


def test_resume_equals_continuous_run(continuous, tmp_path):
    d, out = continuous
    run(tmp_path, "--max_epochs", "1")
    resumed = run(tmp_path, "--max_epochs", "2", "--resume")
    assert [h["epoch"] for h in resumed["history"]] == [2]
    assert resumed["history"][0]["train_loss"] == out["history"][1]["train_loss"]
    a = load_checkpoint(str(d), filename="latest.pkl")
    b = load_checkpoint(str(tmp_path), filename="latest.pkl")
    for k, v in a["params"].items():
        np.testing.assert_array_equal(b["params"][k], v)
    assert resumed["test"] == out["test"]


def test_sigterm_finishes_the_epoch_and_writes_latest(tmp_path, monkeypatch):
    real = R.Trainer.run_epoch

    def run_epoch_then_signal(self, *a, **kw):
        os.kill(os.getpid(), signal.SIGTERM)  # lands during the epoch
        return real(self, *a, **kw)

    monkeypatch.setattr(R.Trainer, "run_epoch", run_epoch_then_signal)
    before = signal.getsignal(signal.SIGTERM)
    out = run(tmp_path, "--max_epochs", "3", "--valid", "5")
    assert [h["epoch"] for h in out["history"]] == [1]
    assert load_checkpoint(str(tmp_path), filename="latest.pkl")["epoch"] == 1
    assert "Stopped by signal at epoch 1" in (tmp_path / "train.log").read_text()
    assert signal.getsignal(signal.SIGTERM) is before


def test_port_checkpoint_evaluates_in_both_packages(continuous):
    d, out = continuous
    got = torch_test(str(d), device="cpu")
    assert got == out["test"]
    want = jax_test(str(d))  # the JAX loader reads the port's opt_state too
    assert abs(got["MRR"] - want["MRR"]) < 1e-4


@pytest.mark.parametrize("flag", [["--mesh", "2x2"], ["--subgraph"], ["--profile_dir", "p"],
                                  ["--hidden_dim", "64"], ["--neg_mode", "pool"]])
def test_unported_flags_raise(flag, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run(tmp_path, "--max_epochs", "1", *flag)


def test_module_entry_point_trains_on_cpu(tmp_path):
    args = TINY + ["--save_dir", str(tmp_path), "--max_epochs", "1",
                   "--synthetic_relations", "3"]
    out = subprocess.run([sys.executable, "-m", "complexhyperbolickge_torch.cli.run", *args],
                         cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "Epoch 1 | average train loss" in out.stdout
    assert load_checkpoint(str(tmp_path))["epoch"] == 1
