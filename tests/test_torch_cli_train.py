"""The port's training entry point (cli/run.py::train) on the CPU.

A tiny synthetic KG trains end to end; a run stopped after epoch 1 and
resumed equals a continuous run bit for bit (shuffles and negatives derive
from (seed, epoch), the optimizer state rides in the checkpoint); SIGTERM
finishes the epoch and writes latest.pkl; the port-trained checkpoint
evaluates through the port's kge-test and the JAX package's, which agree
within 1e-4 in MRR (the port ranks with K1's plain version, JAX with its
dense ranker).  The same for the GNN path: a CompGCN run trains and
resumes, and GNN run dirs cross between the packages both ways.
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
                                  ["--debug_nans"], ["--distributed"]])
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


# ------------------------- RotH, the real-hyperbolic family ---------------------

ROTH = [a for a in TINY if a not in ("FFTRotH", "5")]
ROTH[ROTH.index("--model") + 1:ROTH.index("--model") + 1] = ["RotH"]
ROTH[ROTH.index("--rank") + 1:ROTH.index("--rank") + 1] = ["8"]
ROTH += ["--double_neg"]


def test_roth_trains_and_evaluates_on_cpu(tmp_path):
    """RotH (Poincare ball, double_neg) trains end to end through the
    model-generic trainer; validation and kge-test rank through K5's plain
    version."""
    out = R.train(R.build_parser().parse_args(ROTH + ["--save_dir", str(tmp_path),
                                                      "--max_epochs", "2"]))
    losses = [h["train_loss"] for h in out["history"]]
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    assert 0.0 < out["test"]["MRR"] <= 1.0
    assert torch_test(str(tmp_path), device="cpu") == out["test"]


@pytest.fixture(scope="module")
def jax_roth_dir(tmp_path_factory):
    """A RotH run dir as the JAX trainer writes it (f64 params, optax Adam)."""
    import jax
    import optax

    from complexhyperbolickge_tpu.cli.run import build_model, build_parser, load_dataset
    from complexhyperbolickge_tpu.train import checkpoint as jax_ckpt

    path = tmp_path_factory.mktemp("jax_roth")
    args = build_parser().parse_args([
        "--dataset", "synthetic", "--synthetic_entities", "120", "--model", "RotH",
        "--rank", "8", "--bias", "learn", "--multi_c", "--dtype", "float64",
        "--eval_batch_size", "64", "--eval_backend", "dense"])
    model = build_model(args, load_dataset(args))
    rng = np.random.default_rng(11)
    params = {k: jax.numpy.asarray(rng.normal(0, 0.3, np.shape(v)) + (k == "c"))
              for k, v in model.init(jax.random.PRNGKey(0)).items()}
    jax_ckpt.save_checkpoint(str(path), params, optax.adam(1e-3).init(params), epoch=2,
                             best_mrr=0.1, config={"args": vars(args)})
    return str(path)


def test_kge_test_of_jax_roth_checkpoint_equals_jax(jax_roth_dir):
    """Both packages rank a JAX-written RotH checkpoint with the dense ranker
    in f64: identical metrics; the fused rankers' plain versions (K5, K6)
    agree within 1e-4 in MRR."""
    want = jax_test(jax_roth_dir)
    got = torch_test(jax_roth_dir, device="cpu")
    assert abs(got["MRR"] - want["MRR"]) <= 1e-9
    assert got["MR"] == pytest.approx(want["MR"], abs=1e-9)
    np.testing.assert_allclose(got["hits@[1,3,10]"], want["hits@[1,3,10]"], atol=1e-9)
    for backend in ("auto", "pallas_maskless"):
        fused = torch_test(jax_roth_dir, device="cpu", eval_backend=backend)
        assert abs(fused["MRR"] - got["MRR"]) < 1e-4


# ------------------------------- GNN: CompGCN ----------------------------------

GNN = [a for a in TINY if a not in ("FFTRotH", "5")]
GNN[GNN.index("--model") + 1:GNN.index("--model") + 1] = ["CompGCN"]
GNN[GNN.index("--rank") + 1:GNN.index("--rank") + 1] = ["8"]
GNN += ["--hidden_dim", "8", "--edge_dropout", "0.3"]


@pytest.fixture(scope="module")
def gnn_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("compgcn")
    return d, R.train(R.build_parser().parse_args(GNN + ["--save_dir", str(d),
                                                         "--max_epochs", "2"]))


def test_compgcn_trains_and_evaluates_on_cpu(gnn_run):
    """CompGCN trains through cli.run on the full graph (edge dropout 0.3):
    the loss falls, validation ranks densely over the cached encoding, and
    kge-test of the run dir repeats the final metrics."""
    d, out = gnn_run
    losses = [h["train_loss"] for h in out["history"]]
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    assert 0.0 < out["test"]["MRR"] <= 1.0
    assert torch_test(str(d), device="cpu") == out["test"]
    with pytest.raises(NotImplementedError, match="dense"):
        torch_test(str(d), device="cpu", eval_backend="pallas")


def test_port_gnn_checkpoint_evaluates_in_jax(gnn_run):
    """JAX's load_checkpoint validates the port's nested GNN params against
    its own model's tree, and its kge-test ranks them as the port does."""
    d, out = gnn_run
    want = jax_test(str(d))
    assert abs(want["MRR"] - out["test"]["MRR"]) < 1e-9
    np.testing.assert_allclose(want["hits@[1,3,10]"], out["test"]["hits@[1,3,10]"], atol=1e-9)


def test_gnn_resume_equals_continuous_run(gnn_run, tmp_path):
    _, out = gnn_run
    R.train(R.build_parser().parse_args(GNN + ["--save_dir", str(tmp_path), "--max_epochs", "1"]))
    resumed = R.train(R.build_parser().parse_args(
        GNN + ["--save_dir", str(tmp_path), "--max_epochs", "2", "--resume"]))
    assert resumed["history"][0]["train_loss"] == out["history"][1]["train_loss"]
    assert resumed["test"] == out["test"]


@pytest.fixture(scope="module")
def jax_gnn_dir(tmp_path_factory):
    """A CompGCN run dir as the JAX trainer writes it: f64 params after two
    Adam steps, with its optax state."""
    import jax

    from complexhyperbolickge_tpu.cli.run import build_model, build_parser, load_dataset
    from complexhyperbolickge_tpu.data.dataset import epoch_batches
    from complexhyperbolickge_tpu.train import checkpoint as jax_ckpt
    from complexhyperbolickge_tpu.train.trainer import TrainConfig, Trainer

    path = tmp_path_factory.mktemp("jax_compgcn")
    args = build_parser().parse_args([
        "--dataset", "synthetic", "--synthetic_entities", "60", "--model", "CompGCN",
        "--rank", "8", "--hidden_dim", "8", "--bias", "learn", "--multi_c", "--dtype",
        "float64", "--eval_batch_size", "64", "--eval_backend", "dense",
        "--optimizer", "Adam", "--neg_sample_size", "4"])
    dataset = load_dataset(args)
    model = build_model(args, dataset)
    rng = np.random.default_rng(11)
    params = jax.tree.map(lambda v: jax.numpy.asarray(np.asarray(v) + rng.normal(0, 0.3, np.shape(v))),
                          model.init(jax.random.PRNGKey(0)))
    n_ent, n_rel, _ = dataset.get_shape()
    trainer = Trainer(model, TrainConfig(learning_rate=1e-2, batch_size=256, neg_sample_size=4),
                      n_ent, n_rel)
    b, w, _ = epoch_batches(dataset.get_examples("train")[:512], 256, np.random.default_rng(0))
    params, opt_state, _ = trainer.run_epoch(params, trainer.tx.init(params), b, w,
                                             jax.random.PRNGKey(1))
    jax_ckpt.save_checkpoint(str(path), params, opt_state, epoch=2, best_mrr=0.1,
                             config={"args": vars(args)})
    return str(path)


def test_kge_test_and_serve_of_jax_gnn_checkpoint(jax_gnn_dir):
    """The port's kge-test of a JAX-written CompGCN dir equals JAX's (dense
    ranker, f64); the port's server loads it and its top-1 is the argmax of
    the dense scores; opt_state_from_jax keys its nested optax state by the
    port's dotted names."""
    import torch

    from complexhyperbolickge_torch.cli.serve import PredictService

    want = jax_test(jax_gnn_dir)
    got = torch_test(jax_gnn_dir, device="cpu")
    assert abs(got["MRR"] - want["MRR"]) <= 1e-9
    assert got["MR"] == pytest.approx(want["MR"], abs=1e-9)
    np.testing.assert_allclose(got["hits@[1,3,10]"], want["hits@[1,3,10]"], atol=1e-9)

    svc = PredictService(jax_gnn_dir, k=5, batch=8, device="cpu")
    q = [[0, 1], [5, 3], [17, 0]]
    with torch.no_grad():
        dense = svc.model.score_all(torch.as_tensor(q))
    assert [r["tails"][0] for r in svc.predict(q)] == dense.argmax(1).tolist()

    st = load_checkpoint(jax_gnn_dir)
    from complexhyperbolickge_torch.train.checkpoint import opt_state_from_jax

    conv = opt_state_from_jax(st["opt_state"])
    assert "gnn.0.w_in" in conv["state"] and "entity" in conv["state"]
    assert conv["state"]["gnn.1.bn_scale"]["exp_avg"].shape == (8,)
