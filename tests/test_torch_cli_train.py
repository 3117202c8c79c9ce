"""The port's training entry point (cli/run.py::train) on the CPU.

A tiny synthetic KG trains end to end; a run stopped after epoch 1 and
resumed equals a continuous run bit for bit (shuffles and negatives derive
from (seed, epoch), the optimizer state rides in the checkpoint); SIGTERM
finishes the epoch and writes latest.pkl; the port-trained checkpoint
evaluates through the port's kge-test and the JAX package's, which agree
within 1e-4 in MRR (the port ranks with K1's plain version, JAX with its
dense ranker).  The same for the GNN path: a CompGCN run trains and
resumes, and GNN run dirs cross between the packages both ways; with
--subgraph a CompGCN trains on sampled subgraphs and resumes.
--profile_dir writes a trace, --debug_nans stops at the first NaN step,
and --subgraph on a mesh refuses a batch its data axis does not divide.
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


@pytest.mark.parametrize("flag", [["--mesh", "2x1"],
                                  ["--distributed", "--coordinator", "127.0.0.1:1",
                                   "--num_processes", "2", "--process_id", "0"]])
def test_subgraph_batch_the_data_axis_does_not_divide_raises(flag, tmp_path):
    """--subgraph runs on a mesh (tests/test_torch_parallel_subgraph.py);
    a --batch_size that the data axis does not divide is refused before any
    rank starts or joins a group, as JAX's SubgraphTrainer refuses it."""
    with pytest.raises(ValueError, match="'data' axis 2"):
        run(tmp_path, "--max_epochs", "1", "--model", "CompGCN", "--subgraph",
            "--neg_sample_size", "0", "--batch_size", "255", *flag)


def test_only_the_multi_device_flags_are_unported():
    """No flag is refused as unported any more: the port parses every flag
    of the JAX package's command line."""
    from complexhyperbolickge_tpu.cli.run import build_parser as jax_parser

    assert not hasattr(R, "_UNPORTED")
    ours = {o for a in R.build_parser()._actions for o in a.option_strings}
    assert {o for a in jax_parser()._actions for o in a.option_strings} <= ours


@pytest.mark.parametrize("epochs", [1, 2])
def test_profile_dir_traces_one_epoch(tmp_path, epochs):
    """--profile_dir writes one torch.profiler trace: of epoch 2, or of
    epoch 1 when it is the only one, with a kge.train.step range for each
    of that epoch's batches."""
    import json

    out = run(tmp_path / "run", "--max_epochs", str(epochs), "--profile_dir",
              str(tmp_path / "prof"))
    assert len(out["history"]) == epochs
    traces = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    steps = [e for e in events if e.get("name") == "kge.train.step" and e.get("ph") == "X"]
    assert len(steps) == out["history"][-1]["steps"] > 0


@pytest.mark.parametrize("mode", ["full", "subgraph"])
def test_debug_nans_raises_at_the_first_nan_step(tmp_path, monkeypatch, mode):
    """A NaN injected into the third step's loss: --debug_nans raises
    FloatingPointError naming epoch 1, step 3, in the full-graph loop and in
    the subgraph one."""
    from complexhyperbolickge_torch.train.subgraph import SubgraphTrainer

    cls = R.Trainer if mode == "full" else SubgraphTrainer
    real, calls = cls._loss, []

    def nan_at_third(self, *a, **kw):
        calls.append(1)
        loss = real(self, *a, **kw)
        return loss * float("nan") if len(calls) == 3 else loss

    monkeypatch.setattr(cls, "_loss", nan_at_third)
    argv = TINY if mode == "full" else SUBGRAPH
    with pytest.raises(FloatingPointError, match="epoch 1, step 3"):
        R.train(R.build_parser().parse_args(argv + ["--save_dir", str(tmp_path),
                                                    "--max_epochs", "1", "--debug_nans"]))
    assert len(calls) == 3


def test_nan_check_turns_a_nan_gradient_into_floating_point_error():
    import torch

    from complexhyperbolickge_torch.utils.profiling import NanCheck

    x = torch.zeros(3, dtype=torch.float64, requires_grad=True)
    with NanCheck(epoch=4) as check:  # an infinite gradient is not a NaN (as in JAX)
        check.backward((torch.sqrt(x) * 2.0).sum())
    assert torch.isinf(x.grad).all()
    with pytest.raises(FloatingPointError, match="epoch 4, step 1"):
        with NanCheck(epoch=4) as check:
            check.backward((torch.sqrt(x) * 0.0).sum())  # 0 * inf: NaN in the backward


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


# --------------------------- GNN: --subgraph training ---------------------------


@pytest.fixture(scope="module", autouse=True)
def sampler_lib(tmp_path_factory):
    """The port's sampler library, built from source for this module, so
    no test here loads a copy another process may be writing."""
    from complexhyperbolickge_torch.data import sampler as S

    built = S.load_library(S.build_library(tmp_path_factory.mktemp("native")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(S, "_LIB", built)
        yield built


SUBGRAPH = GNN + ["--subgraph", "--neg_sample_size", "0", "--loss", "crossentropy",
                  "--dropout", "0.1"]


@pytest.fixture(scope="module")
def subgraph_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("compgcn_subgraph")
    return d, R.train(R.build_parser().parse_args(SUBGRAPH + ["--save_dir", str(d),
                                                              "--max_epochs", "2"]))


def test_subgraph_compgcn_trains_and_evaluates_on_cpu(subgraph_run):
    """--subgraph trains CompGCN on sampled subgraphs (edge dropout 0.3,
    dropout 0.1): every directed train edge seeds once an epoch (4,000
    edges in batches of 256: 16 steps), the loss falls, validation and
    kge-test rank over the full-graph encoding."""
    d, out = subgraph_run
    assert [h["steps"] for h in out["history"]] == [16, 16]
    losses = [h["train_loss"] for h in out["history"]]
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    assert 0.0 < out["test"]["MRR"] <= 1.0
    assert torch_test(str(d), device="cpu") == out["test"]
    assert "Subgraph training: cpp sampler, 16 steps an epoch" in (d / "train.log").read_text()


def test_subgraph_resume_equals_continuous_run(subgraph_run, tmp_path):
    """The sampler's seeds, the shuffle and the dropout derive from (seed,
    epoch), and the optimizer state rides in the checkpoint."""
    _, out = subgraph_run
    R.train(R.build_parser().parse_args(SUBGRAPH + ["--save_dir", str(tmp_path),
                                                    "--max_epochs", "1"]))
    resumed = R.train(R.build_parser().parse_args(
        SUBGRAPH + ["--save_dir", str(tmp_path), "--max_epochs", "2", "--resume"]))
    assert resumed["history"][0]["train_loss"] == out["history"][1]["train_loss"]
    assert resumed["test"] == out["test"]


def test_subgraph_refuses_negatives_and_shallow_models(tmp_path):
    with pytest.raises(ValueError, match="neg_sample_size 0"):
        R.train(R.build_parser().parse_args(
            GNN + ["--subgraph", "--save_dir", str(tmp_path), "--max_epochs", "1"]))
    with pytest.raises(ValueError, match="GNN-only"):
        run(tmp_path, "--subgraph", "--neg_sample_size", "0", "--max_epochs", "1")


# ------------------- bfloat16 run dirs across the two packages -------------------

BF16 = {"full": [a if a != "float64" else "bfloat16" for a in GNN],
        "subgraph": [a if a != "float64" else "bfloat16" for a in SUBGRAPH]}


@pytest.fixture(scope="module", params=["full", "subgraph"])
def bf16_run(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"compgcn_bf16_{request.param}")
    out = R.train(R.build_parser().parse_args(BF16[request.param] + [
        "--save_dir", str(d), "--max_epochs", "1"]))
    return request.param, d, out


def test_bf16_run_writes_a_checkpoint_jax_reads_and_evaluates(bf16_run):
    """A bf16 CompGCN run (full graph and --subgraph) writes its checkpoint
    as JAX writes one, ml_dtypes.bfloat16 arrays: JAX's load_checkpoint
    validates it against its own bf16 model and holds the same bits, and
    JAX's kge-test evaluates it."""
    import ml_dtypes

    from complexhyperbolickge_torch.train.checkpoint import flatten
    from complexhyperbolickge_tpu.train import checkpoint as jax_ckpt

    _, d, out = bf16_run
    assert np.isfinite(out["history"][0]["train_loss"])
    mine = load_checkpoint(str(d), filename="latest.pkl")["params"]
    theirs = jax_ckpt.load_checkpoint(str(d), device_put=False, filename="latest.pkl")["params"]
    a, b = flatten(mine), flatten(theirs)
    assert sorted(a) == sorted(b) and np.asarray(a["entity"]).dtype == ml_dtypes.bfloat16
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]).view(np.int16), a[k].view(np.int16))
    m = jax_test(str(d))
    assert np.isfinite(m["MRR"]) and 0.0 < m["MRR"] <= 1.0


@pytest.fixture(scope="module", params=["full", "subgraph"])
def jax_bf16_dir(request, tmp_path_factory):
    """A bf16 CompGCN run dir as the JAX package writes it: bf16 params and
    its trainer's optimizer state (float32, _f32_state_for_bf16), epoch 1."""
    import jax

    from complexhyperbolickge_tpu.cli.run import build_model, build_parser, load_dataset
    from complexhyperbolickge_tpu.train import checkpoint as jax_ckpt
    from complexhyperbolickge_tpu.train.trainer import TrainConfig, Trainer

    path = tmp_path_factory.mktemp(f"jax_compgcn_bf16_{request.param}")
    flags = [a for a in BF16[request.param] if a not in ("--device", "cpu")]
    args = build_parser().parse_args(flags + ["--save_dir", str(path)])
    dataset = load_dataset(args)
    model = build_model(args, dataset)
    params = model.init(jax.random.PRNGKey(3))
    n_ent, n_rel, _ = dataset.get_shape()
    trainer = Trainer(model, TrainConfig(learning_rate=1e-2, batch_size=256,
                                         neg_sample_size=args.neg_sample_size,
                                         loss=args.loss), n_ent, n_rel)
    jax_ckpt.save_checkpoint(str(path), params, trainer.tx.init(params), epoch=1,
                             best_mrr=0.0, config={"args": vars(args)})
    return request.param, path


def test_port_resumes_a_jax_bf16_run_dir(jax_bf16_dir):
    """The port resumes a JAX-written bf16 checkpoint (full graph and
    --subgraph): its params load bit for bit into the bf16 model and the
    next epoch trains."""
    mode, path = jax_bf16_dir
    resumed = R.train(R.build_parser().parse_args(BF16[mode] + [
        "--save_dir", str(path), "--max_epochs", "2", "--resume"]))
    assert [h["epoch"] for h in resumed["history"]] == [2]
    assert np.isfinite(resumed["history"][0]["train_loss"])
    assert 0.0 < resumed["test"]["MRR"] <= 1.0


def test_bf16_params_widen_without_ml_dtypes(tmp_path, monkeypatch):
    """Without ml_dtypes a bf16 param is written widened to float32 with
    "bfloat16" in the schema, and the port's loader reads it back to the
    same bits (strict schema check included)."""
    import torch

    from complexhyperbolickge_torch.train.checkpoint import (
        load_into,
        params_from_jax,
        save_checkpoint,
    )

    x = torch.randn(5, 3).to(torch.bfloat16)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)  # import raises ImportError
    save_checkpoint(str(tmp_path), {"entity": x})
    monkeypatch.undo()
    st = load_checkpoint(str(tmp_path), expect_params={"entity": x})
    assert st["params"]["entity"].dtype == np.float32
    assert st["param_schema"]["entity"] == [[5, 3], "bfloat16"]
    back = params_from_jax(st["params"], "cpu", torch.bfloat16)["entity"]
    assert torch.equal(back.view(torch.int16), x.view(torch.int16))
    model = torch.nn.Module()
    model.entity = torch.nn.Parameter(torch.zeros(5, 3, dtype=torch.bfloat16))
    load_into(model, str(tmp_path))
    assert torch.equal(model.entity.detach().view(torch.int16), x.view(torch.int16))


def test_run_validates_and_tests_with_eval_precision_default(tmp_path):
    """cli.run --eval_precision default: validation and the final test rank
    through the default fused ranker (K1's plain default version here); the
    run dir's kge-test repeats the final metrics in that mode, and JAX's
    kge-test (full float32 on the CPU) reads the run dir within 1e-2 of
    them."""
    out = run(tmp_path, "--max_epochs", "1", "--eval_precision", "default",
              "--dtype", "float32")
    assert 0.0 < out["test"]["MRR"] <= 1.0
    assert load_checkpoint(str(tmp_path))["config"]["args"]["eval_precision"] == "default"
    assert torch_test(str(tmp_path), device="cpu") == out["test"]
    assert abs(jax_test(str(tmp_path))["MRR"] - out["test"]["MRR"]) < 1e-2
