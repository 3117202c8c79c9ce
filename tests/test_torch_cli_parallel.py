"""cli/run.py on a mesh, on the CPU: --mesh DxM starts its ranks (gloo, a
localhost TCP store) and --distributed joins a group the flags describe.

A tiny synthetic KG at an odd entity count trains for 2 epochs without a
mesh, under --mesh 2x1 (data parallel) and under --mesh 1x2 (row-sharded
tables, the sharded K1 ranker's plain version): the epoch losses and the
test metrics agree to rel 1e-9 (2x1 adds the two halves' gradients in
another order; 1x2 computes what one process does).  Only rank 0 writes.
The checkpoints are canonical, so the JAX package loads and ranks them,
and the port resumes a run dir that JAX wrote on a mesh (--mesh 4x2: the
JAX CLI lays its mesh over all 8 of the tests' virtual devices).  A pair of
processes launched with --distributed (--coordinator, or torchrun's
environment) matches the spawned 2x1 run, and a --subgraph --distributed
pair trains a CompGCN as one process does.  Every multi-process run has a
deadline.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from complexhyperbolickge_torch.cli import run as R
from complexhyperbolickge_torch.cli.run import free_port
from complexhyperbolickge_torch.cli.test import test as torch_test
from complexhyperbolickge_torch.train.checkpoint import flatten, load_checkpoint

ROOT = Path(__file__).resolve().parents[1]
N_ENT = 61
COMMON = ["--dataset", "synthetic", "--synthetic_entities", str(N_ENT), "--model", "FFTRotH",
          "--rank", "5", "--batch_size", "256", "--eval_batch_size", "128",
          "--neg_sample_size", "4", "--optimizer", "Adam", "--learning_rate", "0.01",
          "--bias", "learn", "--multi_c", "--dtype", "float64", "--valid", "1", "--seed", "3"]
TINY = COMMON + ["--device", "cpu"]
REL = 1e-9


def run(save_dir, *extra):
    return R.train(R.build_parser().parse_args(TINY + ["--save_dir", str(save_dir), *extra]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """mesh -> (run dir, result) for no mesh, 2x1 and 1x2, 2 epochs each."""
    out = {}
    for mesh in (None, "2x1", "1x2"):
        d = tmp_path_factory.mktemp(f"mesh_{mesh}")
        out[mesh] = d, run(d, "--max_epochs", "2", *(["--mesh", mesh] if mesh else []))
    return out


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, dtype=float), np.asarray(b, dtype=float),
                               rtol=REL, atol=0.0)


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_mesh_run_matches_the_run_without_a_mesh(runs, mesh):
    _, want = runs[None]
    _, got = runs[mesh]
    assert [h["epoch"] for h in got["history"]] == [1, 2]
    for key in ("train_loss", "valid_loss"):
        _close([h[key] for h in got["history"]], [h[key] for h in want["history"]])
    for split in ("valid", "test"):
        for k in ("MR", "MRR", "hits@[1,3,10]"):
            _close(got[split][k], want[split][k])


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_only_rank_zero_writes(runs, mesh):
    d, _ = runs[mesh]
    log = (d / "train.log").read_text()
    assert log.count("Epoch 1 | average train loss") == 1
    assert f"Mesh: data={mesh[0]} model={mesh[2]} over 2 ranks, gloo backend" in log
    assert sorted(p.name for p in d.iterdir()) == ["config.json", "latest.pkl", "state.pkl",
                                                  "train.log"]


def test_mesh_checkpoints_are_canonical_and_jax_ranks_them(runs):
    from complexhyperbolickge_tpu.cli.test import test as jax_test
    from complexhyperbolickge_tpu.train.checkpoint import load_checkpoint as jax_load

    d, _ = runs["1x2"]
    for fn in ("state.pkl", "latest.pkl"):
        st = jax_load(str(d), filename=fn, device_put=False)
        for k in ("entity", "bh", "bt"):
            assert st["params"][k].shape[0] == N_ENT, (fn, k)
        ours = load_checkpoint(str(d), filename=fn)
        for k in ("exp_avg", "exp_avg_sq"):
            assert ours["opt_state"]["state"]["entity"][k].shape == (N_ENT, 10)
    # the same checkpoint as the run without a mesh wrote, to rel 1e-9
    base = load_checkpoint(str(runs[None][0]))
    for k, v in base["params"].items():
        _close(load_checkpoint(str(d))["params"][k], v)
    want = jax_test(str(d))
    got = torch_test(str(d), device="cpu", eval_backend="dense")
    assert abs(got["MRR"] - want["MRR"]) <= 1e-9


def test_resume_of_a_jax_mesh_run_dir_under_a_port_mesh(tmp_path):
    """JAX trains one epoch under --mesh 4x2 (its 8-device CPU mesh); the
    port resumes the run dir for epoch 2 under --mesh 1x2, as it does
    without a mesh."""
    from complexhyperbolickge_tpu.cli import run as JR

    jax_dir = tmp_path / "jax"
    JR.train(JR.build_parser().parse_args(
        COMMON + ["--eval_backend", "dense", "--mesh", "4x2", "--max_epochs", "1",
                  "--save_dir", str(jax_dir)]))
    plain_dir = tmp_path / "plain"
    shutil.copytree(jax_dir, plain_dir)
    got = run(jax_dir, "--mesh", "1x2", "--resume", "--max_epochs", "2")
    want = run(plain_dir, "--resume", "--max_epochs", "2")
    assert [h["epoch"] for h in got["history"]] == [2]
    assert "Resumed from epoch 1" in (jax_dir / "train.log").read_text()
    _close(got["history"][0]["train_loss"], want["history"][0]["train_loss"])
    _close(got["test"]["MRR"], want["test"]["MRR"])


def test_mesh_padded_checkpoint_is_refused_on_resume(tmp_path, runs):
    """A checkpoint whose entity tables carry mesh pad rows is refused, as
    the JAX package refuses it."""
    import pickle

    d = tmp_path / "padded"
    shutil.copytree(runs[None][0], d)
    for fn in ("state.pkl", "latest.pkl"):
        st = pickle.loads((d / fn).read_bytes())
        st["params"]["entity"] = np.pad(st["params"]["entity"], [(0, 1), (0, 0)])
        st.pop("param_schema")
        (d / fn).write_bytes(pickle.dumps(st))
    with pytest.raises(ValueError, match="exceeds the live layout"):
        run(d, "--resume", "--max_epochs", "3")


@pytest.mark.parametrize("rendezvous", ["coordinator", "env"])
def test_distributed_pair_matches_the_spawned_run(runs, tmp_path, rendezvous):
    """Two processes launched with --distributed: --coordinator, as
    tests/test_multihost.py launches the JAX package's, or torchrun's
    environment variables."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "complexhyperbolickge_torch.cli.run", *TINY,
           "--max_epochs", "2", "--mesh", "2x1", "--save_dir", str(tmp_path), "--distributed"]
    if rendezvous == "coordinator":
        cmd += ["--coordinator", f"127.0.0.1:{port}", "--num_processes", "2"]
        launch = [(cmd + ["--process_id", str(i)], env) for i in range(2)]
    else:
        launch = [(cmd, dict(env, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                             RANK=str(i), LOCAL_RANK=str(i), LOCAL_WORLD_SIZE="2"))
                  for i in range(2)]
    procs = [subprocess.Popen(c, cwd=str(tmp_path), env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for c, e in launch]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs[0][-3000:] + outs[1][-3000:]
    assert "Epoch 2 | average train loss" in outs[0]
    assert "average train loss" not in outs[1]  # rank 1 logs warnings only
    spawned = load_checkpoint(str(runs["2x1"][0]))
    pair = load_checkpoint(str(tmp_path))
    assert pair["epoch"] == spawned["epoch"]
    for k, v in spawned["params"].items():
        np.testing.assert_array_equal(pair["params"][k], v)


SUBGRAPH = ["--dataset", "synthetic", "--synthetic_entities", str(N_ENT), "--model", "CompGCN",
            "--rank", "8", "--hidden_dim", "8", "--layers", "1", "--edge_dropout", "0.3",
            "--subgraph", "--neg_sample_size", "0", "--loss", "crossentropy", "--batch_size",
            "64", "--eval_batch_size", "128", "--optimizer", "Adam", "--learning_rate", "0.01",
            "--bias", "learn", "--multi_c", "--dtype", "float64", "--valid", "1", "--seed", "3",
            "--max_epochs", "1", "--device", "cpu"]


def test_subgraph_distributed_pair_matches_one_process(tmp_path, monkeypatch):
    """kge-train --subgraph --distributed on two processes (the default
    mesh: world x 1, each data row half of every step's seed queries)
    trains, validates and writes the checkpoint one process writes: the
    loss and the metrics to rel 1e-9, the params to rtol 1e-7 with an
    absolute floor of 1e-7 (Adam turns the two halves' other order of
    addition into ~1e-9 steps on nearly cancelled entries, and bh, whose
    CE gradient is zero up to rounding, holds Adam's ~1e-11 steps of
    rounding noise in both runs)."""
    from complexhyperbolickge_torch.data import sampler as S

    lib = S.build_library(tmp_path / "native")
    monkeypatch.setenv("KGSAMPLER_LIB", str(lib))
    monkeypatch.setattr(S, "_LIB", None)
    one = R.train(R.build_parser().parse_args(SUBGRAPH + ["--save_dir", str(tmp_path / "one")]))
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "complexhyperbolickge_torch.cli.run", *SUBGRAPH, "--save_dir",
           str(tmp_path / "pair"), "--distributed", "--coordinator", f"127.0.0.1:{port}",
           "--num_processes", "2"]
    procs = [subprocess.Popen(cmd + ["--process_id", str(i)], cwd=str(tmp_path), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs[0][-3000:] + outs[1][-3000:]
    log = (tmp_path / "pair" / "train.log").read_text()
    assert "Mesh: data=2 model=1 over 2 ranks" in log and "cpp sampler" in log
    want, got = load_checkpoint(str(tmp_path / "one")), load_checkpoint(str(tmp_path / "pair"))
    assert got["epoch"] == want["epoch"] == 1
    got_params = flatten(got["params"])
    for k, v in flatten(want["params"]).items():
        np.testing.assert_allclose(got_params[k], v, rtol=1e-7, atol=1e-7, err_msg=k)
    pair = torch_test(str(tmp_path / "pair"), device="cpu")
    for k in ("MR", "MRR", "hits@[1,3,10]"):
        _close(pair[k], one["test"][k])
    assert "average train loss: %.4f" % one["history"][0]["train_loss"] in log


def test_world_size_must_equal_the_mesh(tmp_path):
    """--mesh 2x2 over a 2-process group raises on every rank."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "complexhyperbolickge_torch.cli.run", *TINY, "--max_epochs",
           "1", "--mesh", "2x2", "--save_dir", str(tmp_path), "--distributed", "--coordinator",
           f"127.0.0.1:{port}", "--num_processes", "2"]
    procs = [subprocess.Popen(cmd + ["--process_id", str(i)], cwd=str(tmp_path), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode != 0 for p in procs)
    assert all("mesh 2x2 needs 4 ranks, the process group has 2" in o for o in outs)
