"""Data-parallel and row-sharded training (train/trainer.py on a
parallel/mesh.py Mesh) against one process, on the CPU in float64.

One module-scoped group of 2 spawned processes (gloo) runs every mesh job
in turn, and a group of 4 the 2x2 jobs; this process runs the same jobs
without a mesh.  A 2x1 job splits
each batch over 2 data ranks (the gradients summed over them: the only
difference from one process is the order in which the two halves add); a
1x2 job row-shards the entity tables over 2 model ranks.  Params after one
epoch must match to rtol 1e-9.  The CompGCN job draws edge dropout 0.3 and
adds an N3 regularizer: dropout masks drawn per rank, or a batch-free
regularizer added by both data ranks, would move it far off.  One job is
also held against JAX's Trainer on its make_mesh((2, 1)), with JAX's
negatives replayed and SGD (Adam and Adagrad turn sub-ulp gradient
differences between the packages into +-lr steps; test_torch_trainer.py).
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.data.dataset import epoch_batches, synthetic_kg
from complexhyperbolickge_torch.models import ModelConfig, get_model
from complexhyperbolickge_torch.parallel import gather_entity_tree, make_mesh
from complexhyperbolickge_torch.train.checkpoint import flatten, params_from_jax
from complexhyperbolickge_torch.train.trainer import TrainConfig, Trainer
from torch_parallel_util import spawn_group

TOL = dict(rtol=1e-9, atol=1e-12)
DATA = dict(n_entities=61, n_relations=4, n_train=256, n_valid=32, n_test=32, seed=3)
GNN_ARGS = dict(hidden_dim=6, layers=2, edge_dropout=0.3, dropout=0.0, opn="mult",
                interaction="distmult", basis=0, gnn_agg_method=1)
LR = 2.0**-7  # exact in float32, where JAX keeps its hyperparameters
K = 4


def _params(name, data, seed=0):
    """Well-scaled numpy params of the JAX model `name` (a nested tree for
    a GNN)."""
    from complexhyperbolickge_tpu.models import ModelConfig as JaxConfig
    from complexhyperbolickge_tpu.models import get_model as jax_get_model

    n, r, _ = data.get_shape()
    cfg = JaxConfig(n_entities=n, n_relations=r, rank=6, bias="learn", multi_c=True,
                    dtype="float64")
    jm = (jax_get_model(name)(cfg, argparse.Namespace(**GNN_ARGS), data)
          if name == "CompGCN" else jax_get_model(name)(cfg))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda v: np.asarray(v) + rng.normal(0.0, 0.1, np.shape(v)),
                        jm.init(jax.random.PRNGKey(0)))


def _job(name, shape, params, negs=None, **cfg):
    cfg = {"optimizer": "Adam", "learning_rate": LR, "batch_size": 64,
           "neg_sample_size": K, **cfg}
    return {"name": name, "shape": shape, "params": params, "negs": negs, "cfg": cfg}


def run_job(job, mesh=None, debug_nans=False):
    """One epoch of the job; returns its canonical params (name -> numpy),
    the train loss and the valid loss."""
    data = synthetic_kg(**DATA)
    n, r, _ = data.get_shape()
    cfg = ModelConfig(n_entities=n, n_relations=r, rank=6, bias="learn", multi_c=True,
                      dtype="float64")
    model = (get_model(job["name"])(cfg, argparse.Namespace(**GNN_ARGS), data)
             if job["name"] == "CompGCN" else get_model(job["name"])(cfg))
    model.load_state_dict(params_from_jax(job["params"], "cpu"))
    kw = {}
    if job["negs"] is not None:
        it = iter(job["negs"])
        kw["sampler"] = lambda g, batch, n_ent, k: torch.as_tensor(next(it))
    trainer = Trainer(model, TrainConfig(**job["cfg"]), n, r, mesh=mesh, **kw)
    trainer.debug_nans = debug_nans
    b, w, _ = epoch_batches(data.get_examples("train"), job["cfg"]["batch_size"],
                            np.random.default_rng([3, 1]))
    loss = trainer.run_epoch(b, w, torch.Generator().manual_seed(5))
    vb, vw, _ = epoch_batches(data.get_examples("valid"), job["cfg"]["batch_size"], None)
    valid = trainer.valid_loss(vb, vw, torch.Generator().manual_seed(6)) \
        if job["negs"] is None else None
    params = model.state_dict()
    if mesh is not None:
        params = gather_entity_tree(params, n, mesh)
    return {k: v.detach().numpy().copy() for k, v in params.items()}, loss, valid


def _nan_job(rank, mesh):
    """--debug_nans with a NaN in rank 1's rel table only: every rank
    must raise FloatingPointError (none may wait in a collective)."""
    job = _job("FFTRotH", (2, 1), _params("FFTRotH", synthetic_kg(**DATA)))
    if rank == 1:
        job["params"]["rel"][0, 0] = np.nan
    try:
        run_job(job, mesh, debug_nans=True)
    except FloatingPointError as e:
        return str(e)
    return None


def _ranks(rank, world, jobs):
    out = [run_job(job, make_mesh(job["shape"])) for job in jobs]
    if world == 2:
        out.append(_nan_job(rank, make_mesh((2, 1))))
    return out


def _jax_negatives(key, batches):
    from complexhyperbolickge_tpu.train import losses as JL

    n = DATA["n_entities"]
    return [np.asarray(JL.sample_negatives(jax.random.split(sk, 2)[0], jnp.asarray(bt), n, K))
            for sk, bt in zip(jax.random.split(key, len(batches)), batches)]


@pytest.fixture(scope="module")
def jax_run():
    """JAX's Trainer over a 2-device (2, 1) mesh: SGD, one epoch; its
    negatives and final params."""
    from complexhyperbolickge_tpu import parallel as JP
    from complexhyperbolickge_tpu.models import ModelConfig as JaxConfig
    from complexhyperbolickge_tpu.models import get_model as jax_get_model
    from complexhyperbolickge_tpu.train.trainer import TrainConfig as JaxTrainConfig
    from complexhyperbolickge_tpu.train.trainer import Trainer as JaxTrainer

    data = synthetic_kg(**DATA)
    n, r, _ = data.get_shape()
    params = _params("FFTRotH", data, seed=1)
    jm = jax_get_model("FFTRotH")(JaxConfig(n_entities=n, n_relations=r, rank=6, bias="learn",
                                            multi_c=True, dtype="float64"))
    jt = JaxTrainer(jm, JaxTrainConfig(optimizer="SGD", learning_rate=LR, batch_size=64,
                                       neg_sample_size=K), n, r)
    b, w, _ = epoch_batches(data.get_examples("train"), 64, np.random.default_rng([3, 1]))
    key = jax.random.PRNGKey(7)
    mesh = JP.make_mesh((2, 1), devices=jax.devices()[:2])
    jp = JP.shard_params({k: jnp.asarray(v) for k, v in params.items()}, mesh)
    sb, sw, _ = JP.shard_epoch_arrays(mesh, jnp.asarray(b), jnp.asarray(w))
    jp, _, loss = jt.run_epoch(jp, jt.tx.init(jp), sb, sw, key)
    return params, _jax_negatives(key, b), {k: np.asarray(v) for k, v in jp.items()}, float(loss)


@pytest.fixture(scope="module")
def runs(jax_run, tmp_path_factory):
    """(jobs, each rank's results of every job) from one 2-process group."""
    data = synthetic_kg(**DATA)
    fft, gnn = _params("FFTRotH", data), _params("CompGCN", data)
    jobs = {
        "fft-2x1": _job("FFTRotH", (2, 1), fft),
        "fft-1x2": _job("FFTRotH", (1, 2), fft),
        # SGD: under Adam the bh rows that the all-entity loss moves by
        # nearly cancelling sums drift ~1e-9 apart in one epoch
        "ce-2x1": _job("FFTRotH", (2, 1), fft, neg_sample_size=0, loss="crossentropy",
                       smoothing=0.1, optimizer="SGD"),
        "gnn-2x1": _job("CompGCN", (2, 1), gnn, regularizer="N3", reg=0.05),
        "jax-2x1": _job("FFTRotH", (2, 1), jax_run[0], negs=jax_run[1], optimizer="SGD"),
    }
    out = spawn_group(_ranks, 2, (list(jobs.values()),), tmp_path_factory.mktemp("ranks"))
    jobs["nan-2x1"] = None
    return jobs, {name: (out[0][i], out[1][i]) for i, name in enumerate(jobs)}


@pytest.fixture(scope="module")
def runs_2x2(tmp_path_factory):
    """A 2x2 mesh (4 processes): data and model axes at once, so the row
    gather's backward sums over a data group of 2 while the model group
    splits the rows."""
    data = synthetic_kg(**DATA)
    jobs = {"fft-2x2": _job("FFTRotH", (2, 2), _params("FFTRotH", data)),
            "gnn-2x2": _job("CompGCN", (2, 2), _params("CompGCN", data), regularizer="N3",
                            reg=0.05)}
    out = spawn_group(_ranks, 4, (list(jobs.values()),), tmp_path_factory.mktemp("ranks4"))
    return jobs, {name: tuple(o[i] for o in out) for i, name in enumerate(jobs)}


@pytest.mark.parametrize("name", ["fft-2x1", "fft-1x2", "ce-2x1", "gnn-2x1", "fft-2x2",
                                  "gnn-2x2"])
def test_mesh_epoch_matches_one_process(request, name):
    jobs, results = request.getfixturevalue("runs_2x2" if "2x2" in name else "runs")
    want_params, want_loss, want_valid = run_job(jobs[name])
    for got_params, got_loss, got_valid in results[name]:  # every rank
        assert sorted(got_params) == sorted(want_params)
        for k, v in want_params.items():
            np.testing.assert_allclose(got_params[k], v, err_msg=k, **TOL)
        np.testing.assert_allclose(got_loss, want_loss, **TOL)
        np.testing.assert_allclose(got_valid, want_valid, **TOL)
    # the ranks hold one model
    for other in results[name][1:]:
        for k, v in results[name][0][0].items():
            np.testing.assert_array_equal(other[0][k], v)


def test_gnn_epoch_moves_with_dropout_and_reg(runs):
    """The dropout and the regularizer do act in the CompGCN job: without
    them one process trains to other params."""
    jobs, results = runs
    job = dict(jobs["gnn-2x1"], cfg={**jobs["gnn-2x1"]["cfg"], "reg": 0.0})
    plain = run_job(job)[0]
    got = results["gnn-2x1"][0][0]
    assert max(float(np.abs(got[k] - plain[k]).max()) for k in got) > 1e-6


def test_mesh_epoch_matches_jax_trainer_on_a_mesh(runs, jax_run):
    _, results = runs
    jax_params, jax_loss = jax_run[2], jax_run[3]
    got_params, got_loss, _ = results["jax-2x1"][0]
    for k, v in flatten(jax_params).items():
        np.testing.assert_allclose(got_params[k], v, err_msg=k, **TOL)
    np.testing.assert_allclose(got_loss, jax_loss, **TOL)


def test_debug_nans_raises_on_every_rank(runs):
    """A NaN that one rank alone sees: the flag is OR-ed over the ranks
    before anyone raises, so both raise at the same step and neither hangs
    (the group's deadline would fail the fixture)."""
    _, results = runs
    errors = results["nan-2x1"]
    assert all(e is not None and "step 1 (--debug_nans)" in e for e in errors), errors
