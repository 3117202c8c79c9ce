"""Sampled-subgraph training on a mesh (train/subgraph.py's SubgraphTrainer
with a parallel/mesh.py Mesh) against one process and against JAX's mesh
SubgraphTrainer, on the CPU in float64.

One module-scoped group of 2 spawned processes (gloo) runs every job on a
2x1 mesh (each data row trains on its half of the seed queries) and on a
1x2 mesh (the entity tables row-sharded, 49 rows padded to 50); this
process runs the same jobs without a mesh.  CompGCN at rank 8, hidden 8,
one layer, fanouts 4/4, max_nodes 64, max_edges 512, batches of 32 seed
edges: 460 directed train edges give 15 steps, the last one padded.  After
an epoch the params must match one process's to rtol 1e-9:
  * ce: cross-entropy with smoothing 0.1, SGD (also held against JAX's
    make_mesh((2, 1)) and ((1, 2)) runs over two of the tests' virtual
    devices: dropout 0, as the packages draw dropout from other streams);
  * bce: BCE with smoothing 0.1 and update_steps 2 (the 15th step is the
    epoch-end flush of a partial window);
  * dropout: two layers, edge dropout 0.3 and feature dropout 0.2, an N3
    regularizer: dropout drawn per rank, or the encoder's
    regularizer added by both data rows, would move it far off.
The 1x2 pad row stays zero.  A fourth job at 301 entities records every
tensor that reaches torch.distributed during its steps: none carries
N / M or more rows at the entity table's width (a step gathers only its
subgraph's rows, at most 64).  The spawned workers import no JAX.  Both
packages load the port's sampler library, built once here.
"""

import argparse
import contextlib
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from complexhyperbolickge_torch.cli import run as R
from complexhyperbolickge_torch.cli.test import test as torch_test
from complexhyperbolickge_torch.data import sampler as S
from complexhyperbolickge_torch.data.dataset import synthetic_kg
from complexhyperbolickge_torch.models import ModelConfig, get_model
from complexhyperbolickge_torch.parallel import Mesh, gather_entity_tree, make_mesh, padded_rows
from complexhyperbolickge_torch.train.checkpoint import load_checkpoint, params_from_jax
from complexhyperbolickge_torch.train.subgraph import SubgraphTrainer
from complexhyperbolickge_torch.train.trainer import TrainConfig
from torch_parallel_util import spawn_group

TOL = dict(rtol=1e-9, atol=1e-12)
DATA = dict(n_entities=49, n_relations=4, n_train=230, n_valid=32, n_test=32, seed=3)
WIDE = dict(DATA, n_entities=301, n_train=600)
SAMPLER = dict(fanouts=(4, 4), max_nodes=64, max_edges=512)
ARGS = dict(hidden_dim=8, layers=1, edge_dropout=0.0, dropout=0.0, opn="mult",
            interaction="distmult", basis=0, gnn_agg_method=1)
RANK, BATCH = 8, 32
SHAPES = ((2, 1), (1, 2))
COLLECTIVES = ("all_reduce", "all_gather", "broadcast", "reduce_scatter",
               "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all")


@pytest.fixture(scope="module", autouse=True)
def lib(tmp_path_factory):
    """The port's sampler library, built once into a fresh directory: this
    process's for both packages, and the spawned ranks' through
    KGSAMPLER_LIB."""
    from complexhyperbolickge_tpu.data import sampler as jax_sampler

    path = S.build_library(tmp_path_factory.mktemp("native"))
    built = S.load_library(path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(S, "_LIB", built)
        mp.setattr(jax_sampler, "_LIB", built)
        mp.setenv("KGSAMPLER_LIB", str(path))
        yield built


def _params(data, args, seed=0):
    """Well-scaled params of JAX's CompGCN (a nested numpy tree)."""
    import jax

    from complexhyperbolickge_tpu.models import ModelConfig as JaxConfig
    from complexhyperbolickge_tpu.models import get_model as jax_get_model

    n, r, _ = data.get_shape()
    jm = jax_get_model("CompGCN")(JaxConfig(n_entities=n, n_relations=r, rank=RANK,
                                            bias="learn", multi_c=True, dtype="float64"),
                                  argparse.Namespace(**args), data)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda v: np.asarray(v) + rng.normal(0.0, 0.1, np.shape(v)),
                        jm.init(jax.random.PRNGKey(0)))


def _job(params, data=DATA, args=None, max_steps=None, record=False, **cfg):
    cfg = {"optimizer": "SGD", "learning_rate": 0.05, "batch_size": BATCH,
           "neg_sample_size": 0, "loss": "crossentropy", **cfg}
    return {"params": params, "data": data, "args": {**ARGS, **(args or {})}, "cfg": cfg,
            "max_steps": max_steps, "record": record}


class _Recorder:
    """The shapes of every tensor passed to a torch.distributed collective
    while it is active."""

    def __init__(self):
        self.shapes = []
        self._saved = {}

    def __enter__(self):
        for name in COLLECTIVES:
            f = getattr(dist, name, None)
            if f is None:
                continue
            self._saved[name] = f

            def wrapped(*args, _f=f, **kw):
                for a in (*args, *kw.values()):
                    for t in (a if isinstance(a, (list, tuple)) else [a]):
                        if isinstance(t, torch.Tensor):
                            self.shapes.append(tuple(t.shape))
                return _f(*args, **kw)

            setattr(dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, f in self._saved.items():
            setattr(dist, name, f)


def run_job(job, mesh=None):
    """One epoch (or job["max_steps"] steps) of the job: canonical params
    (name -> numpy), the mean loss, the last model rank's pad rows of the
    entity tables (1x2) and the collectives' shapes (when recorded)."""
    data = synthetic_kg(**job["data"])
    n, r, _ = data.get_shape()
    cfg = ModelConfig(n_entities=n, n_relations=r, rank=RANK, bias="learn", multi_c=True,
                      dtype="float64")
    model = get_model("CompGCN")(cfg, argparse.Namespace(**job["args"]), data)
    model.load_state_dict(params_from_jax(job["params"], "cpu"))
    trainer = SubgraphTrainer(model, TrainConfig(**job["cfg"]), data, mesh=mesh, **SAMPLER)
    rec = _Recorder()
    with rec if job["record"] else contextlib.nullcontext():
        loss = trainer.run_epoch(BATCH, np.random.default_rng([3, 1]),
                                 torch.Generator().manual_seed(5), epoch_id=1,
                                 max_steps=job["max_steps"])
    params = model.state_dict()
    pad = None
    if mesh is not None and mesh.n_model > 1:
        s = padded_rows(n, mesh.n_model) // mesh.n_model
        if mesh.m == mesh.n_model - 1:
            pad = {k: params[k][n - mesh.m * s:].numpy().copy() for k in trainer.rows}
        params = gather_entity_tree(params, n, mesh)
    return ({k: v.detach().numpy().copy() for k, v in params.items()}, loss, pad,
            rec.shapes if job["record"] else None)


def _ranks(rank, world, jobs):
    out = {(name, shape): run_job(job, make_mesh(shape)) for name, job in jobs.items()
           for shape in SHAPES}
    out["jax_imported"] = "jax" in sys.modules
    return out


@pytest.fixture(scope="module")
def jobs():
    data = synthetic_kg(**DATA)
    drop = dict(layers=2, edge_dropout=0.3, dropout=0.2)
    return {
        "ce": _job(_params(data, ARGS), smoothing=0.1),
        "bce": _job(_params(data, ARGS, seed=1), loss="binarycrossentropy", smoothing=0.1,
                    update_steps=2),
        # SGD: under Adam the bh entries that nearly cancelling sums move
        # drift ~1e-9 apart in one epoch (the two data rows add in another
        # order), as in test_torch_parallel_train.py
        "dropout": _job(_params(data, {**ARGS, **drop}, seed=2), args=drop, regularizer="N3",
                        reg=0.05),
        "payload": _job(_params(synthetic_kg(**WIDE), ARGS), data=WIDE, max_steps=3,
                        record=True),
    }


@pytest.fixture(scope="module")
def runs(jobs, tmp_path_factory):
    """Each rank's results of every (job, mesh shape) from one 2-process
    group."""
    return spawn_group(_ranks, 2, (jobs,), tmp_path_factory.mktemp("ranks"), timeout=180)


@pytest.fixture(scope="module")
def one_process(jobs):
    return {name: run_job(job) for name, job in jobs.items()}


@pytest.mark.parametrize("shape", SHAPES, ids=["2x1", "1x2"])
@pytest.mark.parametrize("name", ["ce", "bce", "dropout"])
def test_mesh_epoch_matches_one_process(runs, one_process, name, shape):
    want_params, want_loss, _, _ = one_process[name]
    for got_params, got_loss, pad, _ in (r[(name, shape)] for r in runs):
        assert sorted(got_params) == sorted(want_params)
        for k, v in want_params.items():
            np.testing.assert_allclose(got_params[k], v, err_msg=k, **TOL)
        np.testing.assert_allclose(got_loss, want_loss, **TOL)
    if shape == (1, 2):  # 49 rows padded to 50: the last rank's pad row
        pad = runs[1][(name, shape)][2]
        assert sorted(pad) == ["bh", "bt", "entity"]
        assert all(v.shape[0] == 1 and not v.any() for v in pad.values())
    for k, v in runs[0][(name, shape)][0].items():  # the ranks hold one model
        np.testing.assert_array_equal(runs[1][(name, shape)][0][k], v)


def test_dropout_and_reg_move_the_epoch(runs, jobs, one_process):
    """The dropout job's dropouts and regularizer do act: without them one
    process ends elsewhere; and the spawned workers imported no JAX."""
    job = jobs["dropout"]
    plain = run_job(dict(job, args={**job["args"], "edge_dropout": 0.0, "dropout": 0.0},
                         cfg={**job["cfg"], "reg": 0.0}))[0]
    got = one_process["dropout"][0]
    assert max(float(np.abs(got[k] - plain[k]).max()) for k in got) > 1e-4
    assert not any(r["jax_imported"] for r in runs)


@pytest.mark.parametrize("shape", SHAPES, ids=["2x1", "1x2"])
def test_no_collective_carries_the_entity_table(runs, one_process, shape):
    """Every tensor the steps hand to torch.distributed has fewer than
    N / M rows at the entity table's width (N = 301: 301 rows a shard on
    2x1, 151 on 1x2), and fewer elements than such a shard; the subgraph's
    rows do go through the gathers."""
    n = WIDE["n_entities"]
    s = padded_rows(n, shape[1]) // shape[1]
    for r in runs:
        shapes = r[("payload", shape)][3]
        wide = [sh for sh in shapes if len(sh) >= 2 and sh[-1] == RANK]
        assert wide and max(sh[0] for sh in wide) <= SAMPLER["max_nodes"] < s
        assert max(int(np.prod(sh)) for sh in shapes) < s * RANK
    # the payload job still trains as one process does
    for k, v in one_process["payload"][0].items():
        np.testing.assert_allclose(runs[0][("payload", shape)][0][k], v, err_msg=k, **TOL)


@pytest.fixture(scope="module")
def jax_runs(jobs):
    """JAX's SubgraphTrainer over make_mesh((2, 1)) and ((1, 2)) on two of
    the virtual devices: the ce job's epoch; unpadded params by port name
    and the mean loss."""
    import jax
    import jax.numpy as jnp

    from complexhyperbolickge_tpu import parallel as JP
    from complexhyperbolickge_tpu.data.dataset import synthetic_kg as jax_synthetic_kg
    from complexhyperbolickge_tpu.models import ModelConfig as JaxConfig
    from complexhyperbolickge_tpu.models import get_model as jax_get_model
    from complexhyperbolickge_tpu.train.subgraph import SubgraphTrainer as JaxSubgraphTrainer
    from complexhyperbolickge_tpu.train.trainer import TrainConfig as JaxTrainConfig

    job = jobs["ce"]
    data = jax_synthetic_kg(**DATA)
    n, r, _ = data.get_shape()
    jm = jax_get_model("CompGCN")(JaxConfig(n_entities=n, n_relations=r, rank=RANK,
                                            bias="learn", multi_c=True, dtype="float64"),
                                  argparse.Namespace(**job["args"]), data)
    out = {}
    for shape in SHAPES:
        mesh = JP.make_mesh(shape, devices=jax.devices()[:2])
        jt = JaxSubgraphTrainer(jm, JaxTrainConfig(**job["cfg"]), data, mesh=mesh, **SAMPLER)
        jp = JP.shard_params(jax.tree.map(jnp.asarray, job["params"]), mesh)
        jp, _, loss = jt.run_epoch(jp, jt.tx.init(jp), BATCH, np.random.default_rng([3, 1]),
                                   jax.random.PRNGKey(7), epoch_id=1)
        jp = JP.unpad_entity_tree(jax.tree.map(np.asarray, jp), n,
                                  JP.padded_rows(n, shape[1]))
        out[shape] = {k: v.numpy() for k, v in params_from_jax(jp, "cpu").items()}, loss
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=["2x1", "1x2"])
def test_mesh_epoch_matches_jax_subgraph_trainer_on_a_mesh(runs, jax_runs, shape):
    want_params, want_loss = jax_runs[shape]
    got_params, got_loss, _, _ = runs[0][("ce", shape)]
    for k, v in want_params.items():
        np.testing.assert_allclose(got_params[k], v, rtol=1e-9,
                                   atol=1e-9 * max(1.0, float(np.abs(v).max())), err_msg=k)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-9)


@pytest.mark.parametrize("shape", [(2, 1), (4, 2)], ids=["2x1", "4x2"])
def test_batch_the_data_axis_does_not_divide_raises(shape):
    """As JAX's SubgraphTrainer refuses it at construction (checked on its
    make_mesh over the tests' virtual devices)."""
    import jax

    from complexhyperbolickge_tpu import parallel as JP
    from complexhyperbolickge_tpu.data.dataset import synthetic_kg as jax_synthetic_kg
    from complexhyperbolickge_tpu.models import ModelConfig as JaxConfig
    from complexhyperbolickge_tpu.models import get_model as jax_get_model
    from complexhyperbolickge_tpu.train.subgraph import SubgraphTrainer as JaxSubgraphTrainer
    from complexhyperbolickge_tpu.train.trainer import TrainConfig as JaxTrainConfig

    data = synthetic_kg(**DATA)
    n, r, _ = data.get_shape()
    cfg = dict(n_entities=n, n_relations=r, rank=RANK, multi_c=True, dtype="float64")
    model = get_model("CompGCN")(ModelConfig(**cfg), argparse.Namespace(**ARGS), data)
    tcfg = dict(batch_size=30 if shape[0] == 4 else 33, neg_sample_size=0)
    with pytest.raises(ValueError, match="data"):
        SubgraphTrainer(model, TrainConfig(**tcfg), data, mesh=Mesh(shape), **SAMPLER)
    jm = jax_get_model("CompGCN")(JaxConfig(**cfg), argparse.Namespace(**ARGS),
                                  jax_synthetic_kg(**DATA))
    with pytest.raises(ValueError, match="data"):
        JaxSubgraphTrainer(jm, JaxTrainConfig(**tcfg), jax_synthetic_kg(**DATA),
                           mesh=JP.make_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]]),
                           **SAMPLER)


# ------------------------------ the command line ------------------------------

CLI = ["--dataset", "synthetic", "--synthetic_entities", "49", "--synthetic_train", "230",
       "--synthetic_valid", "32", "--synthetic_test", "32", "--model", "CompGCN", "--rank", "8",
       "--hidden_dim", "8", "--layers", "1", "--edge_dropout", "0.3", "--subgraph",
       "--neg_sample_size", "0", "--loss", "crossentropy", "--batch_size", "32",
       "--eval_batch_size", "64", "--optimizer", "Adam", "--learning_rate", "0.01",
       "--bias", "learn", "--multi_c", "--dtype", "float64", "--valid", "1", "--seed", "3",
       "--max_epochs", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """kge-train --subgraph without a mesh and on --mesh 1x2 (1 epoch)."""
    out = {}
    for mesh in (None, "1x2"):
        d = tmp_path_factory.mktemp(f"subgraph_{mesh}")
        out[mesh] = d, R.train(R.build_parser().parse_args(
            CLI + ["--save_dir", str(d), *(["--mesh", mesh] if mesh else [])]))
    return out


def test_cli_subgraph_on_a_mesh_writes_a_canonical_checkpoint(cli_runs):
    """The 1x2 run trains, validates and ranks as one process does; its
    checkpoint holds the 49-row tables, which the port and the JAX package
    load, and kge-test of it gives one process's metrics."""
    from complexhyperbolickge_tpu.train.checkpoint import load_checkpoint as jax_load

    (d0, one), (d, mesh) = cli_runs[None], cli_runs["1x2"]
    np.testing.assert_allclose(mesh["history"][0]["train_loss"],
                               one["history"][0]["train_loss"], rtol=1e-9)
    np.testing.assert_allclose(mesh["test"]["MRR"], one["test"]["MRR"], rtol=1e-9)
    for st in (load_checkpoint(str(d)), jax_load(str(d), device_put=False)):
        for k in ("entity", "bh", "bt"):
            assert st["params"][k].shape[0] == 49, k
    got = torch_test(str(d), device="cpu")
    np.testing.assert_allclose(got["MRR"], one["test"]["MRR"], rtol=1e-9)
    assert got == mesh["test"]
