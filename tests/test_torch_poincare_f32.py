"""PoincareGCN's subgraph step in float32 at init, in both packages.

At the subgraph path's width (rank 32, hidden 200, 2 layers, multi_c,
bias learn) the layers' relation maps put the relation stream close to the
ball's boundary at init, where float32 keeps few digits: a float32 step
misses the float64 step from the same params and subgraph by ~1e-2 in the
CE loss, and some gradients lose their sign.  JAX's SubgraphTrainer in
float32 misses its float64 step by the same amounts, so this is a property
of the model's init in float32 that the two packages share, not a fault of
the port: the port's float64 step equals JAX's, and its float32 errors
against float64 are JAX's within 5 %.  Both run on the CPU from JAX's
init (PRNGKey(0)) on one sampled subgraph of a 300-entity KG (every node
sampled: 300 nodes, 2,600 edges).
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.data import sampler as S
from complexhyperbolickge_torch.data.dataset import synthetic_kg
from complexhyperbolickge_torch.models import ModelConfig, get_model
from complexhyperbolickge_torch.train.checkpoint import params_from_jax
from complexhyperbolickge_torch.train.subgraph import SubgraphTrainer
from complexhyperbolickge_torch.train.trainer import TrainConfig
from complexhyperbolickge_tpu.data import sampler as jax_sampler
from complexhyperbolickge_tpu.data.dataset import synthetic_kg as jax_synthetic_kg
from complexhyperbolickge_tpu.models import ModelConfig as JaxConfig
from complexhyperbolickge_tpu.models import get_model as jax_get_model
from complexhyperbolickge_tpu.train.subgraph import SubgraphTrainer as JaxSubgraphTrainer
from complexhyperbolickge_tpu.train.trainer import TrainConfig as JaxTrainConfig

DATA = dict(n_entities=300, n_relations=11, n_train=1500, n_valid=50, n_test=50, seed=0)
ARGS = argparse.Namespace(hidden_dim=200, layers=2, edge_dropout=0.0, dropout=0.0,
                          gnn_agg_method=1)
CFG = dict(rank=32, bias="learn", multi_c=True)
TRAIN = dict(optimizer="Adam", learning_rate=1e-3, batch_size=500, neg_sample_size=0,
             loss="crossentropy")
SAMPLER = dict(fanouts=(20, 20), max_nodes=4096, max_edges=32768)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """(loss, gradients by port name as float64 numpy) of one subgraph step
    at init: {(package, dtype): ...}."""
    lib = S.load_library(S.build_library(tmp_path_factory.mktemp("native")))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(S, "_LIB", lib)
        mp.setattr(jax_sampler, "_LIB", lib)
        jdata, tdata = jax_synthetic_kg(**DATA), synthetic_kg(**DATA)
        n, r, _ = tdata.get_shape()
        init = None
        sub = None
        for dtype, np_dtype in (("float64", np.float64), ("float32", np.float32)):
            jm = jax_get_model("PoincareGCN")(JaxConfig(n_entities=n, n_relations=r, dtype=dtype,
                                                        **CFG), ARGS, jdata)
            jt = JaxSubgraphTrainer(jm, JaxTrainConfig(**TRAIN), jdata, **SAMPLER)
            if init is None:
                init = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
                sub = next(jt.sampler.epoch(500, np.random.default_rng(0), seed_base=0))
            *arrays, n_nodes, qw = jt._prep_host(sub)

            def cast(a):
                a = np.asarray(a)
                return jnp.asarray(a.astype(np_dtype) if a.dtype.kind == "f" else a)

            loss, grads = jax.jit(jax.value_and_grad(lambda p, *a: jt._loss(p, *a, None)))(
                jax.tree.map(cast, init), *map(cast, arrays), np_dtype(n_nodes), cast(qw))
            out["jax", dtype] = float(loss), {
                k: v.double().numpy()
                for k, v in params_from_jax(jax.tree.map(np.asarray, grads), "cpu").items()}

            tm = get_model("PoincareGCN")(ModelConfig(n_entities=n, n_relations=r, dtype=dtype,
                                                      **CFG), ARGS, tdata)
            tm.load_state_dict(params_from_jax(init, "cpu"))
            tt = SubgraphTrainer(tm, TrainConfig(**TRAIN), tdata, **SAMPLER)
            loss = tt._loss(*tt._to_device(tt._host_tensors(tt._prep_host(sub))))
            loss.backward()
            out["port", dtype] = float(loss.detach()), {
                k: (torch.zeros_like(p) if p.grad is None else p.grad).double().numpy()
                for k, p in tm.named_parameters()}
    assert sub.n_nodes == 300
    return out


def errors(got, want):
    """The loss's relative error, and the largest gradient error over its
    array's largest entry (floored at 1e-2 of every gradient's largest),
    as chip_smoke.py's subgraph-step parity measures them."""
    (l1, g1), (l0, g0) = got, want
    floor = 1e-2 * max(float(np.abs(g).max()) for g in g0.values())
    return abs(l1 - l0) / abs(l0), max(float(np.abs(g1[k] - g).max()) / max(float(np.abs(g).max()),
                                                                           floor)
                                       for k, g in g0.items())


def test_port_float64_step_equals_jax(steps):
    loss_err, grad_err = errors(steps["port", "float64"], steps["jax", "float64"])
    assert loss_err < 1e-12 and grad_err < 1e-9


def test_float32_at_init_misses_alike_in_both_packages(steps):
    jax_loss, jax_grad = errors(steps["jax", "float32"], steps["jax", "float64"])
    port_loss, port_grad = errors(steps["port", "float32"], steps["port", "float64"])
    assert jax_loss > 1e-3 and jax_grad > 0.5  # JAX's own float32 misses
    assert port_loss == pytest.approx(jax_loss, rel=0.05)
    assert port_grad == pytest.approx(jax_grad, rel=0.05)
