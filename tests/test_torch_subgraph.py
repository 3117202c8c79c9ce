"""Sampled-subgraph training in the port against the JAX package, in
float64 on the CPU, on the JAX sampler tests' small KG (60 entities, 4
relations, 400 train triples; max_nodes 128, max_edges 1024; fanouts 4/4).

* encode_subgraph of the four models on a sampled subgraph, with the
  gradients of a scalar of its outputs w.r.t. every parameter (each conv's
  forward_masked alone: tests/test_torch_subgraph_convs.py);
* SubgraphTrainer's loss and gradients against JAX's _loss for CE, CE with
  smoothing and BCE with smoothing, on an epoch's padded last batch;
* whole epochs: two epochs of SGD, and one with update_steps 2 (a partial
  window flushed at the end), end at JAX's params;
* a bfloat16 CompGCN trains with float32 optimizer state.
Tolerance: rtol 1e-9 with an absolute floor of 1e-9 times the array's
largest magnitude (index_add_ and XLA's scatter sum in other orders); the
trajectories 1e-8.  Dropout is 0 throughout: the port draws it from a
torch.Generator, JAX from its keys.  Both samplers load the port's library,
built once here from native/sampler.cpp.
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
from complexhyperbolickge_torch.parallel import Mesh
from complexhyperbolickge_torch.train.checkpoint import params_from_jax
from complexhyperbolickge_torch.train.subgraph import SubgraphTrainer
from complexhyperbolickge_torch.train.trainer import TrainConfig
from complexhyperbolickge_tpu.data import sampler as jax_sampler
from complexhyperbolickge_tpu.data.dataset import synthetic_kg as jax_synthetic_kg
from complexhyperbolickge_tpu.models import ModelConfig as JaxConfig
from complexhyperbolickge_tpu.models import get_model as jax_get_model
from complexhyperbolickge_tpu.train.subgraph import SubgraphTrainer as JaxSubgraphTrainer
from complexhyperbolickge_tpu.train.trainer import TrainConfig as JaxTrainConfig

DATA = dict(n_entities=60, n_relations=4, n_train=400, n_valid=50, n_test=50, seed=6)
MAX_NODES, MAX_EDGES, FANOUTS = 128, 1024, (4, 4)
SAMPLER = dict(fanouts=FANOUTS, max_nodes=MAX_NODES, max_edges=MAX_EDGES)
ARGS = dict(hidden_dim=8, layers=2, edge_dropout=0.0, dropout=0.0, opn="mult",
            interaction="distmult", basis=0, gnn_agg_method=1)


def close(got, want, name="", rtol=1e-9):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())), err_msg=name)


@pytest.fixture(scope="module", autouse=True)
def lib(tmp_path_factory):
    """The port's sampler library, built once into a fresh directory, as
    both packages' process-wide library."""
    built = S.load_library(S.build_library(tmp_path_factory.mktemp("native")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(S, "_LIB", built)
        mp.setattr(jax_sampler, "_LIB", built)
        yield built


@pytest.fixture(scope="module")
def data():
    return synthetic_kg(**DATA), jax_synthetic_kg(**DATA)


# ------------------------------ the models ---------------------------------


def build(data, name, over=None, multi_c=True, seed=0, dtype="float64"):
    """(JAX model, its perturbed params as numpy, the port model holding
    them)."""
    args = argparse.Namespace(**{**ARGS, **(over or {})})
    tdata, jdata = data
    n_ent, n_rel, _ = tdata.get_shape()
    cfg = dict(n_entities=n_ent, n_relations=n_rel, rank=8, multi_c=multi_c, dtype=dtype,
               bias="learn")
    jm = jax_get_model(name)(JaxConfig(**cfg), args, jdata)
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(lambda v: np.asarray(v) + rng.normal(0.0, 0.1, np.shape(v)),
                      jm.init(jax.random.PRNGKey(0)))
    tm = get_model(name)(ModelConfig(**cfg), args, tdata)
    tm.load_state_dict(params_from_jax(jp, "cpu"))
    return jm, jp, tm


def f64(a):
    """A float array as float64 for JAX (the port casts to the model's
    dtype itself; JAX would keep float32 norms of float32 edge weights)."""
    return np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32 else a


def jax_grads_named(jgrads):
    return params_from_jax(jax.tree.map(np.asarray, jgrads), "cpu")


def assert_grads(tm, jgrads):
    want = jax_grads_named(jgrads)
    for name, prm in tm.named_parameters():
        close(torch.zeros_like(prm) if prm.grad is None else prm.grad, want[name], name)


@pytest.mark.parametrize("name", ["CompGCN", "PoincareGCN", "LorentzGCN", "PoincareGAT"])
def test_encode_subgraph_matches_jax(data, name):
    jm, jp, tm = build(data, name)
    sampler = S.NeighborSampler(data[0], **SAMPLER)
    sub = sampler.sample(np.arange(0, 48, 2), seed=4)
    edge_w = sub.edge_weight * sub.train_mask
    node_w = (np.arange(MAX_NODES) < sub.n_nodes).astype(np.float64)
    x, rp = tm.encode_subgraph(torch.as_tensor(sub.node_ids).long(),
                               torch.as_tensor(sub.edges).long(), torch.as_tensor(edge_w),
                               torch.as_tensor(node_w))
    r = rp[0] if isinstance(rp, tuple) else rp
    rng = np.random.default_rng(2)
    gx, gr = rng.normal(size=tuple(x.shape)), rng.normal(size=tuple(r.shape))

    def jax_scalar(p):
        x, rp = jm.encode_subgraph(p, jnp.asarray(sub.node_ids), jnp.asarray(sub.edges),
                                   jnp.asarray(f64(edge_w)), jnp.asarray(node_w))
        r = rp[0] if isinstance(rp, tuple) else rp
        return jnp.sum(x * gx) + jnp.sum(r * gr), (x, rp)

    (_, (jx, jrp)), jgrads = jax.jit(jax.value_and_grad(jax_scalar, has_aux=True))(
        jax.tree.map(jnp.asarray, jp))
    (torch.sum(x * torch.as_tensor(gx)) + torch.sum(r * torch.as_tensor(gr))).backward()
    close(x.detach(), jx)
    close(r.detach(), jrp[0] if isinstance(jrp, tuple) else jrp)
    if isinstance(rp, tuple):  # the softplused curvature
        close(rp[1].detach(), jrp[1])
    assert_grads(tm, jgrads)


# ------------------------------- the loss ----------------------------------

LOSSES = {"ce": ("crossentropy", None), "ce_smooth": ("crossentropy", 0.1),
          "bce_smooth": ("binarycrossentropy", 0.1)}


def trainers(data, name, loss, smoothing, optimizer="SGD", update_steps=1, reg=0.0):
    jm, jp, tm = build(data, name)
    kw = dict(optimizer=optimizer, learning_rate=0.05, batch_size=64, neg_sample_size=0,
              loss=loss, smoothing=smoothing, update_steps=update_steps, reg=reg)
    jt = JaxSubgraphTrainer(jm, JaxTrainConfig(**kw), data[1], **SAMPLER)
    tt = SubgraphTrainer(tm, TrainConfig(**kw), data[0], **SAMPLER)
    return jt, jax.tree.map(jnp.asarray, jp), tt


@pytest.mark.parametrize("name,case", [("CompGCN", "ce"), ("CompGCN", "ce_smooth"),
                                       ("CompGCN", "bce_smooth"), ("PoincareGCN", "bce_smooth")])
def test_loss_and_grads_match_jax_on_a_padded_batch(data, name, case):
    loss, smoothing = LOSSES[case]
    jt, jp, tt = trainers(data, name, loss, smoothing, reg=0.01 if name == "CompGCN" else 0.0)
    # the epoch's last batch: 800 seed edges in batches of 64 leave 32
    sub = list(tt.sampler.epoch(64, np.random.default_rng(1), seed_base=1))[-1]
    assert sub.query_weight.sum() == 32
    # JAX's batch keeps the padded capacity (MAX_NODES, MAX_EDGES); the
    # port's is cut to the real nodes and edges
    *jarrays, n_nodes, qw = jt._prep_host(sub)
    jargs = [jnp.asarray(f64(a)) for a in jarrays]
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, *a: jt._loss(p, *a, None)))(jp, *jargs, np.float64(n_nodes),
                                              jnp.asarray(f64(qw)))
    prepped = tt._prep_host(sub)
    assert len(prepped[0]) == sub.n_nodes < MAX_NODES and len(prepped[1]) == sub.n_edges
    got = tt._loss(*tt._to_device(tt._host_tensors(prepped)))
    got.backward()
    close(got.detach(), jloss)
    assert_grads(tt.model, jgrads)


# ------------------------------ the epochs ---------------------------------


@pytest.mark.parametrize("name,case,update_steps,epochs", [
    ("CompGCN", "ce", 1, 2), ("CompGCN", "bce_smooth", 2, 1)])
def test_epochs_end_at_jax_params(data, name, case, update_steps, epochs):
    loss, smoothing = LOSSES[case]
    jt, jp, tt = trainers(data, name, loss, smoothing, update_steps=update_steps)
    jo = jt.tx.init(jp)
    for epoch in range(epochs):
        rng = np.random.default_rng([3, epoch])
        jp, jo, jloss = jt.run_epoch(jp, jo, 64, rng, jax.random.PRNGKey(epoch),
                                     epoch_id=epoch)
        tloss = tt.run_epoch(64, np.random.default_rng([3, epoch]), None, epoch_id=epoch)
        close(tloss, jloss, rtol=1e-8)
    want = jax_grads_named(jp)
    for k, v in tt.model.state_dict().items():
        close(v, want[k], k, rtol=1e-8)


def test_bf16_step_keeps_float32_optimizer_state(data):
    _, _, tm = build(data, "CompGCN", dtype="bfloat16")
    tt = SubgraphTrainer(tm, TrainConfig(optimizer="Adam", learning_rate=0.01, batch_size=32,
                                         neg_sample_size=0, loss="crossentropy"),
                         data[0], **SAMPLER)
    before = tm.entity.detach().clone()
    loss = tt.run_epoch(32, np.random.default_rng(0), torch.Generator().manual_seed(0),
                        max_steps=3)
    assert np.isfinite(loss)
    assert tm.entity.dtype == torch.bfloat16 and not torch.equal(tm.entity, before)
    states = [v for st in tt.optimizer.state_dict()["state"].values() for k, v in st.items()
              if k != "step"]
    assert states and all(v.dtype == torch.float32 for v in states)


def test_subgraph_trainer_refuses_what_jax_refuses(data):
    _, _, tm = build(data, "CompGCN")
    with pytest.raises(ValueError, match="neg_sample_size 0"):
        SubgraphTrainer(tm, TrainConfig(neg_sample_size=5), data[0], **SAMPLER)
    with pytest.raises(ValueError, match="'data' axis 2"):
        SubgraphTrainer(tm, TrainConfig(neg_sample_size=0, batch_size=33), data[0],
                        mesh=Mesh((2, 1)), **SAMPLER)
    shallow = get_model("RotH")(ModelConfig(n_entities=60, n_relations=8, rank=4))
    with pytest.raises(ValueError, match="GNN-only"):
        SubgraphTrainer(shallow, TrainConfig(neg_sample_size=0), data[0], **SAMPLER)


def test_sampler_errors_reraise_in_order_and_the_producer_stops(data, monkeypatch):
    _, _, tm = build(data, "CompGCN")
    tt = SubgraphTrainer(tm, TrainConfig(optimizer="SGD", learning_rate=0.01, batch_size=64,
                                         neg_sample_size=0), data[0], **SAMPLER)
    real = tt.sampler.sample
    calls = []

    def flaky(seeds, seed=0):
        calls.append(seed)
        if len(calls) == 3:
            raise RuntimeError("sampler broke")
        return real(seeds, seed)

    monkeypatch.setattr(tt.sampler, "sample", flaky)
    before = tm.entity.detach().clone()
    with pytest.raises(RuntimeError, match="sampler broke"):
        tt.run_epoch(64, np.random.default_rng(0))
    assert len(calls) == 3  # the producer stopped at the error
    assert not torch.equal(tm.entity.detach(), before)  # the two batches before it stepped
