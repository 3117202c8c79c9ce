"""The port's GNN models (models/gnn/models.py) against the JAX package's,
in float64 on the CPU.

JAX's init, perturbed by numpy noise, is injected into the port model as
`jax.tree.map(np.asarray, params)` through checkpoint.params_from_jax (the
nested params["gnn"] list flattens to the state_dict's gnn.<i>.* keys).
encode, score, score_all, get_factors and the gradients of a scalar of the
scores w.r.t. every parameter agree at rtol 1e-9, with an absolute floor of
1e-9 times the array's largest magnitude (sums with cancellation round
differently in another order).  The encoder's gathers and sorted sums run
K10's and K9's plain versions.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.data.dataset import synthetic_kg
from complexhyperbolickge_torch.models import GNN_MODELS, ModelConfig, get_model
from complexhyperbolickge_torch.models.base import NoMask
from complexhyperbolickge_torch.train import checkpoint as ckpt
from complexhyperbolickge_tpu.data.dataset import synthetic_kg as jax_synthetic_kg
from complexhyperbolickge_tpu.models import ModelConfig as JaxConfig
from complexhyperbolickge_tpu.models import get_model as jax_get_model
from complexhyperbolickge_tpu.train import checkpoint as jax_ckpt

RANK = 8
DATA = dict(n_entities=40, n_relations=4, n_train=300, n_valid=40, n_test=40, seed=5)
ARGS = dict(hidden_dim=8, layers=2, edge_dropout=0.0, dropout=0.0, opn="mult",
            interaction="distmult", basis=0, gnn_agg_method=1)

# (model, flag overrides, multi_c)
CASES = [
    ("CompGCN", {}, True),
    ("CompGCN", {"basis": 3, "interaction": "transe", "opn": "add"}, True),
    ("PoincareGCN", {}, True),
    ("PoincareGCN", {}, False),
    ("PoincareGCN", {"gnn_agg_method": 2}, True),
    ("PoincareGCN", {"gnn_agg_method": 3}, True),
    ("LorentzGCN", {}, True),
    ("PoincareGAT", {}, True),
    ("PoincareGAT", {"layers": 3}, False),
]


def close(got, want, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9,
                               atol=1e-9 * max(1.0, float(np.abs(want).max())), err_msg=name)


@pytest.fixture(scope="module")
def data():
    return synthetic_kg(**DATA), jax_synthetic_kg(**DATA)


def build(data, name, over=None, multi_c=True, seed=0):
    """(JAX model, its perturbed params, the port model holding them)."""
    args = argparse.Namespace(**{**ARGS, **(over or {})})
    tdata, jdata = data
    n_ent, n_rel, _ = tdata.get_shape()
    cfg = dict(n_entities=n_ent, n_relations=n_rel, rank=RANK, multi_c=multi_c,
               dtype="float64")
    jm = jax_get_model(name)(JaxConfig(**cfg), args, jdata)
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(lambda v: np.asarray(v) + rng.normal(0.0, 0.1, np.shape(v)),
                      jm.init(jax.random.PRNGKey(0)))
    tm = get_model(name)(ModelConfig(**cfg), args, tdata)
    tm.load_state_dict(ckpt.params_from_jax(jp, "cpu"))
    return jm, jax.tree.map(jnp.asarray, jp), tm


def queries(n_ent, n_rel, b=12, k=5, seed=1):
    rng = np.random.default_rng(seed)
    return (np.stack([rng.integers(0, n_ent, b), rng.integers(0, n_rel, b)], 1),
            rng.integers(0, n_ent, (b, k)))


@pytest.mark.parametrize("name,over,multi_c", CASES)
def test_model_matches_jax(data, name, over, multi_c):
    jm, jp, tm = build(data, name, over, multi_c)
    q, tails = queries(tm.cfg.n_entities, tm.cfg.n_relations)
    g_all = np.random.default_rng(2).normal(size=(len(q), tm.cfg.n_entities))

    def jax_scalar(p):
        """A scalar of both scores, with the encoding, the scores and the
        factors on the side (one jitted program)."""
        cache = jm.encode(p)
        s_all = jm.score_all(p, jnp.asarray(q), cache=cache)
        s = jm.score(p, jnp.asarray(q), jnp.asarray(tails), cache=cache)
        factors = [f.value for f in jm.get_factors(p)]
        return jnp.sum(s_all * g_all) + jnp.sum(s), (cache, s_all, s, factors)

    (_, (jcache, js_all, js, jfactors)), jgrad = jax.jit(
        jax.value_and_grad(jax_scalar, has_aux=True))(jp)

    cache = tm.encode()
    for a, b in zip(jax.tree.leaves(cache), jax.tree.leaves(jcache)):
        close(a.detach(), b)
    s_all = tm.score_all(torch.as_tensor(q))
    s = tm.score(torch.as_tensor(q), torch.as_tensor(tails))
    close(s_all.detach(), js_all)
    close(s.detach(), js)
    factors = tm.get_factors()
    assert len(factors) == len(jfactors) and all(isinstance(f, NoMask) for f in factors)
    for a, b in zip(factors, jfactors):
        close(a.value.detach(), b)

    # gradients of the scores through the encoder (K9's and K10's backwards)
    want = ckpt.params_from_jax(jax.tree.map(np.asarray, jgrad), "cpu")
    (torch.sum(s_all * torch.as_tensor(g_all)) + torch.sum(s)).backward()
    assert set(want) == {n for n, _ in tm.named_parameters()}
    for n, p in tm.named_parameters():
        close(torch.zeros_like(p) if p.grad is None else p.grad, want[n], n)


def test_nested_params_round_trip_and_schema(data):
    """params_to_jax nests the state_dict into JAX's tree (same structure
    and values), params_from_jax flattens it back, and _schema keys it by
    keystr exactly as the JAX package does."""
    _, jp, tm = build(data, "PoincareGCN")
    tree = ckpt.params_to_jax(tm.state_dict())
    assert jax.tree.structure(tree) == jax.tree.structure(jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert isinstance(tree["gnn"], list) and isinstance(tree["gnn"][0]["mlp_curvature"], list)
    back = ckpt.params_from_jax(tree, "cpu")
    assert set(back) == set(tm.state_dict())
    assert all(torch.equal(back[k], v) for k, v in tm.state_dict().items())
    assert ckpt._schema(tree) == jax_ckpt._schema(jp) == ckpt._schema(tm.state_dict())
    assert "['gnn'][0]['mlp_curvature'][1]['w']" in ckpt._schema(tree)
    # a flat model's schema keeps plain names
    assert ckpt._schema({"entity": np.zeros((2, 3))}) == {"entity": [[2, 3], "float64"]}


def test_edge_dropout_changes_the_encoding(data):
    """Training-mode encodes draw edge dropout from the generator; the
    eval-mode encode is deterministic and ignores a generator."""
    _, _, tm = build(data, "CompGCN", {"edge_dropout": 0.2})
    x0, _ = tm.encode()
    x1, _ = tm.encode(torch.Generator().manual_seed(3), training=True)
    x2, _ = tm.encode(torch.Generator().manual_seed(4), training=True)
    assert not torch.allclose(x0, x1) and not torch.allclose(x1, x2)
    x3, _ = tm.encode(torch.Generator().manual_seed(3))
    assert torch.equal(x0, x3)
    x4, _ = tm.encode(torch.Generator().manual_seed(3), training=True)
    assert torch.equal(x1, x4)


def test_compgcn_between_layer_dropout(data):
    """CompGCN drops x features between its layers when training (the
    hyperbolic GNNs do not); eval mode ignores it."""
    _, _, tm = build(data, "CompGCN", {"dropout": 0.5})
    assert tm.drop_in_between
    x1, _ = tm.encode(torch.Generator().manual_seed(3), training=True)
    tm.drop_in_between = False
    x2, _ = tm.encode(torch.Generator().manual_seed(3), training=True)
    assert not torch.allclose(x1, x2)
    assert not build(data, "PoincareGCN", {"dropout": 0.5})[2].drop_in_between


def test_cached_encode_follows_the_params_version(data):
    _, _, tm = build(data, "LorentzGCN")
    a = tm.cached_encode()
    assert tm.cached_encode() is a
    with torch.no_grad():
        tm.gnn[0].w_in.mul_(1.5)  # an in-place update, as an optimizer step
    b = tm.cached_encode()
    assert b is not a and not torch.equal(a[0], b[0])
    torch.testing.assert_close(b[0], tm.encode()[0].detach(), rtol=0, atol=0)


def test_registry_and_build_model(data):
    from complexhyperbolickge_torch.cli.run import build_model, build_parser

    assert GNN_MODELS == ["CompGCN", "PoincareGCN", "PoincareGAT", "LorentzGCN"]
    args = build_parser().parse_args(["--model", "PoincareGAT", "--rank", "8",
                                      "--hidden_dim", "16", "--multi_c", "--dtype", "float64"])
    m = build_model(args, data[0], "cpu", generator=torch.Generator().manual_seed(0))
    assert type(m).__name__ == "PoincareGAT" and m.gnn[0].gather == "concat"
    assert m.graph.head.shape[0] == 2 * len(data[0].data["train"])
    same = build_model(args, data[0], "cpu", generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(p, q) for p, q in zip(m.parameters(), same.parameters()))
    same.reset_parameters(torch.Generator().manual_seed(0))
    assert all(torch.equal(p, q) for p, q in zip(m.parameters(), same.parameters()))
