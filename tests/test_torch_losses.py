"""The port's all-entity losses (cross-entropy, BCE, signed-logsigmoid CE)
and its shared and pooled negative losses against the JAX package's, with
gradients, in float64 on the CPU.

One model of each family scores: FFTRotH (FFT), RotH (real-hyperbolic),
ComplEx (complex) and a CompGCN through BoundGNN over its eval-mode encoding
(the GNN takes no shared or pooled negatives, as in JAX).  Params are drawn
with numpy and injected into both packages; the shared ids, the pool and
its window offsets are JAX's own draws (its key splits rebuilt here), fed
to the port through its `draw` seam.  BCE labels are the synthetic graph's
train label pack.  Tolerance: rtol 1e-9, atol 1e-12.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.data.dataset import synthetic_kg
from complexhyperbolickge_torch.models import ModelConfig, get_model
from complexhyperbolickge_torch.models.gnn import BoundGNN
from complexhyperbolickge_torch.train import losses as TL
from complexhyperbolickge_torch.train.checkpoint import flatten, params_from_jax
from complexhyperbolickge_tpu.data.dataset import synthetic_kg as jax_synthetic_kg
from complexhyperbolickge_tpu.models import ModelConfig as JaxConfig
from complexhyperbolickge_tpu.models import get_model as jax_get_model
from complexhyperbolickge_tpu.models.gnn.models import BoundGNN as JaxBoundGNN
from complexhyperbolickge_tpu.train import losses as JL

TOL = dict(rtol=1e-9, atol=1e-12)
DATA = dict(n_entities=40, n_relations=3, n_train=300, n_valid=40, n_test=40, seed=5)
GNN_ARGS = dict(hidden_dim=8, layers=2, edge_dropout=0.0, dropout=0.0, opn="mult",
                interaction="distmult", basis=0, gnn_agg_method=1)
RANKS = {"FFTRotH": 5, "RotH": 6, "ComplEx": 6, "CompGCN": 6}
FAMILIES = list(RANKS)
B, K, POOL = 16, 5, 24


@pytest.fixture(scope="module")
def data():
    return synthetic_kg(**DATA), jax_synthetic_kg(**DATA)


def build(data, name, seed=0):
    """(JAX model, its params, the port model holding the same params)."""
    tdata, jdata = data
    n_ent, n_rel, _ = tdata.get_shape()
    cfg = dict(n_entities=n_ent, n_relations=n_rel, rank=RANKS[name], bias="learn",
               multi_c=True, dtype="float64")
    args = (argparse.Namespace(**GNN_ARGS), ) if name == "CompGCN" else ()
    jm = jax_get_model(name)(JaxConfig(**cfg), *args, *((jdata,) if args else ()))
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(lambda v: np.asarray(v) + rng.normal(0.0, 0.15, np.shape(v)),
                      jm.init(jax.random.PRNGKey(0)))
    tm = get_model(name)(ModelConfig(**cfg), *args, *((tdata,) if args else ()))
    tm.load_state_dict(params_from_jax(jp, "cpu"))
    return jm, jax.tree.map(jnp.asarray, jp), tm


def batch_of(data, seed=1):
    """B train rows (the last 3 at weight 0) and their label rows."""
    rows, labels = data[0].label_pack("train")
    idx = np.random.default_rng(seed).choice(len(rows), B, replace=False)
    w = np.ones(B)
    w[-3:] = 0.0
    return rows[idx], w, labels[idx]


def value_and_grads(jm, jp, tm, jax_loss, port_loss):
    """Loss and gradients of both packages; GNNs score through BoundGNN
    over the eval-mode encoding, inside the differentiated function."""
    is_gnn = getattr(jm, "is_gnn", False)

    def f(p):
        m = JaxBoundGNN(jm, jm.encode(p, key=None, training=False)) if is_gnn else jm
        return jax_loss(m, p)

    want, want_g = jax.value_and_grad(f)(jp)
    m = BoundGNN(tm, tm.encode(None, training=False)) if is_gnn else tm
    loss = port_loss(m)
    loss.backward()
    want_g = flatten(jax.tree.map(np.asarray, want_g))
    return loss, want, {n: (p.grad, want_g[n]) for n, p in tm.named_parameters()}


def assert_close(loss, want, grads):
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    for n, (g, w) in grads.items():
        got = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(got, w, err_msg=n, **TOL)
    assert any(g is not None and float(g.abs().max()) > 0 for g, _ in grads.values())


def tensors(batch, w, labels=None):
    out = (torch.as_tensor(batch, dtype=torch.int64), torch.as_tensor(w))
    return out if labels is None else (*out, torch.as_tensor(labels, dtype=torch.int64))


# ------------------------------ all-entity losses ------------------------------


@pytest.mark.parametrize("smoothing", [None, 0.1])
@pytest.mark.parametrize("name", FAMILIES)
def test_cross_entropy_loss_equals_jax(data, name, smoothing):
    jm, jp, tm = build(data, name)
    batch, w, _ = batch_of(data)
    n_ent = data[0].n_entities
    tb, tw = tensors(batch, w)
    loss, want, grads = value_and_grads(
        jm, jp, tm,
        lambda m, p: JL.cross_entropy_loss(m, p, jnp.asarray(batch), jnp.asarray(w),
                                           smoothing, n_entities=n_ent)[0],
        lambda m: TL.cross_entropy_loss(m, tb, tw, smoothing, n_entities=n_ent)[0])
    assert_close(loss, want, grads)


@pytest.mark.parametrize("smoothing", [None, 0.1])
@pytest.mark.parametrize("name", FAMILIES)
def test_bce_loss_equals_jax(data, name, smoothing):
    jm, jp, tm = build(data, name)
    batch, w, labels = batch_of(data)
    n_ent = data[0].n_entities
    assert (labels == n_ent).any() and (labels < n_ent).sum(1).max() > 1  # pads, multi-hot
    tb, tw, tl = tensors(batch, w, labels)
    loss, want, grads = value_and_grads(
        jm, jp, tm,
        lambda m, p: JL.bce_loss(m, p, jnp.asarray(batch), jnp.asarray(w),
                                 jnp.asarray(labels), n_ent, smoothing)[0],
        lambda m: TL.bce_loss(m, tb, tw, tl, n_ent, smoothing)[0])
    assert_close(loss, want, grads)


@pytest.mark.parametrize("name", FAMILIES)
def test_signed_logsigmoid_ce_loss_equals_jax(data, name):
    jm, jp, tm = build(data, name)
    batch, w, _ = batch_of(data)
    n_ent = data[0].n_entities
    tb, tw = tensors(batch, w)
    loss, want, grads = value_and_grads(
        jm, jp, tm,
        lambda m, p: JL.signed_logsigmoid_ce_loss(m, p, jnp.asarray(batch), jnp.asarray(w),
                                                  n_entities=n_ent)[0],
        lambda m: TL.signed_logsigmoid_ce_loss(m, tb, tw, n_entities=n_ent)[0])
    assert_close(loss, want, grads)


class _Padded:
    """A model whose score_all carries 3 extra (pad) columns of arbitrary
    scores, as a row-padded entity table gives them."""

    def __init__(self, model):
        self.model = model

    def __getattr__(self, name):
        return getattr(self.model, name)


@pytest.mark.parametrize("loss", ["ce", "ce_smoothed", "bce", "signed"])
def test_pad_columns_are_left_out_as_in_jax(data, loss):
    """With score_all padded past n_entities, each loss equals JAX's (pad
    columns masked the same way), and equals the unpadded loss."""
    jm, jp, tm = build(data, "FFTRotH")
    batch, w, labels = batch_of(data)
    n_ent = data[0].n_entities
    tb, tw, tl = tensors(batch, w, labels)
    pads = np.random.default_rng(3).normal(0.0, 2.0, (B, 3))

    class JaxPadded(_Padded):
        def score_all(self, p, q):
            return jnp.concatenate([self.model.score_all(p, q), jnp.asarray(pads)], axis=1)

    class PortPadded(_Padded):
        def score_all(self, q):
            return torch.cat([self.model.score_all(q), torch.as_tensor(pads)], dim=1)

    jax_fn = {"ce": lambda m, p: JL.cross_entropy_loss(m, p, batch, w, None, n_ent),
              "ce_smoothed": lambda m, p: JL.cross_entropy_loss(m, p, batch, w, 0.1, n_ent),
              "bce": lambda m, p: JL.bce_loss(m, p, batch, w, labels, n_ent, 0.1),
              "signed": lambda m, p: JL.signed_logsigmoid_ce_loss(m, p, batch, w, n_ent)}[loss]
    port_fn = {"ce": lambda m: TL.cross_entropy_loss(m, tb, tw, None, n_ent),
               "ce_smoothed": lambda m: TL.cross_entropy_loss(m, tb, tw, 0.1, n_ent),
               "bce": lambda m: TL.bce_loss(m, tb, tw, tl, n_ent, 0.1),
               "signed": lambda m: TL.signed_logsigmoid_ce_loss(m, tb, tw, n_ent)}[loss]
    got, want, grads = value_and_grads(JaxPadded(jm), jp, tm,
                                       lambda m, p: jax_fn(m, p)[0],
                                       lambda m: port_fn(PortPadded(m))[0])
    assert_close(got, want, grads)
    unpadded = port_fn(tm)[0]
    np.testing.assert_allclose(got.item(), unpadded.item(), **TOL)


def test_dense_labels_equal_jax(data):
    _, _, labels = batch_of(data)
    n_ent = data[0].n_entities
    got = TL.dense_labels(torch.as_tensor(labels), n_ent, torch.float64)
    want = JL.dense_labels(jnp.asarray(labels), n_ent, jnp.float64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------- shared and pooled negatives ---------------------------


def replay_draws(draws):
    """A `draw` that returns the given arrays in order, checking the shape
    and range asked for."""
    it = iter(draws)

    def draw(generator, high, shape, device):
        v = torch.as_tensor(np.array(next(it)), dtype=torch.int64)
        assert tuple(v.shape) == tuple(shape) and int(v.max()) < high
        return v

    return draw


def shared_draws(key, n_ent, double_neg):
    ks = jax.random.split(key, 2)
    return [jax.random.randint(ks[i], (K,), 0, n_ent) for i in range(1 + double_neg)]


def pool_draws(key, n_ent, double_neg):
    ks = jax.random.split(key, 3)
    return ([jax.random.randint(ks[0], (POOL,), 0, n_ent)]
            + [jax.random.randint(ks[1 + i], (B, 1), 0, POOL) for i in range(1 + double_neg)])


@pytest.mark.parametrize("double_neg", [False, True])
@pytest.mark.parametrize("mode", ["shared", "pool"])
@pytest.mark.parametrize("name", ["FFTRotH", "RotH", "ComplEx"])
def test_shared_and_pooled_negatives_equal_jax(data, name, mode, double_neg):
    jm, jp, tm = build(data, name)
    batch, w, _ = batch_of(data)
    n_ent, n_rel, _ = data[0].get_shape()
    key = jax.random.PRNGKey(17)
    tb, tw = tensors(batch, w)
    if mode == "shared":
        draws = shared_draws(key, n_ent, double_neg)
        jax_fn = lambda m, p: JL.neg_sampling_loss_shared(  # noqa: E731
            m, p, jnp.asarray(batch), jnp.asarray(w), key, n_ent, K, double_neg, n_rel)[0]
        port_fn = lambda m: TL.neg_sampling_loss_shared(  # noqa: E731
            m, tb, tw, None, n_ent, K, double_neg, n_rel, draw=replay_draws(draws))[0]
    else:
        draws = pool_draws(key, n_ent, double_neg)
        jax_fn = lambda m, p: JL.neg_sampling_loss_pooled(  # noqa: E731
            m, p, jnp.asarray(batch), jnp.asarray(w), key, n_ent, K, double_neg, n_rel,
            POOL)[0]
        port_fn = lambda m: TL.neg_sampling_loss_pooled(  # noqa: E731
            m, tb, tw, None, n_ent, K, double_neg, n_rel, POOL, draw=replay_draws(draws))[0]
    # a gold collision among the tail ids (the pool), so the mask is exercised
    assert (np.asarray(draws[0])[None, :] == batch[:, 2:3]).any()
    loss, want, grads = value_and_grads(jm, jp, tm, jax_fn, port_fn)
    assert_close(loss, want, grads)


def test_pooled_rejects_k_above_pool_size(data):
    _, _, tm = build(data, "FFTRotH")
    batch, w, _ = batch_of(data)
    with pytest.raises(ValueError, match="neg_pool_size"):
        TL.neg_sampling_loss_pooled(tm, *tensors(batch, w), None, 40, POOL + 1, False, 6, POOL)


def test_default_draws_stay_in_range():
    g = torch.Generator().manual_seed(0)
    ids = TL.uniform_ids(g, 7, (500,), "cpu")
    assert ids.dtype == torch.int64 and ids.min() == 0 and ids.max() == 6
