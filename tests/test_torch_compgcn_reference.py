"""The port's CompGCN (models/gnn) against the plain reference
tests/plain_compgcn.py on the CPU, on seeded random weights at a small
size (64 entities, 3 relations, 300 triples, rank 8, hidden 16), with one
and two layers, BCE with and without label smoothing, in float64 and
float32: the encoder's output, the all-entity scores, the loss, every
leaf's gradient and one Adam step, all through Trainer.train_step over a
batch of the label packs (data/dataset.py::label_pack, epoch_batches).

Tolerances are on the largest entry of each quantity: 1e-10 in float64,
where only the order of the sums differs (the port sums before it
projects, over sorted halves), and 1e-5 in float32, where that order moves
a sum by a few ulps and batch norm's division by the deviation carries it
on.

Also: message.relation_rows' gradient is plain indexing's bit for bit, and
a profiler trace of one training step of each GNN model holds
kge.train.encode inside kge.train.loss and kge.train.rel_grad inside
kge.train.backward.
"""

import argparse
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import plain_compgcn as ref
from complexhyperbolickge_torch.data.dataset import epoch_batches, synthetic_kg
from complexhyperbolickge_torch.models import GNN_MODELS, ModelConfig, get_model
from complexhyperbolickge_torch.models.gnn import message as M
from complexhyperbolickge_torch.train.trainer import TrainConfig, Trainer

RANK, HIDDEN, BATCH, LR = 8, 16, 64, 1e-3
DATA = dict(n_entities=64, n_relations=3, n_train=300, n_valid=20, n_test=20, seed=7)
TOL = {torch.float64: 1e-10, torch.float32: 1e-5}
# (dtype, layers, smoothing)
CASES = [(d, n, s) for d in (torch.float64, torch.float32) for n in (1, 2) for s in (None, 0.1)]
IDS = [f"{str(d)[6:]}-{n}layer-{'smooth' if s else 'plain'}" for d, n, s in CASES]


@pytest.fixture(scope="module")
def kg():
    return synthetic_kg(**DATA)


def gnn_args(layers):
    return argparse.Namespace(hidden_dim=HIDDEN, layers=layers, edge_dropout=0.0,
                              dropout=0.0, opn="mult", interaction="distmult", basis=0,
                              gnn_agg_method=1)


def build(kg, name, dtype, layers):
    n_ent, n_rel, _ = kg.get_shape()
    cfg = ModelConfig(n_entities=n_ent, n_relations=n_rel, rank=RANK, bias="learn",
                      multi_c=True, dtype=str(dtype)[6:])
    return get_model(name)(cfg, gnn_args(layers), kg,
                           generator=torch.Generator().manual_seed(3))


def random_weights(model, seed):
    """Every parameter drawn from N(0, 1) (batch norm's scale around 1):
    weights at which no term of the step is negligible."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            v = torch.randn(p.shape, generator=gen, dtype=torch.float64)
            if name.endswith("bn_scale"):
                v = 1.0 + 0.1 * v
            elif name.endswith(("w_in", "w_out", "w_loop", "w_rel")):
                v = v / p.shape[0] ** 0.5
            p.copy_(v.to(p.dtype))


def close(got, want, tol, name=""):
    got, want = got.detach(), want.detach()
    assert got.shape == want.shape, name
    err = float((got - want).abs().max())
    assert err <= tol * max(float(want.abs().max()), 1e-300), f"{name}: {err}"


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def step(request, kg):
    """One Trainer.train_step of the port (gradients kept, then one Adam
    step) and the reference's loss, gradients and Adam step from the same
    weights on the same batch."""
    dtype, layers, smoothing = request.param
    model = build(kg, "CompGCN", dtype, layers)
    random_weights(model, seed=11 + layers)
    w0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    n_ent, n_rel, _ = kg.get_shape()
    trainer = Trainer(model, TrainConfig(optimizer="Adam", learning_rate=LR, batch_size=BATCH,
                                         neg_sample_size=0, loss="binarycrossentropy",
                                         smoothing=smoothing), n_ent, n_rel)
    examples = kg.get_examples("train")
    _, labels = kg.label_pack("train")
    b, w, lab = epoch_batches(examples, BATCH, np.random.default_rng(5), labels)
    i = len(b) - 1  # the padded last batch: its weights count
    batch, weights = torch.as_tensor(b[i], dtype=torch.int64), torch.as_tensor(w[i], dtype=dtype)
    with torch.no_grad():
        x, rel = model.encode()
        scores = model.score_all(batch[:, :2])
    trainer.optimizer.zero_grad(set_to_none=True)
    loss = trainer.train_step(batch, weights, None, apply=False,
                              labels=torch.as_tensor(lab[i], dtype=torch.int64))
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    trainer.optimizer.step()
    after = {k: p.detach().clone() for k, p in model.named_parameters()}

    P = {k: v.clone().requires_grad_() for k, v in w0.items()}
    graph = ref.edges(kg.data["train"], n_rel)
    multi_hot = ref.multi_hot(examples, batch, n_ent, dtype)
    want_x, want_rel = ref.encode(P, graph, layers)
    want_loss = ref.loss(P, graph, batch, weights, multi_hot, layers, smoothing or 0.0)
    names = sorted(P)
    want_grads = dict(zip(names, torch.autograd.grad(want_loss, [P[k] for k in names])))
    return dict(
        dtype=dtype, tol=TOL[dtype], port=dict(x=x, rel=rel, scores=scores, loss=loss,
                                               grads=grads, after=after),
        want=dict(x=want_x, rel=want_rel, scores=ref.score_all(P, want_x, want_rel, batch),
                  loss=want_loss, grads=want_grads,
                  after=ref.adam(P, want_grads, {}, 1, LR)))


def test_encoder_matches_reference(step):
    close(step["port"]["x"], step["want"]["x"], step["tol"], "x")
    close(step["port"]["rel"], step["want"]["rel"], step["tol"], "rel")


def test_all_entity_scores_match_reference(step):
    close(step["port"]["scores"], step["want"]["scores"], step["tol"], "scores")


def test_loss_matches_reference(step):
    close(step["port"]["loss"], step["want"]["loss"], step["tol"], "loss")


def test_every_gradient_matches_reference(step):
    port, want = step["port"]["grads"], step["want"]["grads"]
    assert set(port) == set(want)
    for k in sorted(want):
        close(port[k], want[k], step["tol"], k)


def test_adam_step_matches_reference(step):
    port, want = step["port"]["after"], step["want"]["after"]
    assert set(port) == set(want)
    for k in sorted(want):
        close(port[k], want[k], step["tol"], k)


@pytest.mark.parametrize("dtype, shape", [(torch.float64, (22, 8)), (torch.float32, (22, 8)),
                                          (torch.float32, (22, 4, 6))])
def test_relation_rows_gradient_is_plain_indexing(dtype, shape):
    gen = torch.Generator().manual_seed(2)
    table = torch.randn(shape, generator=gen, dtype=dtype)
    ids = torch.randint(0, shape[0], (1000,), generator=gen)
    g = torch.randn((1000, *shape[1:]), generator=gen, dtype=dtype)
    a, b = table.clone().requires_grad_(), table.clone().requires_grad_()
    got = M.relation_rows(a, ids)
    want = b[ids]
    assert torch.equal(got, want)
    got.backward(g)
    want.backward(g)
    assert torch.equal(a.grad, b.grad)


def _ops(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("cat") == "cpu_op" and e["name"].startswith("kge.")]


@pytest.mark.parametrize("name", GNN_MODELS)
def test_a_gnn_step_holds_the_encode_and_relation_gradient_ranges(kg, name, tmp_path):
    model = build(kg, name, torch.float32, 1)
    n_ent, n_rel, _ = kg.get_shape()
    trainer = Trainer(model, TrainConfig(optimizer="Adam", batch_size=BATCH,
                                         neg_sample_size=0, loss="binarycrossentropy"),
                      n_ent, n_rel)
    _, labels = kg.label_pack("train")
    b, w, lab = epoch_batches(kg.get_examples("train"), BATCH, None, labels)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(torch.as_tensor(b[0], dtype=torch.int64), torch.as_tensor(w[0]),
                           None, labels=torch.as_tensor(lab[0], dtype=torch.int64))
    ops = _ops(prof, tmp_path)

    def one(n):
        found = [o for o in ops if o[0] == n]
        assert len(found) == 1, (n, [o[0] for o in ops])
        return found[0]

    def inside(a, b):
        return b[1] <= a[1] and a[2] <= b[2]

    assert inside(one("kge.train.encode"), one("kge.train.loss"))
    backward = one("kge.train.backward")
    grads = [o for o in ops if o[0] == "kge.train.rel_grad"]
    assert grads and all(inside(o, backward) for o in grads)
    assert not any(inside(o, one("kge.train.loss")) for o in grads)
