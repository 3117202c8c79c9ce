"""The relation table's gradient (kernels/relgrad.py) on the CPU: the
static relation-sorted layout, the plain split-segment version against
index_add_, and message.relation_rows with and without a layout.

Tolerances: the split sum adds each chunk's rows in the table's dtype and
the chunk partials in float64, another order than index_add_'s, so 1e-12
relative to the largest entry in float64 and 1e-5 in float32.  On the CPU
relation_rows keeps autograd's accumulate even with a layout (the kernels
run only on the card); its split-segment route is reached here by letting
`use_kernel` accept CPU tables, which then runs the plain version.
"""

import argparse

import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.data.dataset import epoch_batches, synthetic_kg
from complexhyperbolickge_torch.kernels import relgrad as R
from complexhyperbolickge_torch.models import ModelConfig, get_model
from complexhyperbolickge_torch.models.gnn import message as M
from complexhyperbolickge_torch.train.trainer import TrainConfig, Trainer

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def draw_ids(e, n_ids, seed, missing=()):
    """(e,) ids in [0, n_ids) drawn unevenly (id 0 the most often), none of
    `missing`."""
    rng = np.random.default_rng(seed)
    keep = np.array([i for i in range(n_ids) if i not in missing])
    p = 1.0 / (1.0 + np.arange(keep.size))
    return torch.as_tensor(rng.choice(keep, e, p=p / p.sum()))


def index_add(g, ids, n_rows):
    return g.new_zeros((n_rows, *g.shape[1:])).index_add_(0, ids, g)


def close(got, want, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float((got - want).abs().max())
    assert err <= TOL[dtype] * max(float(want.abs().max()), 1e-300), err


# ---------------------------------- layout ------------------------------------


@pytest.mark.parametrize("e, n_ids, chunk_rows", [(1000, 22, 16), (3000, 5, 128),
                                                  (7, 3, 1), (500, 11, 1000)])
def test_layout_covers_every_row_once_in_chunks_of_one_id(e, n_ids, chunk_rows):
    ids = draw_ids(e, n_ids, seed=e, missing=(1,))
    lay = R.RelationLayout(ids, "cpu", chunk_rows)
    perm, chunks = lay.perm.long(), lay.chunks.long()
    assert lay.perm.dtype == lay.chunks.dtype == lay.chunk_ptr.dtype == torch.int32
    assert torch.equal(torch.sort(perm).values, torch.arange(e))
    assert torch.equal(ids[perm], torch.sort(ids, stable=True).values)
    assert all(torch.diff(perm[ids[perm] == i]).gt(0).all() for i in range(n_ids))
    counts = torch.bincount(ids, minlength=lay.num_ids)
    assert lay.num_ids == int(ids.max()) + 1
    assert torch.equal(torch.diff(lay.offsets.long()), counts)
    # the chunks tile [0, e) in order, each of at most chunk_rows rows of one id
    assert int(chunks[0, 0]) == 0 and int(chunks[-1, 1]) == e
    assert torch.equal(chunks[1:, 0], chunks[:-1, 1])
    size = chunks[:, 1] - chunks[:, 0]
    assert bool((size > 0).all()) and bool((size <= chunk_rows).all())
    for s, t, i in chunks.tolist():
        assert bool((ids[perm[s:t]] == i).all())
    # chunk_ptr gives each id its chunks; id 1 has none
    per_id = torch.bincount(chunks[:, 2], minlength=lay.num_ids)
    assert torch.equal(torch.diff(lay.chunk_ptr.long()), per_id)
    assert int(per_id[1]) == 0
    assert torch.equal(per_id, (counts + chunk_rows - 1) // chunk_rows)


def test_layout_refuses_bad_ids_and_shifts_share_the_tensors():
    with pytest.raises(ValueError, match="1-D"):
        R.RelationLayout(torch.zeros((2, 3), dtype=torch.int64), "cpu")
    with pytest.raises(ValueError, match="non-negative"):
        R.RelationLayout(torch.tensor([0, -1]), "cpu")
    with pytest.raises(ValueError, match="chunk_rows"):
        R.RelationLayout(torch.tensor([0, 1]), "cpu", chunk_rows=0)
    lay = R.RelationLayout(torch.tensor([4, 2, 2]), "cpu")
    moved = lay.shifted(3).shifted(-1)
    assert (lay.shift, moved.shift) == (0, 2) and moved.perm is lay.perm
    assert lay.id_range == (2, 4)
    empty = R.RelationLayout(torch.zeros(0, dtype=torch.int64), "cpu")
    assert (empty.num_ids, empty.id_range, tuple(empty.chunks.shape)) == (0, None, (0, 3))
    assert torch.equal(R.relation_grad(torch.zeros((0, 4)), empty, 3), torch.zeros((3, 4)))


# ------------------------------- plain version --------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("trailing", [(1,), (3,), (100,), (200,), (4, 6)])
def test_plain_split_sum_is_index_add(dtype, trailing):
    e, n_ids = 3000, 22
    ids = draw_ids(e, n_ids, seed=7, missing=(3, 21))  # rows 3 and 21 get no rows
    lay = R.RelationLayout(ids, "cpu", chunk_rows=64)
    g = torch.randn((e, *trailing), generator=torch.Generator().manual_seed(1), dtype=dtype)
    got = R.relation_grad_plain(g, lay, n_ids)
    close(got, index_add(g, ids, n_ids), dtype)
    assert not got[3].any() and not got[21].any()
    # the wrapper runs the plain version on the CPU and launches nothing
    R.reset_launches()
    assert torch.equal(R.relation_grad(g, lay, n_ids), got)
    assert R.launches == {"relation_grad": 0, "relation_grad_accumulate": 0}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_split_sum_of_shifted_ids_and_a_noncontiguous_g(dtype):
    e, n_ids, shift = 2000, 11, 11
    ids = draw_ids(e, n_ids, seed=3)
    lay = R.RelationLayout(ids, "cpu", chunk_rows=32)
    g = torch.randn((8, e), generator=torch.Generator().manual_seed(2), dtype=dtype).t()
    assert not g.is_contiguous()
    close(R.relation_grad_plain(g, lay.shifted(shift), 2 * n_ids),
          index_add(g, ids + shift, 2 * n_ids), dtype)
    # the inverse half's ids shifted down into the first rows
    up = ids + n_ids
    lay_up = R.RelationLayout(up, "cpu", chunk_rows=32)
    close(R.relation_grad_plain(g, lay_up.shifted(-n_ids), 2 * n_ids),
          index_add(g, ids, 2 * n_ids), dtype)


def test_split_sum_refuses_mismatched_inputs():
    lay = R.RelationLayout(torch.tensor([0, 1, 5]), "cpu")
    g = torch.randn(3, 4)
    with pytest.raises(ValueError, match="shape"):
        R.relation_grad(g[:2], lay, 6)
    with pytest.raises(ValueError, match="outside"):
        R.relation_grad(g, lay, 5)  # id 5 has no row in a 5-row table
    with pytest.raises(ValueError, match="outside"):
        R.relation_grad(g, lay.shifted(-1), 6)  # id 0 would land on row -1
    with pytest.raises(ValueError, match="outside"):
        R.relation_grad_plain(g, lay.shifted(1), 6)
    with pytest.raises(ValueError, match="rows"):
        M.relation_rows(torch.randn(6, 4), torch.tensor([0, 1]), lay)


# ------------------------------- relation_rows --------------------------------


@pytest.fixture
def split_route(monkeypatch):
    """relation_rows' split-segment route on the CPU: use_kernel accepts any
    layout, so the backward calls relation_grad, which runs the plain
    version here."""
    monkeypatch.setattr(R, "use_kernel", lambda table, layout: layout is not None)


@pytest.mark.parametrize("dtype, shape", [(torch.float64, (22, 8)), (torch.float32, (22, 100)),
                                          (torch.float32, (22, 4, 6)), (torch.float64, (22, 1))])
def test_relation_rows_with_a_layout_is_indexing(split_route, dtype, shape):
    gen = torch.Generator().manual_seed(2)
    table = torch.randn(shape, generator=gen, dtype=dtype)
    ids = draw_ids(1000, shape[0] // 2, seed=4) + shape[0] // 2  # rows 0..10 get none
    lay = R.RelationLayout(ids, "cpu", chunk_rows=16)
    g = torch.randn((1000, *shape[1:]), generator=gen, dtype=dtype)
    a, b = table.clone().requires_grad_(), table.clone().requires_grad_()
    R.reset_launches()
    got = M.relation_rows(a, ids, lay)
    want = b[ids]
    assert torch.equal(got, want)
    got.backward(g)
    want.backward(g)
    close(a.grad, b.grad, dtype)
    assert not a.grad[: shape[0] // 2].any()
    assert R.launches["relation_grad_accumulate"] == 0
    # and with the swapped types' shift: the ids moved down, the layout with them
    a.grad = None
    M.relation_rows(a, ids - shape[0] // 2, lay.shifted(-(shape[0] // 2))).backward(g)
    close(a.grad, torch.zeros_like(table).index_add_(0, ids - shape[0] // 2, g), dtype)


@pytest.mark.parametrize("layout", [False, True])
def test_relation_rows_keeps_the_accumulate_off_the_card(layout):
    """A CPU table keeps autograd's accumulate, bit for bit, and counts it."""
    gen = torch.Generator().manual_seed(5)
    table = torch.randn((22, 8), generator=gen)
    ids = torch.randint(0, 22, (1000,), generator=gen)
    lay = R.RelationLayout(ids, "cpu") if layout else None
    g = torch.randn((1000, 8), generator=gen)
    a, b = table.clone().requires_grad_(), table.clone().requires_grad_()
    R.reset_launches()
    M.relation_rows(a, ids, lay).backward(g)
    b[ids].backward(g)
    assert torch.equal(a.grad, b.grad)
    assert R.launches == {"relation_grad": 0, "relation_grad_accumulate": 1}


def test_full_graph_builds_a_layout_of_each_etype_half():
    rng = np.random.default_rng(0)
    e, n = 200, 30
    head = np.concatenate([np.sort(rng.integers(0, n, e // 2)),
                           np.sort(rng.integers(0, n, e // 2))])
    etype = np.concatenate([rng.integers(0, 4, e // 2), rng.integers(4, 8, e // 2)])
    g = M.FullGraph(head, rng.integers(0, n, e), etype, n, "cpu")
    for i, lay in enumerate(g.rel_layouts):
        ids = g.etype[g.half_slice(i)]
        assert lay.num_rows == e // 2 and lay.shift == 0
        assert torch.equal(ids[lay.perm.long()], torch.sort(ids, stable=True).values)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_a_compgcn_step_through_the_split_sum_matches_the_accumulate(monkeypatch, dtype):
    """One CompGCN training step (one layer, BCE) twice from the same
    weights: through autograd's accumulate, then with the split-segment
    route on; every gradient agrees, and only the second counts no
    accumulate (one split sum a direction)."""
    kg = synthetic_kg(n_entities=64, n_relations=3, n_train=300, n_valid=20, n_test=20, seed=7)
    n_ent, n_rel, _ = kg.get_shape()
    cfg = ModelConfig(n_entities=n_ent, n_relations=n_rel, rank=8, bias="learn",
                      multi_c=True, dtype=str(dtype)[6:])
    args = argparse.Namespace(hidden_dim=16, layers=1, edge_dropout=0.0, dropout=0.0,
                              opn="mult", interaction="distmult", basis=0, gnn_agg_method=1)
    model = get_model("CompGCN")(cfg, args, kg, generator=torch.Generator().manual_seed(3))
    trainer = Trainer(model, TrainConfig(optimizer="Adam", batch_size=64, neg_sample_size=0,
                                         loss="binarycrossentropy"), n_ent, n_rel)
    _, labels = kg.label_pack("train")
    b, w, lab = epoch_batches(kg.get_examples("train"), 64, None, labels)

    def grads():
        trainer.optimizer.zero_grad(set_to_none=True)
        R.reset_launches()
        trainer.train_step(torch.as_tensor(b[0], dtype=torch.int64),
                           torch.as_tensor(w[0], dtype=dtype), None, apply=False,
                           labels=torch.as_tensor(lab[0], dtype=torch.int64))
        return {k: p.grad.clone() for k, p in model.named_parameters()}, dict(R.launches)

    want, counts = grads()
    assert counts == {"relation_grad": 0, "relation_grad_accumulate": 2}
    monkeypatch.setattr(R, "use_kernel", lambda table, layout: layout is not None)
    got, counts = grads()
    assert counts == {"relation_grad": 0, "relation_grad_accumulate": 0}
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], dtype)
