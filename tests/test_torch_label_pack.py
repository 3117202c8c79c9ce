"""The port's BCE label packs (KGData.label_pack) and labelled epoch
batches against the JAX package's, on synthetic graphs."""

import numpy as np
import pytest

from complexhyperbolickge_torch.data.dataset import KGData, epoch_batches, synthetic_kg
from complexhyperbolickge_tpu.data import dataset as J

DATA = dict(n_entities=60, n_relations=4, n_train=700, n_valid=90, n_test=90, seed=3)


def pair(debug: bool):
    t, j = synthetic_kg(**DATA), J.synthetic_kg(**DATA)
    splits, filters = t.data, t.to_skip
    return (KGData(splits=splits, filters=filters, debug=debug),
            J.KGData(splits=splits, filters=filters, debug=debug))


@pytest.mark.parametrize("debug", [False, True])
@pytest.mark.parametrize("split", ["train", "valid"])
def test_label_pack_equals_jax(split, debug):
    t, j = pair(debug)
    got, want = t.label_pack(split), j.label_pack(split)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    rows, labels = got
    assert t.label_pack(split) is got  # cached
    # every row's gold is among its labels; pads are n_entities
    assert (labels == rows[:, 2:3]).any(1).all()
    assert labels.max() == t.n_entities and labels.min() >= 0
    if debug:
        assert len(rows) == 1000 if split == "train" else len(rows) == DATA["n_valid"]


def test_valid_labels_add_valid_facts_to_train_facts():
    t, _ = pair(False)
    n = t.n_entities
    _, lab_v = t.label_pack("valid")
    rows_v = t.get_examples("valid")
    for (h, r, tail), lab in zip(rows_v, lab_v):
        want = {int(x[2]) for x in t.data["train"] if x[0] == h and x[1] == r}
        want |= {int(x[2]) for x in t.data["valid"] if x[0] == h and x[1] == r}
        assert set(lab[lab < n].tolist()) == want


@pytest.mark.parametrize("rng_seed", [[0, 1], None])
def test_epoch_batches_with_labels_equal_jax(rng_seed):
    t, _ = pair(False)
    rows, labels = t.label_pack("train")
    rows, labels = rows[:301], labels[:301]
    got = epoch_batches(rows, 64, None if rng_seed is None else np.random.default_rng(rng_seed),
                        labels)
    want = J.epoch_batches(rows, 64, None if rng_seed is None
                           else np.random.default_rng(rng_seed), labels)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    batches, weights, lab = got
    assert lab.shape == (5, 64, labels.shape[1]) and weights[-1, -1] == 0.0
    # the labels follow the triples' permutation: each row's gold is a label
    assert (lab == batches[..., 2:3]).any(-1).all()
    assert epoch_batches(rows, 64, None)[2] is None
