"""KG dataset container and eval packing (numpy only).

Port of complexhyperbolickge_tpu/data/dataset.py, kept as a copy so the
port never imports the JAX package:
  * triples: one int [N, 3] array per split; the train split is augmented
    with inverse triples (swap head/tail, rel += n_relations/2).
  * eval packs: per direction, queries [n, 3] plus a padded filter index
    array [n, Lmax] (pad value = n_entities), deduplicated per row.
  * epoch batches: a shuffled epoch packed into static-shape batches with
    a weight mask (`epoch_batches`).
The BCE label packs wait for the BCE loss (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np

_SPLITS = ("train", "valid", "test")


@dataclasses.dataclass
class EvalPack:
    """Filtered-ranking inputs for one direction of one split."""

    queries: np.ndarray  # int32 [n, 3] (head, rel, gold-tail)
    filter_idx: np.ndarray  # int32 [n, Lmax] true-entity ids, padded n_entities


def dedup_filter_rows(fidx: np.ndarray, n_entities: int) -> np.ndarray:
    """Replace repeat occurrences within each filter row by the pad id.

    The count-subtracting rankers subtract once per entry, so a duplicated
    id would be excluded twice.  Vectorized: sort each row, flag values equal
    to their left neighbour, map the flags back through the permutation."""
    order = np.argsort(fidx, axis=1, kind="stable")
    s = np.take_along_axis(fidx, order, axis=1)
    dup_sorted = np.zeros_like(s, dtype=bool)
    dup_sorted[:, 1:] = s[:, 1:] == s[:, :-1]  # stable: first occurrence kept
    dup = np.zeros_like(dup_sorted)
    np.put_along_axis(dup, order, dup_sorted, axis=1)
    return np.where(dup, n_entities, fidx).astype(fidx.dtype, copy=False)


class KGData:
    """Loads reference-format pickles or takes in-memory split arrays."""

    def __init__(self, data_path: str | None = None, debug: bool = False,
                 splits: dict | None = None, filters: dict | None = None):
        self.debug = debug
        if splits is None:
            if data_path is None:
                raise ValueError("KGData needs data_path or splits")
            splits = {}
            for s in _SPLITS:
                with open(os.path.join(data_path, s + ".pickle"), "rb") as f:
                    splits[s] = pickle.load(f)
            with open(os.path.join(data_path, "to_skip.pickle"), "rb") as f:
                filters = pickle.load(f)
        self.data = {s: np.asarray(v, dtype=np.int64) for s, v in splits.items()}
        self.to_skip = filters
        self._eval_cache: dict = {}
        mx = np.max(self.data["train"], axis=0)
        self.n_entities = int(max(mx[0], mx[2]) + 1)
        # doubled relation count (with inverses)
        self.n_predicates = int(mx[1] + 1) * 2
        if filters is None:
            from complexhyperbolickge_torch.data.preprocess import build_filters

            all_ex = np.concatenate([self.data[s] for s in _SPLITS], axis=0)
            lhs, rhs = build_filters(all_ex, self.n_predicates // 2)
            self.to_skip = {"lhs": lhs, "rhs": rhs}

    # ------------------------------- protocol --------------------------------

    def get_examples(self, split: str, rel_idx: int = -1) -> np.ndarray:
        """Split triples; train is augmented with inverse triples (with the
        rel_idx filter and the debug truncation to 1000 examples)."""
        ex = self.data[split]
        if split == "train":
            inv = ex[:, [2, 1, 0]].copy()
            inv[:, 1] += self.n_predicates // 2
            ex = np.concatenate([ex, inv], axis=0)
        if rel_idx >= 0:
            ex = ex[ex[:, 1] == rel_idx]
        if self.debug:
            ex = ex[:1000]
        return ex.astype(np.int32)

    def get_filters(self):
        return self.to_skip

    def get_shape(self):
        return self.n_entities, self.n_predicates, self.n_entities

    # ------------------------------- eval packs -------------------------------

    def eval_pack(self, split: str, direction: str, rel_idx: int = -1) -> EvalPack:
        """Queries + padded filter arrays for filtered ranking.

        direction 'rhs' ranks tails of (h, r, ?); 'lhs' ranks heads via the
        inverse relation: queries become (t, r + n_rel/2, h).  Every row's
        filter list holds the gold tail exactly once, so it always has at
        least one valid entry.  Rows are padded to the DIRECTION-GLOBAL max
        filter length (+1 for the gold) and deduplicated.  Cached per
        (split, direction, rel_idx).
        """
        ck = (split, direction, rel_idx)
        if ck in self._eval_cache:
            return self._eval_cache[ck]
        ex = self.get_examples(split, rel_idx=rel_idx).astype(np.int64)
        if direction == "lhs":
            ex = np.stack(
                [ex[:, 2], ex[:, 1] + self.n_predicates // 2, ex[:, 0]], axis=1
            )
        skip = self.to_skip[direction]
        lists = [skip.get((int(q[0]), int(q[1])), []) for q in ex]
        lmax = max((len(v) for v in skip.values()), default=0) + 1
        fidx = np.full((len(ex), lmax), self.n_entities, dtype=np.int32)
        for i, l in enumerate(lists):
            gold = int(ex[i, 2])
            u = set(map(int, l))
            u.discard(gold)
            row = list(u)
            fidx[i, : len(row)] = row
            fidx[i, len(row)] = gold
        pack = EvalPack(queries=ex.astype(np.int32), filter_idx=fidx)
        self._eval_cache[ck] = pack
        return pack


def synthetic_kg(n_entities: int = 200, n_relations: int = 11,
                 n_train: int = 2000, n_valid: int = 200, n_test: int = 200,
                 seed: int = 0) -> KGData:
    """Random KG with the reference datasets' shape statistics; the same
    numpy draws as the JAX package, so one seed gives one graph in both."""
    rng = np.random.default_rng(seed)
    # every entity/relation id must appear in train (shape maximality below)
    n_train = max(n_train, n_entities, n_relations)

    def draw(n):
        h = rng.integers(0, n_entities, size=n)
        r = rng.integers(0, n_relations, size=n)
        t = rng.integers(0, n_entities, size=n)
        return np.stack([h, r, t], axis=1).astype(np.int64)

    train = draw(n_train)
    train[: n_entities, 0] = np.arange(n_entities)
    train[: n_relations, 1] = np.arange(n_relations)
    splits = {"train": train, "valid": draw(n_valid), "test": draw(n_test)}
    return KGData(splits=splits, filters=None)


def epoch_batches(examples: np.ndarray, batch_size: int,
                  rng: np.random.Generator | None):
    """Shuffle and pack one epoch into static-shape batches + weight mask.

    Returns (batches [nb, B, 3] int32, weights [nb, B] float32).  The final
    partial batch is padded with copies of row 0 at weight 0.  rng=None
    skips the shuffle (validation-loss passes); the trainer's rng is
    np.random.default_rng([seed, epoch]), as in the JAX package, so both
    packages see the same batches in the same order.
    """
    n = examples.shape[0]
    ex = examples if rng is None else examples[rng.permutation(n)]
    nb = -(-n // batch_size)
    pad = nb * batch_size - n
    weights = np.ones(nb * batch_size, dtype=np.float32)
    if pad:
        ex = np.concatenate([ex, np.broadcast_to(ex[:1], (pad, 3))], axis=0)
        weights[n:] = 0.0
    return (ex.reshape(nb, batch_size, 3).astype(np.int32),
            weights.reshape(nb, batch_size))
