"""Raw KG file preprocessing: tab-separated triples -> int arrays + filters.

Port of complexhyperbolickge_tpu/data/preprocess.py (numpy only):
entities and relations are id-mapped in sorted order, splits become int64
[N, 3] arrays, and the filtered-evaluation dicts map (entity, relation) ->
sorted true-tail list, with the lhs direction keyed by relation +
n_relations.  The artifacts are pickles with the reference's names and
layout ({split}.pickle + to_skip.pickle), which KGData reads:

    DATA_PATH=data python -m complexhyperbolickge_torch.data.preprocess
"""

from __future__ import annotations

import collections
import os
import pickle

import numpy as np

SPLITS = ("train", "valid", "test")


def build_vocab(path: str):
    """Scan all splits; map entities and relations to ids in sorted order."""
    entities, relations = set(), set()
    for split in SPLITS:
        with open(os.path.join(path, split)) as f:
            for line in f:
                h, r, t = line.strip().split("\t")
                entities.add(h)
                entities.add(t)
                relations.add(r)
    ent2idx = {x: i for i, x in enumerate(sorted(entities))}
    rel2idx = {x: i for i, x in enumerate(sorted(relations))}
    return ent2idx, rel2idx


def read_triples(path: str, ent2idx, rel2idx) -> np.ndarray:
    """The triples of one raw split file whose names are in the vocab, as
    int64 ids [N, 3]."""
    out = []
    with open(path) as f:
        for line in f:
            h, r, t = line.strip().split("\t")
            if h in ent2idx and t in ent2idx and r in rel2idx:
                out.append((ent2idx[h], rel2idx[r], ent2idx[t]))
    return np.asarray(out, dtype=np.int64).reshape(-1, 3)


def build_filters(examples: np.ndarray, n_relations: int):
    """Filtered-setting skip lists over ALL splits' triples.

    rhs[(h, r)] = sorted true tails; lhs[(t, r + n_relations)] = sorted true
    heads (inverse-relation keying).
    """
    lhs = collections.defaultdict(set)
    rhs = collections.defaultdict(set)
    for h, r, t in examples:
        rhs[(int(h), int(r))].add(int(t))
        lhs[(int(t), int(r) + n_relations)].add(int(h))
    return (
        {k: sorted(v) for k, v in lhs.items()},
        {k: sorted(v) for k, v in rhs.items()},
    )


def process_dataset(path: str, out_path: str | None = None):
    """Preprocess one dataset directory holding raw train/valid/test files;
    writes the pickles to out_path (default: the same directory) and
    returns (examples by split, filters)."""
    out_path = out_path or path
    ent2idx, rel2idx = build_vocab(path)
    examples = {s: read_triples(os.path.join(path, s), ent2idx, rel2idx) for s in SPLITS}
    all_ex = np.concatenate([examples[s] for s in SPLITS], axis=0)
    lhs_skip, rhs_skip = build_filters(all_ex, len(rel2idx))
    filters = {"lhs": lhs_skip, "rhs": rhs_skip}
    os.makedirs(out_path, exist_ok=True)
    for s in SPLITS:
        with open(os.path.join(out_path, s + ".pickle"), "wb") as f:
            pickle.dump(examples[s], f)
    with open(os.path.join(out_path, "to_skip.pickle"), "wb") as f:
        pickle.dump(filters, f)
    return examples, filters


def main():
    """Preprocess every dataset directory under $DATA_PATH that holds the
    three raw split files."""
    data_path = os.environ["DATA_PATH"]
    for name in sorted(os.listdir(data_path)):
        d = os.path.join(data_path, name)
        if os.path.isdir(d) and all(os.path.exists(os.path.join(d, s)) for s in SPLITS):
            print(f"processing {name}")
            process_dataset(d)


if __name__ == "__main__":
    main()
