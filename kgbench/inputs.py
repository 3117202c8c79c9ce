"""What the benchmark makes from --seed and hands to both the program and
the reference: the knowledge graph and the weights.

The graph is uniform random triples at a dataset's published counts, every
entity and relation present in train (the draws of the program's
data/dataset.py::synthetic_kg, copied so that the program cannot move
them).  Weights are drawn on the device with a torch.Generator of their
own stream, one call a parameter, in the parameters' dtype.
"""

from __future__ import annotations

import numpy as np

# independent streams of one seed
GRAPH_STREAM, WEIGHT_STREAM = 1, 2


def seed_words(seed: int) -> int:
    """A whole-number seed of any size or sign as a non-negative integer
    (numpy's seed sequences and torch's generators take those)."""
    return int(seed) % (1 << 64)


def stream_seed(seed: int, stream: int) -> int:
    """A 64-bit generator seed for (seed, stream)."""
    state = np.random.SeedSequence([seed_words(seed), stream]).generate_state(1, np.uint64)
    return int(state[0])


def make_graph(seed: int, n_entities: int, n_relations: int, n_train: int,
               n_valid: int, n_test: int) -> dict:
    """{"train", "valid", "test"} -> int64 (n, 3) triples (head, rel, tail),
    drawn uniformly; the first train triples name every entity as a head
    and every relation once, so the graph's shape is the counts'."""
    rng = np.random.default_rng(stream_seed(seed, GRAPH_STREAM))
    n_train = max(n_train, n_entities, n_relations)

    def draw(n):
        h = rng.integers(0, n_entities, size=n)
        r = rng.integers(0, n_relations, size=n)
        t = rng.integers(0, n_entities, size=n)
        return np.stack([h, r, t], axis=1).astype(np.int64)

    train = draw(n_train)
    train[:n_entities, 0] = np.arange(n_entities)
    train[:n_relations, 1] = np.arange(n_relations)
    return {"train": train, "valid": draw(n_valid), "test": draw(n_test)}


def draw_weights(shapes: dict, dists: dict, seed: int, device, dtype) -> dict:
    """name -> tensor of shapes[name] on `device` in `dtype`, drawn from
    dists[name]: ["normal", mean, std], ["uniform", low, high] or
    ["const", value]; one generator of the card (or the CPU), parameters
    in name order."""
    import torch

    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, WEIGHT_STREAM))
    out = {}
    for name in sorted(shapes):
        shape, (kind, *args) = tuple(shapes[name]), dists[name]
        if kind == "normal":
            v = torch.randn(shape, generator=gen, device=device, dtype=dtype) * args[1] + args[0]
        elif kind == "uniform":
            v = torch.rand(shape, generator=gen, device=device, dtype=dtype)
            v = v * (args[1] - args[0]) + args[0]
        elif kind == "const":
            v = torch.full(shape, float(args[0]), device=device, dtype=dtype)
        else:
            raise ValueError(f"unknown weight distribution {kind!r} for {name}")
        out[name] = v
    return out
