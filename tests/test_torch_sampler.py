"""The port's neighbour sampler (data/sampler.py) and subgraph labels
(train/subgraph.py::build_subgraph_labels) against the JAX package's, on
the JAX sampler tests' small KG (60 entities, 4 relations, 400 train
triples; max_nodes 128, max_edges 1024; fanouts 4/4).

Both backends equal JAX's bit for bit: the C++ sampler (the port's library,
built here from native/sampler.cpp into a temporary directory, under both
packages' wrappers) and the numpy one, over several
seeds and an edge cap that forces the reservoir; epoch() too, with its
padded last batch and query_weight.  The loader: a KGSAMPLER_LIB that does
not exist raises, a failed build raises with the compiler's output, and
the sampler never falls back to numpy unless asked.
"""

import numpy as np
import pytest

from complexhyperbolickge_torch.data import dataset as TD
from complexhyperbolickge_torch.data import sampler as S
from complexhyperbolickge_torch.train.subgraph import build_subgraph_labels
from complexhyperbolickge_tpu.data import dataset as JD
from complexhyperbolickge_tpu.data import sampler as jax_sampler
from complexhyperbolickge_tpu.data.sampler import NeighborSampler as JaxSampler
from complexhyperbolickge_tpu.train.subgraph import build_subgraph_labels as jax_labels

DATA = dict(n_entities=60, n_relations=4, n_train=400, n_valid=50, n_test=50, seed=6)
MAX_NODES, MAX_EDGES = 128, 1024
FIELDS = ("node_ids", "edges", "edge_weight", "train_mask", "queries", "n_nodes", "n_edges",
          "overflow")


@pytest.fixture(scope="module")
def data():
    return TD.synthetic_kg(**DATA), JD.synthetic_kg(**DATA)


@pytest.fixture(scope="module", autouse=True)
def lib(tmp_path_factory):
    """The port's library, built from source into a fresh directory, as
    the process's; the JAX sampler loads the same file (the comparison is
    of the two wrappers, and no test waits on another process's build)."""
    built = S.load_library(S.build_library(tmp_path_factory.mktemp("native")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(S, "_LIB", built)
        mp.setattr(jax_sampler, "_LIB", built)
        yield built


def pair(data, backend, **kw):
    kw = {"fanouts": (4, 4), "max_nodes": MAX_NODES, "max_edges": MAX_EDGES, **kw}
    numpy = backend == "numpy"
    t = S.NeighborSampler(data[0], force_numpy=numpy, **kw)
    j = JaxSampler(data[1], force_numpy=numpy, **kw)
    assert t.backend == j.backend == backend
    return t, j


def assert_same(a, b):
    for f in FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        if isinstance(vb, np.ndarray):
            assert va.dtype == vb.dtype, f
        np.testing.assert_array_equal(va, vb, err_msg=f)


@pytest.mark.parametrize("backend", ["cpp", "numpy"])
@pytest.mark.parametrize("max_edges", [MAX_EDGES, 96])
def test_sample_equals_jax_bit_for_bit(data, backend, max_edges):
    t, j = pair(data, backend, max_edges=max_edges)
    np.testing.assert_array_equal(t.edges_global, j.edges_global)
    np.testing.assert_array_equal(t.edge_train_mask, j.edge_train_mask)
    rng = np.random.default_rng(0)
    for seed in range(4):
        seeds = rng.choice(t.n_train_edges, 24, replace=False)
        a, b = t.sample(seeds, seed=seed), j.sample(seeds, seed=seed)
        assert_same(a, b)
        assert 0 < a.n_nodes <= MAX_NODES
        assert (a.overflow > 0) == (max_edges == 96)


@pytest.mark.parametrize("backend", ["cpp", "numpy"])
def test_epoch_equals_jax_with_padded_tail(data, backend):
    t, j = pair(data, backend)
    bs = 64  # 800 train edges with inverses: 12 full batches and a tail of 32
    got = list(t.epoch(bs, np.random.default_rng(3), seed_base=2))
    want = list(j.epoch(bs, np.random.default_rng(3), seed_base=2))
    assert len(got) == len(want) == -(-t.n_train_edges // bs)
    for a, b in zip(got, want):
        assert_same(a, b)
        np.testing.assert_array_equal(a.query_weight, b.query_weight)
    tail = got[-1]
    assert tail.queries.shape == (bs, 3)
    assert tail.query_weight.sum() == t.n_train_edges % bs
    assert sum(int(b.query_weight.sum()) for b in got) == t.n_train_edges


def test_subgraph_labels_equal_jax(data):
    t, j = pair(data, "cpp", fanouts=(6, 6))
    for seed in range(4):
        seeds = np.arange(seed * 8, seed * 8 + 24)
        a, b = t.sample(seeds, seed=seed), j.sample(seeds, seed=seed)
        got, want = build_subgraph_labels(a, MAX_NODES), jax_labels(b, MAX_NODES)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        assert (got[np.arange(24), a.queries[:, 2]] == 1).all()


def test_missing_kgsampler_lib_raises(data, monkeypatch, tmp_path):
    missing = str(tmp_path / "nope.so")
    monkeypatch.setenv("KGSAMPLER_LIB", missing)
    with pytest.raises(FileNotFoundError, match="KGSAMPLER_LIB"):
        S.library_path()
    monkeypatch.setattr(S, "_LIB", None)
    with pytest.raises(FileNotFoundError, match="nope.so"):
        S.NeighborSampler(data[0], fanouts=(4, 4), max_nodes=MAX_NODES, max_edges=MAX_EDGES)


def test_failed_build_raises_and_never_falls_back_to_numpy(data, monkeypatch, tmp_path):
    bad = tmp_path / "sampler.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(S, "SOURCE", bad)
    with pytest.raises(RuntimeError, match=r"building the C\+\+ sampler .* failed:\n.*error"):
        S.build_library(tmp_path / "out")
    assert not list((tmp_path / "out").glob("*.so*"))
    # no library anywhere: the sampler raises the build's error
    monkeypatch.delenv("KGSAMPLER_LIB", raising=False)
    monkeypatch.setattr(S, "_LIB", None)
    monkeypatch.setattr(S, "_ROOT", tmp_path)
    monkeypatch.setattr(S, "_PKG_DIR", tmp_path)
    monkeypatch.setattr(S, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed"):
        S.NeighborSampler(data[0], fanouts=(4, 4), max_nodes=MAX_NODES, max_edges=MAX_EDGES)
    assert S._LIB is None
    assert S.NeighborSampler(data[0], force_numpy=True).backend == "numpy"


def test_build_is_stamped_and_reused(tmp_path):
    so = S.build_library(tmp_path)
    stamp = so.with_name(so.name + ".sha256")
    assert stamp.read_text() == S._digest()
    mtime = so.stat().st_mtime_ns
    assert S.build_library(tmp_path) == so and so.stat().st_mtime_ns == mtime
    stamp.write_text("stale")
    S.build_library(tmp_path)
    assert stamp.read_text() == S._digest()
    assert not list(tmp_path.glob("*.tmp*"))
