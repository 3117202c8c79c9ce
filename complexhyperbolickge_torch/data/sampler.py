"""Host-side neighbour sampler producing fixed-shape padded subgraphs.

Port of complexhyperbolickge_tpu/data/sampler.py: a ctypes wrapper over the
repo's C++ sampler (native/sampler.cpp), with the same pure-numpy sampler
beside it.  Per batch (every array a fixed capacity, so the device step
sees one shape):
  node_ids    (max_nodes,)   int32 global ids, padded with 0 (n_nodes real)
  edges       (max_edges, 3) int32 (local head, type, local tail), pad rows 0
  edge_weight (max_edges,)   float32 1 for real edges else 0
  train_mask  (max_edges,)   float32 1 if the edge is a train edge
  queries     (B, 3)         int32 seed triples in LOCAL ids
  n_nodes, n_edges, overflow ints

The library is found as JAX finds it: $KGSAMPLER_LIB (a path that does not
exist is an error), then native/libkgsampler.so at the root of the
checkout (`make -C native`), then a copy beside this module.  When none
exists it is built from native/sampler.cpp with g++ into build/native/,
stamped with the sha256 of source and flags and rebuilt when the stamp
differs; the build writes a temporary file and renames it, so concurrent
processes never load a half-written library.

Unlike JAX, the sampler never falls back to numpy on its own: the two
backends draw different subgraphs from one seed, so a silent switch would
change the training run.  The numpy sampler runs only with
force_numpy=True; a library that can be neither found nor built raises,
naming the build error.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG_DIR = Path(__file__).resolve().parent
_ROOT = _PKG_DIR.parents[1]
SOURCE = _ROOT / "native" / "sampler.cpp"
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")

_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)

_lock = threading.Lock()
_LIB = None


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()


def build_library(build_dir: Path | None = None) -> Path:
    """Compile native/sampler.cpp with g++ into build_dir (default
    build/native/)/libkgsampler.so unless the stamp beside it matches
    source and flags; returns the path.  Raises RuntimeError with the
    compiler's output when the build fails."""
    build_dir = Path(build_dir or BUILD_DIR)
    so = build_dir / "libkgsampler.so"
    stamp = so.with_name(so.name + ".sha256")
    digest = _digest()
    if so.exists() and stamp.exists() and stamp.read_text() == digest:
        return so
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot build the C++ sampler: {cxx} failed to start ({e})") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the C++ sampler from {SOURCE} failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    stamp_tmp = stamp.with_name(tmp.name + ".sha256")
    stamp_tmp.write_text(digest)
    os.replace(stamp_tmp, stamp)
    return so


def library_path() -> Path:
    """The sampler library to load, in JAX's search order, built from
    source when no copy exists."""
    env = os.environ.get("KGSAMPLER_LIB")
    if env:
        if not os.path.exists(env):
            raise FileNotFoundError(f"KGSAMPLER_LIB={env} does not exist")
        return Path(env)
    for p in (_ROOT / "native" / "libkgsampler.so", _PKG_DIR / "libkgsampler.so"):
        if p.exists():
            return p
    return build_library()


def load_library(path: Path) -> ctypes.CDLL:
    """The library at `path` with the sampler's argtypes set."""
    lib = ctypes.CDLL(str(path))
    lib.kgs_create.restype = ctypes.c_void_p
    lib.kgs_create.argtypes = [_I64P, _I64P, _I64P, _U8P, ctypes.c_int64, ctypes.c_int64]
    lib.kgs_destroy.argtypes = [ctypes.c_void_p]
    lib.kgs_sample.restype = ctypes.c_int64
    lib.kgs_sample.argtypes = [
        ctypes.c_void_p, _I64P, ctypes.c_int64, _I64P, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
        _I64P, _I64P, _U8P, _I64P, _I64P, _I64P, _I64P,
    ]
    return lib


def _lib() -> ctypes.CDLL:
    """The process's sampler library, found or built on first use."""
    global _LIB
    with _lock:
        if _LIB is None:
            _LIB = load_library(library_path())
        return _LIB


@dataclasses.dataclass
class Subgraph:
    node_ids: np.ndarray
    edges: np.ndarray
    edge_weight: np.ndarray
    train_mask: np.ndarray
    queries: np.ndarray
    n_nodes: int
    n_edges: int
    overflow: int
    # 1 per real seed query, 0 for the rows that pad an epoch's last batch
    query_weight: np.ndarray | None = None


class NeighborSampler:
    """Samples padded subgraphs around batches of seed edges.

    The graph is the train triples (and, with include_valid, the valid
    ones) with their inverses; valid edges carry train mask 0."""

    def __init__(self, dataset, fanouts=(20, 20), max_nodes: int = 4096,
                 max_edges: int = 32768, include_valid: bool = True,
                 force_numpy: bool = False):
        self.fanouts = np.asarray(fanouts, dtype=np.int64)
        self.max_nodes, self.max_edges = max_nodes, max_edges
        n_rel_half = dataset.n_predicates // 2

        def with_inverses(ex):
            inv = ex[:, [2, 1, 0]].copy()
            inv[:, 1] += n_rel_half
            return np.concatenate([ex, inv], axis=0)

        train = with_inverses(dataset.data["train"])
        parts, masks = [train], [np.ones(len(train), np.uint8)]
        if include_valid:
            valid = with_inverses(dataset.data["valid"])
            parts.append(valid)
            masks.append(np.zeros(len(valid), np.uint8))
        self.edges_global = np.concatenate(parts).astype(np.int64)
        self.edge_train_mask = np.concatenate(masks)
        self.n_train_edges = len(train)
        self.n_nodes_global = dataset.n_entities

        self._handle = None
        self._lib = None
        if force_numpy:
            # CSR over outgoing edges
            self._np_idx = np.argsort(self.edges_global[:, 0], kind="stable")
            off = np.zeros(self.n_nodes_global + 1, np.int64)
            np.add.at(off, self.edges_global[:, 0] + 1, 1)
            self._np_off = np.cumsum(off)
        else:
            self._lib = _lib()
            e = self.edges_global
            self._handle = self._lib.kgs_create(
                e[:, 0].copy().ctypes.data_as(_I64P),
                e[:, 2].copy().ctypes.data_as(_I64P),
                e[:, 1].copy().ctypes.data_as(_I64P),
                self.edge_train_mask.ctypes.data_as(_U8P),
                len(e), self.n_nodes_global,
            )

    @property
    def backend(self) -> str:
        return "cpp" if self._handle is not None else "numpy"

    # ------------------------------ sampling --------------------------------

    def sample(self, seed_edge_ids: np.ndarray, seed: int = 0) -> Subgraph:
        seed_edge_ids = np.asarray(seed_edge_ids, dtype=np.int64)
        if self._handle is not None:
            return self._sample_cpp(seed_edge_ids, seed)
        return self._sample_numpy(seed_edge_ids, seed)

    def _sample_cpp(self, seeds, seed):
        b = len(seeds)
        nodes = np.empty(self.max_nodes, np.int64)
        edges = np.empty(self.max_edges * 3, np.int64)
        tmask = np.empty(self.max_edges, np.uint8)
        queries = np.empty(b * 3, np.int64)
        nn = np.zeros(1, np.int64)
        ne = np.zeros(1, np.int64)
        ov = np.zeros(1, np.int64)
        rc = self._lib.kgs_sample(
            self._handle, seeds.ctypes.data_as(_I64P), b,
            self.fanouts.ctypes.data_as(_I64P), len(self.fanouts),
            self.max_nodes, self.max_edges, seed,
            nodes.ctypes.data_as(_I64P), edges.ctypes.data_as(_I64P),
            tmask.ctypes.data_as(_U8P), queries.ctypes.data_as(_I64P),
            nn.ctypes.data_as(_I64P), ne.ctypes.data_as(_I64P),
            ov.ctypes.data_as(_I64P),
        )
        if rc != 0:
            raise RuntimeError(
                f"kgs_sample failed: rc={rc}"
                + (" (seed endpoints exceed max_nodes; raise max_nodes or lower "
                   "batch_size)" if rc == -2 else ""))
        return self._pack(nodes, edges.reshape(-1, 3), tmask, queries.reshape(-1, 3),
                          int(nn[0]), int(ne[0]), int(ov[0]))

    def _sample_numpy(self, seeds, seed):
        rng = np.random.default_rng(seed)
        e = self.edges_global
        local: dict[int, int] = {}
        nodes: list[int] = []

        def add(u):
            if u in local:
                return local[u]
            if len(nodes) >= self.max_nodes:
                return -1
            local[u] = len(nodes)
            nodes.append(u)
            return local[u]

        frontier = []
        for eid in seeds:
            for u in (e[eid, 0], e[eid, 2]):
                if add(int(u)) >= 0:
                    frontier.append(int(u))
        for k in self.fanouts:
            nxt = []
            for u in frontier:
                eids = self._np_idx[self._np_off[u]:self._np_off[u + 1]]
                if len(eids) > k:
                    eids = rng.choice(eids, size=int(k), replace=False)
                for eid in eids:
                    v = int(e[eid, 2])
                    if v not in local:
                        if add(v) < 0:
                            break
                        nxt.append(v)
            frontier = nxt

        node_arr = np.asarray(nodes, np.int64)
        in_set = np.zeros(self.n_nodes_global, bool)
        in_set[node_arr] = True
        is_seed = np.zeros(len(e), bool)
        is_seed[seeds] = True
        eids = np.nonzero(in_set[e[:, 0]] & in_set[e[:, 2]] & ~is_seed)[0]
        overflow = max(0, len(eids) - self.max_edges)
        if overflow:
            eids = rng.choice(eids, size=self.max_edges, replace=False)

        lut = np.full(self.n_nodes_global, -1, np.int64)
        lut[node_arr] = np.arange(len(node_arr))
        sub_edges = np.stack([lut[e[eids, 0]], e[eids, 1], lut[e[eids, 2]]], axis=1)
        queries = np.stack([lut[e[seeds, 0]], e[seeds, 1], lut[e[seeds, 2]]], axis=1)
        if (queries[:, [0, 2]] < 0).any():
            raise RuntimeError("seed endpoints exceed max_nodes; raise max_nodes or lower "
                               "batch_size")
        nodes_pad = np.full(self.max_nodes, -1, np.int64)
        nodes_pad[: len(node_arr)] = node_arr
        edges_pad = np.full((self.max_edges, 3), -1, np.int64)
        edges_pad[: len(sub_edges)] = sub_edges
        tmask_pad = np.zeros(self.max_edges, np.uint8)
        tmask_pad[: len(eids)] = self.edge_train_mask[eids]
        return self._pack(nodes_pad, edges_pad, tmask_pad, queries, len(node_arr),
                          len(sub_edges), overflow)

    def _pack(self, nodes, edges, tmask, queries, n_nodes, n_edges, overflow):
        ew = (edges[:, 0] >= 0).astype(np.float32)
        return Subgraph(
            node_ids=np.maximum(nodes, 0).astype(np.int32),
            edges=np.maximum(edges, 0).astype(np.int32),
            edge_weight=ew,
            train_mask=tmask.astype(np.float32) * ew,
            queries=queries.astype(np.int32),
            n_nodes=n_nodes,
            n_edges=n_edges,
            overflow=overflow,
        )

    # ------------------------------ iteration --------------------------------

    def epoch(self, batch_size: int, rng: np.random.Generator, seed_base: int = 0):
        """Shuffled batches of seed edges over the train edges.  The last
        partial batch is padded to batch_size with its first seed, and its
        padded rows get query_weight 0.  Batch i's sampling seed is
        seed_base * n_train_edges + its offset: one seed per (epoch,
        offset)."""
        order = rng.permutation(self.n_train_edges)
        for i in range(0, self.n_train_edges, batch_size):
            seeds = order[i: i + batch_size]
            n_real = len(seeds)
            if n_real < batch_size:
                seeds = np.concatenate([seeds, np.broadcast_to(seeds[:1],
                                                               (batch_size - n_real,))])
            sub = self.sample(seeds, seed=seed_base * self.n_train_edges + i)
            qw = np.ones(batch_size, np.float32)
            qw[n_real:] = 0.0
            sub.query_weight = qw
            yield sub

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.kgs_destroy(self._handle)
