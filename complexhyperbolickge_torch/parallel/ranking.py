"""Entity-sharded filtered ranking.

Port of complexhyperbolickge_tpu/parallel/ranking.py.  Every query is
ranked against ALL entities; on a mesh with a model axis of M ranks each
rank holds one row slice of the entity tables (parallel/mesh.py:
padded_rows(N, M) / M rows from global row lo = m * S) and contributes its
slice's count to

    rank = 1 + sum over the model group of #{local scores >= target}

with the filtered entities each rank owns taken out of its count.  A rank's
work is written as a generator, `steps(q, fidx)`: it yields each tensor
that the model group sums (the rows the queries need, which only their
owners hold; the dense rankers' gold score; the (B,) counts) and is sent
the sum back, and it returns the ranks.  A ranker's __call__ drives it with
all_reduce over its model group; `run_shards` drives the M shards of one
process in lockstep (tests).  Each shard adds exact zeros for what it does
not own, so the sums are bit for bit what one process computes.

A fused shard is the one-device fused ranker (kernels/_ranker.py) set to
its rows lo .. lo + real: it builds its tables from its local rows and its
query inputs by the same _queries_core on a mini-table of the gathered
head and gold rows, and shares the filter, bias, gold add-back (shard 0
only), NaN discipline and family table (fused_ranker_class) with it.
"""

from __future__ import annotations

import torch

from complexhyperbolickge_torch.kernels._ranker import fused_ranker_class
from complexhyperbolickge_torch.kernels.chyp_rank import ChypRanker
from complexhyperbolickge_torch.kernels.hyp_rank import AttRHRanker, HypRanker
from complexhyperbolickge_torch.ops.math import check_precision, eval_matmul_precision
from complexhyperbolickge_torch.parallel.mesh import (
    ENTITY_PARAMS,
    Mesh,
    _wire,
    call_with_tables,
    padded_rows,
    shard_entity_tree,
)
from complexhyperbolickge_torch.train.evaluate import (
    NONFINITE_PARAMS,
    filtered_rank_counts,
    params_finite,
)
from complexhyperbolickge_torch.utils.versions import is_current, params_key


def run_shards(rankers, q, fidx):
    """The ranks of the shard rankers of ONE model group, run in this
    process in lockstep: each yielded tensor summed over the shards."""
    gens = [r.steps(q, fidx) for r in rankers]
    parts = [next(g) for g in gens]
    while True:
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        parts, done = [], []
        for g in gens:
            try:
                parts.append(g.send(total.clone()))
            except StopIteration as e:
                done.append(e.value)
        if done:
            if parts:
                raise RuntimeError("shard rankers took different numbers of steps")
            return done[0]


class _Shard:
    """What every sharded ranker shares: the shard's place (lo, S, the real
    rows it holds), its local rows of the entity tables, the rows that only
    their owners hold, and the drive over the model group."""

    def _init_shard(self, model, mesh: Mesh, n_entities: int):
        self.model = model
        self.mesh = mesh
        self.n = n_entities
        self.shard_idx, self.n_shards = mesh.m, mesh.n_model
        self.s = padded_rows(n_entities, self.n_shards) // self.n_shards
        self.lo = self.shard_idx * self.s
        self.real = max(0, min(self.s, n_entities - self.lo))  # rows < N

    def local(self, name: str):
        """This shard's rows of an entity-table parameter (S rows): the
        model's own on a row-sharded model, else cut from the full table."""
        t = getattr(self.model, name)
        if t.shape[0] == self.s or self.n_shards == 1:
            return t
        return shard_entity_tree({name: t}, self.n, self.shard_idx, self.n_shards)[name]

    def owned(self, ids):
        """(local row, owned) of global ids."""
        loc = ids - self.lo
        return loc, (loc >= 0) & (loc < self.real)

    def owned_rows(self, table, ids):
        """The rows of `ids` this shard owns, zeros for the others."""
        loc, own = self.owned(ids)
        rows = table[loc.clamp(0, max(self.s - 1, 0))]
        return torch.where(own[:, None], rows, torch.zeros_like(rows))

    def __call__(self, q, fidx):
        steps = self.steps(q, fidx)
        try:
            part = next(steps)
            while True:
                wire = _wire(part).contiguous()
                part = steps.send(self.mesh.sum_model(wire).to(part.dtype))
        except StopIteration as e:
            return e.value

    def check_params(self, model=None):
        """FloatingPointError on every rank of the model group when any
        rank's parameters hold NaN or inf (get_ranking's check, its flag
        summed over the group, so no rank raises alone)."""
        bad = 0.0 if params_finite(self.model) else 1.0
        flag = torch.tensor([bad], device=next(self.model.parameters()).device)
        if float(self.mesh.sum_model(flag)) > 0:
            raise FloatingPointError(NONFINITE_PARAMS)


def _head_gold_part(shard, q):
    """(B, 2 D + 2): the owned rows of the heads' entity and bh and the
    golds' entity and bt; summed over the group, every query's rows."""
    ent = shard.local("entity")
    return torch.cat([shard.owned_rows(ent, q[:, 0]),
                      shard.owned_rows(shard.local("bh"), q[:, 0]),
                      shard.owned_rows(ent, q[:, 2]),
                      shard.owned_rows(shard.local("bt"), q[:, 2])], dim=1)


def _mini_tables(rows, q):
    """The mini-tables of the summed rows and the queries that index them:
    entity = [heads; golds], bh = [bh of the heads; 0], bt = [0; bt of the
    golds], and q_mini = (i, rel, B + i), so a model method indexes the
    rows one process would read."""
    b, d = q.shape[0], (rows.shape[1] - 2) // 2
    heads, bh, gold, bt = rows.split([d, 1, d, 1], dim=1)
    zero = torch.zeros_like(bh)
    mini = {"entity": torch.cat([heads, gold]), "bh": torch.cat([bh, zero]),
            "bt": torch.cat([zero, bt])}
    i = torch.arange(b, device=q.device)
    return mini, torch.stack([i, q[:, 1], b + i], dim=1)


class _ShardedFused(_Shard):
    """A fused ranker (the class it is mixed into) on one shard's rows: its
    lo and real, its tables from the local rows, its query inputs from the
    gathered head and gold rows; everything else is the fused ranker's."""

    def __init__(self, model, mesh: Mesh, n_entities: int, masked: bool = True,
                 precision: str = "highest"):
        super().__init__(model, masked=masked, precision=precision)
        self._init_shard(model, mesh, n_entities)

    def _prepare_tables(self):
        local = {k: self.local(k) for k in ("entity", "bt")}
        return call_with_tables(self.model, local, super()._prepare_tables)

    @torch.no_grad()
    def steps(self, q, fidx):
        tables = self._get_tables()
        rows = yield _head_gold_part(self, q)
        mini, q_mini = _mini_tables(rows, q)
        x = self._inputs(q, fidx, self.masked, tables, lambda: call_with_tables(
            self.model, mini, self._queries_core, q_mini, tables))
        total = yield self._sweep(x, q, fidx).to(torch.int32)
        return self._ranks(total, x["t2"])


class ShardedChypRanker(_ShardedFused, ChypRanker):
    """K1 (masked) or K2 (maskless) on one shard: FFTUnitBall family."""


class ShardedHypRanker(_ShardedFused, HypRanker):
    """K5 (masked) or K6 (maskless) on one shard: BaseH (not AttRH) and
    BaseLorentz, with the radius table of the local slice."""


class ShardedAttRHRanker(_ShardedFused, AttRHRanker):
    """K7 (masked) or K8 (maskless) on one shard: AttRH."""


class ShardedDenseRanker(_Shard):
    """Dense filtered ranking on one shard (JAX make_sharded_ranker):
    model.sim of the queries against the shard's real rows plus
    _apply_bias with its bt, the gold score from its owner, and the local
    filtered count.  Serves every model without a fused ranker and
    --eval_backend dense."""

    def __init__(self, model, mesh: Mesh, n_entities: int, precision: str = "highest"):
        self._init_shard(model, mesh, n_entities)
        self.precision = check_precision(precision)

    def _queries(self, rows, q):
        mini, q_mini = _mini_tables(rows, q)
        return call_with_tables(self.model, mini, self.model.get_queries, q_mini[:, :2])

    def _rhs(self):
        """This shard's real rows of the candidate table and of bt."""
        return self.local("entity")[: self.real], self.local("bt")[: self.real]

    @torch.no_grad()
    def steps(self, q, fidx):
        m = self.model
        rows = yield from self._query_rows(q)
        with eval_matmul_precision(self.precision):
            lhs, lhs_b = self._queries(rows, q)
            rhs, bt = self._rhs()
            s = m._apply_bias(m.sim(lhs, rhs, all_pairs=True), lhs_b, bt, all_pairs=True)
        loc, own = self.owned(q[:, 2])
        tgt = torch.gather(s, 1, loc.clamp(0, max(self.real - 1, 0))[:, None]) if self.real \
            else torch.zeros((q.shape[0], 1), dtype=s.dtype, device=s.device)
        target = yield torch.where(own[:, None], tgt, torch.zeros_like(tgt))
        total = yield filtered_rank_counts(s, target, fidx, self.real, self.lo).to(torch.int32)
        return 1.0 + total.to(torch.float32) + (target[:, 0] * 0.0).to(torch.float32)

    def _query_rows(self, q):
        rows = yield _head_gold_part(self, q)
        return rows


class ShardedGNNRanker(ShardedDenseRanker):
    """Dense ranking of a GNN model on one shard (JAX
    make_sharded_gnn_ranker): the full-graph encoder runs on every rank,
    once per params version, over the whole entity table (gathered from the
    group when the model is row-sharded), and each shard scores against its
    rows of the encoded table."""

    def __init__(self, model, mesh: Mesh, n_entities: int, precision: str = "highest"):
        super().__init__(model, mesh, n_entities, precision)
        self._enc = None

    def _full_tables(self):
        names = [k for k in ENTITY_PARAMS if k in self.model._parameters]
        if all(getattr(self.model, k).shape[0] == self.n for k in names):
            return {k: getattr(self.model, k) for k in names}
        # every shard's rows at their place in a zero table, summed
        parts = []
        for k in names:
            t = self.local(k)
            full = t.new_zeros((self.s * self.n_shards,) + tuple(t.shape[1:]))
            full[self.lo: self.lo + self.s] = t
            parts.append(full.reshape(full.shape[0], -1))
        total = yield torch.cat(parts, dim=1)
        out, at = {}, 0
        for k, p in zip(names, parts):
            w = p.shape[1]
            out[k] = total[: self.n, at: at + w].reshape((self.n,) + tuple(
                getattr(self.model, k).shape[1:]))
            at += w
        return out

    def _query_rows(self, q):
        key = params_key(self.model.parameters())
        if self._enc is None or not is_current(self._enc[0], key):
            full = yield from self._full_tables()
            self._enc = (key, (full, call_with_tables(self.model, full, self.model.encode)))
        self._full, self._cache = self._enc[1]
        return None

    def _queries(self, rows, q):
        return call_with_tables(self.model, self._full, self.model.get_queries, q[:, :2],
                                self._cache)

    def _rhs(self):
        return self._cache[0][self.lo: self.lo + self.real], \
            self._full["bt"][self.lo: self.lo + self.real]


# the sharded twin of each fused ranker
_SHARDED = {ChypRanker: ShardedChypRanker, HypRanker: ShardedHypRanker,
            AttRHRanker: ShardedAttRHRanker}


def make_best_sharded_ranker(model, mesh: Mesh, n_entities: int, backend: str = "auto",
                             precision: str = "highest"):
    """Sharded counterpart of train/evaluate.py::make_best_ranker, by the
    same table (kernels/_ranker.py::fused_ranker_class): the shard twin of
    the model family's fused ranker ('pallas_maskless': the maskless form),
    else the sharded GNN ranker for GNN models and the dense sharded ranker
    for the rest.  JAX's 'auto means dense' rests on TPU measurements; the
    single-device port already ranks through the fused kernels."""
    ranker = fused_ranker_class(model, backend)
    if ranker is not None:
        return _SHARDED[ranker](model, mesh, n_entities, backend != "pallas_maskless",
                                precision)
    if getattr(model, "is_gnn", False):
        return ShardedGNNRanker(model, mesh, n_entities, precision)
    return ShardedDenseRanker(model, mesh, n_entities, precision)
