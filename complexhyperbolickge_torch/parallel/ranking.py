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

The fused rankers are the single-device ones (kernels/chyp_rank.py,
kernels/hyp_rank.py) on the rank's slice: K1 / K2 for the FFT family, K5 /
K6 for BaseH (not AttRH) and BaseLorentz, K7 / K8 for AttRH, and with
precision "default" their bf16 instances.  The local tables are built from
the rank's rows with the same code (pad rows, past N or past the slice,
carry bt = -1e30 and the mask bit), and the query inputs by the same
_queries_core on a mini-table of the gathered head and gold rows, so every
per-pair score is the one-process score.  The masked form scatters the
owned filter ids into local_np + 1 columns and drops the last (torch's
scatter has no drop mode; JAX's _local_pad_filter_mask); the maskless form
sends ids another rank owns to -1, which the kernels skip, excludes the
gold on its owner only and adds the gold back on shard 0 only.
"""

from __future__ import annotations

import torch

from complexhyperbolickge_torch.kernels._ranker import bf16_rows
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

    def local_filter_count(self, s, target, fidx):
        """The shard's #{score >= target} over its real columns s (B, real),
        less the filtered entities it owns that counted, plus those the
        -1e6 overwrite would still count (train/evaluate.py::
        filtered_rank_counts, local form)."""
        loc, own = self.owned(fidx)
        g = torch.gather(s, 1, loc.clamp(0, max(self.real - 1, 0))) if self.real else \
            torch.zeros(fidx.shape, dtype=s.dtype, device=s.device)
        total = torch.sum(s >= target, dim=1)
        sub = torch.sum(own & (g >= target), dim=1)
        add = torch.sum(own & (target <= -1e6), dim=1)
        return (total - sub + add).to(torch.int32)

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
        rank's parameters hold NaN or inf (get_ranking's check; no rank
        raises alone)."""
        params = [p for p in self.model.parameters() if p.dtype.is_floating_point]
        bad = any(not bool(torch.isfinite(p).all()) for p in params)
        flag = torch.tensor([1.0 if bad else 0.0], device=params[0].device)
        if float(self.mesh.sum_model(flag)) > 0:
            raise FloatingPointError(
                "non-finite model parameters entering evaluation (diverged "
                "training run?) — ranks would silently read as 1")


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
    """A fused ranker (the class it is mixed into) on one shard's rows."""

    def __init__(self, model, mesh: Mesh, n_entities: int, masked: bool = True,
                 precision: str = "highest"):
        super().__init__(model, masked=masked, precision=precision)
        self._init_shard(model, mesh, n_entities)
        self._pinned = None

    def _get_tables(self):
        # pinned while _queries_core runs on the mini-tables
        return self._pinned if self._pinned is not None else super()._get_tables()

    def _prepare_tables(self):
        local = {k: self.local(k) for k in ("entity", "bt")}
        return call_with_tables(self.model, local, super()._prepare_tables)

    def _padded_bias(self, np_: int, device):
        """The local tail biases: the real rows' (bias=learn) or 0, and
        -1e30 on the rows past N or past the slice."""
        m = self.model
        bt = torch.full((np_,), -1e30, dtype=torch.float32, device=device)
        bt[: self.real] = (m.bt.detach()[: self.real, 0].to(torch.float32)
                           if m.cfg.bias == "learn" else 0.0)
        return bt

    @torch.no_grad()
    def steps(self, q, fidx):
        b = q.shape[0]
        tables = self._get_tables()
        rows = yield _head_gold_part(self, q)
        mini, q_mini = _mini_tables(rows, q)
        self._pinned = tables
        try:
            queries = call_with_tables(self.model, mini, self._queries_core, q_mini)
        finally:
            self._pinned = None
        x = dict(zip(self.TABLES, tables))
        x.update(zip(self.QUERIES, queries))
        if self.precision == "default":  # the contraction's bf16 operands
            x[self.TABLES[0]] = tables[-1]
            x[self.QUERIES[0]] = bf16_rows(x[self.QUERIES[0]], self.BF16_HALVES)
        np_ = tables[0].shape[0]
        loc, own = self.owned(fidx)
        if self.masked:
            mask = torch.zeros((b, np_ + 1), dtype=torch.int8, device=q.device)
            mask[:, self.real:np_] = 1  # rows past N or past the slice
            mask.scatter_(1, torch.where(own, loc, np_), 1)  # others: dropped column
            x["mask"] = mask[:, :np_].contiguous()
        else:
            x["fidx"] = torch.where(own, loc, -1).to(torch.int32).contiguous()
            g_loc, g_own = self.owned(q[:, 2])
            x["gold"] = torch.where(g_own, g_loc, -1).to(torch.int32).contiguous()
        counts = self._counts(x, self.masked)
        if not self.masked and self.shard_idx == 0:
            # the gold's dense-path contribution, once: 0 when it is
            # filtered (always, under the reference protocol), else 1
            counts = counts + (~(fidx == q[:, 2:3]).any(dim=1)).to(torch.int32)
        total = yield counts.to(torch.int32)
        # NaN discipline: t2 * 0 is NaN exactly when the gold score is
        return 1.0 + total.to(torch.float32) + x["t2"] * 0.0


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
        total = yield self.local_filter_count(s, target, fidx)
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
        key = [(p, p._version) for p in self.model.parameters()]
        hit = self._enc
        if not (hit is not None and len(hit[0]) == len(key)
                and all(a is c and v == w for (a, v), (c, w) in zip(hit[0], key))):
            full = yield from self._full_tables()
            cache = call_with_tables(self.model, full, self.model.encode)
            self._enc = hit = (key, (full, cache))
        self._full, self._cache = hit[1]
        return None

    def _queries(self, rows, q):
        return call_with_tables(self.model, self._full, self.model.get_queries, q[:, :2],
                                self._cache)

    def _rhs(self):
        return self._cache[0][self.lo: self.lo + self.real], \
            self._full["bt"][self.lo: self.lo + self.real]


def make_sharded_ranker(model, mesh: Mesh, n_entities: int, precision: str = "highest"):
    """The dense sharded ranker (JAX make_sharded_ranker)."""
    return ShardedDenseRanker(model, mesh, n_entities, precision)


def make_sharded_gnn_ranker(model, mesh: Mesh, n_entities: int, precision: str = "highest"):
    """The GNN sharded ranker (JAX make_sharded_gnn_ranker)."""
    return ShardedGNNRanker(model, mesh, n_entities, precision)


def make_sharded_pallas_ranker(model, mesh: Mesh, n_entities: int,
                               precision: str = "highest", masked: bool = True):
    """K1 / K2 per shard (JAX make_sharded_pallas_ranker)."""
    return ShardedChypRanker(model, mesh, n_entities, masked, precision)


def make_sharded_hyp_ranker(model, mesh: Mesh, n_entities: int,
                            precision: str = "highest", masked: bool = True):
    """K5 / K6 per shard (JAX make_sharded_hyp_ranker)."""
    return ShardedHypRanker(model, mesh, n_entities, masked, precision)


def make_sharded_attrh_ranker(model, mesh: Mesh, n_entities: int,
                              precision: str = "highest", masked: bool = True):
    """K7 / K8 per shard (JAX make_sharded_attrh_ranker)."""
    return ShardedAttRHRanker(model, mesh, n_entities, masked, precision)


def make_best_sharded_ranker(model, mesh: Mesh, n_entities: int, backend: str = "auto",
                             precision: str = "highest"):
    """Sharded counterpart of train/evaluate.py::make_best_ranker, by the
    port's policy: 'auto' and 'pallas' take the masked fused ranker of the
    model's family per shard (K1 FFTUnitBall, K7 AttRH, tested before BaseH
    which it subclasses, K5 BaseH and BaseLorentz), 'pallas_maskless' the
    maskless one (K2, K8, K6), 'dense' and the families without a fused
    ranker the dense sharded ranker, and GNN models the sharded GNN ranker.
    JAX's 'auto means dense' rests on TPU measurements; the single-device
    port already ranks through the fused kernels."""
    from complexhyperbolickge_torch.models.chyperbolic import FFTUnitBall
    from complexhyperbolickge_torch.models.hyperbolic import AttRH, BaseH, BaseLorentz

    if backend not in ("auto", "dense", "pallas", "pallas_maskless"):
        raise ValueError(f"unknown eval backend {backend!r}")
    check_precision(precision)
    if getattr(model, "is_gnn", False):
        if backend in ("pallas", "pallas_maskless"):
            raise NotImplementedError("no fused CUDA ranker exists for GNN models; rank "
                                      "them with --eval_backend dense (or auto)")
        return make_sharded_gnn_ranker(model, mesh, n_entities, precision)
    if backend != "dense":
        masked = backend != "pallas_maskless"
        for family, make in ((FFTUnitBall, make_sharded_pallas_ranker),
                             (AttRH, make_sharded_attrh_ranker),
                             ((BaseH, BaseLorentz), make_sharded_hyp_ranker)):
            if isinstance(model, family):
                return make(model, mesh, n_entities, precision, masked)
    if backend in ("pallas", "pallas_maskless"):
        raise NotImplementedError(
            f"no fused CUDA ranker exists for {type(model).__name__}; rank it "
            "with --eval_backend dense (or auto)")
    return make_sharded_ranker(model, mesh, n_entities, precision)
