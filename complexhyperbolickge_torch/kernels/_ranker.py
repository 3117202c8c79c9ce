"""What the fused filtered rankers share (ChypRanker, HypRanker,
AttRHRanker), on one device or on one shard of a mesh: the per-params
table cache, the pad-row bias, the filter inputs of the masked and the
maskless kernels, the gold add-back, the NaN discipline, and the table of
which family a fused ranker serves (fused_ranker_class).

A ranker is called as ranker(q (B, 3), fidx (B, L)) -> ranks (B,) float32,
with q and fidx int64 tensors on the model's device.  A subclass names its
tables (TABLES, built by `_prepare_tables()`, the padded entity table
first) and its per-batch query inputs (QUERIES, from `_queries_core(q,
tables)`, the threshold t2 last), and counts with `_counts(x, masked)` on
the dict that `kernel_inputs` returns.  The tables hold the global rows lo
.. lo + real: all N on one device, a slice on a shard
(parallel/ranking.py), which runs the same query, filter and count code
on its rows.

Under a torch.profiler each call is a range kge.rank.call
(utils/profiling.py::span) holding, in order, kge.rank.queries (the query
inputs and threshold, and at "default" the query rows' rounding),
kge.rank.filter (the filter ids' clamp and the int8 mask, or the maskless
form's int32 ids) and kge.rank.sweep (the sweep kernel and, maskless, the
filtered subtraction); the table check and the count epilogue are the
call's own.

precision "default" (--eval_precision default) is JAX's single-pass bf16
contraction with f32 accumulation: both operands of the score contraction
are rounded to bfloat16 (round-to-nearest-even), their products summed in
float32, everything else float32.  A default ranker keeps a bfloat16 copy
of the padded entity table beside the float32 tables (whose norms stay
those of the unrounded rows) and rounds the query rows per batch; the
kernel inputs "rhs" and the query rows are then the bfloat16 operands,
rows padded with zeros to a multiple of 16 features (one mma k-step).  The
plain default versions contract the rounded operands exactly (float64) and
round once to float32: within float32 summation of any order of the card's
tensor-core sum.
"""

from __future__ import annotations

import torch

from complexhyperbolickge_torch.ops.math import check_precision, round_up
from complexhyperbolickge_torch.utils.profiling import span
from complexhyperbolickge_torch.utils.versions import is_current, params_key

# entity rows per tile of the sweep kernels; tables are padded to a
# multiple of it (the kernels also take a ragged last tile)
ROW_TILE = 128
# features of one bf16 mma k-step (m16n8k16): bf16 rows are padded to it
BF16_K = 16


def to_bf16(x):
    """x rounded to bfloat16 (round-to-nearest-even); a bfloat16 x as is."""
    return x if x.dtype == torch.bfloat16 else x.to(torch.bfloat16)


def bf16_rows(x, halves: bool = False):
    """float rows x (n, d) -> contiguous bfloat16 (n, round_up(d, 16)),
    rounded to nearest even and zero-padded (exact: zero terms); with
    `halves` each half of the d features is padded on its own (AttRH's two
    contractions), (n, 2 round_up(d / 2, 16))."""
    n, d = x.shape
    parts = x.chunk(2, dim=1) if halves else (x,)
    width = round_up(parts[0].shape[1], BF16_K)
    out = torch.zeros((n, width * len(parts)), dtype=torch.bfloat16, device=x.device)
    for i, p in enumerate(parts):
        out[:, i * width: i * width + p.shape[1]] = p
    return out


def plain_mm(a, b, precision: str):
    """a (M, d) @ b (N, d)^T as the kernels' plain versions take it, float32
    (M, N): highest, a float32 matmul; default, the bfloat16-rounded
    operands' products summed exactly (float64) and rounded once."""
    if precision == "highest":
        return a @ b.T
    return (to_bf16(a).double() @ to_bf16(b).double().T).float()


def plain_rows(q, rows, precision: str):
    """q (B, d) against each query's rows (B, L, d), float32 (B, L), as
    plain_mm."""
    if precision == "highest":
        return torch.einsum("bd,bld->bl", q, rows)
    return torch.einsum("bd,bld->bl", to_bf16(q).double(), to_bf16(rows).double()).float()


# A bf16 instance's float32 tensor-core sum of the exact bf16 products
# against its plain version's once-rounded exact sum, per unit of
# sum_k |q_k w_k|: 64 float32 ulps, above a truncating accumulator's few
# ulps a k-step over <= 8 k-steps.
TC_REL = 2.0 ** -17


def _sq_range(v, e):
    """The range of s^2 over s in [v - e, v + e]."""
    lo, hi = v - e, v + e
    mn = torch.where(lo * hi <= 0, torch.zeros_like(lo), torch.minimum(lo * lo, hi * hi))
    return mn, torch.maximum(lo * lo, hi * hi)


def score_interval(kind: str, x: dict, rel: float = 0.0, rounded: bool = False):
    """float64 score bounds (lo, hi), each (B, Np), of a ranker family's
    kernel inputs x ("chyp", "poincare", "lorentz" or "attrh"; the names of
    kernel_inputs): the score contraction of the operands (rounded to
    bfloat16 first when `rounded`) moved by rel sum_k |q_k w_k| either way,
    pushed through the family's epilogue.  The FFT cross-ratio is convex
    in (Re, Im) and the real-hyperbolic scores monotone in <x, v>, so the
    ends bound each pair's score; rel = 0 gives the score twice."""
    from complexhyperbolickge_torch.kernels import chyp_rank as K
    from complexhyperbolickge_torch.kernels import hyp_rank as H

    def op(t):
        return to_bf16(t).double() if rounded else t.double()

    if kind == "chyp":
        b, d = x["lhs2"].shape[0] // 2, x["lhs2"].shape[1]
        a, w = op(x["lhs2"]), op(x["rhs"][:, :d])
        acc, dl = a @ w.T, (a.abs() @ w.abs().T) * rel
        (rn, rx), (jn, jx) = _sq_range(acc[:b] - 1.0, dl[:b]), _sq_range(acc[b:], dl[b:])
        den = x["zn"].double()[:, None] * x["wn"].double()[None, :]

        def score(s2):
            xx = (2.0 * s2 / den - 1.0).clamp_min(K.X_MIN)
            dd = torch.log(xx + torch.sqrt(xx * xx - 1.0))
            return x["bt"].double()[None, :] - dd * dd

        return score(rx + jx), score(rn + jn)
    c, bt = x["c"].double()[:, None], x["bt"].double()[None, :]
    a, w = op(x["lhs"]), op(x["rhs"])

    def ends(sl, un, x2, dist):
        acc, dl = a[:, sl] @ w[:, sl].T, (a[:, sl].abs() @ w[:, sl].abs().T) * rel
        u = x[un].double()[None, :]
        e = [dist(v / u, u, c, x[x2].double()[:, None]) for v in (acc - dl, acc + dl)]
        return torch.minimum(*e), torch.maximum(*e)

    if kind == "attrh":
        h = a.shape[1] // 2
        (r0, r1), (f0, f1) = (ends(slice(None, h), "un_rot", "x2r", H._half_dist_sq),
                              ends(slice(h, None), "un_ref", "x2f", H._half_dist_sq))
        w0, w1 = x["w0"].double()[:, None], x["w1"].double()[:, None]
        return bt - w0 * r1 - w1 * f1, bt - w0 * r0 - w1 * f0
    d0, d1 = ends(slice(None), "un", "x2", H._DISTS[kind])
    return bt - d1 * d1, bt - d0 * d0


def near_threshold(lo, hi, t2):
    """Per query (B,): the entities whose score interval [lo, hi] comes
    within 1e-5 (1 + |t2|) of the threshold t2, the float32 epilogue's and
    the thresholds' own error."""
    t2 = t2.double()
    e = (1e-5 * (1.0 + t2.abs()))[:, None]
    return ((lo - e <= t2[:, None]) & (t2[:, None] <= hi + e)).sum(1)


BACKENDS = ("auto", "dense", "pallas", "pallas_maskless")


def fused_ranker_class(model, backend: str):
    """The fused ranker class for `backend` (--eval_backend) and the model's
    family, None for the dense ranker: ChypRanker for the FFTUnitBall
    family, AttRHRanker for AttRH (before BaseH, which it subclasses),
    HypRanker for the rest of BaseH and BaseLorentz.  make_best_ranker and
    make_best_sharded_ranker both select by it."""
    from complexhyperbolickge_torch.kernels.chyp_rank import ChypRanker
    from complexhyperbolickge_torch.kernels.hyp_rank import AttRHRanker, HypRanker
    from complexhyperbolickge_torch.models.chyperbolic import FFTUnitBall
    from complexhyperbolickge_torch.models.hyperbolic import AttRH, BaseH, BaseLorentz

    if backend not in BACKENDS:
        raise ValueError(f"unknown eval backend {backend!r}")
    if backend != "dense":
        for family, ranker in ((FFTUnitBall, ChypRanker), (AttRH, AttRHRanker),
                               ((BaseH, BaseLorentz), HypRanker)):
            if isinstance(model, family):
                return ranker
    if backend in ("pallas", "pallas_maskless"):
        raise NotImplementedError(
            f"no fused CUDA ranker exists for {type(model).__name__}; rank it "
            "with --eval_backend dense (or auto)")
    return None


class FusedRanker:
    TABLES: tuple = ()
    QUERIES: tuple = ()
    # the model parameters the tables are built from
    TABLE_PARAMS: tuple = ("entity", "bt")
    # bf16 rows: the two halves of the features padded each on its own
    BF16_HALVES = False

    def __init__(self, model, masked: bool = True, precision: str = "highest"):
        if model.cfg.bias not in ("learn", "none", "constant"):
            raise ValueError(f"unknown bias mode {model.cfg.bias!r}")
        self.model = model
        self.masked = masked
        self.precision = check_precision(precision)
        # the global rows held, lo .. lo + real: all of them on a device; a
        # shard sets its slice (parallel/ranking.py)
        self.lo, self.real = 0, model.cfg.n_entities
        self._tables_key = None
        self._tables = None

    def _prepare_tables(self) -> tuple:
        raise NotImplementedError

    def _queries_core(self, q, tables) -> tuple:
        raise NotImplementedError

    def _counts(self, x: dict, masked: bool):
        raise NotImplementedError

    def _padded_bias(self, np_: int, device):
        """Tail biases over the padded table: the held rows' bt with
        bias=learn, else 0, and -1e30 on the pad rows (past N or past a
        shard's slice), which puts them below every threshold in the
        maskless sweeps (their finite distance could otherwise count)."""
        m = self.model
        bt = torch.full((np_,), -1e30, dtype=torch.float32, device=device)
        bt[: self.real] = (m.bt.detach()[: self.real, 0].to(torch.float32)
                           if m.cfg.bias == "learn" else 0.0)
        return bt

    def _gold_threshold(self, sim_gold, gold):
        """t2 = the gold tail's score with the lhs bias folded out: bt[gold]
        stays on the table side under bias=learn; 'constant' adds gamma on
        both sides and 'none' nothing."""
        m = self.model
        t2 = sim_gold
        if m.cfg.bias == "learn":
            t2 = t2 + m.bt[gold, 0].to(torch.float32)
        return t2.contiguous()

    def _get_tables(self):
        """The padded tables (and, precision "default", the bfloat16 copy
        of the first, last), rebuilt when a TABLE_PARAMS parameter object or
        its `_version` counter changed, so an in-place update
        (load_state_dict, an optimizer step) is never served stale."""
        key = params_key(getattr(self.model, name) for name in self.TABLE_PARAMS)
        if not is_current(self._tables_key, key):
            tables = self._prepare_tables()
            if self.precision == "default":
                d = self.model.entity.shape[1]
                tables = (*tables, bf16_rows(tables[0][:, :d], self.BF16_HALVES))
            self._tables, self._tables_key = tables, key
        return self._tables

    def _local(self, ids, fill: int):
        """Global ids -> the held ones' local rows, `fill` for the others."""
        loc = ids - self.lo if self.lo else ids
        return torch.where((loc >= 0) & (loc < self.real), loc, torch.full_like(loc, fill))

    def _filter(self, q, fidx, np_: int, masked: bool) -> dict:
        """Masked: int8 (B, Np), set on the pad rows (real and up) and on the
        held filter ids; the other ids (out of range, the pad id N, another
        shard's) go to pad row `real`, which every table has (torch's
        scatter has no "drop" mode).  Maskless: local int32 rows, -1 (which
        the subtractions skip) for the ids and the gold not held."""
        if masked:
            mask = torch.zeros((q.shape[0], np_), dtype=torch.int8, device=q.device)
            mask[:, self.real:] = 1
            mask.scatter_(1, self._local(fidx, self.real).long(), 1)
            return {"mask": mask}
        gold = q[:, 2]
        if self.lo or self.real < self.model.cfg.n_entities:  # a shard: not every gold
            gold = self._local(gold, -1)
        return {"fidx": self._local(fidx, -1).to(torch.int32).contiguous(),
                "gold": gold.to(torch.int32).contiguous()}

    def _inputs(self, q, fidx, masked: bool, tables: tuple, queries) -> dict:
        """The kernels' inputs of one batch from the tables and `queries()`,
        the query inputs (precision "default": the table and the query rows
        as bfloat16), and the filter inputs."""
        x = dict(zip(self.TABLES, tables))
        with span("rank.queries"):
            x.update(zip(self.QUERIES, queries()))
            if self.precision == "default":  # the contraction's bf16 operands
                x[self.TABLES[0]] = tables[-1]
                x[self.QUERIES[0]] = bf16_rows(x[self.QUERIES[0]], self.BF16_HALVES)
        with span("rank.filter"):
            x.update(self._filter(q, fidx, tables[0].shape[0], masked))
        return x

    def _sweep(self, x: dict, q, fidx):
        """The counts over the held rows.  Maskless, shard 0 adds back the
        gold that the sweep and the subtraction left out: +1 unless it is
        filtered (always, under the reference protocol)."""
        with span("rank.sweep"):
            counts = self._counts(x, self.masked)
        if not self.masked and self.lo == 0:
            counts = counts + (~(fidx == q[:, 2:3]).any(dim=1)).to(torch.int32)
        return counts

    @staticmethod
    def _ranks(counts, t2):
        """NaN discipline: t2 * 0 is NaN exactly when the gold score is, so
        NaN params fail get_ranking's host check instead of ranking 1."""
        return 1.0 + counts.to(torch.float32) + t2 * 0.0

    @torch.no_grad()
    def kernel_inputs(self, q, fidx, masked: bool | None = None) -> dict:
        """The kernels' inputs for one batch (`_inputs`): mask (masked) or
        fidx and gold (maskless) as `_filter` builds them."""
        masked = self.masked if masked is None else masked
        tables = self._get_tables()
        return self._inputs(q, fidx, masked, tables, lambda: self._queries_core(q, tables))

    @torch.no_grad()
    def __call__(self, q, fidx):
        with span("rank.call"):
            x = self.kernel_inputs(q, fidx)
            return self._ranks(self._sweep(x, q, fidx), x["t2"])
