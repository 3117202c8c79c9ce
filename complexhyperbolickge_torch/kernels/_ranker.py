"""What the fused filtered rankers share (ChypRanker, HypRanker,
AttRHRanker): the per-params table cache, the filter inputs of the masked
and the maskless kernels, the gold add-back and the NaN discipline.

A ranker is called as ranker(q (B, 3), fidx (B, L)) -> ranks (B,) float32,
with q and fidx int64 tensors on the model's device.  A subclass names its
tables (TABLES, built by `_prepare_tables()`, the padded entity table
first) and its per-batch query inputs (QUERIES, from `_queries_core(q)`,
the threshold t2 last), and counts with `_counts(x, masked)` on the dict
that `kernel_inputs` returns.
"""

from __future__ import annotations

import torch

# entity rows per tile of the sweep kernels; tables are padded to a
# multiple of it (the kernels also take a ragged last tile)
ROW_TILE = 128


class FusedRanker:
    TABLES: tuple = ()
    QUERIES: tuple = ()
    # the model parameters the tables are built from
    TABLE_PARAMS: tuple = ("entity", "bt")

    def __init__(self, model, masked: bool = True):
        if model.cfg.bias not in ("learn", "none", "constant"):
            raise ValueError(f"unknown bias mode {model.cfg.bias!r}")
        self.model = model
        self.masked = masked
        self._tables_key = None
        self._tables = None

    def _prepare_tables(self) -> tuple:
        raise NotImplementedError

    def _queries_core(self, q) -> tuple:
        raise NotImplementedError

    def _counts(self, x: dict, masked: bool):
        raise NotImplementedError

    def _padded_bias(self, np_: int, device):
        """Tail biases over the padded table: bt with bias=learn, else 0, and
        -1e30 on the pad rows, which puts them below every threshold in the
        maskless sweeps (their finite distance could otherwise count)."""
        m = self.model
        bt = torch.full((np_,), -1e30, dtype=torch.float32, device=device)
        n = m.cfg.n_entities
        bt[:n] = m.bt.detach()[:, 0].to(torch.float32) if m.cfg.bias == "learn" else 0.0
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
        """The padded tables, rebuilt when a TABLE_PARAMS parameter object or
        its `_version` counter changed, so an in-place update
        (load_state_dict, an optimizer step) is never served stale."""
        params = [getattr(self.model, name) for name in self.TABLE_PARAMS]
        key = [(p, p._version) for p in params]
        old = self._tables_key
        if old is None or any(o[0] is not k[0] or o[1] != k[1] for o, k in zip(old, key)):
            self._tables = self._prepare_tables()
            self._tables_key = key
        return self._tables

    @torch.no_grad()
    def kernel_inputs(self, q, fidx, masked: bool | None = None) -> dict:
        """The kernels' inputs for one batch: the tables, the query inputs,
        and mask (int8 (B, Np), masked form) or fidx and gold (int32,
        maskless form).  Filter ids outside [0, Np) are sent to pad row
        n_entities, where torch's scatter has no "drop" mode."""
        masked = self.masked if masked is None else masked
        tables = self._get_tables()
        out = dict(zip(self.TABLES, tables))
        out.update(zip(self.QUERIES, self._queries_core(q)))
        rhs = tables[0]
        n = self.model.cfg.n_entities
        np_ = rhs.shape[0]
        fidx = torch.where((fidx >= 0) & (fidx < np_), fidx, torch.full_like(fidx, n))
        if masked:
            mask = torch.zeros((q.shape[0], np_), dtype=torch.int8, device=rhs.device)
            mask[:, n:] = 1
            mask.scatter_(1, fidx.long(), 1)
            out["mask"] = mask
        else:
            out["fidx"] = fidx.to(torch.int32).contiguous()
            out["gold"] = q[:, 2].to(torch.int32).contiguous()
        return out

    @torch.no_grad()
    def __call__(self, q, fidx):
        x = self.kernel_inputs(q, fidx)
        counts = self._counts(x, self.masked)
        if not self.masked:
            # the gold was excluded from both the sweep and the subtraction;
            # the dense path's contribution is 0 when it is filtered (always,
            # under the reference protocol) and +1 otherwise
            gold_filtered = (x["fidx"] == x["gold"][:, None]).any(dim=1)
            counts = counts + (~gold_filtered).to(torch.int32)
        # NaN discipline: counts are finite by construction, so NaN params
        # would silently rank everything 1; t2 * 0 is NaN exactly when the
        # gold-target score is, and get_ranking's host check then fires
        return 1.0 + counts.to(torch.float32) + x["t2"] * 0.0
