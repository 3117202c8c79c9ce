"""Filtered-ranking evaluation: MR / MRR / Hits@{1,3,10}, lhs+rhs averaged.

Port of complexhyperbolickge_tpu/train/evaluate.py (the ranking, serving
and metric parts; training-time validation comes with the training slice).

Protocol: rank = 1 + #{score >= target} after setting every filtered
entity (the gold tail included) to -1e6; metrics averaged over the tail-
and head-prediction directions (the lhs direction queries the inverse
relation).  Filters arrive as padded index arrays (data/dataset.py
eval_pack) and are excluded by count subtraction.

Rankers are callables rank_fn(q (B, 3), fidx (B, L)) -> ranks (B,) float32
over the model's current parameters, with q and fidx int64 tensors on the
model's device.  GNN models rank and predict densely over their encoder
output, computed once per params version (GNNModel.cached_encode).
"""

from __future__ import annotations

import numpy as np
import torch

from complexhyperbolickge_torch.ops.math import check_precision, eval_matmul_precision
from complexhyperbolickge_torch.utils.versions import is_current, params_key


def _mask_pad_cols(scores, n_entities: int):
    """Push score columns past n_entities (row-padded entity tables) below
    any target, so they never count toward a rank or win top-k."""
    if scores.shape[-1] == n_entities:
        return scores
    valid = (torch.arange(scores.shape[-1], device=scores.device)
             < n_entities)[None, :]
    return torch.where(valid, scores, torch.full_like(scores, -torch.inf))


def filtered_rank_counts(scores, target, fidx, n_entities: int, lo: int = 0):
    """#{score >= target} with the filtered entities excluded, without
    writing into the (B, N) matrix: the filtered entries' scores are gathered
    from the same matrix (bitwise the same values) and those that counted
    are subtracted; entries a -1e6 overwrite would still have counted
    (target <= -1e6) are added back.  Filter rows must be deduplicated and
    padded with N.  A shard's scores (parallel/ranking.py) hold the
    n_entities columns of global rows lo .. lo + n_entities; the filter ids
    outside them are another shard's."""
    total = torch.sum(scores >= target, dim=1)
    loc = fidx - lo if lo else fidx
    valid = (loc >= 0) & (loc < n_entities)
    cols = scores.shape[-1]
    g = torch.gather(scores, 1, loc.clamp(0, cols - 1)) if cols else \
        torch.zeros(fidx.shape, dtype=scores.dtype, device=scores.device)
    sub = torch.sum(valid & (g >= target), dim=1)
    # the -1e6 overwrite value, compared in the scores' dtype (a scalar, so
    # no host-to-device copy per batch)
    add = torch.sum(valid & (target <= -1e6), dim=1)
    return total - sub + add


def _score_all(model, queries, precision: str = "highest"):
    """score_all over the current params, its all-pairs contractions at
    `precision` (ops/math.py::eval_matmul_precision); a GNN scores against
    its cached eval-mode encoding, encoded outside the precision scope
    (exact), as JAX encodes outside it."""
    if getattr(model, "is_gnn", False):
        cache = model.cached_encode()
        with eval_matmul_precision(precision):
            return model.score_all(queries, cache=cache)
    with eval_matmul_precision(precision):
        return model.score_all(queries)


def make_ranker(model, eval_batch_size: int | None = None,
                precision: str = "highest"):
    """Dense filtered ranker: score_all materializes the (B, N) scores
    (two matmuls plus the epilogue), then counts by subtraction; the target
    is the gold's entry of the same matrix.  precision "default" rounds the
    operands of score_all's all-pairs contractions to bfloat16 (JAX traces
    its score region under eval_matmul_precision alike).
    eval_batch_size is accepted for symmetry with make_best_ranker."""
    check_precision(precision)

    @torch.no_grad()
    def rank_batch(q, fidx):
        scores = _mask_pad_cols(_score_all(model, q[:, :2], precision),
                                model.cfg.n_entities)
        target = torch.gather(scores, 1, q[:, 2:3])
        counts = filtered_rank_counts(scores, target, fidx, model.cfg.n_entities)
        # NaN discipline: target * 0 is NaN exactly when the gold score is;
        # no full-matrix isfinite reduce
        return 1.0 + counts.to(torch.float32) + (target[:, 0] * 0.0).to(torch.float32)

    return rank_batch


def make_best_ranker(model, eval_batch_size: int, backend: str = "auto",
                     precision: str = "highest"):
    """Ranking-backend selector.

    backend='auto' takes the masked fused CUDA ranker of the model's family
    (kernels/_ranker.py::fused_ranker_class) on any device (the CPU runs its
    plain version): JAX's rule (dense below 100k entities) rests on TPU
    measurements, and on the H100 the dense path writes and re-reads a (B,
    N) f32 score matrix a batch (82 MB at WN18RR, B = 500).  'pallas' and
    'pallas_maskless' (names that saved config.json files carry) are the
    masked (K1, K5, K7) and maskless (K2, K6, K8) CUDA rankers; 'dense', and
    every family without a fused ranker (the GNN models), the materializing
    one.  precision: 'highest' (exact fp32) or 'default', JAX's single-pass
    bf16 contraction with f32 accumulation (the fused rankers' bf16
    tensor-core instances, the dense ranker's rounded operands).
    """
    from complexhyperbolickge_torch.kernels._ranker import fused_ranker_class

    ranker = fused_ranker_class(model, backend)
    if ranker is not None:
        return ranker(model, masked=backend != "pallas_maskless", precision=precision)
    return make_ranker(model, eval_batch_size, precision=precision)


def make_predictor(model, k: int = 10):
    """Top-k tail prediction for (head, rel) queries, the serving path.

    Returns fn(queries (B, 2), filter_idx=None) -> (ids (B, k), scores
    (B, k)); filter_idx (padded known-true-tail ids, pad = n_entities) masks
    known facts so predictions are new candidates.  NaN discipline: the
    params finiteness check raises FloatingPointError before NaN params are
    served (verdict cached per params version), and NaN top-k scores (an
    overflow inside score_all) raise too; -inf is legitimate (filtered or
    pad columns)."""

    @torch.no_grad()
    def predict(queries, fidx=None):
        _check_params_finite(model)
        n = model.cfg.n_entities
        scores = _mask_pad_cols(_score_all(model, queries), n)
        if fidx is not None:
            # one extra column absorbs the pad and out-of-range ids (torch
            # has no scatter "drop")
            fidx = fidx.long()
            fidx = torch.where((fidx >= 0) & (fidx < n), fidx,
                               torch.full_like(fidx, n))
            scores = torch.nn.functional.pad(scores, (0, 1), value=-torch.inf)
            scores.scatter_(1, fidx, -torch.inf)
            scores = scores[:, :n]
        vals, ids = torch.topk(scores, k, dim=1)
        if torch.isnan(vals).any():
            raise FloatingPointError(
                "NaN top-k prediction scores (score overflow at serving "
                "time?) — refusing to serve arbitrary ids"
            )
        return ids, vals

    return predict


NONFINITE_PARAMS = ("non-finite model parameters entering evaluation (diverged "
                    "training run?) — ranks would silently read as 1")


def params_finite(model) -> bool:
    """Whether every floating parameter is finite.  The verdict is cached
    on the model per params version (utils/versions.py), so serving pays
    one device sync per checkpoint."""
    params = list(model.parameters())
    key = params_key(params)
    hit = getattr(model, "_finite_verdict", None)
    if hit is None or not is_current(hit[0], key):
        with torch.no_grad():
            flags = [torch.isfinite(p).all() for p in params
                     if p.dtype.is_floating_point]
            hit = model._finite_verdict = (key, bool(torch.stack(flags).all()) if flags
                                           else True)
    return hit[1]


def _check_params_finite(model):
    """Raise FloatingPointError when a parameter holds NaN/inf."""
    if not params_finite(model):
        raise FloatingPointError(NONFINITE_PARAMS)


def get_ranking(model, pack, batch_size: int = 500, rank_fn=None) -> np.ndarray:
    """Ranks (float32 numpy) of the gold entity for every query of an
    EvalPack: the split is uploaded once and ranked batch by batch on the
    model's device, with one host sync at the end.  A ranker with a
    check_params method (the sharded ones: parallel/ranking.py) checks the
    params itself, across its group."""
    rank_fn = rank_fn or make_ranker(model)
    getattr(rank_fn, "check_params", _check_params_finite)(model)
    device = next(model.parameters()).device
    q = torch.as_tensor(pack.queries, dtype=torch.int64, device=device)
    fidx = torch.as_tensor(pack.filter_idx, dtype=torch.int64, device=device)
    ranks = [rank_fn(q[i: i + batch_size], fidx[i: i + batch_size])
             for i in range(0, q.shape[0], batch_size)]
    out = torch.cat(ranks).cpu().numpy().astype(np.float32, copy=False)
    if not np.isfinite(out).all():
        raise FloatingPointError("non-finite ranks in evaluation")
    return out


def _direction_metrics(ranks: np.ndarray):
    return {
        "MR": float(np.mean(ranks)),
        "MRR": float(np.mean(1.0 / ranks)),
        "hits@[1,3,10]": [float(np.mean(ranks <= k)) for k in (1, 3, 10)],
    }


def compute_metrics(model, dataset, split: str, batch_size: int = 500,
                    rel_idx: int = -1, rank_fn=None):
    """Both-direction filtered metrics."""
    rank_fn = rank_fn or make_ranker(model)
    out = {}
    for direction in ("rhs", "lhs"):
        pack = dataset.eval_pack(split, direction, rel_idx=rel_idx)
        if len(pack.queries) == 0:
            out[direction] = {"MR": 0.0, "MRR": 0.0, "hits@[1,3,10]": [0.0] * 3}
            continue
        ranks = get_ranking(model, pack, batch_size, rank_fn=rank_fn)
        out[direction] = _direction_metrics(ranks)
    return out


def avg_both(metrics):
    """Average the lhs/rhs metric dicts."""
    lhs, rhs = metrics["lhs"], metrics["rhs"]
    return {
        "MR": (lhs["MR"] + rhs["MR"]) / 2,
        "MRR": (lhs["MRR"] + rhs["MRR"]) / 2,
        "hits@[1,3,10]": [
            (a + b) / 2 for a, b in zip(lhs["hits@[1,3,10]"], rhs["hits@[1,3,10]"])
        ],
    }


def format_metrics(metrics, split: str) -> str:
    h = metrics["hits@[1,3,10]"]
    return (
        f"\t {split} MR: {metrics['MR']:.2f} | MRR: {metrics['MRR']:.3f} | "
        f"H@1: {h[0]:.3f} | H@3: {h[1]:.3f} | H@10: {h[2]:.3f}"
    )


def count_params(model) -> int:
    """Total parameter count."""
    return sum(p.numel() for p in model.parameters())
