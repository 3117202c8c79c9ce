"""Training losses.

Port of complexhyperbolickge_tpu/train/losses.py:
  * per-query negative sampling with the shifted-randint sampler (uniform
    over the entities that are not the gold tail) and the logsigmoid loss
    over the positive and the K negatives of every query;
  * shared negatives (one (K,) candidate set a batch) and pooled negatives
    (a (P,) pool a step, each query's negatives a window of K pool slots),
    both scored through the models' all-pairs `sim`;
  * the all-entity losses over score_all's (B, N) scores: cross-entropy
    with label smoothing (factored, no (B, N) log-softmax), BCE against
    the multi-hot of padded label lists, and the signed-logsigmoid CE of
    the labelless binarycrossentropy branch.
`weights` (B,) masks the padded rows of the static-shape batch
(data/dataset.py::epoch_batches).  Every loss returns (loss, regularizer
factors).

double_neg corrupts the head of (h, r, t) by scoring the query
(t, (r + n_rel/2) % n_rel), the inverse relation, against sampled head
candidates: the same cost and model semantics as tail corruption.

Randomness comes from a torch.Generator of the batch's device through an
injectable draw (`sampler` for per-query negatives, `draw` for the shared
ids, the pool and its window offsets), so tests can feed the JAX package's
draws.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad_col_mask(preds, n_entities):
    """(1, Np) bool mask of the real entity columns, or None when preds
    has exactly n_entities columns.  Tables row-padded for sharding make
    score_all emit pad columns, which every all-entity loss must leave
    out (mask -> zero gradient -> pad rows stay zero)."""
    np_ = preds.shape[-1]
    if n_entities is None or np_ == n_entities:
        return None
    return (torch.arange(np_, device=preds.device) < n_entities)[None, :]


def sample_negatives(generator, batch, n_entities: int, k: int):
    """k uniform samples over the entities != the gold tail batch[:, 2],
    drawn on the batch's device from `generator` (a generator of that
    device)."""
    neg = torch.randint(0, n_entities - 1, (batch.shape[0], k),
                        generator=generator, device=batch.device)
    return torch.where(neg < batch[:, 2:3], neg, neg + 1)


def neg_sampling_loss(model, batch, weights, generator, n_entities: int,
                      k: int, double_neg: bool, n_rel: int,
                      sampler=sample_negatives):
    """-mean[logsig(pos) ++ logsig(-neg)] over the valid elements; returns
    (loss, regularizer factors).  `sampler(generator, batch, n_entities, k)`
    draws the negative ids: tails for `batch`, then heads for the inverted
    batch under double_neg.  Tests inject a sampler that returns the JAX
    package's draws."""
    queries, tails = batch[:, :2], batch[:, 2:3]
    factors = model.get_factors(queries, tails)

    # one get_queries chain and one (B, 1 + k) block of candidate ids, the
    # positive first, serve the positive and the negative scores
    lhs, lhs_b = model.get_queries(queries)
    ids = torch.cat([tails, sampler(generator, batch, n_entities, k)], dim=1)
    s = model.score_ids(lhs, lhs_b, ids)
    pos, neg_s = s[:, :1], s[:, 1:]  # (B, 1), (B, k)

    w = weights[:, None]
    num = torch.sum(w * F.logsigmoid(pos)) + torch.sum(w * F.logsigmoid(-neg_s))
    den = torch.sum(weights) * (1 + k)

    if double_neg:
        inv_q = _inverse_queries(batch, n_rel)
        inv_batch = torch.stack([batch[:, 2], batch[:, 1], batch[:, 0]], dim=1)
        neg_h = sampler(generator, inv_batch, n_entities, k)
        neg_hs = model.score(inv_q, neg_h)
        num = num + torch.sum(w * F.logsigmoid(-neg_hs))
        den = den + torch.sum(weights) * k
    return -num / den, factors


def uniform_ids(generator, high: int, shape, device):
    """Uniform int64 draws in [0, high) of `shape` on `device` from
    `generator`: the shared negatives, the pool and its window offsets."""
    return torch.randint(0, high, shape, generator=generator, device=device)


def _inverse_queries(batch, n_rel: int):
    """(t, (r + n_rel/2) % n_rel): the head-corruption queries."""
    return torch.stack([batch[:, 2], (batch[:, 1] + n_rel // 2) % n_rel], dim=1)


def _candidate_set_loss(model, batch, weights, double_neg: bool, n_rel: int, negs):
    """The shared and pooled losses' frame: -(sum of logsig(pos) over the
    valid rows + the negatives' sums) / (valid rows + kept negatives).
    `negs(lhs, lhs_b, gold)` scores one direction's negatives and returns
    (sum of keep * logsig(-s), sum of keep): the tails, then (double_neg)
    the heads through the inverse queries.  One get_queries chain serves
    the positive and the tail negatives."""
    queries, tails = batch[:, :2], batch[:, 2:3]
    factors = model.get_factors(queries, tails)
    lhs, lhs_b = model.get_queries(queries)
    pos = model.score_ids(lhs, lhs_b, tails)  # (B, 1)
    num = torch.sum(weights[:, None] * F.logsigmoid(pos))
    den = torch.sum(weights)
    n_t, d_t = negs(lhs, lhs_b, tails)
    num, den = num + n_t, den + d_t
    if double_neg:
        inv_lhs, inv_b = model.get_queries(_inverse_queries(batch, n_rel))
        n_h, d_h = negs(inv_lhs, inv_b, batch[:, 0:1])
        num, den = num + n_h, den + d_h
    return -num / den, factors


def neg_sampling_loss_shared(model, batch, weights, generator, n_entities: int,
                             k: int, double_neg: bool, n_rel: int, draw=uniform_ids):
    """Negative sampling with ONE shared (K,) negative set a batch (and a
    second one for the heads under double_neg), scored as the all-pairs
    (B, D) x (D, K) form.  A negative equal to a query's gold is left out
    of the mean.  `draw(generator, high, shape, device)` draws the ids."""
    w = weights[:, None]

    def shared_negs(lhs, lhs_b, gold):
        neg_ids = draw(generator, n_entities, (k,), batch.device)
        s = model.sim(lhs, model.entity[neg_ids], all_pairs=True)  # (B, K)
        s = model._apply_bias(s, lhs_b, model.bt[neg_ids], all_pairs=True)
        keep = w * (neg_ids[None, :] != gold)  # gold-tail collisions out
        return torch.sum(keep * F.logsigmoid(-s)), torch.sum(keep)

    return _candidate_set_loss(model, batch, weights, double_neg, n_rel, shared_negs)


def neg_sampling_loss_pooled(model, batch, weights, generator, n_entities: int,
                             k: int, double_neg: bool, n_rel: int, pool_size: int,
                             draw=uniform_ids):
    """Per-query negatives scored through a per-step candidate pool: P
    i.i.d.-uniform entity ids, scored as one (B, D) x (D, P) all-pairs
    block; each query's K negatives are a contiguous window (mod P) of pool
    slots from a uniform offset, taken by a mask on the (B, P) scores.
    Negatives equal to the gold are left out of the mean.  Requires
    k <= pool_size.  `draw(generator, high, shape, device)` draws the pool,
    then the tail offsets, then (double_neg) the head offsets."""
    if k > pool_size:
        raise ValueError(f"neg_sample_size {k} > neg_pool_size {pool_size}")
    w = weights[:, None]
    pool = draw(generator, n_entities, (pool_size,), batch.device)
    pool_rows, pool_bt = model.entity[pool], model.bt[pool]
    j = torch.arange(pool_size, device=batch.device)[None, :]

    def pooled_negs(lhs, lhs_b, gold):
        s = model.sim(lhs, pool_rows, all_pairs=True)  # (B, P)
        s = model._apply_bias(s, lhs_b, pool_bt, all_pairs=True)
        off = draw(generator, pool_size, (gold.shape[0], 1), batch.device)
        in_win = torch.remainder(j - off, pool_size) < k  # (B, P) window mask
        keep = w * in_win * (pool[None, :] != gold)
        return torch.sum(keep * F.logsigmoid(-s)), torch.sum(keep)

    return _candidate_set_loss(model, batch, weights, double_neg, n_rel, pooled_negs)


def cross_entropy_loss(model, batch, weights, smoothing: float | None,
                       n_entities: int | None = None):
    """All-entity CE with torch-style label smoothing eps:
    loss_i = (1 - eps)(-log p_t) + eps * mean_k(-log p_k), factored as
        lse_i - (1 - eps) * preds[i, t_i] - (eps / N) * sum_k preds[i, k]
    so no (B, N) log-softmax is formed: a logsumexp, a (B, 1) gold gather
    and (eps > 0) a row sum."""
    queries, tails = batch[:, :2], batch[:, 2]
    preds = model.score_all(queries)  # (B, N), or (B, Np) padded
    factors = model.get_factors(queries, None)
    valid = _pad_col_mask(preds, n_entities)
    masked = preds if valid is None else torch.where(valid, preds, -1e30)
    lse = torch.logsumexp(masked, dim=-1)  # pad columns carry no mass
    gold = torch.gather(preds, 1, tails[:, None])[:, 0]
    eps = 0.0 if smoothing is None else smoothing
    if eps:
        n = preds.shape[-1] if valid is None else n_entities
        real = preds if valid is None else torch.where(valid, preds, 0.0)
        nll = lse - (1 - eps) * gold - eps * (torch.sum(real, dim=-1) / n)
    else:
        nll = lse - gold
    return torch.sum(weights * nll) / torch.sum(weights), factors


def dense_labels(label_idx, n_entities: int, dtype):
    """Padded true-tail lists (B, L) -> multi-hot (B, N); the pad value
    n_entities is dropped.  The explicit unpadded-width form (bce_loss
    builds its own multi-hot over the scores' width)."""
    b = label_idx.shape[0]
    lab = torch.zeros((b, n_entities + 1), dtype=dtype, device=label_idx.device)
    lab.scatter_(1, label_idx.long(), 1.0)
    return lab[:, :n_entities]


def bce_loss(model, batch, weights, label_idx, n_entities: int, smoothing: float | None):
    """BCE(sigmoid(preds), smoothed multi-hot labels) in log space, each
    log term clamped at -100 as torch.nn.BCELoss does.  The multi-hot is
    built over the scores' (possibly padded) width by an amax scatter of
    1 at real labels and 0 at pads, so pads and duplicate labels are
    no-ops; logsig(-x) = logsig(x) - x gives both log terms from one
    softplus pass."""
    queries = batch[:, :2]
    preds = model.score_all(queries)  # (B, N), or (B, Np) padded
    factors = model.get_factors(queries, None)
    valid = _pad_col_mask(preds, n_entities)
    eps = 0.0 if smoothing is None else smoothing
    label_idx = label_idx.long()
    lab_ok = (label_idx < n_entities).to(preds.dtype)
    idx = torch.clamp_max(label_idx, preds.shape[-1] - 1)
    y = torch.zeros_like(preds).scatter_reduce_(1, idx, lab_ok, "amax")
    y = (1.0 - eps) * y + eps / n_entities
    ls = F.logsigmoid(preds)
    log_p = torch.clamp_min(ls, -100.0)
    log_1mp = torch.clamp_min(ls - preds, -100.0)
    per = -(y * log_p + (1.0 - y) * log_1mp)
    if valid is not None:
        per = torch.where(valid, per, 0.0)
    total = torch.sum(weights[:, None] * per)
    return total / (torch.sum(weights) * n_entities), factors


def signed_logsigmoid_ce_loss(model, batch, weights, n_entities: int | None = None):
    """The labelless binarycrossentropy branch: log_prob = logsig(-preds),
    plus logsig(p) - logsig(-p) at each row's gold; loss = -mean(log_prob).
    The (B, 1) gold bump is added to the row sums instead of scattered
    into a (B, N) copy."""
    queries, tails = batch[:, :2], batch[:, 2]
    preds = model.score_all(queries)
    factors = model.get_factors(queries, None)
    valid = _pad_col_mask(preds, n_entities)
    n = preds.shape[-1] if valid is None else n_entities
    log_prob = F.logsigmoid(-preds)
    if valid is not None:
        log_prob = torch.where(valid, log_prob, 0.0)
    gold = torch.gather(preds, 1, tails[:, None])
    bump = F.logsigmoid(gold) - F.logsigmoid(-gold)  # (B, 1)
    row_sum = torch.sum(log_prob, dim=-1, keepdim=True) + bump
    return -torch.sum(weights[:, None] * row_sum) / (torch.sum(weights) * n), factors
