"""Training losses.

Port of complexhyperbolickge_tpu/train/losses.py, per-query negative
sampling first: the shifted-randint sampler (uniform over the entities that
are not the gold tail) and the logsigmoid loss over the positive and the K
negatives of every query.  `weights` (B,) masks the padded rows of the
static-shape batch (data/dataset.py::epoch_batches).

double_neg corrupts the head of (h, r, t) by scoring the query
(t, (r + n_rel/2) % n_rel), the inverse relation, against sampled head
candidates: the same cost and model semantics as tail corruption.

The shared/pooled negative losses, the all-entity cross-entropy, BCE and
the signed-logsigmoid CE are ROADMAP Queue 1 item 10 and raise here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
        inv_q = torch.stack([batch[:, 2], (batch[:, 1] + n_rel // 2) % n_rel], dim=1)
        inv_batch = torch.stack([batch[:, 2], batch[:, 1], batch[:, 0]], dim=1)
        neg_h = sampler(generator, inv_batch, n_entities, k)
        neg_hs = model.score(inv_q, neg_h)
        num = num + torch.sum(w * F.logsigmoid(-neg_hs))
        den = den + torch.sum(weights) * k
    return -num / den, factors


def _not_ported(name: str):
    def loss(*args, **kwargs):
        raise NotImplementedError(
            f"{name} has no PyTorch port yet (ROADMAP.md Queue 1 item 10); "
            "train with per-query negative sampling (--neg_sample_size > 0, "
            "--neg_mode per_query)")

    loss.__name__ = name
    return loss


neg_sampling_loss_shared = _not_ported("neg_sampling_loss_shared")
neg_sampling_loss_pooled = _not_ported("neg_sampling_loss_pooled")
cross_entropy_loss = _not_ported("cross_entropy_loss")
bce_loss = _not_ported("bce_loss")
signed_logsigmoid_ce_loss = _not_ported("signed_logsigmoid_ce_loss")
