"""The plain reference of the training and ranking protocol that every
configuration shares (KGEmb's, which the paper's code inherits):
per-query negative sampling with the logsigmoid loss and double_neg,
Adam, the epoch feed, and filtered ranks with their metrics.

Plain PyTorch and NumPy.  Nothing here imports the program; the model
arithmetic comes from the configuration's own reference module
(`reference/<config>.py`), which exports PARAMS, INIT, queries,
score_ids and score_all.  `Arith` says in which precision the reference
computes: float64 (the reference), or "tf32", float32 whose every
contraction takes TF32's 10-bit operands (the control).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

MIN_NORM = 1e-15


# --------------------------------- precision ----------------------------------


def round_tf32(x):
    """float32 x rounded to nearest (ties to even) at TF32's 10 mantissa
    bits (no gradient)."""
    bits = x.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


class _TF32MM(torch.autograd.Function):
    """a @ b with both operands rounded to TF32 and float32 sums; the
    backward's products round their operands alike."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ra, rb)
        ctx.shapes = (a.shape, b.shape)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = round_tf32(g)
        ga = (rg @ rb.transpose(-1, -2)).sum_to_size(ctx.shapes[0])
        gb = (ra.transpose(-1, -2) @ rg).sum_to_size(ctx.shapes[1])
        return ga, gb


@dataclasses.dataclass
class Arith:
    """The reference's precision, for every contraction (matrix product
    and dot product over the feature axis): mode "float64", or "tf32":
    float32 whose contractions take their operands rounded to TF32's 10
    mantissa bits and sum in float32 (the tensor cores' TF32 products),
    the same on every device."""

    mode: str = "float64"

    @property
    def dtype(self):
        return torch.float64 if self.mode == "float64" else torch.float32

    def mm(self, a, b):
        """The contraction a @ b (batched as torch.matmul)."""
        return a @ b if self.mode == "float64" else _TF32MM.apply(a, b)

    def dot(self, a, b):
        """sum(a * b) over the last axis, kept as a size-1 axis."""
        if self.mode != "float64":
            a = a + (round_tf32(a) - a).detach()
            b = b + (round_tf32(b) - b).detach()
        return torch.sum(a * b, dim=-1, keepdim=True)


F64 = Arith("float64")


def safe_norm(x, ar: Arith = F64):
    """|x| over the last axis with the squared norm clamped at MIN_NORM^2."""
    return torch.sqrt(ar.dot(x, x).clamp_min(MIN_NORM * MIN_NORM))


def tanh(x):
    return torch.tanh(x.clamp(-15, 15))


class Artanh(torch.autograd.Function):
    """artanh with its input clamped to +-(1 - 1e-5); the gradient at the
    clamped input, as the paper's code defines it."""

    @staticmethod
    def forward(ctx, x):
        xc = x.clamp(-1 + 1e-5, 1 - 1e-5)
        ctx.save_for_backward(xc)
        return 0.5 * (torch.log1p(xc) - torch.log1p(-xc))

    @staticmethod
    def backward(ctx, g):
        (xc,) = ctx.saved_tensors
        return g / (1 - xc ** 2)


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def givens_rotations(r, x):
    """Block-diagonal 2 x 2 rotations by the normalized (cos, sin) pairs
    of r, applied to the pairs of x."""
    g = r.reshape(*r.shape[:-1], -1, 2)
    g = g / torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True).clamp_min(1.1754944e-38))
    xp = x.reshape(*x.shape[:-1], -1, 2)
    cos, sin = g[..., 0], g[..., 1]
    y0 = cos * xp[..., 0] - sin * xp[..., 1]
    y1 = sin * xp[..., 0] + cos * xp[..., 1]
    return torch.stack([y0, y1], dim=-1).reshape(x.shape)


def mobius_add(x, y, c, ar: Arith = F64):
    x2, y2, xy = ar.dot(x, x), ar.dot(y, y), ar.dot(x, y)
    num = (1 + 2 * c * xy + c * y2) * x + (1 - c * x2) * y
    denom = 1 + 2 * c * xy + c ** 2 * x2 * y2
    return num / denom.clamp_min(MIN_NORM)


# ------------------------------- epoch and feed --------------------------------


def train_examples(train: np.ndarray, n_rel2: int) -> np.ndarray:
    """The train triples and their inverses (t, r + n_rel, h)."""
    inv = train[:, [2, 1, 0]].copy()
    inv[:, 1] += n_rel2 // 2
    return np.concatenate([train, inv], axis=0)


def epoch_rows(examples: np.ndarray, seed: int, epoch: int) -> np.ndarray:
    """The rows of epoch `epoch` in the order it steps them: a permutation
    drawn from numpy's generator of [seed, epoch]."""
    return examples[np.random.default_rng([seed, epoch]).permutation(len(examples))]


def generator(seed: int, stream: int, device) -> torch.Generator:
    """The generator of an epoch's negatives: torch's generator on
    `device` seeded from numpy's seed sequence of [seed, stream]."""
    state = np.random.SeedSequence([seed, stream]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def sample(gen, gold, n: int, k: int):
    """k uniform ids a row over the n entities other than the row's gold."""
    neg = torch.randint(0, n - 1, (gold.shape[0], k), generator=gen, device=gold.device)
    return torch.where(neg < gold[:, None], neg, neg + 1)


# ----------------------------------- training -----------------------------------


def neg_sampling_loss(ref, cfg, P, batch, gen, ar: Arith):
    """-mean of logsigmoid over each row's positive and its K negative
    tails, and under double_neg K negative heads scored through the
    inverse relation; rows all count (full batches)."""
    n, k, n_rel = cfg["n_entities"], cfg["neg_sample_size"], cfg["n_relations"]
    lhs, lb = ref.queries(P, batch[:, 0], batch[:, 1], cfg, ar)
    ids = torch.cat([batch[:, 2:3], sample(gen, batch[:, 2], n, k)], dim=1)
    s = ref.score_ids(P, lhs, lb, ids, cfg, ar)
    num = torch.sum(F.logsigmoid(s[:, :1])) + torch.sum(F.logsigmoid(-s[:, 1:]))
    den = batch.shape[0] * (1 + k)
    if cfg["double_neg"]:
        inv_r = (batch[:, 1] + n_rel // 2) % n_rel
        neg_h = sample(gen, batch[:, 0], n, k)
        lhs_h, lb_h = ref.queries(P, batch[:, 2], inv_r, cfg, ar)
        num = num + torch.sum(F.logsigmoid(-ref.score_ids(P, lhs_h, lb_h, neg_h, cfg, ar)))
        den = den + batch.shape[0] * k
    return -num / den


def train_steps(ref, cfg, params0: dict, batches, gen, ar: Arith, loss_fn=None):
    """Steps of the per-query negative-sampling loss and Adam (betas 0.9,
    0.999, eps 1e-8) from params0 over `batches` (a list of (B, 3) int64
    tensors), negatives drawn from gen.  Returns (losses, the first step's
    gradients, the params after the last step), all detached, in the
    reference's precision."""
    loss_fn = loss_fn or neg_sampling_loss
    names = sorted(params0)
    P = {k: params0[k].detach().to(ar.dtype).clone().requires_grad_() for k in names}
    m = {k: torch.zeros_like(P[k]) for k in names}
    v = {k: torch.zeros_like(P[k]) for k in names}
    lr, b1, b2, eps = cfg["learning_rate"], 0.9, 0.999, 1e-8
    losses, first = [], None
    for t, batch in enumerate(batches, start=1):
        loss = loss_fn(ref, cfg, P, batch, gen, ar)
        grads = torch.autograd.grad(loss, [P[k] for k in names])
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(names, grads)}
        with torch.no_grad():
            for k, g in zip(names, grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m[k] / (1 - b1 ** t)
                v_hat = v[k] / (1 - b2 ** t)
                P[k].sub_(lr * m_hat / (torch.sqrt(v_hat) + eps))
    return losses, first, {k: P[k].detach() for k in names}


def leaf_norms(tensors: dict) -> dict:
    """name -> the float64 norm of each tensor."""
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


def norm_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the reference's
    (dicts of norms), over the larger of that leaf's reference norm and the
    median leaf's; `keep` names the leaves compared (default all)."""
    med = float(np.median(list(ref.values())))
    names = sorted(ref) if keep is None else sorted(keep)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in names)


def moved_leaves(grad_norms: dict, rel: float = 1e-3) -> list:
    """The leaves whose reference gradient norm reaches `rel` of the
    median leaf's: the others move under Adam by round-off alone."""
    med = float(np.median(list(grad_norms.values())))
    return [k for k, x in grad_norms.items() if x >= rel * med]


# ----------------------------------- ranking -----------------------------------


def eval_queries(test: np.ndarray, n_rel2: int, direction: str) -> np.ndarray:
    """(n, 3) queries (head, rel, gold): rhs ranks tails of (h, r, ?), lhs
    heads through the inverse relation, (t, r + n_rel, h)."""
    if direction == "rhs":
        return test.astype(np.int64)
    return np.stack([test[:, 2], test[:, 1] + n_rel2 // 2, test[:, 0]], axis=1)


def filter_lists(splits: dict, queries: np.ndarray, n_rel2: int, n: int) -> np.ndarray:
    """Per query the ids of every true answer of its (head, rel) in any
    split, the gold among them, padded with n: (n_queries, L) int64."""
    allx = np.concatenate([splits[s] for s in ("train", "valid", "test")], axis=0)
    half = n_rel2 // 2
    keys = np.concatenate([allx[:, 0] * n_rel2 + allx[:, 1],
                           allx[:, 2] * n_rel2 + allx[:, 1] + half])
    vals = np.concatenate([allx[:, 2], allx[:, 0]])
    kv = np.unique(np.stack([keys, vals], axis=1), axis=0)
    qk = queries[:, 0] * n_rel2 + queries[:, 1]
    lo = np.searchsorted(kv[:, 0], qk, side="left")
    hi = np.searchsorted(kv[:, 0], qk, side="right")
    width = int((hi - lo).max())
    cols = np.arange(width)
    take = np.minimum(lo[:, None] + cols[None, :], len(kv) - 1)
    return np.where(cols[None, :] < (hi - lo)[:, None], kv[take, 1], n).astype(np.int64)


def filtered_ranks(scores, gold, fidx):
    """1 + the entities not in a query's filter row (the gold among them)
    whose score reaches the gold's: scores (B, N), gold (B,), fidx (B, L)
    padded with N."""
    n = scores.shape[1]
    t = torch.gather(scores, 1, gold[:, None])
    keep = torch.ones((scores.shape[0], n + 1), dtype=torch.bool, device=scores.device)
    keep.scatter_(1, fidx, False)
    return 1 + torch.sum((scores >= t) & keep[:, :n], dim=1)


def rank_gaps(scores, gold, fidx, port_ranks):
    """For a block of queries: the reference's filtered ranks and, for each
    row of port_ranks (P, B), the gap by which the program's rank lies off
    them, in score units over 1 + |gold score|: 0 where the ranks agree;
    where the program counts c entities and the reference more (fewer),
    how far above (below) the gold score the (c + 1)-th (c-th) best
    unfiltered reference score lies; inf for a rank that is no count.
    scores (B, N) float64; gold (B,); fidx (B, L) padded with N."""
    b, n = scores.shape
    t = torch.gather(scores, 1, gold[:, None])[:, 0]
    keep = torch.ones((b, n + 1), dtype=torch.bool, device=scores.device)
    keep.scatter_(1, fidx, False)
    masked = torch.where(keep[:, :n], scores, torch.full_like(scores, -torch.inf))
    c_ref = torch.sum(masked >= t[:, None], dim=1)
    desc = torch.sort(masked, dim=1, descending=True).values
    gaps = []
    for r in port_ranks.to(torch.float64):
        ok = torch.isfinite(r) & (r == torch.round(r)) & (r >= 1) & (r <= n)
        c = torch.where(ok, r - 1, torch.zeros_like(r)).long()
        above = torch.gather(desc, 1, (c - 1).clamp(0, n - 1)[:, None])[:, 0]  # c-th best
        below = torch.gather(desc, 1, c.clamp(0, n - 1)[:, None])[:, 0]  # (c + 1)-th best
        gap = torch.where(c > c_ref, t - above,
                          torch.where(c < c_ref, below - t, torch.zeros_like(t)))
        gap = gap.abs() / (1 + t.abs())
        gaps.append(torch.where(ok, gap, torch.full_like(gap, torch.inf)))
    return (1 + c_ref).to(torch.float64), torch.stack(gaps)


def direction_metrics(ranks: np.ndarray) -> dict:
    """MR, MRR and hits@1, 3, 10 of one direction's ranks."""
    ranks = np.asarray(ranks, dtype=np.float64)
    return {"MR": float(np.mean(ranks)), "MRR": float(np.mean(1.0 / ranks)),
            "hits@[1,3,10]": [float(np.mean(ranks <= k)) for k in (1, 3, 10)]}
