"""Base module for KG embedding models.

Port of complexhyperbolickge_tpu/models/base.py.  A model is an nn.Module
whose parameters carry the JAX params-dict names (entity, rel, bh, bt,
rel_diag, c, ...), so `state_dict()` keys equal a checkpoint's keys and
params cross between the packages one to one (train/checkpoint.py).

Two scoring modes with distinct shapes:
  * score(queries (B, 2), tails (B, K)) -> (B, K)   [training shape]
  * score_all(queries (B, 2))           -> (B, N)   [ranking]
Bias handling: 'learn' adds bh[head] + bt[tail]; 'constant' adds gamma;
'none' adds nothing.  get_factors gives the regularizers their factors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch import nn

from complexhyperbolickge_torch.ops.math import pinned_mm

_DTYPES = {
    "float32": torch.float32,
    "float": torch.float32,
    "single": torch.float32,
    "float64": torch.float64,
    "double": torch.float64,
    "bfloat16": torch.bfloat16,
}


class NoMask:
    """A regularization factor that padded-batch weights must never zero.

    regularizers._masked_sum masks by shape alone (leading dim == batch
    size); the full entity table (the factor when tails is None) can have
    n_entities == batch size on a toy graph trained full-batch, and would
    then lose its rows at padded batch positions.  Wrapping it makes "do not
    mask" explicit."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    @property
    def shape(self):
        return self.value.shape


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model hyperparameters (the JAX ModelConfig, field for field).

    n_relations is the doubled relation count (with inverse relations).
    """

    n_entities: int
    n_relations: int
    rank: int
    init_size: float = 1e-3
    bias: str = "learn"  # learn | none | constant
    gamma: float = 0.0
    multi_c: bool = False
    dtype: str = "float32"
    dropout: float = 0.0  # accepted for config parity; the reference never applies it

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


class KGModel(nn.Module):
    """Base scorer.  Subclasses declare `extra_param_specs` and implement
    `get_queries` and `sim`."""

    _softplus_single_c = False  # FFT family: raw weight when not multi_c

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        for name, (shape, _) in sorted(self.param_specs().items()):
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=cfg.torch_dtype, device=device)))
        self.reset_parameters(generator)

    # ------------------------------ parameters ------------------------------

    @property
    def entity_dim(self) -> int:
        return self.cfg.rank

    @property
    def rel_dim(self) -> int:
        return self.cfg.rank

    def param_specs(self) -> Dict[str, Tuple[Tuple[int, ...], object]]:
        """name -> (shape, init) with init in {normal, uniform, zeros, ones}
        or ("normal", mean, std): normal = N(0, init_size), uniform =
        U(-1, 1)."""
        cfg = self.cfg
        specs = {
            "entity": ((cfg.n_entities, self.entity_dim), "normal"),
            "rel": ((cfg.n_relations, self.rel_dim), "normal"),
            "bh": ((cfg.n_entities, 1), "zeros"),
            "bt": ((cfg.n_entities, 1), "zeros"),
        }
        specs.update(self.extra_param_specs())
        return specs

    def extra_param_specs(self) -> Dict[str, Tuple[Tuple[int, ...], object]]:
        return {}

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Draw every parameter from its init kind.  Values are drawn on the
        CPU (from `generator`, a CPU torch.Generator) and copied over, so one
        seed gives the same weights on every device.  JAX's random bits
        differ: parity tests inject params instead.  init_post() runs last."""
        for name, (shape, kind) in sorted(self.param_specs().items()):
            if isinstance(kind, tuple):  # ("normal", mean, std)
                _, mean, std = kind
                v = torch.randn(shape, generator=generator) * std + mean
            elif kind == "normal":
                v = torch.randn(shape, generator=generator) * self.cfg.init_size
            elif kind == "uniform":
                v = torch.rand(shape, generator=generator) * 2.0 - 1.0
            elif kind == "zeros":
                v = torch.zeros(shape)
            elif kind == "ones":
                v = torch.ones(shape)
            else:
                raise ValueError(f"unknown init kind {kind}")
            getattr(self, name).copy_(v)
        self.init_post()

    def init_post(self):
        """Hook for model-specific init adjustments (e.g. ones in a slice),
        applied in place after the draws."""

    # ------------------------------ curvature -------------------------------

    def curvature(self, r):
        """Per-query curvature, (B, 1) with multi_c and (1, 1) otherwise.
        With multi_c the softplus runs over the whole (n_relations, 1) table
        before the gather, so a relation's curvature has the same bits in
        every batch (CPU kernels round by position in a vectorized loop), and
        curvature(arange(n_relations)) indexes to it exactly."""
        if self.cfg.multi_c:
            return _softplus(self.c)[r]
        c0 = self.c[0][None, :]
        if self._softplus_single_c:
            c0 = _softplus(c0)
        return c0

    # ------------------------------- scoring --------------------------------

    def get_queries(self, queries):
        """queries (B, 2) [head, rel] -> (lhs_pack, lhs_bias (B, 1)); the
        first element of lhs_pack is (B, D)."""
        raise NotImplementedError

    def get_rhs(self, tails=None):
        """tails (B, K) -> ((B, K, D), (B, K, 1)); None -> ((N, D), (N, 1))."""
        if tails is None:
            return self.entity, self.bt
        return self.entity[tails], self.bt[tails]

    def sim(self, lhs_pack, rhs_e, all_pairs: bool):
        """Similarity scores: (B, K) when all_pairs=False, else (B, N)."""
        raise NotImplementedError

    def _apply_bias(self, s, lhs_bias, rhs_bias, all_pairs: bool):
        if self.cfg.bias == "learn":
            rb = rhs_bias[None, :, 0] if all_pairs else rhs_bias[..., 0]
            return lhs_bias + rb + s
        if self.cfg.bias == "constant":
            return s + self.cfg.gamma
        return s

    def score_ids(self, lhs_pack, lhs_bias, ids):
        """Scores of get_queries' (lhs_pack, lhs_bias) against the candidate
        tails ids (B, K) -> (B, K): the training losses' hook.  Gathers the
        candidate rows and runs sim; a model may score the ids without the
        gather (FFTUnitBall)."""
        rhs_e, rhs_b = self.get_rhs(ids)
        s = self.sim(lhs_pack, rhs_e, all_pairs=False)
        return self._apply_bias(s, lhs_bias, rhs_b, all_pairs=False)

    def score(self, queries, tails):
        """Scores of (B,) queries against (B, K) candidate tails -> (B, K)."""
        return self.score_ids(*self.get_queries(queries), tails)

    def score_all(self, queries):
        """Scores of (B,) queries against all N entities -> (B, N)."""
        lhs, lhs_b = self.get_queries(queries)
        rhs_e, rhs_b = self.get_rhs(None)
        s = self.sim(lhs, rhs_e, all_pairs=True)
        return self._apply_bias(s, lhs_b, rhs_b, all_pairs=True)

    # ----------------------------- regularization ---------------------------

    def get_factors(self, queries, tails=None):
        """Embedding factors for the N3/F2/L2 regularizers: the raw head,
        rel and tail rows; when tails is None the whole entity table, as a
        NoMask, is the third factor."""
        head_e = self.entity[queries[..., 0]]
        rel_e = self.rel[queries[..., 1]]
        if tails is None:
            return head_e, rel_e, NoMask(self.entity)
        return head_e, rel_e, self.entity[tails]

    def forward(self, queries, tails=None):
        return self.score_all(queries) if tails is None else self.score(queries, tails)


def _softplus(x):
    """log(1 + e^x) as jax.nn.softplus computes it (logaddexp(x, 0));
    torch's F.softplus switches to the identity above x = 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ----------------------------- shared primitives -----------------------------


def dot_train(x, y):
    """(B, d) or (B, 1, d) vs (B, K, d) -> (B, K) inner products."""
    if x.dim() == 2:
        x = x[:, None, :]
    return torch.sum(x * y, dim=-1)


def dot_all(x, y):
    """(B, d) vs (N, d) -> (B, N) inner products as one matmul."""
    return pinned_mm(x, y.T)


def neg_sq_dist(lhs, rhs_e, all_pairs: bool):
    """-(|x|^2 + |y|^2 - 2 <x, y>): the 'dist' similarity of CompGCN's transe
    decoder (and of BaseE, not ported yet)."""
    x2 = torch.sum(lhs * lhs, dim=-1, keepdim=True)  # (B, 1)
    if all_pairs:
        y2 = torch.sum(rhs_e * rhs_e, dim=-1)[None, :]  # (1, N)
        return -(x2 + y2 - 2 * dot_all(lhs, rhs_e))
    y2 = torch.sum(rhs_e * rhs_e, dim=-1)  # (B, K)
    return -(x2 + y2 - 2 * dot_train(lhs, rhs_e))
