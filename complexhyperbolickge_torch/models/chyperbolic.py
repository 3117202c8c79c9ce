"""Complex-hyperbolic FFT KG embedding models (the paper's core family).

Port of complexhyperbolickge_tpu/models/chyperbolic.py.  Entity embeddings
are complex frequency-space vectors stored packed as [Re | Im] (2*rank
reals).  get_queries round-trips through real coordinate space with an
orthonormal inverse rFFT (dim = 2*(rank-1)), applies a relation-specific
hyperbolic isometry there, and maps back with rFFT.  The score is minus the
squared complex-hyperbolic distance with the implicit PU(n,1) lift.
"""

from __future__ import annotations

import torch

from complexhyperbolickge_torch.kernels import chyp_queries as CQ
from complexhyperbolickge_torch.kernels import chyp_train as CT
from complexhyperbolickge_torch.models.base import KGModel
from complexhyperbolickge_torch.ops import chyperbolic as CH
from complexhyperbolickge_torch.ops.euclidean import (
    givens_reflection,
    givens_rotations,
    givens_unitary,
)
from complexhyperbolickge_torch.ops.fft import irfft_packed, rfft_packed

CHYP_MODELS = ["FFTRotH", "FFTRefH", "FFTAttH", "FFTIsoH"]


class FFTUnitBall(KGModel):
    """Base for the FFT family.

    rank = complex dimension + 1; real coordinate dim = 2*(rank-1).
    entity (N, 2*rank) packed complex; rel (nR, 2*dim); rel_diag (nR, dim).
    """

    def __init__(self, cfg, device=None, generator=None):
        self.dim = 2 * (cfg.rank - 1)
        super().__init__(cfg, device=device, generator=generator)

    @property
    def entity_dim(self):
        return 2 * self.cfg.rank

    @property
    def rel_dim(self):
        return 2 * self.dim

    def extra_param_specs(self):
        nr = self.cfg.n_relations
        return {
            "rel_diag": ((nr, self.dim), "uniform"),
            "c": ((nr if self.cfg.multi_c else 1, 1), "ones"),
        }

    def sim(self, lhs_pack, rhs_e, all_pairs: bool):
        (lhs_e,) = lhs_pack
        if all_pairs:
            return -CH.chyp_distance_all(lhs_e, rhs_e) ** 2
        return -CH.chyp_distance(lhs_e[:, None, :], rhs_e) ** 2

    def score_ids(self, lhs_pack, lhs_bias, ids):
        """A float32 pair on the card scores the entity rows ids through
        K3/K4 without gathering them (kernels/chyp_train.py); any other
        pair (CPU, float64, bfloat16) scores the gathered rows."""
        (lhs_e,) = lhs_pack
        if not CH.use_train_kernel(lhs_e, self.entity):
            return super().score_ids(lhs_pack, lhs_bias, ids)
        s = -CT.chyp_train_distance_ids(lhs_e, self.entity, ids) ** 2
        return self._apply_bias(s, lhs_bias, self.bt[ids], all_pairs=False)


class FFTRotH(FFTUnitBall):
    """Givens rotations in coordinate space.  On float32 tables on the card
    (kernels/chyp_queries.py::use_kernel) the chain is one CUDA forward
    and one backward; any other tables (CPU, float64, bfloat16) run it
    eagerly."""

    def get_queries(self, queries):
        tables = (self.entity, self.rel, self.rel_diag, self.c, self.bh)
        if queries.dim() == 2 and CQ.use_kernel(*tables):
            return CQ.fftroth_queries(*tables, queries, self.cfg.multi_c)
        h, r = queries[..., 0], queries[..., 1]
        c = self.curvature(r)
        head = irfft_packed(self.entity[h])  # (B, dim) real
        head = CH.expmap0(head, c)
        rel1, rel2 = torch.chunk(self.rel[r], 2, dim=-1)
        rel1 = CH.expmap0(rel1, c)
        rel2 = CH.expmap0(rel2, c)
        lhs = CH.project(CH.real_mobius_add(head, rel1, c), c)
        res1 = givens_rotations(self.rel_diag[r], lhs)
        res2 = CH.real_mobius_add(res1, rel2, c)
        res = rfft_packed(res2)  # (B, 2*rank) packed
        return (res,), self.bh[h]


class FFTRefH(FFTUnitBall):
    """Givens reflections applied in Euclidean space before expmap0."""

    def get_queries(self, queries):
        h, r = queries[..., 0], queries[..., 1]
        c = self.curvature(r)
        rel = torch.chunk(self.rel[r], 2, dim=-1)[0]
        rel = CH.expmap0(rel, c)
        head = irfft_packed(self.entity[h])
        lhs = givens_reflection(self.rel_diag[r], head)
        lhs = CH.expmap0(lhs, c)
        res = CH.project(CH.real_mobius_add(lhs, rel, c), c)
        return (rfft_packed(res),), self.bh[h]


class FFTAttH(FFTUnitBall):
    """Attention over {reflection, rotation} candidates."""

    def extra_param_specs(self):
        nr = self.cfg.n_relations
        specs = super().extra_param_specs()
        specs["rel_diag"] = ((nr, 2 * self.dim), "uniform")
        specs["context_vec"] = ((nr, self.dim), "normal")
        return specs

    def get_queries(self, queries):
        h, r = queries[..., 0], queries[..., 1]
        c = self.curvature(r)
        head = irfft_packed(self.entity[h])
        rot_mat, ref_mat = torch.chunk(self.rel_diag[r], 2, dim=-1)
        rot_q = givens_rotations(rot_mat, head)[..., None, :]
        ref_q = givens_reflection(ref_mat, head)[..., None, :]
        cands = torch.cat([ref_q, rot_q], dim=-2)  # (B, 2, dim)
        context_vec = self.context_vec[r][..., None, :]
        # scale = 1/sqrt(rank), rank the COMPLEX rank, computed in the
        # working dtype as the JAX model does
        scale = 1.0 / torch.sqrt(torch.tensor(float(self.cfg.rank),
                                              dtype=head.dtype,
                                              device=head.device))
        att = torch.sum(context_vec * cands * scale, dim=-1, keepdim=True)
        att = torch.softmax(att, dim=-2)
        att_q = torch.sum(att * cands, dim=-2)
        lhs = CH.expmap0(att_q, c)
        rel = torch.chunk(self.rel[r], 2, dim=-1)[0]
        rel = CH.expmap0(rel, c)
        res = CH.project(CH.real_mobius_add(lhs, rel, c), c)
        return (rfft_packed(res),), self.bh[h]


class FFTIsoH(FFTUnitBall):
    """PU(n,1)-isometry model: a unitary transform on the complex frequency
    vector BEFORE the irfft, one Mobius translation (rel is (nR, dim)), and
    rel_diag (nR, 3*rank) normal-initialized.  The reference computes
    expmap0 of the head and discards it; only the effective semantics are
    kept.  Needs an even rank (rank/2 complex pairs)."""

    def __init__(self, cfg, device=None, generator=None):
        if cfg.rank % 2 != 0:
            raise ValueError(f"FFTIsoH requires even rank, got {cfg.rank}")
        super().__init__(cfg, device=device, generator=generator)

    @property
    def rel_dim(self):
        return self.dim

    def extra_param_specs(self):
        nr = self.cfg.n_relations
        return {
            "rel_diag": ((nr, 3 * self.cfg.rank), "normal"),
            "c": ((nr if self.cfg.multi_c else 1, 1), "ones"),
        }

    def get_queries(self, queries):
        h, r = queries[..., 0], queries[..., 1]
        rank = self.cfg.rank
        c = self.curvature(r)
        rel = CH.expmap0(self.rel[r], c)
        head_p = self.entity[h]
        head = torch.complex(head_p[..., :rank], head_p[..., rank:])
        a, b, angles = torch.chunk(self.rel_diag[r], 3, dim=-1)
        head = givens_unitary(a, b, angles, head)
        head = torch.fft.irfft(head, norm="ortho").to(head_p.dtype)  # (B, dim)
        res = CH.project(CH.real_mobius_add(head, rel, c), c)
        return (rfft_packed(res),), self.bh[h]
