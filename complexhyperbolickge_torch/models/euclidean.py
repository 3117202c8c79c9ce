"""Euclidean KG embedding models: TransE, CP, MurE, RotE, RefE, AttE.

Port of complexhyperbolickge_tpu/models/euclidean.py.  The reference's RefE
raises a NameError (its lhs is used before assignment); here, as in JAX,
RefE is the evident intent: a Givens reflection (the true involution of
ops/euclidean.py::givens_reflection) plus a translation.
"""

from __future__ import annotations

import torch

from complexhyperbolickge_torch.models.base import KGModel, dot_all, dot_train, neg_sq_dist
from complexhyperbolickge_torch.ops.euclidean import givens_reflection, givens_rotations

EUC_MODELS = ["TransE", "CP", "MurE", "RotE", "RefE", "AttE"]


class BaseE(KGModel):
    """sim = dot product ('dot') or negative squared distance ('dist')."""

    sim_kind = "dist"

    def sim(self, lhs_pack, rhs_e, all_pairs: bool):
        (lhs_e,) = lhs_pack
        if self.sim_kind == "dot":
            return dot_all(lhs_e, rhs_e) if all_pairs else dot_train(lhs_e, rhs_e)
        return neg_sq_dist(lhs_e, rhs_e, all_pairs)

    def _finish(self, queries, lhs_e):
        return (lhs_e,), self.bh[queries[..., 0]]


class TransE(BaseE):
    """Translations."""

    def get_queries(self, queries):
        lhs_e = self.entity[queries[..., 0]] + self.rel[queries[..., 1]]
        return self._finish(queries, lhs_e)


class CP(BaseE):
    """Canonical tensor decomposition."""

    sim_kind = "dot"

    def get_queries(self, queries):
        lhs_e = self.entity[queries[..., 0]] * self.rel[queries[..., 1]]
        return self._finish(queries, lhs_e)


class _RelDiag(BaseE):
    """A model with a (n_relations, rank) U(-1, 1) rel_diag table."""

    def extra_param_specs(self):
        return {"rel_diag": ((self.cfg.n_relations, self.cfg.rank), "uniform")}


class MurE(_RelDiag):
    """Diagonal scaling plus a translation."""

    def get_queries(self, queries):
        r = queries[..., 1]
        lhs_e = self.rel_diag[r] * self.entity[queries[..., 0]] + self.rel[r]
        return self._finish(queries, lhs_e)


class RotE(_RelDiag):
    """Givens rotations plus a translation."""

    def get_queries(self, queries):
        r = queries[..., 1]
        lhs_e = givens_rotations(self.rel_diag[r], self.entity[queries[..., 0]]) + self.rel[r]
        return self._finish(queries, lhs_e)


class RefE(_RelDiag):
    """Givens reflections plus a translation."""

    def get_queries(self, queries):
        r = queries[..., 1]
        lhs_e = givens_reflection(self.rel_diag[r], self.entity[queries[..., 0]]) + self.rel[r]
        return self._finish(queries, lhs_e)


class AttE(BaseE):
    """Attention over the {reflection, rotation} candidates, plus a
    translation."""

    def extra_param_specs(self):
        nr, r = self.cfg.n_relations, self.cfg.rank
        return {
            "ref": ((nr, r), "uniform"),
            "rot": ((nr, r), "uniform"),
            # the reference re-inits only rot and ref; context_vec keeps
            # nn.Embedding's N(0, 1), not init_size-scaled (unlike AttH)
            "context_vec": ((nr, r), ("normal", 0.0, 1.0)),
        }

    def get_queries(self, queries):
        head = self.entity[queries[..., 0]]
        r = queries[..., 1]
        ref_q = givens_reflection(self.ref[r], head)[..., None, :]
        rot_q = givens_rotations(self.rot[r], head)[..., None, :]
        cands = torch.cat([ref_q, rot_q], dim=-2)  # (B, 2, d)
        context = self.context_vec[r][..., None, :]
        scale = 1.0 / torch.sqrt(torch.tensor(float(self.cfg.rank), dtype=head.dtype,
                                              device=head.device))
        att = torch.softmax(torch.sum(context * cands * scale, dim=-1, keepdim=True), dim=-2)
        lhs_e = torch.sum(att * cands, dim=-2) + self.rel[r]
        return self._finish(queries, lhs_e)
