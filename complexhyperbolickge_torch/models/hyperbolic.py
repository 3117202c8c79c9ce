"""Real-hyperbolic KG embedding models (Poincare ball and Lorentz
hyperboloid).

Port of complexhyperbolickge_tpu/models/hyperbolic.py.  Eight models: RotH,
RefH and AttH (Chami et al. 2020), AttRH, IsoH, IFFTH, RotLH and HyboNet.

  * Training scores (B, 1, d) queries against (B, K, d) candidates in the
    broadcast form of the distances (eager autograd).
  * All-entity scores use the folded forms (`hyp_sim_expmap_all`,
    `lorentz_sim_expmap_all`): one (B, d) x (d, N) matmul and per-pair
    radius arithmetic, never expmap0 of the whole table per batch.
  * With multi_c off, the BaseH and BaseLorentz families softplus one shared
    curvature; IFFTH takes the raw weight, as the reference does.
"""

from __future__ import annotations

import torch

from complexhyperbolickge_torch.models.base import KGModel
from complexhyperbolickge_torch.ops import hyperbolic as H
from complexhyperbolickge_torch.ops.euclidean import (
    givens_reflection,
    givens_rotations,
    givens_unitary,
)
from complexhyperbolickge_torch.ops.fft import _fft_dtype
from complexhyperbolickge_torch.ops.math import mm_operands

HYP_MODELS = ["RotH", "RefH", "AttH", "AttRH", "IFFTH", "IsoH", "RotLH", "HyboNet"]


def _scale_pairs(x, scale2):
    """x[..., 0::2] *= s; x[..., 1::2] *= s for the pairs' scales s."""
    xp = x.reshape(*x.shape[:-1], -1, 2)
    return (xp * scale2[..., None]).reshape(x.shape)


class BaseH(KGModel):
    """Poincare-ball family base.  sim = -hyp_distance_multi_c(lhs,
    expmap0(rhs, c), c)^2: expmap0 maps the tail into the ball and the
    distance folds another expmap of its second argument (the reference's
    double tanh, kept)."""

    _softplus_single_c = True

    @property
    def rel_dim(self):
        return 2 * self.cfg.rank

    def extra_param_specs(self):
        nr = self.cfg.n_relations
        return {"rel_diag": ((nr, self.cfg.rank), "uniform"),
                "c": ((nr if self.cfg.multi_c else 1, 1), "ones")}

    def sim(self, lhs_pack, rhs_e, all_pairs: bool):
        lhs_e, c = lhs_pack
        if all_pairs:
            return -H.hyp_sim_expmap_all(lhs_e, rhs_e, c) ** 2
        c3 = c[:, :, None]  # (B, 1, 1)
        rhs_h = H.expmap0(rhs_e, c3)
        return -H.hyp_distance_multi_c(lhs_e[:, None, :], rhs_h, c3)[..., 0] ** 2


class RotH(BaseH):
    """Rotations, then Mobius translations."""

    def get_queries(self, queries):
        h, r = queries[..., 0], queries[..., 1]
        c = self.curvature(r)
        head = H.expmap0(self.entity[h], c)
        rel1, rel2 = torch.chunk(self.rel[r], 2, dim=-1)
        rel1 = H.expmap0(rel1, c)
        rel2 = H.expmap0(rel2, c)
        lhs = H.project(H.mobius_add(head, rel1, c), c)
        res1 = givens_rotations(self.rel_diag[r], lhs)
        res2 = H.mobius_add(res1, rel2, c)
        return (res2, c), self.bh[h]


class RefH(BaseH):
    """Reflections in tangent space, then a Mobius translation."""

    def get_queries(self, queries):
        h, r = queries[..., 0], queries[..., 1]
        c = self.curvature(r)
        rel = H.expmap0(torch.chunk(self.rel[r], 2, dim=-1)[0], c)
        lhs = H.expmap0(givens_reflection(self.rel_diag[r], self.entity[h]), c)
        res = H.project(H.mobius_add(lhs, rel, c), c)
        return (res, c), self.bh[h]


class AttH(BaseH):
    """Softmax attention over {reflection, rotation}."""

    def extra_param_specs(self):
        nr, rank = self.cfg.n_relations, self.cfg.rank
        specs = super().extra_param_specs()
        specs["rel_diag"] = ((nr, 2 * rank), "uniform")
        specs["context_vec"] = ((nr, rank), "normal")
        return specs

    def get_queries(self, queries):
        h, r = queries[..., 0], queries[..., 1]
        c = self.curvature(r)
        head = self.entity[h]
        rot_mat, ref_mat = torch.chunk(self.rel_diag[r], 2, dim=-1)
        rot_q = givens_rotations(rot_mat, head)[..., None, :]
        ref_q = givens_reflection(ref_mat, head)[..., None, :]
        cands = torch.cat([ref_q, rot_q], dim=-2)  # (B, 2, d)
        context_vec = self.context_vec[r][..., None, :]
        scale = 1.0 / torch.sqrt(torch.tensor(float(self.cfg.rank),
                                              dtype=head.dtype, device=head.device))
        att = torch.sum(context_vec * cands * scale, dim=-1, keepdim=True)
        att = torch.softmax(att, dim=-2)
        lhs = H.expmap0(torch.sum(att * cands, dim=-2), c)
        rel = H.expmap0(torch.chunk(self.rel[r], 2, dim=-1)[0], c)
        res = H.project(H.mobius_add(lhs, rel, c), c)
        return (res, c), self.bh[h]


class AttRH(BaseH):
    """Split rotation / reflection subspaces with learned 2-way weights.
    The reference scores the raw (not expmapped) tail halves, so each half
    is a single-fold distance (hyp_distance_multi_c), not BaseH's double
    fold: AttRH has its own fused ranker."""

    def extra_param_specs(self):
        nr, rank = self.cfg.n_relations, self.cfg.rank
        specs = super().extra_param_specs()
        specs["rel_diag"] = ((nr, rank), "uniform")
        specs["weights"] = ((nr, 2), "normal")
        return specs

    def get_queries(self, queries):
        h, r = queries[..., 0], queries[..., 1]
        c = self.curvature(r)
        head = H.expmap0(self.entity[h], c)
        head_rot, head_ref = torch.chunk(head, 2, dim=-1)
        rel_rot, rel_ref = torch.chunk(self.rel[r], 2, dim=-1)
        rd_rot, rd_ref = torch.chunk(self.rel_diag[r], 2, dim=-1)

        rel1, rel2 = torch.chunk(rel_rot, 2, dim=-1)
        rel1 = H.expmap0(rel1, c)
        rel2 = H.expmap0(rel2, c)
        lhs = H.project(H.mobius_add(head_rot, rel1, c), c)
        res_rot = H.mobius_add(givens_rotations(rd_rot, lhs), rel2, c)

        relr = H.expmap0(torch.chunk(rel_ref, 2, dim=-1)[0], c)
        lhs = H.expmap0(givens_reflection(rd_ref, head_ref), c)
        res_ref = H.project(H.mobius_add(lhs, relr, c), c)

        res2 = torch.cat([res_rot, res_ref], dim=-1)
        w = torch.softmax(self.weights[r], dim=-1)  # (B, 2)
        return (res2, c, w), self.bh[h]

    def sim(self, lhs_pack, rhs_e, all_pairs: bool):
        lhs_e, c, w = lhs_pack
        lhs_rot, lhs_ref = torch.chunk(lhs_e, 2, dim=-1)
        rhs_rot, rhs_ref = torch.chunk(rhs_e, 2, dim=-1)
        if all_pairs:
            d_rot = H.hyp_distance_multi_c_all(lhs_rot, rhs_rot, c)
            d_ref = H.hyp_distance_multi_c_all(lhs_ref, rhs_ref, c)
        else:
            c3 = c[:, :, None]
            d_rot = H.hyp_distance_multi_c(lhs_rot[:, None, :], rhs_rot, c3)[..., 0]
            d_ref = H.hyp_distance_multi_c(lhs_ref[:, None, :], rhs_ref, c3)[..., 0]
        return -w[:, 0:1] * d_rot**2 - w[:, 1:2] * d_ref**2


class IsoH(BaseH):
    """A rotation and per-block scaling between logmap0 and expmap0."""

    def extra_param_specs(self):
        specs = super().extra_param_specs()
        specs["rel_diag"] = ((self.cfg.n_relations, 2 * self.cfg.rank), "uniform")
        return specs

    def init_post(self):
        self.rel_diag[..., self.cfg.rank:] = 1.0  # the scaling half starts at 1

    def get_queries(self, queries):
        h, r = queries[..., 0], queries[..., 1]
        rank = self.cfg.rank
        c = self.curvature(r)
        head = H.expmap0(self.entity[h], c)
        rel1, rel2 = torch.chunk(self.rel[r], 2, dim=-1)
        rel1 = H.expmap0(rel1, c)
        rel2 = H.expmap0(rel2, c)
        lhs = H.project(H.mobius_add(head, rel1, c), c)
        rd = self.rel_diag[r]
        rot, scale = rd[..., :rank], rd[..., rank:]
        scale1, scale2 = torch.chunk(scale, 2, dim=-1)
        res1 = givens_rotations(rot, H.logmap0(lhs, c), scale=scale1)
        res1 = H.expmap0(_scale_pairs(res1, scale2), c)
        res2 = H.project(H.mobius_add(res1, rel2, c), c)
        return (res2, c), self.bh[h]


class IFFTH(BaseH):
    """rfft -> Givens unitary -> irfft inside the Poincare pipeline.  The
    rank must be even and n = rank//2 + 1 even: irfft of n bins returns
    2(n-1) = rank dims only for an even rank, and the unitary takes the n
    bins in pairs."""

    _softplus_single_c = False  # the reference softpluses only with multi_c

    def __init__(self, cfg, device=None, generator=None):
        self.n = cfg.rank // 2 + 1  # complex bins after the rfft
        if cfg.rank % 2 != 0 or self.n % 2 != 0:
            raise ValueError("IFFTH requires rank even and n = rank//2 + 1 even; "
                             f"got rank={cfg.rank}, n={self.n}")
        super().__init__(cfg, device=device, generator=generator)

    def extra_param_specs(self):
        specs = super().extra_param_specs()
        specs["rel_diag"] = ((self.cfg.n_relations, 3 * self.n), "uniform")
        return specs

    def get_queries(self, queries):
        h, r = queries[..., 0], queries[..., 1]
        c = self.curvature(r)
        head = H.expmap0(self.entity[h], c)
        rel1, rel2 = torch.chunk(self.rel[r], 2, dim=-1)
        rel1 = H.expmap0(rel1, c)
        rel2 = H.expmap0(rel2, c)
        head = H.project(H.mobius_add(head, rel1, c), c)
        # bf16 round-trips through f32 (torch.fft takes f32 and f64)
        head_f = torch.fft.rfft(head.to(_fft_dtype(head.dtype)), norm="ortho")
        a, b, angle = torch.chunk(self.rel_diag[r], 3, dim=-1)
        head_f = givens_unitary(a, b, angle, head_f)
        head = torch.fft.irfft(head_f, norm="ortho").to(head.dtype)  # (B, rank)
        res2 = H.project(H.mobius_add(head, rel2, c), c)
        return (res2, c), self.bh[h]


# ------------------------------ Lorentz family -------------------------------


class BaseLorentz(KGModel):
    """Hyperboloid family base: sim = -d_L(lhs, expmap0_lorentz(rhs, c))^2."""

    _softplus_single_c = True

    @property
    def rel_dim(self):
        return 2 * self.cfg.rank

    def extra_param_specs(self):
        nr = self.cfg.n_relations
        return {"rel_diag": ((nr, self.cfg.rank), "uniform"),
                "c": ((nr if self.cfg.multi_c else 1, 1), "ones")}

    def sim(self, lhs_pack, rhs_e, all_pairs: bool):
        lhs_e, c = lhs_pack
        if all_pairs:
            return -H.lorentz_sim_expmap_all(lhs_e, rhs_e, c) ** 2
        c3 = c[:, :, None]
        rhs_h = H.expmap0_lorentz(rhs_e, c3)
        return -H.hyp_distance_multi_c_lorentz(lhs_e[:, None, :], rhs_h, c3)[..., 0] ** 2


class RotLH(BaseLorentz):
    """Lorentz boosts and scaled rotations."""

    def extra_param_specs(self):
        specs = super().extra_param_specs()
        specs["rel_diag"] = ((self.cfg.n_relations, 2 * self.cfg.rank), "uniform")
        return specs

    def init_post(self):
        self.rel_diag[..., self.cfg.rank:] = 1.0

    def get_queries(self, queries):
        h, r = queries[..., 0], queries[..., 1]
        rank = self.cfg.rank
        c = self.curvature(r)
        head = H.expmap0_lorentz(self.entity[h], c)
        rel1, rel2 = torch.chunk(self.rel[r], 2, dim=-1)
        lhs = H.lorentz_boost(head, rel1, c)
        rd = self.rel_diag[r]
        rot, scale = rd[..., :rank], rd[..., rank:]
        scale1, scale2 = torch.chunk(scale, 2, dim=-1)
        res1 = givens_rotations(rot, H.logmap0_lorentz(lhs, c), scale=scale1)
        res1 = H.expmap0_lorentz(_scale_pairs(res1, scale2), c)
        res2 = H.lorentz_boost(res1, rel2, c)
        return (res2, c), self.bh[h]


class HyboNet(BaseLorentz):
    """A full (rank+1)^2 Lorentz linear transform per relation."""

    @property
    def rel_dim(self):
        return (self.cfg.rank + 1) ** 2

    def extra_param_specs(self):
        specs = super().extra_param_specs()
        # the reference's normal(mean=-1, std=1), last column set to 1 after
        specs["rel_diag"] = ((self.cfg.n_relations, self.cfg.rank + 2), ("normal", -1.0, 1.0))
        return specs

    def init_post(self):
        self.rel_diag[..., -1] = 1.0

    def _lorentz_linear(self, x, weight, scale, bias, c):
        """x (B, rank+1) through weight (B, rank+1, rank+1); `time` uses the
        product before the bias.  An exact fp32/fp64 einsum (TF32 is off
        package-wide); inside get_queries of a dense "default" ranking its
        operands are rounded to bfloat16, as JAX reads mm_precision() here."""
        x = torch.einsum("...i,...ji->...j", *mm_operands(x, weight))
        epsilon = (1.0 / c**0.5) + 0.1
        time = torch.sigmoid(x[..., 0:1]) * scale + epsilon
        x_narrow = (x + bias)[..., 1:]
        denom = torch.sqrt(torch.sum(x_narrow * x_narrow, dim=-1, keepdim=True)
                           / (time * time - 1))
        return x_narrow / denom

    def get_queries(self, queries):
        h, r = queries[..., 0], queries[..., 1]
        rank = self.cfg.rank
        c = self.curvature(r)
        head = H.expmap0_lorentz(self.entity[h], c)
        head0 = torch.sqrt(torch.sum(head**2, dim=-1, keepdim=True) + 1 / c)
        head = torch.cat([head0, head], dim=-1)
        rel_transform = self.rel[r].reshape(*r.shape, rank + 1, rank + 1)
        rel = self.rel_diag[r]
        rel_bias, rel_scale = rel[..., :-1], torch.abs(rel[..., -1:])
        res2 = self._lorentz_linear(head, rel_transform, rel_scale, rel_bias, c)
        return (res2, c), self.bh[h]
