"""Complex-space KG embedding models: ComplEx, RotatE, Fourier.

Port of complexhyperbolickge_tpu/models/complexm.py.  `rank` is the real
storage width; the complex dimension is rank // 2, stored packed [Re | Im].
"""

from __future__ import annotations

import torch

from complexhyperbolickge_torch.models.base import KGModel, NoMask, dot_all, dot_train
from complexhyperbolickge_torch.ops.fft import irfft_packed, rfft_packed
from complexhyperbolickge_torch.ops.math import safe_sqrt

COMPLEX_MODELS = ["ComplEx", "RotatE", "Fourier"]


class BaseC(KGModel):
    """Hermitian dot-product scorer over packed [Re | Im] embeddings:
    sum Re(lhs) Re(rhs) + Im(lhs) Im(rhs), which on the packed layout is a
    plain inner product (one matmul in all-pairs mode)."""

    def __init__(self, cfg, device=None, generator=None):
        if cfg.rank % 2 != 0:
            raise ValueError(f"Complex models require even embedding dimension, got {cfg.rank}")
        self.half = cfg.rank // 2
        super().__init__(cfg, device=device, generator=generator)

    def sim(self, lhs_pack, rhs_e, all_pairs: bool):
        (lhs_e,) = lhs_pack
        return dot_all(lhs_e, rhs_e) if all_pairs else dot_train(lhs_e, rhs_e)

    def _split(self, v):
        return v[..., :self.half], v[..., self.half:]

    def _rel_half(self):
        return self.half

    def get_factors(self, queries, tails=None):
        """Complex magnitudes as regularization factors.  As in the
        reference (and JAX), `tails` is ignored: the third factor is the
        magnitudes of the FULL entity table, even under negative sampling,
        wrapped in NoMask (it is not a batch).  safe_sqrt keeps the
        gradient finite at exactly zero rows."""
        head_e = self.entity[queries[..., 0]]
        rel_e = self.rel[queries[..., 1]]
        out = []
        for f, half in ((head_e, self.half), (rel_e, self._rel_half()),
                        (self.entity, self.half)):
            re, im = f[..., :half], f[..., half:]
            out.append(safe_sqrt(re**2 + im**2))
        return out[0], out[1], NoMask(out[2])

    def _finish(self, queries, lhs_e):
        return (lhs_e,), self.bh[queries[..., 0]]


class ComplEx(BaseC):
    """Complex bilinear product."""

    def get_queries(self, queries):
        hr, hi = self._split(self.entity[queries[..., 0]])
        rr, ri = self._split(self.rel[queries[..., 1]])
        lhs_e = torch.cat([hr * rr - hi * ri, hr * ri + hi * rr], dim=-1)
        return self._finish(queries, lhs_e)


class RotatE(BaseC):
    """Unit-modulus complex rotations."""

    def get_queries(self, queries):
        hr, hi = self._split(self.entity[queries[..., 0]])
        rr, ri = self._split(self.rel[queries[..., 1]])
        rel_norm = torch.sqrt(rr**2 + ri**2)
        cos, sin = rr / rel_norm, ri / rel_norm
        lhs_e = torch.cat([hr * cos - hi * sin, hr * sin + hi * cos], dim=-1)
        return self._finish(queries, lhs_e)


class Fourier(BaseC):
    """irfft -> per-coordinate high/low-pass min/max -> rfft.  The
    reference's asymmetric FFT lengths are kept: irfft with n = dim =
    2 (half - 1), rfft with n = 2 half - 1."""

    def __init__(self, cfg, device=None, generator=None):
        self.dim = 2 * (cfg.rank // 2 - 1)
        super().__init__(cfg, device=device, generator=generator)

    @property
    def rel_dim(self):
        return 2 * self.dim

    def _rel_half(self):
        return self.dim

    @torch.no_grad()
    def init_post(self):
        # shift the high-pass up and the low-pass down
        shift = 3 * self.cfg.init_size
        self.rel[..., :self.dim] += shift
        self.rel[..., self.dim:] -= shift

    def get_queries(self, queries):
        head = self.entity[queries[..., 0]]  # packed (B, 2 half)
        rel = self.rel[queries[..., 1]]
        hpf, lpf = rel[..., :self.dim], rel[..., self.dim:]
        x = irfft_packed(head, n=self.dim)
        res = 0.5 * (torch.minimum(x, hpf) + torch.maximum(x, lpf))
        lhs_e = rfft_packed(res, n=2 * self.half - 1)
        return self._finish(queries, lhs_e)
