"""Real-FFT helpers over the packed [Re | Im] layout.

Port of complexhyperbolickge_tpu/ops/fft.py (irfft_packed / rfft_packed).
The reference round-trips entity embeddings between complex frequency space
and real coordinate space with torch.fft.rfft/irfft(norm="ortho").  A
complex vector of R bins is stored as 2R reals [Re | Im]; the real length
defaults to n = 2(R - 1).
"""

from __future__ import annotations

import torch


def _fft_dtype(dtype):
    """FFTs run in f32 or f64; bf16 round-trips through f32 (as in JAX)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def irfft_packed(v, n: int | None = None):
    """Packed (..., 2R) [Re | Im] -> real (..., n); n defaults to 2(R-1)."""
    r = v.shape[-1] // 2
    ft = _fft_dtype(v.dtype)
    zc = torch.complex(v[..., :r].to(ft), v[..., r:].to(ft))
    if n is None:
        n = 2 * (r - 1)
    return torch.fft.irfft(zc, n=n, norm="ortho").to(v.dtype)


def rfft_packed(x, n: int | None = None):
    """Real (..., n) -> packed (..., 2*(n//2 + 1)) [Re | Im]."""
    z = torch.fft.rfft(x.to(_fft_dtype(x.dtype)), n=n, norm="ortho")
    return torch.cat([z.real, z.imag], dim=-1).to(x.dtype)
