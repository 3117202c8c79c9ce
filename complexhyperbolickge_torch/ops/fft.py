"""Real-FFT helpers over the packed [Re | Im] layout, plus DFT-matrix forms.

Port of complexhyperbolickge_tpu/ops/fft.py.  The reference round-trips
entity embeddings between complex frequency space and real coordinate space
with torch.fft.rfft/irfft(norm="ortho").  A complex vector of R bins is
stored as 2R reals [Re | Im]; the real length defaults to n = 2(R - 1).

  * `irfft_packed` / `rfft_packed`: torch.fft; what the models use.
  * `irfft_matrix` / `rfft_matrix`: the same linear maps as explicit small
    real matrices (66 x 64 at rank 33), and `irfft_packed_mm` /
    `rfft_packed_mm`, the transforms as one matmul with them (exact fp32:
    TF32 is off, complexhyperbolickge_torch/__init__.py).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
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


@lru_cache(maxsize=None)
def _irfft_matrix_np(r: int, n: int) -> np.ndarray:
    """(2R, n) real matrix M with packed_v @ M == irfft_packed(packed_v, n)."""
    eye = np.eye(r)
    out = np.zeros((2 * r, n))
    for j in range(r):
        out[j] = np.fft.irfft(eye[j], n=n, norm="ortho")
        out[r + j] = np.fft.irfft(1j * eye[j], n=n, norm="ortho")
    return out


@lru_cache(maxsize=None)
def _rfft_matrix_np(n: int, r_out: int) -> np.ndarray:
    """(n, 2 r_out) real matrix M with x @ M == rfft_packed(x) (n -> r_out bins)."""
    eye = np.eye(n)
    out = np.zeros((n, 2 * r_out))
    for j in range(n):
        z = np.fft.rfft(eye[j], n=n, norm="ortho")
        out[j, :r_out] = z.real
        out[j, r_out:] = z.imag
    return out


def irfft_matrix(r: int, n: int | None = None, dtype=torch.float32, device=None):
    """The (2R, n) matrix of irfft_packed (n defaults to 2(R-1))."""
    if n is None:
        n = 2 * (r - 1)
    return torch.as_tensor(_irfft_matrix_np(r, n), dtype=dtype, device=device)


def rfft_matrix(n: int, dtype=torch.float32, device=None):
    """The (n, 2 (n//2 + 1)) matrix of rfft_packed."""
    return torch.as_tensor(_rfft_matrix_np(n, n // 2 + 1), dtype=dtype, device=device)


def irfft_packed_mm(v, n: int | None = None):
    """Matmul form of irfft_packed."""
    m = irfft_matrix(v.shape[-1] // 2, n, dtype=v.dtype, device=v.device)
    return torch.matmul(v, m)


def rfft_packed_mm(x):
    """Matmul form of rfft_packed."""
    return torch.matmul(x, rfft_matrix(x.shape[-1], dtype=x.dtype, device=x.device))
