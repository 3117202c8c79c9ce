"""The port's remaining ops against the JAX package's, in float64 on the
CPU: euc_sqdistance, givens_isometry and norm_clamp (ops/euclidean.py),
mobius_add_complex (ops/chyperbolic.py), and the DFT matrices with
irfft_packed_mm / rfft_packed_mm (ops/fft.py).  Values, and gradients of a
weighted sum where the op is differentiable in reals, at rtol 1e-10, atol
1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.ops import chyperbolic as TC
from complexhyperbolickge_torch.ops import euclidean as TE
from complexhyperbolickge_torch.ops import fft as TF
from complexhyperbolickge_tpu.ops import chyperbolic as JC
from complexhyperbolickge_tpu.ops import euclidean as JE
from complexhyperbolickge_tpu.ops import fft as JF

TOL = dict(rtol=1e-10, atol=1e-12)


def value_and_grads(jax_fn, torch_fn, *arrays, seed=5):
    """Both ops' values and the gradients of sum(w * out) w.r.t. each input."""
    want = jax_fn(*map(jnp.asarray, arrays))
    w = np.random.default_rng(seed).normal(size=np.shape(want))
    jg = jax.grad(lambda *a: jnp.sum(jnp.asarray(w) * jax_fn(*a)),
                  argnums=tuple(range(len(arrays))))(*map(jnp.asarray, arrays))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    got = torch_fn(*ts)
    torch.sum(torch.as_tensor(w) * got).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for t, g in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)


def test_euc_sqdistance_matches_jax():
    r = np.random.default_rng(0)
    value_and_grads(JE.euc_sqdistance, TE.euc_sqdistance,
                    r.normal(size=(5, 1, 6)), r.normal(size=(5, 4, 6)))


@pytest.mark.parametrize("bounds", [(0.5, None), (None, 1.0), (0.8, 1.2)])
def test_norm_clamp_matches_jax(bounds):
    lo, hi = bounds
    x = np.random.default_rng(1).normal(0.0, 0.6, (20, 4))
    value_and_grads(lambda v: JE.norm_clamp(v, lo, hi), lambda v: TE.norm_clamp(v, lo, hi), x)


@pytest.mark.parametrize("lift", [False, True])
@pytest.mark.parametrize("kan", [False, True])
def test_givens_isometry_matches_jax(kan, lift):
    r = np.random.default_rng(2)
    unitary = r.normal(size=(3, 12))  # a | b | angle: 2 complex params each
    z = r.normal(size=(3, 4)) + 1j * r.normal(size=(3, 4))  # 2 complex pairs
    abelian = r.normal(0.0, 0.3, (3, 2)) if kan else None
    nil = r.normal(size=(3, 4)) if kan else None
    want = JE.givens_isometry(jnp.asarray(unitary), jnp.asarray(z),
                              None if abelian is None else jnp.asarray(abelian),
                              None if nil is None else jnp.asarray(nil), lift=lift)
    got = TE.givens_isometry(torch.as_tensor(unitary), torch.as_tensor(z),
                             None if abelian is None else torch.as_tensor(abelian),
                             None if nil is None else torch.as_tensor(nil), lift=lift)
    for a, b in zip(got if lift else (got,), want if lift else (want,)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_mobius_add_complex_matches_jax():
    r = np.random.default_rng(3)
    x = 0.5 * (r.normal(size=(6, 5)) + 1j * r.normal(size=(6, 5)))
    y = 0.5 * (r.normal(size=(6, 5)) + 1j * r.normal(size=(6, 5)))
    want = JC.mobius_add_complex(jnp.asarray(x), jnp.asarray(y))
    got = TC.mobius_add_complex(torch.as_tensor(x), torch.as_tensor(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("r,n", [(33, None), (5, None), (5, 9), (4, 7)])
def test_dft_matrices_and_mm_forms_match_jax(r, n):
    np.testing.assert_allclose(TF.irfft_matrix(r, n, dtype=torch.float64).numpy(),
                               np.asarray(JF.irfft_matrix(r, n, dtype=jnp.float64)), **TOL)
    rng = np.random.default_rng(4)
    v = rng.normal(size=(7, 2 * r))
    value_and_grads(lambda a: JF.irfft_packed_mm(a, n), lambda a: TF.irfft_packed_mm(a, n), v)
    # the matmul form is the FFT form
    np.testing.assert_allclose(TF.irfft_packed_mm(torch.as_tensor(v), n).numpy(),
                               TF.irfft_packed(torch.as_tensor(v), n).numpy(), **TOL)
    x = rng.normal(size=(7, n or 2 * (r - 1)))
    np.testing.assert_allclose(TF.rfft_matrix(x.shape[-1], dtype=torch.float64).numpy(),
                               np.asarray(JF.rfft_matrix(x.shape[-1], dtype=jnp.float64)), **TOL)
    value_and_grads(JF.rfft_packed_mm, TF.rfft_packed_mm, x)
    np.testing.assert_allclose(TF.rfft_packed_mm(torch.as_tensor(x)).numpy(),
                               TF.rfft_packed(torch.as_tensor(x)).numpy(), **TOL)
