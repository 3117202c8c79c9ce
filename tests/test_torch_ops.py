"""complexhyperbolickge_torch.ops against complexhyperbolickge_tpu.ops in f64.

The same numpy-drawn inputs go through the JAX function and its port; the
FFT implementations differ (XLA's vs PyTorch's), so agreement is ~1e-15 and
the stated tolerance is atol = rtol = 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.ops import chyperbolic as TCH
from complexhyperbolickge_torch.ops import euclidean as TE
from complexhyperbolickge_torch.ops import fft as TF
from complexhyperbolickge_torch.ops import math as TM
from complexhyperbolickge_tpu.ops import chyperbolic as JCH
from complexhyperbolickge_tpu.ops import euclidean as JE
from complexhyperbolickge_tpu.ops import fft as JF
from complexhyperbolickge_tpu.ops import math as JM

TOL = dict(atol=1e-10, rtol=1e-10)


def _both(fn_j, fn_t, *arrays):
    """Run fn_j on jnp arrays and fn_t on torch tensors of the same values."""
    out_j = fn_j(*[jnp.asarray(a) for a in arrays])
    out_t = fn_t(*[torch.as_tensor(a) for a in arrays])
    return out_j, out_t


def _close(out_j, out_t):
    if isinstance(out_j, tuple):
        for a, b in zip(out_j, out_t):
            _close(a, b)
        return
    np.testing.assert_allclose(np.asarray(out_t.detach()), np.asarray(out_j), **TOL)


def _ball(rng, shape, scale=0.2):
    return rng.normal(0.0, scale, shape)


# (name, jax fn, torch fn, input maker) — inputs drawn from a seeded numpy rng
CASES = {
    "artanh": (JM.artanh, TM.artanh, lambda r: [r.uniform(-1.2, 1.2, (7, 9))]),
    "tanh": (JM.tanh, TM.tanh, lambda r: [r.uniform(-30, 30, (7, 9))]),
    "arcosh": (JM.arcosh, TM.arcosh, lambda r: [r.uniform(0.5, 5, (7, 9))]),
    "clamp_min": (lambda x: JM.clamp_min(x, 0.3), lambda x: TM.clamp_min(x, 0.3),
                  lambda r: [r.normal(size=(7, 9))]),
    "safe_sqrt": (JM.safe_sqrt, TM.safe_sqrt,
                  lambda r: [np.where(r.random((7, 9)) < 0.3, 0.0, r.random((7, 9)))]),
    "safe_norm": (JM.safe_norm, TM.safe_norm,
                  lambda r: [np.concatenate([r.normal(size=(6, 9)), np.zeros((1, 9))])]),
    "irfft_packed": (JF.irfft_packed, TF.irfft_packed, lambda r: [r.normal(size=(5, 18))]),
    "rfft_packed": (JF.rfft_packed, TF.rfft_packed, lambda r: [r.normal(size=(5, 16))]),
    "givens_rotations": (JE.givens_rotations, TE.givens_rotations,
                         lambda r: [r.normal(size=(5, 8)), r.normal(size=(5, 8))]),
    "givens_rotations_inverse": (
        lambda a, b: JE.givens_rotations(a, b, inverse=True),
        lambda a, b: TE.givens_rotations(a, b, inverse=True),
        lambda r: [r.normal(size=(5, 8)), r.normal(size=(5, 8))]),
    "givens_rotations_scaled": (
        lambda a, b, s: JE.givens_rotations(a, b, scale=s),
        lambda a, b, s: TE.givens_rotations(a, b, scale=s),
        lambda r: [r.normal(size=(5, 8)), r.normal(size=(5, 8)), r.normal(size=(5, 4))]),
    "givens_reflection": (JE.givens_reflection, TE.givens_reflection,
                          lambda r: [r.normal(size=(5, 8)), r.normal(size=(5, 8))]),
    "multi_index_select": (JE.multi_index_select, TE.multi_index_select,
                           lambda r: [r.normal(size=(9, 4)), r.integers(0, 9, (3, 5))]),
    "safe_normalize": (JE.safe_normalize, TE.safe_normalize,
                       lambda r: [r.normal(size=(5, 8))]),
    "project": (JCH.project, TCH.project,
                lambda r: [r.normal(0, 0.6, (6, 8)), r.uniform(0.5, 2, (6, 1))]),
    "expmap0": (JCH.expmap0, TCH.expmap0,
                lambda r: [r.normal(0, 0.6, (6, 8)), r.uniform(0.5, 2, (6, 1))]),
    "logmap0": (JCH.logmap0, TCH.logmap0,
                lambda r: [_ball(r, (6, 8)), r.uniform(0.5, 2, (6, 1))]),
    "real_mobius_add": (JCH.real_mobius_add, TCH.real_mobius_add,
                        lambda r: [_ball(r, (6, 8)), _ball(r, (6, 8)),
                                   r.uniform(0.5, 2, (6, 1))]),
    "swap_neg": (JCH.swap_neg, TCH.swap_neg, lambda r: [r.normal(size=(4, 10))]),
    "hermitian_sqnorm_lifted": (JCH.hermitian_sqnorm_lifted, TCH.hermitian_sqnorm_lifted,
                                lambda r: [_ball(r, (4, 10))]),
    "chyp_distance_train_shape": (
        lambda a, b: JCH.chyp_distance(a[:, None, :], b),
        lambda a, b: TCH.chyp_distance(a[:, None, :], b),
        lambda r: [_ball(r, (4, 10)), _ball(r, (4, 6, 10))]),
    "chyp_distance_pairs": (JCH.chyp_distance, TCH.chyp_distance,
                            lambda r: [_ball(r, (7, 10)), _ball(r, (7, 10))]),
    "chyp_distance_all": (JCH.chyp_distance_all, TCH.chyp_distance_all,
                          lambda r: [_ball(r, (5, 10)), _ball(r, (13, 10))]),
    "chyp_distance_all_clamped": (
        JCH.chyp_distance_all, TCH.chyp_distance_all,
        lambda r: [_ball(r, (5, 10), 0.01), _ball(r, (13, 10), 0.8)]),
    "lift": (JCH.lift, TCH.lift, lambda r: [r.normal(size=(4, 10))]),
    "chyp_distance_explicit": (
        lambda a, b: JCH.chyp_distance_explicit(JCH.lift(a), JCH.lift(b)),
        lambda a, b: TCH.chyp_distance_explicit(TCH.lift(a), TCH.lift(b)),
        lambda r: [_ball(r, (7, 10)), _ball(r, (7, 10))]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax_f64(name):
    fn_j, fn_t, make = CASES[name]
    arrays = make(np.random.default_rng(0))
    _close(*_both(fn_j, fn_t, *arrays))


@pytest.mark.parametrize("lift", [False, True])
def test_givens_unitary_matches_jax(lift):
    rng = np.random.default_rng(1)
    a, b, ang = (rng.normal(size=(5, 8)) for _ in range(3))
    z = rng.normal(size=(5, 8)) + 1j * rng.normal(size=(5, 8))
    out_j = JE.givens_unitary(jnp.asarray(a), jnp.asarray(b), jnp.asarray(ang),
                              jnp.asarray(z), lift=lift)
    out_t = TE.givens_unitary(torch.as_tensor(a), torch.as_tensor(b),
                              torch.as_tensor(ang), torch.as_tensor(z), lift=lift)
    _close(out_j, out_t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_ball_eps_and_constants(dtype):
    jdt = {torch.float32: jnp.float32, torch.float64: jnp.float64,
           torch.bfloat16: jnp.bfloat16}[dtype]
    assert TM.ball_eps(dtype) == JM.ball_eps(jdt)
    assert TM.MIN_NORM == JM.MIN_NORM
    assert TCH._PROJECT_EPS == JCH._PROJECT_EPS
    assert [TM.round_up(x, 8) for x in (1, 8, 9)] == [JM.round_up(x, 8) for x in (1, 8, 9)]


def test_irfft_rfft_roundtrip_f32():
    """Packed irfft/rfft invert each other on the real-valued layout (the
    DC and Nyquist imaginary parts are dropped by irfft, as in JAX)."""
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(3, 64)), dtype=torch.float32)
    back = TF.irfft_packed(TF.rfft_packed(x))
    torch.testing.assert_close(back, x, atol=1e-5, rtol=1e-5)
