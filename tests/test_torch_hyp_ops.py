"""complexhyperbolickge_torch.ops.hyperbolic against
complexhyperbolickge_tpu.ops.hyperbolic in float64: values, and the
gradients of a weighted sum of the output with respect to every input
(the curvature included), at rtol 1e-9 (atol 1e-12 for entries that cancel
to ~0).

The inputs cover the clamp regimes: points at and beyond the ball edge
(project's clip, artanh's clamp), lorentz_boost with |v| > 10 (tanh
saturates, g and gamma clamp), and rows of norm ~1e-6 in logmap0_lorentz.
They stay off exact ties of jnp.maximum, whose gradient splits in half
there (torch.clamp_min's does not).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.ops import hyperbolic as TH
from complexhyperbolickge_tpu.ops import hyperbolic as JH

TOL = dict(rtol=1e-9, atol=1e-12)


def _c(r, n=6):
    return r.uniform(0.5, 2.0, (n, 1))


def _edge(r, shape, c_rows):
    """Points at radius 0.999 / sqrt(c), near the ball's edge (inside
    project's f64 clip at 1 - 1e-5, so its where stays on one branch)."""
    x = r.normal(size=shape)
    return x / np.linalg.norm(x, axis=-1, keepdims=True) * 0.999 / np.sqrt(c_rows)


def _boost_inputs(r, scale):
    return [r.normal(0, 0.3, (6, 8)), r.normal(0, scale, (6, 8)), _c(r)]


def _small_rows(r):
    y = r.normal(0, 0.3, (6, 8))
    y[:3] *= 1e-5  # |y| ~ 1e-5: beta rounds to 1 in f32, not in the identity
    return [y, _c(r)]


CASES = {
    "project": (JH.project, TH.project, lambda r: [r.normal(0, 0.6, (6, 8)), _c(r)]),
    "expmap0": (JH.expmap0, TH.expmap0, lambda r: [r.normal(0, 0.6, (6, 8)), _c(r)]),
    "expmap0_saturated": (JH.expmap0, TH.expmap0,
                          lambda r: [r.normal(0, 8.0, (6, 8)), _c(r)]),
    "logmap0": (JH.logmap0, TH.logmap0, lambda r: [r.normal(0, 0.2, (6, 8)), _c(r)]),
    "logmap0_edge": (JH.logmap0, TH.logmap0,
                     lambda r: [_edge(r, (6, 8), c := _c(r)), c]),
    "mobius_add": (JH.mobius_add, TH.mobius_add,
                   lambda r: [r.normal(0, 0.2, (6, 8)), r.normal(0, 0.2, (6, 8)), _c(r)]),
    "mobius_add_edge": (JH.mobius_add, TH.mobius_add,
                        lambda r: [_edge(r, (6, 8), c := _c(r)), _edge(r, (6, 8), c), c]),
    "hyp_dist_from_parts": (
        JH._hyp_dist_multi_c_from_parts, TH._hyp_dist_multi_c_from_parts,
        lambda r: [r.uniform(0.01, 0.4, (6, 1)), r.normal(0, 0.3, (6, 5)),
                   r.uniform(0.1, 2.0, (1, 5)), _c(r)]),
    "hyp_distance_multi_c": (
        JH.hyp_distance_multi_c, TH.hyp_distance_multi_c,
        lambda r: [r.normal(0, 0.2, (6, 1, 8)), r.normal(0, 0.5, (6, 4, 8)),
                   _c(r)[:, :, None]]),
    "hyp_distance_multi_c_edge": (
        JH.hyp_distance_multi_c, TH.hyp_distance_multi_c,
        # x at the edge, v of moderate norm: with both at the edge the
        # gradient loses ~5 digits to cancellation and the two summation
        # orders differ by 1e-5 relative on its smallest entries
        lambda r: [_edge(r, (6, 1, 8), (c := _c(r))[:, :, None]),
                   r.normal(0, 0.5, (6, 4, 8)), c[:, :, None]]),
    "hyp_distance_multi_c_all": (
        JH.hyp_distance_multi_c_all, TH.hyp_distance_multi_c_all,
        lambda r: [r.normal(0, 0.2, (6, 8)), r.normal(0, 0.5, (11, 8)), _c(r)]),
    "expmap0_lorentz": (JH.expmap0_lorentz, TH.expmap0_lorentz,
                        lambda r: [r.normal(0, 0.6, (6, 8)), _c(r)]),
    "logmap0_lorentz": (JH.logmap0_lorentz, TH.logmap0_lorentz,
                        lambda r: [r.normal(0, 0.6, (6, 8)), _c(r)]),
    "logmap0_lorentz_small_rows": (JH.logmap0_lorentz, TH.logmap0_lorentz, _small_rows),
    "lorentz_boost": (JH.lorentz_boost, TH.lorentz_boost, lambda r: _boost_inputs(r, 0.3)),
    "lorentz_boost_fast": (JH.lorentz_boost, TH.lorentz_boost,
                           lambda r: _boost_inputs(r, 6.0)),  # |v| ~ 17 > 10
    "hyp_distance_multi_c_lorentz": (
        JH.hyp_distance_multi_c_lorentz, TH.hyp_distance_multi_c_lorentz,
        lambda r: [r.normal(0, 0.4, (6, 1, 8)), r.normal(0, 0.4, (6, 4, 8)),
                   _c(r)[:, :, None]]),
    "hyp_distance_multi_c_lorentz_all": (
        JH.hyp_distance_multi_c_lorentz_all, TH.hyp_distance_multi_c_lorentz_all,
        lambda r: [r.normal(0, 0.4, (6, 8)), r.normal(0, 0.4, (11, 8)), _c(r)]),
    "hyp_sim_expmap_all": (JH.hyp_sim_expmap_all, TH.hyp_sim_expmap_all,
                           lambda r: [r.normal(0, 0.2, (6, 8)), r.normal(0, 0.5, (11, 8)),
                                      _c(r)]),
    "hyp_sim_expmap_all_clipped": (  # large rows hit project()'s clip
        JH.hyp_sim_expmap_all, TH.hyp_sim_expmap_all,
        lambda r: [r.normal(0, 0.2, (6, 8)), r.normal(0, 4.0, (11, 8)), _c(r)]),
    "lorentz_sim_expmap_all": (JH.lorentz_sim_expmap_all, TH.lorentz_sim_expmap_all,
                               lambda r: [r.normal(0, 0.4, (6, 8)),
                                          r.normal(0, 0.4, (11, 8)), _c(r)]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_and_grads_match_jax_f64(name):
    fn_j, fn_t, make = CASES[name]
    rng = np.random.default_rng(0)
    arrays = make(rng)
    want = np.asarray(fn_j(*[jnp.asarray(a) for a in arrays]))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    got = fn_t(*ts)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    assert np.isfinite(want).all()

    w = rng.normal(size=want.shape)
    jg = jax.grad(lambda *a: jnp.sum(fn_j(*a) * w), argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    torch.sum(got * torch.as_tensor(w)).backward()
    for i, (t, g) in enumerate(zip(ts, jg)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), err_msg=f"arg {i}", **TOL)
        assert np.isfinite(np.asarray(g)).all()


def test_lorentz_boost_f32_saturation_stays_finite():
    """In float32, tanh(|v|) rounds to 1 for |v| > ~10 and g to >= 1; the
    clamp of g below 1 keeps the boost finite, as in JAX."""
    r = np.random.default_rng(3)
    y, v, c = (a.astype(np.float32) for a in _boost_inputs(r, 30.0))
    got = TH.lorentz_boost(torch.as_tensor(y), torch.as_tensor(v), torch.as_tensor(c))
    want = np.asarray(JH.lorentz_boost(jnp.asarray(y), jnp.asarray(v), jnp.asarray(c)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_logmap0_lorentz_f32_small_rows_stay_finite():
    """The exact identity beta^2 - 1 = c |y|^2 keeps rows of norm ~1e-5
    finite in float32, where arcosh(beta) / sqrt(beta^2 - 1) is 0/0."""
    y, c = (a.astype(np.float32) for a in _small_rows(np.random.default_rng(4)))
    got = TH.logmap0_lorentz(torch.as_tensor(y), torch.as_tensor(c))
    want = np.asarray(JH.logmap0_lorentz(jnp.asarray(y), jnp.asarray(c)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
