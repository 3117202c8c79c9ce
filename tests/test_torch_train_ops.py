"""Gradients of the port's training ops against the JAX package.

The same numpy-drawn inputs go through both packages; values and gradients
compare in float64 at rtol 1e-9 (atol 1e-12 for gradients that are exactly
0 on one side).  Regimes: clamped at the init scale (every clamp of the
distance saturated) and near the unit-ball boundary (the analytic
backward's denominator clamp active).  The FFTRotH cases include the two
regressions where a plain-clamp forward gave the wrong gradient: exactly 0
in float32 at the init scale, and an unclamped denominator near the
boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.models import ModelConfig, get_model
from complexhyperbolickge_torch.ops import chyperbolic as TCH
from complexhyperbolickge_torch.ops import fft as TF
from complexhyperbolickge_torch.ops import math as TM
from complexhyperbolickge_torch.train.checkpoint import params_from_jax
from complexhyperbolickge_tpu.models import ModelConfig as JaxConfig
from complexhyperbolickge_tpu.models import get_model as jax_get_model
from complexhyperbolickge_tpu.ops import chyperbolic as JCH
from complexhyperbolickge_tpu.ops import fft as JF
from complexhyperbolickge_tpu.ops import math as JM

TOL = dict(rtol=1e-9, atol=1e-12)
REGIMES = {"clamped_at_init": 1e-3, "near_boundary": 0.3}


def torch_value_and_grads(fn, arrays, cot):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    (out * torch.as_tensor(cot)).sum().backward()
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


def jax_value_and_grads(fn, arrays, cot):
    def f(args, c):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(c)

    out, grads = jax.jit(f)([jnp.asarray(a) for a in arrays], jnp.asarray(cot))
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def assert_all_close(got, want, **tol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **(tol or TOL))


@pytest.mark.parametrize("name,jfn,tfn,lo,hi", [
    ("st_clip_both", lambda x: JM.st_clip(x, -0.5, 0.7),
     lambda x: TM.st_clip(x, -0.5, 0.7), -2, 2),
    ("st_clip_lo", lambda x: JM.st_clip(x, 0.1, None),
     lambda x: TM.st_clip(x, 0.1, None), -1, 1),
    ("artanh", JM.artanh, TM.artanh, -1.3, 1.3),
])
def test_math_values_and_gradients(name, jfn, tfn, lo, hi):
    r = np.random.default_rng(0)
    x = r.uniform(lo, hi, (6, 9))
    cot = r.normal(size=(6, 9))
    assert_all_close(torch_value_and_grads(tfn, [x], cot),
                     jax_value_and_grads(jfn, [x], cot))


@pytest.mark.parametrize("regime", REGIMES)
def test_distance_core_matches_jax(regime):
    r = np.random.default_rng(1)
    s = REGIMES[regime]
    lhs, rhs = r.normal(0, s, (11, 12)), r.normal(0, s, (11, 5, 12))
    cot = r.normal(size=(11, 5))
    got = torch_value_and_grads(TCH.ChypDistanceCore.apply, [lhs, rhs], cot)
    assert_all_close(got, jax_value_and_grads(JCH._chyp_distance_core, [lhs, rhs], cot))
    assert np.abs(got[1]).max() > 0  # the clamps pass gradient through
    # the dispatcher's train shape on a CPU pair is the same function
    via = torch_value_and_grads(lambda a, b: TCH.chyp_distance(a[:, None, :], b),
                                [lhs, rhs], cot)
    assert_all_close(via, got, rtol=0, atol=0)


@pytest.mark.parametrize("regime", REGIMES)
def test_distance_all_matches_jax(regime):
    r = np.random.default_rng(2)
    s = REGIMES[regime]
    lhs, rhs = r.normal(0, s, (7, 12)), r.normal(0, s, (13, 12))
    cot = r.normal(size=(7, 13))
    assert_all_close(torch_value_and_grads(TCH.chyp_distance_all, [lhs, rhs], cot),
                     jax_value_and_grads(JCH.chyp_distance_all, [lhs, rhs], cot))


def test_broadcast_distance_matches_jax():
    """Shapes other than the train shape: autograd with straight-through clamps."""
    r = np.random.default_rng(3)
    lhs, rhs = r.normal(0, 0.2, (9, 12)), r.normal(0, 0.2, (9, 12))
    cot = r.normal(size=(9,))
    assert_all_close(torch_value_and_grads(TCH.chyp_distance, [lhs, rhs], cot),
                     jax_value_and_grads(JCH.chyp_distance, [lhs, rhs], cot))


@pytest.mark.parametrize("fn", ["irfft_packed", "rfft_packed"])
def test_fft_gradients_match_jax(fn):
    r = np.random.default_rng(4)
    x = r.normal(size=(5, 18 if fn == "irfft_packed" else 16))
    out_shape = np.shape(getattr(JF, fn)(jnp.asarray(x)))
    cot = r.normal(size=out_shape)
    assert_all_close(torch_value_and_grads(getattr(TF, fn), [x], cot),
                     jax_value_and_grads(getattr(JF, fn), [x], cot))


def fftroth_pair(entity_scale, dtype, rank=5, n_ent=30, n_rel=6, seed=5):
    cfg = dict(n_entities=n_ent, n_relations=n_rel, rank=rank, bias="learn",
               multi_c=True, dtype=dtype)
    jm = jax_get_model("FFTRotH")(JaxConfig(**cfg))
    shapes = {k: np.shape(v) for k, v in jm.init(jax.random.PRNGKey(0)).items()}
    r = np.random.default_rng(seed)
    params = {k: r.normal(0.0, entity_scale if k == "entity" else 0.2, s)
              + (1.0 if k == "c" else 0.0) for k, s in shapes.items()}
    params = {k: v.astype(dtype) for k, v in params.items()}
    tm = get_model("FFTRotH")(ModelConfig(**cfg))
    tm.load_state_dict(params_from_jax(params, "cpu"))
    q = np.stack([r.integers(0, n_ent, 8), r.integers(0, n_rel, 8)], axis=1)
    t = r.integers(0, n_ent, (8, 4))
    return jm, params, tm, q, t


@pytest.mark.parametrize("entity_scale,dtype,tol", [
    (1e-3, "float64", TOL),
    (0.3, "float64", TOL),
    # the float32 regression: the gradient must flow through saturated clamps
    (1e-3, "float32", dict(rtol=2e-4, atol=1e-6)),
], ids=["init_f64", "near_boundary_f64", "init_f32"])
def test_fftroth_score_gradients_match_jax(entity_scale, dtype, tol):
    jm, params, tm, q, t = fftroth_pair(entity_scale, dtype)

    def loss(p):
        return jnp.sum(jm.score(p, jnp.asarray(q), jnp.asarray(t)))

    want = jax.jit(jax.grad(loss))({k: jnp.asarray(v) for k, v in params.items()})
    tm.score(torch.as_tensor(q), torch.as_tensor(t)).sum().backward()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[name]),
                                   err_msg=name, **tol)
    assert np.abs(tm.entity.grad.numpy()).max() > 0
