"""The port's Euclidean (TransE, CP, MurE, RotE, RefE, AttE) and complex
(ComplEx, RotatE, Fourier) models against the JAX package's, in float64
on the CPU.

Params are drawn with numpy at the JAX param_specs shapes and carried into
the port by params_from_jax.  score, score_all and get_factors agree, and
so do the gradients of a scalar of each w.r.t. every parameter, at rtol
1e-10, atol 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.models import ModelConfig, get_model
from complexhyperbolickge_torch.models.base import NoMask
from complexhyperbolickge_torch.train.checkpoint import params_from_jax, params_to_jax
from complexhyperbolickge_torch.train.evaluate import make_best_ranker, make_ranker
from complexhyperbolickge_tpu.models import ModelConfig as JaxConfig
from complexhyperbolickge_tpu.models import get_model as jax_get_model

TOL = dict(rtol=1e-10, atol=1e-12)
MODELS = ["TransE", "CP", "MurE", "RotE", "RefE", "AttE", "ComplEx", "RotatE", "Fourier"]
N_ENT, N_REL, RANK = 30, 6, 8


def _pair(name, bias="learn", seed=0):
    cfg = dict(n_entities=N_ENT, n_relations=N_REL, rank=RANK, bias=bias, gamma=0.5,
               dtype="float64")
    jm = jax_get_model(name)(JaxConfig(**cfg))
    rng = np.random.default_rng(seed)
    np_params = {k: rng.normal(0.0, 0.3, np.shape(v))
                 for k, v in jm.init(jax.random.PRNGKey(0)).items()}
    tm = get_model(name)(ModelConfig(**cfg))
    tm.load_state_dict(params_from_jax(np_params, "cpu"))
    return jm, {k: jnp.asarray(v) for k, v in np_params.items()}, tm, rng


def _check_grads(tm, out, jax_grads):
    out.backward()
    for n, p in tm.named_parameters():
        got = np.zeros(p.shape) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(jax_grads[n]), err_msg=n, **TOL)


def _weights(shape, seed=9):
    return np.random.default_rng(seed).normal(size=shape)


@pytest.mark.parametrize("bias", ["learn", "constant", "none"])
@pytest.mark.parametrize("name", MODELS)
def test_score_and_grads_match_jax(name, bias):
    jm, jp, tm, rng = _pair(name, bias)
    q = np.stack([rng.integers(0, N_ENT, 7), rng.integers(0, N_REL, 7)], axis=1)
    t = rng.integers(0, N_ENT, (7, 4))
    w = _weights((7, 4))
    def f(p):
        return jnp.sum(jnp.asarray(w) * jm.score(p, jnp.asarray(q), jnp.asarray(t)))

    _, jg = jax.value_and_grad(f)(jp)
    got = tm.score(torch.as_tensor(q), torch.as_tensor(t))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jm.score(jp, q, t)), **TOL)
    _check_grads(tm, torch.sum(torch.as_tensor(w) * got), jg)


@pytest.mark.parametrize("name", MODELS)
def test_score_all_and_grads_match_jax(name):
    jm, jp, tm, rng = _pair(name)
    q = np.stack([rng.integers(0, N_ENT, 9), rng.integers(0, N_REL, 9)], axis=1)
    w = _weights((9, N_ENT))
    def f(p):
        return jnp.sum(jnp.asarray(w) * jm.score_all(p, jnp.asarray(q)))

    _, jg = jax.value_and_grad(f)(jp)
    got = tm.score_all(torch.as_tensor(q))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jm.score_all(jp, q)), **TOL)
    _check_grads(tm, torch.sum(torch.as_tensor(w) * got), jg)


@pytest.mark.parametrize("tails", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_get_factors_and_grads_match_jax(name, tails):
    """The regularizer factors (the complex family's: magnitudes, with the
    full entity table as a NoMask third factor whatever tails says)."""
    jm, jp, tm, rng = _pair(name)
    q = np.stack([rng.integers(0, N_ENT, 5), rng.integers(0, N_REL, 5)], axis=1)
    t = rng.integers(0, N_ENT, (5, 3)) if tails else None

    def unwrap(f):
        return f.value if hasattr(f, "value") else f

    jf = jm.get_factors(jp, jnp.asarray(q), None if t is None else jnp.asarray(t))
    tf = tm.get_factors(torch.as_tensor(q), None if t is None else torch.as_tensor(t))
    assert [type(f).__name__ == "NoMask" for f in jf] == [isinstance(f, NoMask) for f in tf]
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(unwrap(a).detach().numpy(), np.asarray(unwrap(b)), **TOL)

    def total(fs, xp):
        return sum(xp.sum(unwrap(f) ** 3) for f in fs)

    _, jg = jax.value_and_grad(lambda p: total(jm.get_factors(
        p, jnp.asarray(q), None if t is None else jnp.asarray(t)), jnp))(jp)
    _check_grads(tm, total(tf, torch), jg)


@pytest.mark.parametrize("name", MODELS)
def test_state_dict_keys_equal_jax_params(name):
    cfg = dict(n_entities=11, n_relations=4, rank=6, dtype="float32")
    jp = jax_get_model(name)(JaxConfig(**cfg)).init(jax.random.PRNGKey(0))
    tm = get_model(name)(ModelConfig(**cfg), generator=torch.Generator().manual_seed(0))
    np_t = params_to_jax(tm.state_dict())
    assert sorted(np_t) == sorted(jp)
    for k, v in jp.items():
        assert np_t[k].shape == v.shape and np_t[k].dtype == np.asarray(v).dtype, k


def test_fourier_init_post_equals_jax():
    """Fourier shifts its high-pass half up and its low-pass half down by
    3 init_size after the draws."""
    cfg = dict(n_entities=N_ENT, n_relations=N_REL, rank=RANK, init_size=0.01, dtype="float64")
    jm = jax_get_model("Fourier")(JaxConfig(**cfg))
    rng = np.random.default_rng(2)
    raw = {k: rng.normal(size=np.shape(v)) for k, v in jm.init(jax.random.PRNGKey(0)).items()}
    want = jm.init_post({k: jnp.asarray(v) for k, v in raw.items()})
    tm = get_model("Fourier")(ModelConfig(**cfg))
    tm.load_state_dict(params_from_jax(raw, "cpu"))
    with torch.no_grad():
        tm.init_post()
    for k, v in want.items():
        np.testing.assert_allclose(getattr(tm, k).detach().numpy(), np.asarray(v), **TOL)
    # and a fresh model carries the shift: rel halves centred at +-3 init_size
    fresh = get_model("Fourier")(ModelConfig(**dict(cfg, n_relations=400)),
                                 generator=torch.Generator().manual_seed(0))
    d = fresh.dim
    assert abs(fresh.rel[:, :d].mean().item() - 0.03) < 0.003
    assert abs(fresh.rel[:, d:].mean().item() + 0.03) < 0.003


@pytest.mark.parametrize("name", ["ComplEx", "RotatE", "Fourier"])
def test_complex_models_need_even_rank(name):
    with pytest.raises(ValueError, match="even embedding dimension"):
        get_model(name)(ModelConfig(n_entities=5, n_relations=2, rank=5))


@pytest.mark.parametrize("name", MODELS)
def test_best_ranker_is_dense_and_ranks_as_jax(name):
    """auto gives the dense ranker, as JAX does for these families; its
    filtered ranks equal JAX's dense ranker's."""
    from complexhyperbolickge_tpu.train.evaluate import make_ranker as jax_make_ranker

    jm, jp, tm, rng = _pair(name)
    q = np.stack([rng.integers(0, N_ENT, 6), rng.integers(0, N_REL, 6),
                  rng.integers(0, N_ENT, 6)], axis=1).astype(np.int32)
    fidx = np.full((6, 3), N_ENT, np.int32)
    fidx[:, 0] = q[:, 2]
    fidx[:3, 1] = rng.integers(0, N_ENT, 3)
    rank_fn = make_best_ranker(tm, 4)
    assert rank_fn.__qualname__ == make_ranker(tm, 4).__qualname__
    assert rank_fn.__qualname__ == "make_ranker.<locals>.rank_batch"
    got = np.asarray(rank_fn(torch.as_tensor(q), torch.as_tensor(fidx)))
    want = np.asarray(jax_make_ranker(jm, 4)(jp, jnp.asarray(q), jnp.asarray(fidx)))
    np.testing.assert_array_equal(got, want)
