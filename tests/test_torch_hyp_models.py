"""The eight real-hyperbolic models of complexhyperbolickge_torch against the
JAX models, in float64.

Params are drawn with numpy at the JAX param_specs shapes and injected into
both packages (params_from_jax).  score, score_all and the gradients of a
weighted sum of each with respect to every parameter agree at rtol 1e-9
(atol 1e-12 for entries that cancel to ~0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.models import ModelConfig, all_models, get_model
from complexhyperbolickge_torch.models.hyperbolic import HYP_MODELS
from complexhyperbolickge_torch.train.checkpoint import params_from_jax, params_to_jax
from complexhyperbolickge_tpu.models import ModelConfig as JaxConfig
from complexhyperbolickge_tpu.models import get_model as jax_get_model
from complexhyperbolickge_tpu.models.hyperbolic import HYP_MODELS as JAX_HYP_MODELS

TOL = dict(rtol=1e-9, atol=1e-12)
N_ENT, N_REL, B, K = 40, 6, 9, 5
# AttRH splits the rank into four, IFFTH needs rank//2 + 1 even
RANKS = {"AttRH": 8, "IFFTH": 6}


def _pair(name, *, multi_c=True, bias="learn", seed=0):
    cfg = dict(n_entities=N_ENT, n_relations=N_REL, rank=RANKS.get(name, 6), bias=bias,
               gamma=0.5, multi_c=multi_c, dtype="float64")
    jm = jax_get_model(name)(JaxConfig(**cfg))
    shapes = {k: np.shape(v) for k, v in jm.init(jax.random.PRNGKey(0)).items()}
    rng = np.random.default_rng(seed)
    np_params = {k: rng.normal(0.0, 0.2, s) + (1.0 if k == "c" else 0.0)
                 for k, s in shapes.items()}
    tm = get_model(name)(ModelConfig(**cfg))
    tm.load_state_dict(params_from_jax(np_params, "cpu"))
    return jm, {k: jnp.asarray(v) for k, v in np_params.items()}, tm, rng


def _queries(rng, n=B):
    return np.stack([rng.integers(0, N_ENT, n), rng.integers(0, N_REL, n)], axis=1)


def _grads_close(jm, jp, tm, jax_fn, torch_fn, weight):
    """Values and gradients of sum(weight * scores) w.r.t. every param."""
    want, jg = jax.value_and_grad(lambda p: jnp.sum(jax_fn(p) * weight))(jp)
    tm.zero_grad()
    out = torch.sum(torch_fn() * torch.as_tensor(weight))
    out.backward()
    np.testing.assert_allclose(out.item(), float(want), **TOL)
    for k, p in tm.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad  # unused: bias off
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), err_msg=k, **TOL)


def test_registry_holds_every_hyperbolic_model():
    assert HYP_MODELS == JAX_HYP_MODELS
    assert [m for m in all_models if m in HYP_MODELS] == HYP_MODELS
    for name in HYP_MODELS:
        assert get_model(name).__name__ == name


@pytest.mark.parametrize("multi_c", [False, True])
@pytest.mark.parametrize("name", HYP_MODELS)
def test_score_all_and_grads_match_jax(name, multi_c):
    jm, jp, tm, rng = _pair(name, multi_c=multi_c)
    q = _queries(rng)
    want = np.asarray(jm.score_all(jp, jnp.asarray(q)))
    got = tm.score_all(torch.as_tensor(q))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    w = rng.normal(size=want.shape)
    _grads_close(jm, jp, tm, lambda p: jm.score_all(p, jnp.asarray(q)),
                 lambda: tm.score_all(torch.as_tensor(q)), w)


@pytest.mark.parametrize("bias", ["learn", "constant", "none"])
@pytest.mark.parametrize("name", HYP_MODELS)
def test_score_and_grads_match_jax(name, bias):
    jm, jp, tm, rng = _pair(name, bias=bias, seed=1)
    q = _queries(rng)
    t = rng.integers(0, N_ENT, (B, K))
    want = np.asarray(jm.score(jp, jnp.asarray(q), jnp.asarray(t)))
    got = tm.score(torch.as_tensor(q), torch.as_tensor(t))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    w = rng.normal(size=want.shape)
    _grads_close(jm, jp, tm, lambda p: jm.score(p, jnp.asarray(q), jnp.asarray(t)),
                 lambda: tm.score(torch.as_tensor(q), torch.as_tensor(t)), w)


@pytest.mark.parametrize("name", HYP_MODELS)
def test_init_shapes_equal_jax_params(name):
    """state_dict keys, shapes and dtypes equal the JAX params', so a JAX
    checkpoint loads one to one."""
    cfg = dict(n_entities=11, n_relations=4, rank=RANKS.get(name, 8), dtype="float32",
               multi_c=True)
    jp = jax_get_model(name)(JaxConfig(**cfg)).init(jax.random.PRNGKey(0))
    tm = get_model(name)(ModelConfig(**cfg), generator=torch.Generator().manual_seed(0))
    np_t = params_to_jax(tm.state_dict())
    assert sorted(np_t) == sorted(jp)
    for k, v in jp.items():
        assert np_t[k].shape == v.shape and np_t[k].dtype == np.asarray(v).dtype, k


@pytest.mark.parametrize("name,col", [("IsoH", slice(6, None)), ("RotLH", slice(6, None)),
                                      ("HyboNet", slice(-1, None))])
def test_init_post_sets_ones(name, col):
    """IsoH's and RotLH's scaling halves and HyboNet's scale column start
    at 1, as in JAX (a JAX init gives the same ones)."""
    cfg = dict(n_entities=11, n_relations=4, rank=6, init_size=0.1)
    tm = get_model(name)(ModelConfig(**cfg), generator=torch.Generator().manual_seed(2))
    jp = jax_get_model(name)(JaxConfig(**cfg)).init(jax.random.PRNGKey(0))
    rd = tm.rel_diag.detach()
    assert torch.equal(rd[:, col], torch.ones_like(rd[:, col]))
    np.testing.assert_array_equal(np.asarray(jp["rel_diag"])[:, col], 1.0)
    rest = rd[:, : (rd.shape[1] - 1 if name == "HyboNet" else 6)]
    assert not torch.equal(rest, torch.ones_like(rest))


def test_hybonet_rel_diag_init_is_normal_mean_minus_one():
    cfg = ModelConfig(n_entities=5, n_relations=400, rank=6)
    tm = get_model("HyboNet")(cfg, generator=torch.Generator().manual_seed(0))
    body = tm.rel_diag.detach()[:, :-1]
    assert abs(body.mean().item() + 1.0) < 0.05 and abs(body.std().item() - 1.0) < 0.05


def test_single_c_softplus_split():
    """Without multi_c, BaseH / BaseLorentz softplus the shared curvature
    and IFFTH takes the raw weight."""
    for name, soft in (("RotH", True), ("RotLH", True), ("IFFTH", False)):
        tm = get_model(name)(ModelConfig(n_entities=5, n_relations=2, rank=6))
        c = tm.curvature(torch.tensor([0, 1])).detach()
        want = np.log1p(np.e) if soft else 1.0
        assert c.shape == (1, 1) and abs(c.item() - want) < 1e-6, name


@pytest.mark.parametrize("rank", [5, 8])
def test_iffth_rank_must_give_even_bins(rank):
    with pytest.raises(ValueError, match="IFFTH requires rank even"):
        get_model("IFFTH")(ModelConfig(n_entities=5, n_relations=2, rank=rank))
