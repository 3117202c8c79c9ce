"""The four FFT models of complexhyperbolickge_torch against the JAX models.

Params are drawn with numpy at the JAX param_specs shapes and injected into
both packages (params_from_jax), so score and score_all compare in f64 with
atol = rtol = 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.models import ModelConfig, get_model
from complexhyperbolickge_torch.train.checkpoint import params_from_jax, params_to_jax
from complexhyperbolickge_tpu.models import ModelConfig as JaxConfig
from complexhyperbolickge_tpu.models import get_model as jax_get_model

TOL = dict(atol=1e-10, rtol=1e-10)
MODELS = ["FFTRotH", "FFTRefH", "FFTAttH", "FFTIsoH"]


def _pair(name, *, multi_c=True, bias="learn", rank=6, n_ent=40, n_rel=6,
          dtype="float64", seed=0):
    cfg = dict(n_entities=n_ent, n_relations=n_rel, rank=rank, bias=bias,
               gamma=0.5, multi_c=multi_c, dtype=dtype)
    jm = jax_get_model(name)(JaxConfig(**cfg))
    shapes = {k: np.shape(v) for k, v in jm.init(jax.random.PRNGKey(0)).items()}
    rng = np.random.default_rng(seed)
    np_params = {k: rng.normal(0.0, 0.2, s) + (1.0 if k == "c" else 0.0)
                 for k, s in shapes.items()}
    np_params = {k: v.astype(dtype) for k, v in np_params.items()}
    tm = get_model(name)(ModelConfig(**cfg))
    tm.load_state_dict(params_from_jax(np_params, "cpu"))
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    return jm, jp, tm, rng


@pytest.mark.parametrize("multi_c", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_score_all_matches_jax(name, multi_c):
    jm, jp, tm, rng = _pair(name, multi_c=multi_c)
    q = np.stack([rng.integers(0, 40, 9), rng.integers(0, 6, 9)], axis=1)
    want = np.asarray(jm.score_all(jp, jnp.asarray(q)))
    got = tm.score_all(torch.as_tensor(q)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("bias", ["learn", "constant", "none"])
@pytest.mark.parametrize("name", MODELS)
def test_score_matches_jax(name, bias):
    jm, jp, tm, rng = _pair(name, bias=bias)
    q = np.stack([rng.integers(0, 40, 7), rng.integers(0, 6, 7)], axis=1)
    t = rng.integers(0, 40, (7, 5))
    want = np.asarray(jm.score(jp, jnp.asarray(q), jnp.asarray(t)))
    got = tm.score(torch.as_tensor(q), torch.as_tensor(t)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", MODELS)
def test_state_dict_keys_equal_jax_params(name):
    """state_dict keys, shapes and dtypes equal the JAX params', so a JAX
    checkpoint loads one to one."""
    cfg = dict(n_entities=11, n_relations=4, rank=4, dtype="float32")
    jp = jax_get_model(name)(JaxConfig(**cfg)).init(jax.random.PRNGKey(0))
    tm = get_model(name)(ModelConfig(**cfg), generator=torch.Generator().manual_seed(0))
    np_t = params_to_jax(tm.state_dict())
    assert sorted(np_t) == sorted(jp)
    for k, v in jp.items():
        assert np_t[k].shape == v.shape and np_t[k].dtype == np.asarray(v).dtype, k


def test_init_is_seeded_and_device_explicit():
    cfg = ModelConfig(n_entities=20, n_relations=4, rank=5, init_size=0.1)
    a = get_model("FFTRotH")(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = get_model("FFTRotH")(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert torch.equal(a.c, torch.ones_like(a.c))
    assert torch.equal(a.bh, torch.zeros_like(a.bh))
    assert a.rel_diag.abs().max() <= 1.0


def test_fftisoh_needs_even_rank():
    with pytest.raises(ValueError, match="even rank"):
        get_model("FFTIsoH")(ModelConfig(n_entities=5, n_relations=2, rank=5))


@pytest.mark.parametrize("name", ["RotE", "TransE", "ComplEx", "RefE", "nope"])
def test_unported_models_raise_with_roadmap_pointer(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model(name)


def test_forward_is_score_all_or_score():
    _, _, tm, rng = _pair("FFTRotH")
    q = torch.as_tensor(np.stack([rng.integers(0, 40, 3), rng.integers(0, 6, 3)], 1))
    t = torch.as_tensor(rng.integers(0, 40, (3, 4)))
    torch.testing.assert_close(tm(q), tm.score_all(q))
    torch.testing.assert_close(tm(q, t), tm.score(q, t))
