"""The train-mode distance kernels K3/K4 (kernels/chyp_train.py).

On the CPU: the plain version (float32) against the JAX Pallas kernel in
interpret mode, at a B that is not a multiple of its 64-row tile, to the
JAX kernel test's tolerances (forward rtol 1e-5; gradients rtol 1e-4, atol
1e-6), in the clamped-at-init (1e-3) and the unclamped (0.4) regimes.

On a card (the `cuda` marker; these skip without one): the CUDA kernels
against the plain version on the card at the same tolerances, at ragged
shapes and the WN18RR train shape (500, 100, 66).  They need no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_chyp_train.py
"""

import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.kernels import chyp_train as CT
from complexhyperbolickge_torch.ops import chyperbolic as CH

FWD_TOL = dict(rtol=1e-5, atol=0.0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
SCALES = [0.4, 1e-3]


def make_pair(b, k, d, scale, seed=1):
    r = np.random.default_rng(seed)
    lhs = r.normal(0, scale, (b, d)).astype(np.float32)
    rhs = r.normal(0, scale, (b, k, d)).astype(np.float32)
    g = r.normal(size=(b, k)).astype(np.float32)
    return lhs, rhs, g


def value_and_grads(fn, lhs, rhs, g, device="cpu"):
    l = torch.tensor(lhs, device=device, requires_grad=True)
    r = torch.tensor(rhs, device=device, requires_grad=True)
    d = fn(l, r)
    (d * torch.tensor(g, device=device)).sum().backward()
    return [t.detach().cpu().numpy() for t in (d, l.grad, r.grad)]


@pytest.mark.parametrize("scale", SCALES)
def test_plain_matches_jax_pallas_interpret(scale, monkeypatch):
    jax = pytest.importorskip("jax")
    from complexhyperbolickge_tpu.kernels import chyp_train as jax_ct

    monkeypatch.setattr(jax_ct, "INTERPRET", True)
    lhs, rhs, g = make_pair(70, 7, 18, scale)  # B = 70: the JAX padding path

    def f(l, r):
        return jax.numpy.sum(jax_ct.chyp_train_distance(l, r) * g)

    want_d = np.asarray(jax_ct.chyp_train_distance(lhs, rhs))
    want_gl, want_gr = jax.grad(f, argnums=(0, 1))(lhs, rhs)
    got_d, got_gl, got_gr = value_and_grads(CT.chyp_train_distance_plain, lhs, rhs, g)
    np.testing.assert_allclose(got_d, want_d, **FWD_TOL)
    np.testing.assert_allclose(got_gl, np.asarray(want_gl), **GRAD_TOL)
    np.testing.assert_allclose(got_gr, np.asarray(want_gr), **GRAD_TOL)


@pytest.mark.parametrize("scale", SCALES)
def test_cpu_wrapper_is_the_plain_version_and_launches_nothing(scale):
    lhs, rhs, g = make_pair(5, 3, 10, scale)
    CT.reset_launches()
    got = value_and_grads(CT.chyp_train_distance, lhs, rhs, g)
    want = value_and_grads(CT.chyp_train_distance_plain, lhs, rhs, g)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert CT.launches == {"chyp_train_fwd": 0, "chyp_train_bwd": 0}


def test_plain_forward_matches_distance_core():
    """The plain version is ChypDistanceCore with acosh as log(x + sqrt(x^2-1))."""
    lhs, rhs, g = make_pair(6, 4, 12, 0.2)
    plain = value_and_grads(CT.chyp_train_distance_plain, lhs, rhs, g)
    core = value_and_grads(CH.ChypDistanceCore.apply, lhs, rhs, g)
    for a, b in zip(plain, core):
        np.testing.assert_allclose(a, b, **FWD_TOL)


# ------------------------------- on the card ----------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("shape", [(500, 100, 66), (37, 7, 18), (3, 1, 70), (64, 33, 2)])
def test_kernels_match_plain_on_card(shape, scale):
    dev = _cuda_or_skip()
    lhs, rhs, g = make_pair(*shape, scale)
    CT.reset_launches()
    got = value_and_grads(CT.chyp_train_distance, lhs, rhs, g, dev)
    torch.cuda.synchronize()
    assert CT.launches == {"chyp_train_fwd": 1, "chyp_train_bwd": 1}
    want = value_and_grads(CT.chyp_train_distance_plain, lhs, rhs, g, dev)
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL)
    np.testing.assert_allclose(got[1], want[1], **GRAD_TOL)
    np.testing.assert_allclose(got[2], want[2], **GRAD_TOL)


@pytest.mark.cuda
def test_dispatcher_routes_train_shape_to_kernel():
    dev = _cuda_or_skip()
    lhs, rhs, g = make_pair(8, 5, 18, 0.2)
    l = torch.tensor(lhs, device=dev)
    r = torch.tensor(rhs, device=dev)
    CT.reset_launches()
    CH.chyp_distance(l[:, None, :], r)
    CH.chyp_distance(l.double()[:, None, :], r.double())  # float64: the core
    CH.chyp_distance(l, r[:, 0])  # not the train shape
    assert CT.launches["chyp_train_fwd"] == 1


@pytest.mark.cuda
def test_backward_is_deterministic_and_checks_inputs():
    dev = _cuda_or_skip()
    lhs, rhs, g = make_pair(50, 20, 66, 0.4)
    a = value_and_grads(CT.chyp_train_distance, lhs, rhs, g, dev)
    b = value_and_grads(CT.chyp_train_distance, lhs, rhs, g, dev)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    l = torch.tensor(lhs, device=dev)
    r = torch.tensor(rhs, device=dev)
    with pytest.raises(TypeError, match="dtype"):
        CT.chyp_train_forward(l.double(), r.double())
    with pytest.raises(ValueError, match="is on"):
        CT.chyp_train_forward(l, r.cpu())
    with pytest.raises(ValueError, match="D even"):
        CT.chyp_train_forward(l[:, :65].contiguous(), r[..., :65].contiguous())
