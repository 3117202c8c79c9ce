"""K9 (kernels/segsum.py) and K10 (kernels/gather.py) on the CPU: their
plain versions against the JAX Pallas kernels in interpret mode, and the
autograd closures the GNN encoder uses.

  * K9: make_sorted_segment_sum's plain route against the JAX
    make_sorted_segment_sum(..., interpret=True) on tests/
    test_segsum_kernel.py's shapes, at its float32 tolerance (1e-5), with
    the gradient against jax.grad.
  * K10: row_gather's plain route against pallas_row_gather(...,
    interpret=True)[:, :H], exactly, on tests/test_gather_kernel.py's
    shapes, with the gather's gradient against JAX autodiff of x[ids].
The closures' backwards (K9's is K10, K10's is K10 by the sorting
permutation then K9) equal index_add_ in float64.  Nothing launches on the
CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complexhyperbolickge_torch import kernels as KS
from complexhyperbolickge_torch.kernels import gather as G
from complexhyperbolickge_torch.kernels import segsum as S
from complexhyperbolickge_tpu.kernels.gather import pallas_row_gather
from complexhyperbolickge_tpu.kernels.segsum import make_sorted_segment_sum as jax_segsum

F32_TOL = dict(atol=1e-5, rtol=1e-5)  # tests/test_segsum_kernel.py's


@pytest.mark.parametrize("e,n,h,tn,te", [
    (1000, 300, 40, 64, 128),
    (5000, 777, 200, 256, 512),
    (10, 5, 3, 8, 128),
    (512, 256, 128, 256, 512),
])
def test_segsum_plain_matches_the_pallas_kernel(e, n, h, tn, te):
    rng = np.random.default_rng(0)
    dst = np.sort(rng.integers(0, n, e)).astype(np.int32)
    msgs = rng.normal(size=(e, h)).astype(np.float32)
    want = jax_segsum(dst, n, tn=tn, te=te, interpret=True)(jnp.asarray(msgs))
    got = S.make_sorted_segment_sum(dst, n, "cpu")(torch.as_tensor(msgs))
    assert got.shape == (n, h) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("e,n,h,tn,te", [(1000, 300, 40, 64, 128), (5000, 777, 200, 256, 512)])
def test_segsum_plain_bf16_is_the_pallas_kernel_rounded_once(e, n, h, tn, te):
    """bfloat16 messages: the plain version sums in float32 and rounds once,
    what the JAX kernel's float32 output gives cast to bfloat16 (within one
    bfloat16 ulp, 2^-7 relative: the two sum in other orders); its gradient
    (a gather) and K10's closure backward over bfloat16 (a float32 sum
    rounded once) likewise."""
    rng = np.random.default_rng(2)
    dst = np.sort(rng.integers(0, n, e)).astype(np.int32)
    msgs = torch.as_tensor(rng.normal(size=(e, h)), dtype=torch.bfloat16)
    want = jax_segsum(dst, n, tn=tn, te=te, interpret=True)(jnp.asarray(msgs.float().numpy()))
    m = msgs.clone().requires_grad_()
    got = S.make_sorted_segment_sum(dst, n, "cpu")(m)
    assert got.shape == (n, h) and got.dtype == torch.bfloat16
    want_bf16 = torch.as_tensor(np.asarray(want)).to(torch.bfloat16).float()
    torch.testing.assert_close(got.float(), want_bf16, rtol=2 ** -7, atol=1e-6)
    g = torch.as_tensor(rng.normal(size=(n, h)), dtype=torch.bfloat16)
    (got * g).sum().backward()
    assert m.grad.dtype == torch.bfloat16 and torch.equal(m.grad, g[torch.as_tensor(dst).long()])
    ids = rng.integers(0, n, e)
    x = torch.as_tensor(rng.normal(size=(n, h)), dtype=torch.bfloat16).requires_grad_()
    gx = torch.as_tensor(rng.normal(size=(e, h)), dtype=torch.bfloat16)
    out = G.make_row_gather(ids, n, "cpu")(x)
    assert torch.equal(out, x.detach()[torch.as_tensor(ids)])
    (out * gx).sum().backward()
    wide = torch.zeros((n, h)).index_add_(0, torch.as_tensor(ids), gx.float())
    assert x.grad.dtype == torch.bfloat16
    torch.testing.assert_close(x.grad.float(), wide.to(torch.bfloat16).float(),
                               rtol=2 ** -7, atol=1e-6)


def test_segsum_gradient_matches_jax():
    rng = np.random.default_rng(1)
    e, n, h = 700, 90, 32
    dst = np.sort(rng.integers(0, n, e)).astype(np.int32)
    msgs = rng.normal(size=(e, h)).astype(np.float32)
    f = jax_segsum(dst, n, tn=64, te=128, interpret=True)
    want = jax.grad(lambda m: jnp.sum(f(m) ** 2))(jnp.asarray(msgs))
    m = torch.as_tensor(msgs).requires_grad_()
    torch.sum(S.make_sorted_segment_sum(dst, n, "cpu")(m) ** 2).backward()
    np.testing.assert_allclose(m.grad.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n,h,e,chunk", [
    (300, 200, 1024, 256),
    (97, 64, 512, 512),
    (16, 300, 128, 64),
])
def test_row_gather_plain_matches_the_pallas_kernel(n, h, e, chunk):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, h)).astype(np.float32)
    ids = rng.integers(0, n, e).astype(np.int32)
    want = np.asarray(pallas_row_gather(jnp.asarray(ids), jnp.asarray(x), chunk=chunk,
                                        interpret=True))[:, :h]
    got = G.row_gather(torch.as_tensor(x), torch.as_tensor(ids))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(G.make_row_gather(ids, n, "cpu")(torch.as_tensor(x)).numpy(), want)


def test_row_gather_gradient_matches_jax():
    rng = np.random.default_rng(2)
    n, h, e = 50, 16, 400
    x = rng.normal(size=(n, h))
    ids = rng.integers(0, n, e)
    g = rng.normal(size=(e, h))
    want = jax.grad(lambda v: jnp.sum(v[jnp.asarray(ids)] * jnp.asarray(g)))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    torch.sum(G.make_row_gather(ids, n, "cpu")(xt) * torch.as_tensor(g)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("trailing", [(), (6,), (4, 3)])
def test_closures_forward_and_backward_on_the_cpu(trailing):
    """Both closures over any trailing shape: forward equal to index_add_ /
    indexing, backward equal to autograd of the plain forms (K10's through
    the sorted permutation and K9), and no launch counted."""
    rng = np.random.default_rng(3)
    e, n = 300, 40
    dst = np.sort(rng.integers(0, n - 5, e))  # rows n-5.. get no edges
    ids = rng.integers(0, n, e)
    msgs = torch.as_tensor(rng.normal(size=(e, *trailing))).requires_grad_()
    x = torch.as_tensor(rng.normal(size=(n, *trailing))).requires_grad_()
    KS.reset_launches()
    out_s = S.make_sorted_segment_sum(dst, n, "cpu")(msgs)
    out_g = G.make_row_gather(ids, n, "cpu")(x)
    gs, gg = torch.randn_like(out_s), torch.randn_like(out_g)
    ds, dx = torch.autograd.grad((out_s * gs).sum() + (out_g * gg).sum(), (msgs, x))
    ref_s = torch.zeros((n, *trailing), dtype=msgs.dtype).index_add(0, torch.as_tensor(dst), msgs)
    ref_g = x[torch.as_tensor(ids)]
    rs, rx = torch.autograd.grad((ref_s * gs).sum() + (ref_g * gg).sum(), (msgs, x))
    torch.testing.assert_close(out_s, ref_s, rtol=1e-12, atol=1e-12)
    assert torch.equal(out_g, ref_g) and torch.equal(ds, rs)
    torch.testing.assert_close(dx, rx, rtol=1e-12, atol=1e-12)
    assert not (out_s[n - 5:] != 0).any()
    assert sum(KS.launches().values()) == 0


def test_closures_reject_bad_indices():
    with pytest.raises(ValueError, match="sorted"):
        S.make_sorted_segment_sum(np.array([3, 1, 2]), 5, "cpu")
    with pytest.raises(ValueError, match="sorted"):
        S.make_sorted_segment_sum(np.array([1, 2, 5]), 5, "cpu")  # out of range
    with pytest.raises(ValueError, match=r"\[0, 5\)"):
        G.make_row_gather(np.array([0, 7]), 5, "cpu")
    with pytest.raises(ValueError, match="rows"):
        G.make_row_gather(np.array([0, 4]), 5, "cpu")(torch.zeros(4, 2))
    seg = S.make_sorted_segment_sum(np.array([0, 0, 3]), 5, "cpu")
    assert seg.row_ptr.tolist() == [0, 2, 2, 2, 3, 3]
