"""The port's lazy row-sparse Adam (train/sparse_adam.py) against the JAX
package's sparse_adam and torch.optim.SparseAdam, in float64 on the CPU.

Gradients are dense with exactly-zero rows (as the port's tables get them):
a row is touched when any of its entries is nonzero, a 1-D parameter is
masked element-wise, and bias correction counts every step.  Tolerance
against JAX: rtol 1e-9, atol 1e-12; against torch.optim.SparseAdam (the
same arithmetic on sparse gradients): rtol 1e-12, atol 1e-15.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from complexhyperbolickge_torch.train.sparse_adam import SparseAdam
from complexhyperbolickge_torch.train.trainer import F32StateForBF16, make_optimizer
from complexhyperbolickge_tpu.train.sparse_adam import sparse_adam

TOL = dict(rtol=1e-9, atol=1e-12)
LR, STEPS = 2.0**-5, 7


def sparse_grads(rng, shapes, step):
    """Gradients with about half the rows (elements of 1-D params) zero;
    step 3 leaves every row of the first parameter untouched."""
    out = {}
    for i, (k, s) in enumerate(shapes.items()):
        g = rng.normal(0.0, 1.0, s)
        mask = rng.random(s[0]) < 0.5
        g[mask] = 0.0
        if step == 3 and i == 0:
            g[:] = 0.0
        out[k] = g
    return out


@pytest.mark.parametrize("shapes", [{"entity": (12, 4), "bt": (12, 1), "c": (5,)},
                                    {"w": (3, 2, 4)}])
def test_seven_steps_equal_jax_sparse_adam(shapes):
    rng = np.random.default_rng(0)
    init = {k: rng.normal(0.0, 0.3, s) for k, s in shapes.items()}
    tx = sparse_adam(LR)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    js = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.as_tensor(v.copy())) for k, v in init.items()}
    opt = SparseAdam(list(params.values()), lr=LR)
    for step in range(STEPS):
        grads = sparse_grads(rng, shapes, step)
        upd, js = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            p.grad = torch.as_tensor(grads[k])
        opt.step()
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), err_msg=k, **TOL)
        st = opt.state[p]
        assert float(st["step"]) == STEPS == int(js.step)
        np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(js.mu[k]), **TOL)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(js.nu[k]), **TOL)


def test_seven_steps_equal_torch_sparse_adam_on_sparse_embeddings():
    """An nn.Embedding(sparse=True) toy under torch.optim.SparseAdam and a
    dense twin under the port's SparseAdam, fed the same lookups: every
    touched row's gradient is nonzero, so the two agree."""
    torch.manual_seed(0)
    sparse = torch.nn.Embedding(30, 6, sparse=True).double()
    dense = torch.nn.Embedding(30, 6).double()
    dense.weight.data.copy_(sparse.weight.data)
    ref = torch.optim.SparseAdam(sparse.parameters(), lr=LR)
    opt = SparseAdam(dense.parameters(), lr=LR)
    rng = np.random.default_rng(1)
    for _ in range(STEPS):
        ids = torch.as_tensor(rng.integers(0, 30, 9))
        target = torch.as_tensor(rng.normal(size=(9, 6)))
        for emb, o in ((sparse, ref), (dense, opt)):
            o.zero_grad()
            ((emb(ids) - target) ** 2).sum().backward()
            o.step()
    np.testing.assert_allclose(dense.weight.detach().numpy(), sparse.weight.detach().numpy(),
                               rtol=1e-12, atol=1e-15)


def test_untouched_rows_keep_values_and_moments():
    p = torch.nn.Parameter(torch.ones(4, 3, dtype=torch.float64))
    opt = SparseAdam([p], lr=0.1)
    p.grad = torch.ones(4, 3, dtype=torch.float64)
    opt.step()
    m0, v0, p0 = (opt.state[p]["exp_avg"].clone(), opt.state[p]["exp_avg_sq"].clone(),
                  p.detach().clone())
    g = torch.zeros(4, 3, dtype=torch.float64)
    g[1] = 2.0
    p.grad = g
    opt.step()
    rows = [0, 2, 3]
    assert torch.equal(p[rows], p0[rows])
    assert torch.equal(opt.state[p]["exp_avg"][rows], m0[rows])
    assert torch.equal(opt.state[p]["exp_avg_sq"][rows], v0[rows])
    assert not torch.equal(p[1], p0[1])
    assert float(opt.state[p]["step"]) == 2.0


def test_bfloat16_params_keep_float32_state():
    p = torch.nn.Parameter(torch.ones(5, 2, dtype=torch.bfloat16))
    opt = make_optimizer("SparseAdam", 0.01, [p])
    assert isinstance(opt, F32StateForBF16) and isinstance(opt.inner, SparseAdam)
    g = torch.zeros(5, 2, dtype=torch.bfloat16)
    g[0] = 1.0
    p.grad = g
    opt.step()
    st = opt.inner.state[opt.shadow[0]]
    assert st["exp_avg"].dtype == torch.float32
    q = p.detach()
    assert q.dtype == torch.bfloat16 and float(q[0, 0]) < 1.0 and float(q[1, 0]) == 1.0
