"""Each GNN conv of the port (models/gnn/convs.py) against the JAX conv's
full-graph apply, in float64 on the CPU: JAX's init perturbed by numpy
noise is injected into both, the same x, relation pack and an edge weight
with zeros (dropped edges) go through both, and the outputs and the
gradients of a scalar of them (w.r.t. every parameter, x and the relation
inputs) agree at rtol 1e-9, with an absolute floor of 1e-9 times the
array's largest magnitude: sums with cancellation (the per-head einsums'
gradients) round differently in another order.  The port's gathers and
sorted sums run K10's and K9's plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.models.gnn import convs as C
from complexhyperbolickge_torch.models.gnn.message import FullGraph
from complexhyperbolickge_torch.ops.math import tanh
from complexhyperbolickge_torch.train.checkpoint import params_from_jax
from complexhyperbolickge_tpu.models.gnn import convs as JC
from complexhyperbolickge_tpu.ops.math import tanh as jtanh

N_ENT, N_REL, N_FWD = 30, 8, 100  # N_REL with inverses


def close(got, want, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9,
                               atol=1e-9 * max(1.0, float(np.abs(want).max())), err_msg=name)


def layout(seed=0):
    """[forward; inverse] edges, each half sorted by its receiving node, as
    GNNModel builds them."""
    rng = np.random.default_rng(seed)
    h, r, t = (rng.integers(0, N_ENT, N_FWD), rng.integers(0, N_REL // 2, N_FWD),
               rng.integers(0, N_ENT, N_FWD))
    pf, pi = np.argsort(h, kind="stable"), np.argsort(t, kind="stable")
    head = np.concatenate([h[pf], t[pi]])
    tail = np.concatenate([t[pf], h[pi]])
    etype = np.concatenate([r[pf], r[pi] + N_REL // 2])
    w = (rng.random(2 * N_FWD) > 0.25).astype(np.float64)
    return head, tail, etype, w


# name -> (JAX conv, port conv, d_in, d_out, hyperbolic): CompGCN's relation
# input is (Nr, d_in); the others' pack is (rel (Nr, 3 d_in), raw curvature
# (Nr, 1))
CASES = {
    "compgcn_mult": (lambda *a: JC.CompGCNConv(*a, opn="mult"),
                     lambda *a, **k: C.CompGCNConv(*a, opn="mult", **k), 6, 8, False),
    "compgcn_add": (lambda *a: JC.CompGCNConv(*a, opn="add"),
                    lambda *a, **k: C.CompGCNConv(*a, opn="add", **k), 6, 6, False),
    "poincare_1": (lambda *a: JC.PoincareConv(*a, agg_method=1),
                   lambda *a, **k: C.PoincareConv(*a, agg_method=1, **k), 4, 8, True),
    "poincare_2": (lambda *a: JC.PoincareConv(*a, agg_method=2),
                   lambda *a, **k: C.PoincareConv(*a, agg_method=2, **k), 4, 8, True),
    "poincare_3": (lambda *a: JC.PoincareConv(*a, agg_method=3),
                   lambda *a, **k: C.PoincareConv(*a, agg_method=3, **k), 4, 8, True),
    "lorentz": (JC.LorentzConv, C.LorentzConv, 4, 8, True),
    "gat_mean": (lambda *a: JC.PoincareGATConv(*a, gather="mean"),
                 lambda *a, **k: C.PoincareGATConv(*a, gather="mean", **k), 4, 8, True),
    "gat_concat": (lambda *a: JC.PoincareGATConv(*a, gather="concat"),
                   lambda *a, **k: C.PoincareGATConv(*a, gather="concat", **k), 4, 8, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_conv_matches_jax_apply_and_gradients(case):
    jcls, tcls, d_in, d_out, hyp = CASES[case]
    d_in_r, d_out_r = (3 * d_in, 3 * d_out) if hyp else (d_in, d_out)
    # a hidden layer: tanh activation, dropout rate set but no key / generator
    jconv = jcls(d_in, d_out, d_in_r, d_out_r, jtanh, 0.5)
    tconv = tcls(d_in, d_out, d_in_r, d_out_r, tanh, 0.5, dtype=torch.float64)
    rng = np.random.default_rng(7)
    p = jax.tree.map(lambda v: np.asarray(v, np.float64) + rng.normal(0, 0.1, np.shape(v)),
                     jconv.init(jax.random.PRNGKey(1)))
    tconv.load_state_dict(params_from_jax(p, "cpu"))

    head, tail, etype, w = layout()
    x = rng.normal(0, 0.3, (N_ENT, d_in))
    rel = rng.normal(0, 0.3, (N_REL, d_in_r))
    curv = rng.normal(0, 1.0, (N_REL, 1))
    outs = [(N_ENT, d_out), (N_REL, d_out_r)]
    gs = [rng.normal(size=s) for s in outs]

    def jax_scalar(p, x, rel, curv):
        pack = (rel, curv) if hyp else rel
        out, rp = jconv.apply(p, x, tuple(map(jnp.asarray, (head, tail, etype))), pack,
                              jnp.asarray(w))
        r_out = rp[0] if hyp else rp
        return jnp.sum(out * gs[0]) + jnp.sum(r_out * gs[1]), (out, rp)

    (_, (jout, jrp)), jgrads = jax.jit(jax.value_and_grad(jax_scalar, argnums=(0, 1, 2, 3),
                                                          has_aux=True))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(rel), jnp.asarray(curv))

    graph = FullGraph(head, tail, etype, N_ENT, "cpu")
    tx, trel, tcurv = (torch.as_tensor(a).requires_grad_() for a in (x, rel, curv))
    out, rp = tconv(tx, graph, (trel, tcurv) if hyp else trel, torch.as_tensor(w))
    r_out = rp[0] if hyp else rp
    (torch.sum(out * torch.as_tensor(gs[0])) + torch.sum(r_out * torch.as_tensor(gs[1]))).backward()

    close(out.detach(), jout)
    close(r_out.detach(), jrp[0] if hyp else jrp)
    if hyp:  # the raw curvature output, before softplus
        close(rp[1].detach(), jrp[1])
    want = params_from_jax(jax.tree.map(np.asarray, jgrads[0]), "cpu")
    for name, prm in tconv.named_parameters():
        # a parameter the aggregation method leaves unused has no gradient
        close(torch.zeros_like(prm) if prm.grad is None else prm.grad, want[name], name)
    close(tx.grad, jgrads[1])
    close(trel.grad, jgrads[2])
    if hyp:
        close(tcurv.grad, jgrads[3])


@pytest.mark.parametrize("case", ["compgcn_mult", "poincare_1", "gat_concat"])
def test_conv_params_match_the_jax_layout_and_init_draws(case):
    """The port's parameter names and shapes are JAX's (state_dict keys are
    its flattened paths), and reset_parameters draws finite values with the
    JAX init kinds (zeros / ones where JAX has them)."""
    jcls, tcls, d_in, d_out, hyp = CASES[case]
    d_in_r, d_out_r = (3 * d_in, 3 * d_out) if hyp else (d_in, d_out)
    jp = params_from_jax(jax.tree.map(np.asarray, jcls(d_in, d_out, d_in_r, d_out_r, None)
                                      .init(jax.random.PRNGKey(0))), "cpu")
    tconv = tcls(d_in, d_out, d_in_r, d_out_r, None)
    tconv.reset_parameters(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in tconv.state_dict().items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    for k, v in jp.items():
        got = tconv.state_dict()[k]
        assert torch.isfinite(got).all()
        if torch.all(v == 0) or torch.all(v == 1):
            assert torch.equal(got.double(), v.double()), k


@pytest.mark.parametrize("kind", ["MLP", "MonotonicMLP"])
def test_utils_nn_blocks_match_jax(kind):
    """utils/nn.py's MLP and MonotonicMLP with JAX's params injected: the
    same (d_in, d_out) weight layout, outputs and input gradients."""
    from complexhyperbolickge_torch.utils import nn as TN
    from complexhyperbolickge_tpu.utils import nn as JN

    jblock = JN.MLP(5, 7, 3, num_layers=3) if kind == "MLP" else JN.MonotonicMLP(5, 3, 7)
    tblock = (TN.MLP(5, 7, 3, num_layers=3, dtype=torch.float64) if kind == "MLP"
              else TN.MonotonicMLP(5, 3, 7, dtype=torch.float64))
    rng = np.random.default_rng(0)
    p = jax.tree.map(lambda v: np.asarray(v, np.float64) + rng.normal(0, 0.2, np.shape(v)),
                     jblock.init(jax.random.PRNGKey(0)))
    tblock.load_state_dict(params_from_jax(p, "cpu"))
    x = rng.normal(size=(6, 5))
    want, jgrad = jax.value_and_grad(lambda v: jnp.sum(jblock.apply(p, v) ** 2))(jnp.asarray(x))
    tx = torch.as_tensor(x).requires_grad_()
    got = torch.sum(tblock(tx) ** 2)
    got.backward()
    close(got.detach(), want)
    close(tx.grad, jgrad)
    tblock.reset_parameters(torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v).all() for v in tblock.state_dict().values())
