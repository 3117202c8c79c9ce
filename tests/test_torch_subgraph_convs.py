"""Each GNN conv's masked (subgraph) forward in the port
(models/gnn/convs.py::forward_masked) against the JAX conv's apply_masked,
in float64 on the CPU: CompGCN add and mult, PoincareConv methods 1-3,
LorentzConv (its swapped relation types), GAT mean and concat.  JAX's init
perturbed by numpy noise goes into both; unsorted edges of both directions
(dir_w 1 for a forward type), an edge weight with dropped edges and a
node_w with padded rows (CompGCN's batch norm) go through both; outputs and
the gradients of a scalar of them w.r.t. every parameter, x and the
relation inputs agree at rtol 1e-9, with an absolute floor of 1e-9 times
the array's largest magnitude (index_add_ and XLA's scatter sum in other
orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.models.gnn import convs as C
from complexhyperbolickge_torch.ops.math import tanh
from complexhyperbolickge_torch.train.checkpoint import params_from_jax
from complexhyperbolickge_tpu.models.gnn import convs as JC
from complexhyperbolickge_tpu.ops.math import tanh as jtanh

N_ENT, N_REL, N_EDGES = 30, 8, 120  # N_REL with inverses


def close(got, want, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-9,
                               atol=1e-9 * max(1.0, float(np.abs(want).max())), err_msg=name)


# name -> (JAX conv, port conv, d_in, d_out, hyperbolic)
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


def masked_layout(seed=0):
    """Unsorted edges of both directions (dir_w 1 for a forward type), a
    weight with dropped (0) edges, and node_w with padded rows."""
    rng = np.random.default_rng(seed)
    head, tail = rng.integers(0, N_ENT - 4, N_EDGES), rng.integers(0, N_ENT - 4, N_EDGES)
    etype = rng.integers(0, N_REL, N_EDGES)
    dir_w = (etype < N_REL // 2).astype(np.float64)
    edge_w = (rng.random(N_EDGES) > 0.25).astype(np.float64)
    node_w = (np.arange(N_ENT) < N_ENT - 4).astype(np.float64)
    return head, tail, etype, edge_w, dir_w, node_w


@pytest.mark.parametrize("case", list(CASES))
def test_forward_masked_matches_jax_apply_masked(case):
    jcls, tcls, d_in, d_out, hyp = CASES[case]
    d_in_r, d_out_r = (3 * d_in, 3 * d_out) if hyp else (d_in, d_out)
    jconv = jcls(d_in, d_out, d_in_r, d_out_r, jtanh, 0.5)
    tconv = tcls(d_in, d_out, d_in_r, d_out_r, tanh, 0.5, dtype=torch.float64)
    rng = np.random.default_rng(7)
    p = jax.tree.map(lambda v: np.asarray(v, np.float64) + rng.normal(0, 0.1, np.shape(v)),
                     jconv.init(jax.random.PRNGKey(1)))
    tconv.load_state_dict(params_from_jax(p, "cpu"))

    head, tail, etype, edge_w, dir_w, node_w = masked_layout()
    x = rng.normal(0, 0.3, (N_ENT, d_in))
    rel = rng.normal(0, 0.3, (N_REL, d_in_r))
    curv = rng.normal(0, 1.0, (N_REL, 1))
    gs = [rng.normal(size=s) for s in [(N_ENT, d_out), (N_REL, d_out_r)]]

    def jax_scalar(p, x, rel, curv):
        out, rp = jconv.apply_masked(p, x, tuple(map(jnp.asarray, (head, tail, etype))),
                                     (rel, curv) if hyp else rel, jnp.asarray(edge_w),
                                     jnp.asarray(dir_w), jnp.asarray(node_w))
        r_out = rp[0] if hyp else rp
        return jnp.sum(out * gs[0]) + jnp.sum(r_out * gs[1]), (out, rp)

    (_, (jout, jrp)), jgrads = jax.jit(jax.value_and_grad(jax_scalar, argnums=(0, 1, 2, 3),
                                                          has_aux=True))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(rel), jnp.asarray(curv))

    tx, trel, tcurv = (torch.as_tensor(a).requires_grad_() for a in (x, rel, curv))
    edges = tuple(torch.as_tensor(a) for a in (head, tail, etype))
    out, rp = tconv.forward_masked(tx, edges, (trel, tcurv) if hyp else trel,
                                   *map(torch.as_tensor, (edge_w, dir_w, node_w)))
    r_out = rp[0] if hyp else rp
    (torch.sum(out * torch.as_tensor(gs[0]))
     + torch.sum(r_out * torch.as_tensor(gs[1]))).backward()

    close(out.detach(), jout)
    close(r_out.detach(), jrp[0] if hyp else jrp)
    if hyp:
        close(rp[1].detach(), jrp[1])
    want = params_from_jax(jax.tree.map(np.asarray, jgrads[0]), "cpu")
    for name, prm in tconv.named_parameters():
        close(torch.zeros_like(prm) if prm.grad is None else prm.grad, want[name], name)
    close(tx.grad, jgrads[1])
    close(trel.grad, jgrads[2])
    if hyp:
        close(tcurv.grad, jgrads[3])
