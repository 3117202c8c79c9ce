"""The port's message-passing primitives (models/gnn/message.py) against
the JAX package's, in float64 on the CPU: the same numpy inputs through
both, values and gradients at rtol 1e-9.  Where JAX sums over a sorted
index, the port is given that index's K9 closure (SortedSegmentSum,
SortedHalves), whose plain version runs here; the sorted-halves forms must
equal the unsorted ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.kernels.segsum import SortedSegmentSum
from complexhyperbolickge_torch.models.gnn import message as M
from complexhyperbolickge_tpu.models.gnn import message as JM

TOL = dict(rtol=1e-9, atol=1e-12)
E, N = 120, 25


def inputs(seed=0, h=5):
    """An (E,) index whose halves are each sorted, an unsorted one, values
    (E, h), a 0/1 edge weight with zeros, all float64."""
    rng = np.random.default_rng(seed)
    halves = np.concatenate([np.sort(rng.integers(0, N, E // 2)),
                             np.sort(rng.integers(0, N - 3, E // 2))])  # N-3.. empty
    tail = rng.integers(0, N, E)
    vals = rng.normal(size=(E, h))
    w = (rng.random(E) > 0.3).astype(np.float64)
    return halves, tail, vals, w


def t(a):
    return torch.as_tensor(a)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("trailing", [(), (5,), (3, 4)])
def test_segment_sum_unsorted_and_sorted(trailing):
    _, tail, _, _ = inputs()
    rng = np.random.default_rng(1)
    src = rng.normal(size=(E, *trailing))
    close(M.segment_sum(t(src), t(tail), N),
          JM.segment_sum(jnp.asarray(src), jnp.asarray(tail), N))
    srt = np.sort(tail)
    want = JM.segment_sum(jnp.asarray(src), jnp.asarray(srt), N, indices_are_sorted=True)
    close(M.segment_sum(t(src), SortedSegmentSum(srt, N, "cpu"), N), want)
    # the raw sorted index is the same sum through index_add_
    close(M.segment_sum(t(src), t(srt), N), want)


def test_segment_max_and_mean():
    _, tail, vals, _ = inputs()
    tail = np.where(tail == 3, 4, tail)  # segment 3 empty: -inf, as in JAX
    close(M.segment_max(t(vals), t(tail), N),
          JM.segment_max(jnp.asarray(vals), jnp.asarray(tail), N))
    close(M.segment_mean(t(vals), t(tail), N),
          JM.segment_mean(jnp.asarray(vals), jnp.asarray(tail), N))


@pytest.mark.parametrize("sorted_", [False, True])
def test_compute_norm(sorted_):
    _, tail, _, w = inputs()
    idx = np.sort(tail) if sorted_ else tail
    index = SortedSegmentSum(idx, N, "cpu") if sorted_ else t(idx)
    close(M.compute_norm(index, t(w), N),
          JM.compute_norm(jnp.asarray(idx), jnp.asarray(w), N, indices_are_sorted=sorted_))


def test_sorted_halves_equal_jax_and_the_unsorted_forms():
    halves, _, vals, w = inputs()
    sh = M.SortedHalves(t(halves), N)
    want = JM.segment_sum_sorted_halves(jnp.asarray(vals), jnp.asarray(halves), N)
    close(sh(t(vals)), want)
    close(M.segment_sum(t(vals), sh, N), want)
    close(M.segment_sum(t(vals), t(halves), N), want)
    want_n = JM.compute_norm_sorted_halves(jnp.asarray(halves), jnp.asarray(w), N)
    close(M.compute_norm(sh, t(w), N), want_n)
    close(M.compute_norm(t(halves), t(w), N), want_n)


@pytest.mark.parametrize("normalize_to_1", [True, False])
@pytest.mark.parametrize("head_sorted_halves", [False, True])
def test_compute_symmetric_norm(normalize_to_1, head_sorted_halves):
    halves, tail, _, w = inputs()
    head = M.SortedHalves(t(halves), N) if head_sorted_halves else t(halves)
    got = M.compute_symmetric_norm(head, t(tail), t(w), N, normalize_to_1=normalize_to_1)
    want = JM.compute_symmetric_norm(jnp.asarray(halves), jnp.asarray(tail), jnp.asarray(w),
                                     N, normalize_to_1=normalize_to_1,
                                     head_sorted_halves=head_sorted_halves)
    close(got, want)


def test_gradients_through_the_sorted_sums_equal_jax():
    """d/d(vals, w) of a scalar of the symmetric norm and the sorted-halves
    aggregate: K9's backward is K10, the gather of K10's is K9."""
    halves, tail, vals, w = inputs()
    g = np.random.default_rng(3).normal(size=(N, vals.shape[1]))
    sh = M.SortedHalves(t(halves), N)

    def port(v, ww):
        norm = M.compute_symmetric_norm(sh, t(tail), ww, N)
        return torch.sum(sh(norm[:, None] * v) * t(g))

    def jax_f(v, ww):
        norm = JM.compute_symmetric_norm(jnp.asarray(halves), jnp.asarray(tail), ww, N,
                                         head_sorted_halves=True)
        return jnp.sum(JM.segment_sum_sorted_halves(norm[:, None] * v, jnp.asarray(halves), N)
                       * jnp.asarray(g))

    tv, tw = t(vals).requires_grad_(), t(w).requires_grad_()
    port(tv, tw).backward()
    jv, jw = jax.grad(jax_f, argnums=(0, 1))(jnp.asarray(vals), jnp.asarray(w))
    close(tv.grad, jv)
    close(tw.grad, jw)


def test_edge_dropout_mask_and_dropout():
    assert torch.equal(M.edge_dropout_mask(None, 7, 0.5), torch.ones(7))
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(M.edge_dropout_mask(gen, 7, 0.0, torch.float64), torch.ones(7, dtype=torch.float64))
    mask = M.edge_dropout_mask(gen, 20_000, 0.3, torch.float64)
    assert set(mask.unique().tolist()) == {0.0, 1.0}
    assert abs(float(mask.mean()) - 0.7) < 0.02
    x = torch.randn(200, 50, generator=gen)
    assert M.dropout(None, x, 0.5) is x and M.dropout(gen, x, 0.0) is x
    y = M.dropout(gen, x, 0.25)
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / 0.75)
    assert abs(float(kept.double().mean()) - 0.75) < 0.02
    # the same generator state gives the same draws
    a = M.edge_dropout_mask(torch.Generator().manual_seed(5), 100, 0.3)
    b = M.edge_dropout_mask(torch.Generator().manual_seed(5), 100, 0.3)
    assert torch.equal(a, b)


def test_full_graph_layout_and_closures():
    halves, tail, vals, _ = inputs()
    etype = np.arange(E) % 4
    g = M.FullGraph(halves, tail, etype, N, "cpu")
    assert g.half == E // 2 and g.head.dtype == torch.int64
    x = torch.as_tensor(np.random.default_rng(4).normal(size=(N, 3)))
    for i in (0, 1):
        sl = g.half_slice(i)
        assert torch.equal(g.tail_gathers[i](x), x[g.tail[sl]])
        close(g.heads.halves[i](t(vals[sl])), JM.segment_sum(
            jnp.asarray(vals[sl]), jnp.asarray(halves[sl]), N))
    with pytest.raises(ValueError, match="sorted"):
        M.FullGraph(tail, tail, etype, N, "cpu")  # halves not sorted
