"""Message-passing primitives: segment reductions, degree norms and the
full-graph edge layout.

Port of complexhyperbolickge_tpu/models/gnn/message.py.  As there, edge
dropout is a 0/1 edge-weight MASK, not edge removal: dropped edges carry
weight 0 through the degree norms and the aggregation, so every shape stays
the same from step to step.

Where JAX passes `indices_are_sorted=True` (or uses its sorted-halves
forms), the port passes the K9 closure of that index (kernels/segsum.py),
built once with the graph, in the index's place.  An `index` argument is
one of
  * an (E,) index tensor: the sum is index_add_ (JAX leaves it to XLA's
    scatter);
  * a `SortedSegmentSum` (K9 closure of one sorted index);
  * a `SortedHalves` (an index whose two halves are each sorted, the
    [forward; inverse] layout, with one K9 closure a half): JAX's
    segment_sum_sorted_halves / compute_norm_sorted_halves are
    segment_sum / compute_norm over it.
`FullGraph` builds the encoder's static layout once: the K9 closures of its
receiving-node halves, the K10 closures (kernels/gather.py) of its
tail gathers and the relation-sorted layouts (kernels/relgrad.py) of its
etype halves.  `relation_rows(table, etype, layout)` is every conv's
per-edge lookup of its relation table: table[etype], whose backward is a
profiler range kge.train.rel_grad (utils/profiling.py::span): the
split-segment kernels over the layout (relgrad.use_kernel: a layout and
a CUDA float32 or float64 table), else autograd's own accumulate into the
table's rows.  Randomness (edge and feature dropout) comes from the
torch.Generator the caller passes; None means no dropout.
"""

from __future__ import annotations

import torch

from complexhyperbolickge_torch.kernels import relgrad
from complexhyperbolickge_torch.kernels.gather import make_row_gather
from complexhyperbolickge_torch.kernels.segsum import SortedSegmentSum, make_sorted_segment_sum
from complexhyperbolickge_torch.utils.profiling import span


class SortedHalves:
    """An (E,) index whose halves [:E//2] and [E//2:] are each sorted, with
    the K9 closure of each half: calling it sums src (E, ...) into
    (num_segments, ...)."""

    def __init__(self, index, num_segments: int):
        h = index.shape[0] // 2
        self.index = index
        self.halves = (make_sorted_segment_sum(index[:h], num_segments, index.device),
                       make_sorted_segment_sum(index[h:], num_segments, index.device))

    def __call__(self, src):
        h = self.index.shape[0] // 2
        return self.halves[0](src[:h]) + self.halves[1](src[h:])


def _ids(index):
    """The index tensor behind any of the index forms."""
    if isinstance(index, SortedHalves):
        return index.index
    if isinstance(index, SortedSegmentSum):
        return index.dst
    return index


class _RelationRows(torch.autograd.Function):
    """table[ids], whose backward runs inside the range kge.train.rel_grad:
    relgrad.relation_grad's two launches over the ids' static layout where
    relgrad.use_kernel says so, else the accumulate that autograd's
    IndexBackward0 runs (relgrad.relation_grad_accumulate: the same bits
    and launches as plain indexing)."""

    @staticmethod
    def forward(ctx, table, ids, layout):
        ctx.save_for_backward(ids)
        ctx.shape = table.shape
        ctx.layout = layout if relgrad.use_kernel(table, layout) else None
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        with span("train.rel_grad"):
            if ctx.layout is not None:
                grad = relgrad.relation_grad(g.contiguous(), ctx.layout, ctx.shape[0])
            else:
                grad = relgrad.relation_grad_accumulate(g, ids, ctx.shape)
        return grad, None, None


def relation_rows(table, etype, layout=None):
    """The rows of a relation table (Nr, ...) at each edge's type (E,) ->
    (E, ...): plain indexing with its backward marked as a phase.  `layout`
    is etype's relgrad.RelationLayout (built once, for a static etype), or
    None."""
    if layout is not None and etype.shape[0] != layout.num_rows:
        raise ValueError(f"etype has {etype.shape[0]} rows, its layout {layout.num_rows}")
    return _RelationRows.apply(table, etype, layout)


def segment_sum(src, index, num_segments: int):
    """Sum the rows of src (E, ...) into (num_segments, ...) by index (any
    index form)."""
    if isinstance(index, (SortedSegmentSum, SortedHalves)):
        return index(src)
    return src.new_zeros((num_segments, *src.shape[1:])).index_add(0, index, src)


def segment_max(src, index, num_segments: int):
    """Max over segments; empty segments give -inf, as jax.ops.segment_max."""
    idx = index.long().reshape(-1, *[1] * (src.dim() - 1)).expand_as(src)
    out = src.new_full((num_segments, *src.shape[1:]), -torch.inf)
    return out.scatter_reduce(0, idx, src, "amax", include_self=True)


def segment_mean(src, index, num_segments: int):
    s = segment_sum(src, index, num_segments)
    cnt = segment_sum(src.new_ones((src.shape[0], 1)), index, num_segments)
    return s / cnt.clamp_min(1.0)


def _inv_deg(deg):
    return torch.where(deg > 0, 1.0 / deg.clamp_min(1e-30), torch.zeros_like(deg))


def compute_norm(head, edge_weight, num_ent: int):
    """Per-edge 1/deg(head) norm.  head: (E,) receiving-node index (any
    index form); edge_weight: (E,) 0/1 mask (or weights)."""
    deg = segment_sum(edge_weight, head, num_ent)
    return _inv_deg(deg)[_ids(head)] * edge_weight


def compute_symmetric_norm(head, tail, edge_weight, num_ent: int,
                           normalize_to_1: bool = True):
    """Symmetric 1/sqrt(deg_i deg_j) norm, optionally re-normalized so each
    node's incoming weights sum to deg/(deg+1).  head: any index form; the
    tail-keyed degree is an unsorted sum (index_add_)."""
    hid = _ids(head)
    deg = (segment_sum(edge_weight, head, num_ent)
           + segment_sum(edge_weight, tail, num_ent) + 1.0)
    deg_inv = 1.0 / torch.sqrt(deg)  # deg >= 1
    norm = deg_inv[hid] * edge_weight * deg_inv[tail]
    if normalize_to_1:
        sum_norm = segment_sum(norm, head, num_ent) + 1.0 / deg
        norm = norm / sum_norm[hid]
    return norm


def edge_dropout_mask(generator, n_edges: int, rate: float, dtype=torch.float32,
                      device=None):
    """Bernoulli keep-mask (keep probability 1 - rate) over edges, drawn
    from `generator` (a generator of `device`); all ones without one."""
    if generator is None or rate <= 0.0:
        return torch.ones((n_edges,), dtype=dtype, device=device)
    keep = torch.rand((n_edges,), generator=generator, device=device) < 1.0 - rate
    return keep.to(dtype)


def dropout(generator, x, rate: float):
    """Inverted dropout (kept values scaled by 1/(1-p)), drawn from
    `generator`; the identity without one."""
    if generator is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class FullGraph:
    """The encoder's static full-graph layout: head, tail and etype (E,)
    int64 on `device` in [forward; inverse] halves, each half sorted by its
    receiving node (head).  Built once with it: `heads`, the SortedHalves
    (K9) of head, `tail_gathers`, the K10 closures of each half's tail
    gather x[tail[half]], and `rel_layouts`, the relgrad.RelationLayout of
    each half's etype."""

    def __init__(self, head, tail, etype, num_nodes: int, device):
        def dev(a):
            return torch.as_tensor(a, dtype=torch.int64).to(device)

        self.head, self.tail, self.etype = dev(head), dev(tail), dev(etype)
        self.half = self.head.shape[0] // 2
        self.heads = SortedHalves(self.head, num_nodes)
        self.tail_gathers = (make_row_gather(self.tail[:self.half], num_nodes, device),
                             make_row_gather(self.tail[self.half:], num_nodes, device))
        self.rel_layouts = (relgrad.RelationLayout(self.etype[:self.half], device),
                            relgrad.RelationLayout(self.etype[self.half:], device))

    def half_slice(self, i: int) -> slice:
        return slice(0, self.half) if i == 0 else slice(self.half, None)
