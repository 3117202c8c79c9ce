"""The relation table's gradient as a deterministic split-segment sum.

The GNN convs look up their relation tables per edge, `table[etype]`
(models/gnn/message.py::relation_rows).  The backward of that lookup sums
the edge rows' gradient g (E, ...) into the table's rows; over the static
full-graph edge list, whose ids never change, it runs here:

  * `RelationLayout`, built once on the host from the id vector: `perm`
    (E,) int32, the stable permutation that sorts the rows by id; `offsets`
    (n_ids + 1,) int32, each id's first sorted row; `chunks` (n_chunks, 3)
    int32, (start, end, id) runs of at most `chunk_rows` consecutive sorted
    rows of one id; `chunk_ptr` (n_ids + 1,) int32, each id's first chunk.
    `shifted(k)` is the same layout for the ids + k (LorentzConv's and
    PoincareGATConv's swapped types).
  * `relation_grad` launches `relgrad_f32` / `relgrad_f64`
    (csrc/relgrad.cu) for a CUDA float32 or float64 g: each chunk's rows
    summed in sorted order in g's dtype (`relgrad_partial_kernel`), then each
    output row's chunk partials in ascending order in float64, rounded once
    (`relgrad_sum_kernel`; a row with no edges gets 0).  No atomics: two
    runs give the same bits.  A CUDA g of another dtype raises.

For a CPU g, `relation_grad` runs the plain PyTorch version,
`relation_grad_plain`, which splits the sum the same way (index_add_ into
the chunks, then a float64 index_add_ of the partials).
`relation_grad_accumulate` is autograd's own backward of `table[ids]` (a
sort-based index_put_ with accumulate), which relation_rows keeps where
`use_kernel` is false: no layout, a CPU table, or another dtype.

`launches` counts `relation_grad`: calls of the two kernel launches, and
`relation_grad_accumulate`: backward calls that took autograd's
accumulate instead.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from complexhyperbolickge_torch.kernels._build import check_tensor, launch

# since the last reset_launches()
launches = {"relation_grad": 0, "relation_grad_accumulate": 0}

# the instantiations of csrc/relgrad.cu
KERNEL_DTYPES = {torch.float32: "f32", torch.float64: "f64"}

# sorted rows a chunk at most: one warp sums a chunk
CHUNK_ROWS = 128


def reset_launches():
    for k in launches:
        launches[k] = 0


class RelationLayout:
    """The relation-sorted layout of one fixed id vector (E,) on `device`
    (module docstring; the full-graph case: the edge list is static across
    steps).  `num_rows` is E, `num_ids` the largest id + 1; `shift` is added
    to every id (0 as built); `id_range` is the (least, largest) id that has
    rows, None for no rows.  Raises ValueError on ids that are not 1-D and
    non-negative."""

    def __init__(self, ids, device, chunk_rows: int = CHUNK_ROWS):
        ids = np.asarray(torch.as_tensor(ids).cpu(), dtype=np.int64)
        if ids.ndim != 1:
            raise ValueError(f"ids must be 1-D, got shape {ids.shape}")
        if ids.size and ids.min() < 0:
            raise ValueError("ids must be non-negative")
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
        perm = np.argsort(ids, kind="stable")
        n_ids = int(ids.max()) + 1 if ids.size else 0
        offsets = np.searchsorted(ids[perm], np.arange(n_ids + 1), "left")
        per_id = -(-np.diff(offsets) // chunk_rows)  # chunks of each id
        chunk_ptr = np.concatenate([[0], np.cumsum(per_id)])
        cid = np.repeat(np.arange(n_ids), per_id)  # each chunk's id
        start = offsets[:-1][cid] + (np.arange(chunk_ptr[-1]) - chunk_ptr[:-1][cid]) * chunk_rows
        end = np.minimum(start + chunk_rows, offsets[1:][cid])

        def dev(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)

        self.num_rows, self.num_ids, self.chunk_rows, self.shift = ids.size, n_ids, chunk_rows, 0
        self.id_range = (int(ids.min()), n_ids - 1) if ids.size else None
        self.perm, self.offsets, self.chunk_ptr = dev(perm), dev(offsets), dev(chunk_ptr)
        self.chunks = dev(np.stack([start, end, cid], 1).reshape(-1, 3))

    def shifted(self, k: int) -> RelationLayout:
        """The layout of ids + k (the same tensors)."""
        out = copy.copy(self)
        out.shift = self.shift + k
        return out


def use_kernel(table, layout) -> bool:
    """Whether the backward of relation_rows(table, ids, layout) takes the
    split-segment kernels: a static layout and a CUDA float32 or float64
    table."""
    return layout is not None and table.device.type == "cuda" and table.dtype in KERNEL_DTYPES


def _check(g, layout: RelationLayout, n_rows: int):
    if g.device != layout.perm.device:
        raise ValueError(f"g is on {g.device}, the layout on {layout.perm.device}")
    if g.dim() == 0 or g.shape[0] != layout.num_rows:
        raise ValueError(f"g has shape {tuple(g.shape)}, expected ({layout.num_rows}, ...)")
    lo_hi = layout.id_range
    if lo_hi is not None and not 0 <= lo_hi[0] + layout.shift <= lo_hi[1] + layout.shift < n_rows:
        raise ValueError(f"ids {lo_hi[0]}..{lo_hi[1]} shifted by {layout.shift} fall outside "
                         f"the table's {n_rows} rows")


# ------------------------------ plain version ---------------------------------


def relation_grad_plain(g, layout: RelationLayout, n_rows: int):
    """out (n_rows, ...) with out[r] = the sum of g[i] over ids[i] + shift
    = r, split as the kernels split it: each chunk's rows in sorted order in
    g's dtype, then each row's chunk partials in float64, rounded once."""
    _check(g, layout, n_rows)
    flat = g.reshape(layout.num_rows, math.prod(g.shape[1:]))
    chunks = layout.chunks.long()
    row_chunk = torch.repeat_interleave(torch.arange(chunks.shape[0], device=g.device),
                                        chunks[:, 1] - chunks[:, 0])
    partial = flat.new_zeros((chunks.shape[0], flat.shape[1])).index_add_(
        0, row_chunk, flat[layout.perm.long()])
    out = torch.zeros((n_rows, flat.shape[1]), dtype=torch.float64, device=g.device)
    out.index_add_(0, chunks[:, 2] + layout.shift, partial.double())
    return out.to(g.dtype).reshape(n_rows, *g.shape[1:])


# --------------------------------- wrapper ------------------------------------


def relation_grad(g, layout: RelationLayout, n_rows: int):
    """The relation table's gradient (no autograd): g (E, ...) summed into
    (n_rows, ...) by the layout's ids + shift."""
    if g.device.type == "cpu":
        return relation_grad_plain(g, layout, n_rows)
    _check(g, layout, n_rows)
    if g.device.type != "cuda":
        raise ValueError(f"relation_grad takes CPU or CUDA tensors, got {g.device}")
    if g.dtype not in KERNEL_DTYPES:
        raise TypeError(f"g has dtype {g.dtype}: the relation gradient kernels are built "
                        "for float32 and float64")
    check_tensor("g", g, g.dtype, g.shape, layout.perm.device)
    w = math.prod(g.shape[1:])
    n_chunks = layout.chunks.shape[0]
    partial = torch.empty((n_chunks, w), dtype=g.dtype, device=g.device)
    out = torch.empty((n_rows, *g.shape[1:]), dtype=g.dtype, device=g.device)
    launch("relgrad", f"relgrad_{KERNEL_DTYPES[g.dtype]}", g.device,
           g.reshape(layout.num_rows, w), layout.perm, layout.chunks, layout.chunk_ptr,
           partial, out, n_chunks, layout.num_ids, layout.shift, n_rows, w)
    launches["relation_grad"] += 1
    return out


def relation_grad_accumulate(g, ids, shape):
    """Autograd's backward of table[ids] for a table of `shape`
    (IndexBackward0: _index_put_impl_ with accumulate and unsafe, in place
    on zeros), counted."""
    launches["relation_grad_accumulate"] += 1
    return torch.ops.aten._index_put_impl_(g.new_zeros(shape), [ids], g, True, True)
