"""The process mesh, row-sharded entity tables and data-parallel batches.

Port of complexhyperbolickge_tpu/parallel/mesh.py.  JAX lays a
jax.sharding.Mesh with axes ('data', 'model') over devices; here the mesh is
one process per device, D x M ranks, joined by torch.distributed:

  * rank r sits at mesh position (d, m) = (r // M, r % M): data outer,
    model inner, so the M ranks of one data row (its 'model' group) are
    consecutive and stay within a node when M divides the processes per
    node, as JAX keeps its model axis off the slow fabric;
  * 'data': each training batch splits over the D data rows
    (shard_epoch_arrays), and the gradients of the replicated parameters
    are summed over the data group (sum_grads; with M > 1 over every rank,
    divided by M, so the model group's copies stay one);
  * 'model': the entity-table leaves (entity, bh, bt) and their optimizer
    moments live as each rank's own rows only, padded by name to
    padded_rows(N, M) (shard_model_, shard_entity_tree); a training step
    gathers the tables inside the model group (gather_tables), and the
    rankers (parallel/ranking.py) sweep each rank's slice and sum (B,)
    counts over the model group.

A 1 x 1 mesh is one process with no process group: every collective below
is then skipped.  One group of each kind is built per row and per column
(every rank calls new_group for all of them, in the same order).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

# rows of these parameters lie on the entity axis and shard over 'model'
ENTITY_PARAMS = ("entity", "bh", "bt")


@dataclasses.dataclass
class Mesh:
    """This process's place in a (D, M) mesh.  data_group holds the D ranks
    of its model column (the ranks that own the same entity rows), and
    model_group the M ranks of its data row (the ranks that see the same
    batch slice); each is None when it would hold this rank alone."""

    shape: tuple
    rank: int = 0
    device: torch.device = torch.device("cpu")
    data_group: object = None
    model_group: object = None

    @property
    def n_data(self) -> int:
        return self.shape[0]

    @property
    def n_model(self) -> int:
        return self.shape[1]

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def collective(self) -> bool:
        """Whether this mesh runs collectives: more than one rank, or a
        group of one (a 1 x 1 mesh over a process group of world size 1)."""
        return self.size > 1 or self.data_group is not None or self.model_group is not None

    @property
    def d(self) -> int:
        return self.rank // self.n_model

    @property
    def m(self) -> int:
        return self.rank % self.n_model

    # ------------------------------ collectives ------------------------------

    def sum_data(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the data group, in place (t must be contiguous)."""
        if self.data_group is not None:
            dist.all_reduce(t, group=self.data_group)
        return t

    def sum_model(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the model group, in place (t must be contiguous)."""
        if self.model_group is not None:
            dist.all_reduce(t, group=self.model_group)
        return t

    def data_total(self, x: torch.Tensor) -> torch.Tensor:
        """A loss normalizer summed over the data group: the global batch's
        value of a sum this rank took over its slice (no gradient)."""
        if self.data_group is None:
            return x
        return self.sum_data(x.detach().clone().contiguous())

    def any(self, flag: bool) -> bool:
        """True on every rank when `flag` is true on any rank."""
        if not self.collective:
            return bool(flag)
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item() > 0)

    def broadcast_float(self, x: float | None) -> float | None:
        """Rank 0's x on every rank (None stays None)."""
        if not self.collective:
            return x
        t = torch.tensor([np.nan if x is None else float(x)], dtype=torch.float64,
                         device=self.device)
        dist.broadcast(t, src=0)
        v = float(t.item())
        return None if np.isnan(v) else v

    def barrier(self):
        if self.collective:
            dist.barrier()


def parse_shape(text: str) -> tuple:
    """'DxM' -> (D, M)."""
    try:
        d, m = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes DATAxMODEL, e.g. 4x2; got {text!r}") from None
    if d < 1 or m < 1:
        raise ValueError(f"--mesh sizes must be positive, got {text!r}")
    return d, m


def make_mesh(shape=(1, 1), device=None, local_size: int | None = None) -> Mesh:
    """The Mesh of this process for `shape` (D, M).  D x M > 1 needs an
    initialized default process group of exactly D x M ranks (raises
    otherwise).  local_size: the processes on this node, when known; a
    model group that cannot stay within a node is logged, as JAX logs a
    mesh that does not align with its process granules."""
    d_, m_ = (int(s) for s in shape)
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if d_ * m_ == 1:
        return Mesh((1, 1), 0, dev)
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"mesh {d_}x{m_} needs an initialized process group of "
                         f"{d_ * m_} ranks")
    world = dist.get_world_size()
    if world != d_ * m_:
        raise ValueError(f"mesh {d_}x{m_} needs {d_ * m_} ranks, the process group "
                         f"has {world}")
    rank = dist.get_rank()
    if local_size and local_size % m_ and m_ > 1:
        logging.info("mesh %dx%d: model groups of %d ranks do not align with %d "
                     "processes a node; model-axis traffic may cross nodes",
                     d_, m_, m_, local_size)
    mesh = Mesh((d_, m_), rank, dev)
    for d in range(d_):  # model groups: one data row each
        ranks = [d * m_ + m for m in range(m_)]
        g = dist.new_group(ranks) if m_ > 1 else None
        if rank in ranks:
            mesh.model_group = g
    for m in range(m_):  # data groups: one model column each
        ranks = [d * m_ + m for d in range(d_)]
        g = dist.new_group(ranks) if d_ > 1 else None
        if rank in ranks:
            mesh.data_group = g
    return mesh


# ------------------------------ entity padding --------------------------------


def padded_rows(n: int, n_shards: int) -> int:
    """Rows after padding n up to a multiple of the model-axis size."""
    return -(-n // n_shards) * n_shards


def _is_entity_path(path) -> bool:
    """True when a tree path runs through an entity-table name.  The JAX
    package tests the innermost key, which is the param name in an optax
    moment tree ({"mu": {"entity": ...}}); the port's optimizer state nests
    the other way ({"entity": {"exp_avg": ...}}), so any key on the path
    counts.  Selecting by NAME, then by shape, keeps a row-coincident
    bystander (a 64-row rel beside a 63 -> 64-padded entity table) whole."""
    return any(k in ENTITY_PARAMS for k in path if isinstance(k, str))


def _map_tree(f, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_tree(f, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return type(tree)(_map_tree(f, v, path + (i,)) for i, v in enumerate(tree))
    return f(path, tree)


def _rows(x) -> int | None:
    shape = getattr(x, "shape", None)
    return shape[0] if shape is not None and len(shape) >= 1 else None


def _pad(x, rows: int):
    """x zero-padded to `rows` leading rows (numpy or torch)."""
    if isinstance(x, torch.Tensor):
        return torch.cat([x, x.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))])
    return np.pad(x, [(0, rows - x.shape[0])] + [(0, 0)] * (x.ndim - 1))


def pad_entity_tree(tree, n_entities: int, np_: int):
    """Zero-pad every entity-table leaf with n_entities leading rows to np_
    rows (leaves chosen by name, then by shape).  Zero pad rows are inert:
    the training step slices the gathered tables back to n_entities rows,
    so they get no gradient, and the rankers keep them out of every count."""
    if np_ == n_entities:
        return tree
    return _map_tree(lambda p, x: _pad(x, np_) if _is_entity_path(p) and _rows(x) == n_entities
                     else x, tree)


def unpad_entity_tree(tree, n_entities: int, np_: int):
    """Inverse of pad_entity_tree: every np_-row entity-table leaf cut back
    to n_entities rows (checkpoints stay canonical)."""
    if np_ == n_entities:
        return tree
    return _map_tree(lambda p, x: x[:n_entities] if _is_entity_path(p) and _rows(x) == np_
                     else x, tree)


def shard_entity_tree(tree, n_entities: int, shard_idx: int, n_shards: int):
    """Each entity-table leaf of a canonical tree (n_entities rows) padded
    by name to padded_rows(n_entities, n_shards) and cut to shard
    `shard_idx`'s rows; other leaves as they are."""
    np_ = padded_rows(n_entities, n_shards)
    s = np_ // n_shards
    lo = shard_idx * s
    return _map_tree(lambda p, x: x[lo: lo + s] if _is_entity_path(p) and _rows(x) == np_
                     else x, pad_entity_tree(tree, n_entities, np_))


def gather_entity_tree(tree, n_entities: int, mesh: Mesh):
    """Inverse of shard_entity_tree across the model group: every
    entity-table leaf of this rank's rows (padded_rows / M rows) gathered
    from the whole group and cut to n_entities rows; numpy leaves come back
    numpy.  Every rank of the group must call it with the same tree."""
    m = mesh.n_model
    if m == 1:
        return tree
    np_ = padded_rows(n_entities, m)

    def f(path, x):
        if not (_is_entity_path(path) and _rows(x) == np_ // m):
            return x
        is_np = not isinstance(x, torch.Tensor)
        t = torch.as_tensor(np.asarray(x)) if is_np else x.detach()
        part = _wire(t).to(mesh.device).contiguous()
        parts = [torch.empty_like(part) for _ in range(m)]
        dist.all_gather(parts, part, group=mesh.model_group)
        full = torch.cat(parts).to(t.dtype)
        return full.cpu().numpy() if is_np else full.to(t.device)

    return unpad_entity_tree(_map_tree(f, tree), n_entities, np_)


# ------------------------------ row-sharded model -----------------------------


def shard_model_(model: nn.Module, shard_idx: int, n_shards: int) -> list:
    """Replace the model's entity-table parameters (entity, bh, bt) by
    Parameters of shard `shard_idx`'s rows (padded_rows(N, n_shards) /
    n_shards rows, zero past N), in place; returns their names.  The
    optimizer built afterwards then holds only local rows and moments."""
    n = model.cfg.n_entities
    names = [k for k in ENTITY_PARAMS if k in model._parameters]
    if n_shards == 1:
        return names
    with torch.no_grad():
        for k in names:
            local = shard_entity_tree({k: getattr(model, k).detach()}, n, shard_idx,
                                      n_shards)[k]
            model._parameters[k] = nn.Parameter(local.clone())
    return names


def _wire(t: torch.Tensor) -> torch.Tensor:
    """t as a collective carries it: bfloat16 widened to float32 (exact),
    which every backend reduces; other dtypes as they are."""
    return t.float() if t.dtype == torch.bfloat16 else t


class _RowGather(torch.autograd.Function):
    """Forward: this rank's rows of a table, all-gathered within the model
    group and cut to n rows.  Backward: the rows of the full-table gradient
    that this rank owns, summed over the data group (the ranks that own the
    same rows and saw other batch slices).  The model-group peers saw the
    same slice, so each keeps its own rows of the same full gradient; built
    from a slice and all_reduce, which every backend has."""

    @staticmethod
    def forward(ctx, local, mesh, n):
        part = _wire(local.detach()).contiguous()
        parts = [torch.empty_like(part) for _ in range(mesh.n_model)]
        dist.all_gather(parts, part, group=mesh.model_group)
        ctx.mesh, ctx.rows = mesh, local.shape[0]
        return torch.cat(parts)[:n].to(local.dtype)

    @staticmethod
    def backward(ctx, grad):
        mesh, s = ctx.mesh, ctx.rows
        lo = mesh.m * s
        out = _wire(grad.new_zeros((s,) + tuple(grad.shape[1:])))
        own = grad[lo: lo + s]
        out[: own.shape[0]] = own
        return mesh.sum_data(out).to(grad.dtype), None, None


def gather_tables(model: nn.Module, names, mesh: Mesh) -> dict:
    """name -> the full (N, ...) table of each row-sharded parameter,
    differentiable through _RowGather."""
    n = model.cfg.n_entities
    return {k: _RowGather.apply(getattr(model, k), mesh, n) for k in names}


class _OwnedRows(torch.autograd.Function):
    """Forward: rows `ids` of a table whose rank holds rows [lo, lo + s):
    each rank reads the ids it owns from its shard, zeros elsewhere, and the
    model group sums (one nonzero term an element: one process's bits).
    Backward: the (len(ids), ...) gradient, the same on every data rank's
    peers, is summed over the data group first (the ids must be the same on
    every rank of the mesh), then each rank adds the rows it owns into a
    zero shard gradient.  Neither direction moves more than len(ids) rows."""

    @staticmethod
    def forward(ctx, local, ids, mesh):
        s = local.shape[0]
        lo = mesh.m * s
        own = ((ids >= lo) & (ids < lo + s)).view(-1, *[1] * (local.dim() - 1))
        idx = (ids - lo).clamp(0, s - 1)
        rows = _wire(local.detach())[idx]
        rows = mesh.sum_model(torch.where(own, rows, torch.zeros_like(rows)))
        ctx.save_for_backward(idx, own)
        ctx.mesh, ctx.rows = mesh, s
        return rows.to(local.dtype)

    @staticmethod
    def backward(ctx, grad):
        idx, own = ctx.saved_tensors
        g = _wire(grad)
        if ctx.mesh.data_group is not None:
            g = ctx.mesh.sum_data(g.clone(memory_format=torch.contiguous_format))
        out = g.new_zeros((ctx.rows,) + tuple(g.shape[1:]))
        out.index_add_(0, idx, torch.where(own, g, torch.zeros_like(g)))
        return out.to(grad.dtype), None, None


def gather_rows(model: nn.Module, name: str, ids: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rows `ids` (global entity ids, the same on every rank) of the
    row-sharded parameter `name`, differentiable through _OwnedRows: what
    model.<name>[ids] is in one process, without the whole table on any
    rank.  On a mesh with M = 1 the shard is the whole table, and the
    backward still sums only the len(ids) rows over the data group."""
    return _OwnedRows.apply(getattr(model, name), ids, mesh)


def sum_grads(model: nn.Module, mesh: Mesh | None, skip=()):
    """The gradients of the model's replicated parameters summed over the
    data group, one flat all_reduce per dtype; the parameters named in
    `skip` (the row-gathered tables) were summed in their gather's
    backward.  With M > 1 the all_reduce spans every rank and the sum is
    divided by M: the model group's copies of a gradient, which a kernel
    with atomics (index_add_ on the card) may leave an ulp apart, become
    one value on every rank, so the ranks keep one model.  A no-op without
    a data group or a model axis."""
    if mesh is None or (mesh.data_group is None and mesh.n_model == 1):
        return
    by_dtype: dict = {}
    for name, p in model.named_parameters():
        if p.grad is not None and name not in skip:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for dtype, grads in by_dtype.items():
        flat = _wire(torch.cat([g.reshape(-1) for g in grads]))
        if mesh.n_model > 1:
            dist.all_reduce(flat)
            flat /= mesh.n_model
        else:
            mesh.sum_data(flat)
        for g, v in zip(grads, flat.to(dtype).split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))


class _Call(nn.Module):
    """A module whose forward calls fn(*args): lets functional_call swap the
    model's tables for the length of any method call."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, fn, *args, **kwargs):
        return fn(*args, **kwargs)


def call_with_tables(model: nn.Module, tables: dict, fn, *args, **kwargs):
    """fn(*args, **kwargs) with the model's parameters `tables` (name ->
    tensor) swapped in through torch.func.functional_call: inside it,
    model.entity is the gathered table (or a ranker's mini-table)."""
    return torch.func.functional_call(
        _Call(model), {f"model.{k}": v for k, v in tables.items()}, (fn, *args), kwargs)


# ------------------------------ epoch arrays ----------------------------------


def batch_rows(mesh: Mesh, batch_size: int) -> slice:
    """This rank's rows of a batch of batch_size: the data row's slice.
    Raises when the data axis does not divide the batch (a JAX device_put
    refuses that layout too)."""
    if batch_size % mesh.n_data:
        raise ValueError(f"batch size {batch_size} is not divisible by the mesh's "
                         f"data axis {mesh.n_data}")
    b = batch_size // mesh.n_data
    return slice(mesh.d * b, (mesh.d + 1) * b)


def shard_epoch_arrays(mesh: Mesh, batches, weights, labels=None):
    """Each rank's slice of each batch (axis 1) of the epoch arrays that
    every rank builds in full from the epoch seed; labels None stays None."""
    rows = batch_rows(mesh, np.shape(batches)[1])
    return (batches[:, rows], weights[:, rows],
            None if labels is None else labels[:, rows])
