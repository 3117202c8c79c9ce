"""Row gather: CUDA kernel K10.

Port of complexhyperbolickge_tpu/kernels/gather.py.  out[i] = x[ids[i]]
over rows of any width.  The JAX kernel pads rows to Mosaic's 4 KB DMA unit
and returns zero pad columns; this one returns exactly (E, ...) and takes
any E.

  * `row_gather(x, ids)` (no autograd) launches `row_gather_f32` /
    `row_gather_f64` / `row_gather_bf16` (csrc/gather.cu) for a CUDA
    float32, float64 or bfloat16 x and int32 ids; the result is bitwise
    x[ids].  K9's backward calls it.
  * `make_row_gather(ids, num_rows, device)` is the GNN encoder's form for a
    static id vector (its edge gathers x[tail]): a callable `RowGather`,
    differentiable.  Its backward is the scatter-add of d_out into x's rows
    by ids, done deterministically: d_out gathered by the ids-sorted
    permutation (K10), then summed over the sorted ids (K9).  Both are built
    with the closure.

For CPU tensors the plain versions run (`row_gather_plain`, x[ids], and
K9's plain version in the backward).  A CUDA tensor of another dtype
raises.  Each launch is counted in `launches`.
"""

from __future__ import annotations

import numpy as np
import torch

from complexhyperbolickge_torch.kernels import segsum
from complexhyperbolickge_torch.kernels._build import check_tensor, launch

# launches of the CUDA kernel since the last reset_launches()
launches = {"row_gather": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


def row_gather_plain(x, ids):
    """x[ids] by PyTorch indexing."""
    return x[ids]


def row_gather(x, ids):
    """K10 forward (no autograd): x (N, ...) rows at int32 ids (E,) ->
    (E, ...).  The ids must lie in [0, N): kernels do not check them."""
    if x.device.type == "cpu":
        return row_gather_plain(x, ids)
    if x.device.type != "cuda":
        raise ValueError(f"row_gather takes CPU or CUDA tensors, got {x.device}")
    segsum.check_kernel_dtype("x", x)
    if x.dim() == 0 or ids.dim() != 1:
        raise ValueError("row_gather takes x (N, ...) and ids (E,)")
    n, e = x.shape[0], ids.shape[0]
    h = int(np.prod(x.shape[1:], dtype=np.int64))
    check_tensor("x", x, x.dtype, x.shape, x.device)
    check_tensor("ids", ids, torch.int32, (e,), x.device)
    out = torch.empty((e, *x.shape[1:]), dtype=x.dtype, device=x.device)
    launch("gather", f"row_gather_{segsum.KERNEL_DTYPES[x.dtype]}", x.device,
           x.reshape(n, h), ids, out, e, h)
    launches["row_gather"] += 1
    return out


class RowGather:
    """K10 for one fixed id vector: a callable x (num_rows, ...) -> (E, ...),
    differentiable.  Holds `ids` (E,) int32, the stable ids-sorting
    permutation `perm` (E,) int32 and `scatter`, K9 over the sorted ids."""

    def __init__(self, ids, num_rows: int, device):
        i = np.asarray(torch.as_tensor(ids).cpu(), dtype=np.int64)
        if i.ndim != 1 or (i.size and (i.min() < 0 or i.max() >= num_rows)):
            raise ValueError(f"ids must be 1-D with values in [0, {num_rows})")
        perm = np.argsort(i, kind="stable")
        self.num_rows = num_rows
        self.ids = torch.as_tensor(i, dtype=torch.int32, device=device)
        self.perm = torch.as_tensor(perm, dtype=torch.int32, device=device)
        self.scatter = segsum.SortedSegmentSum(i[perm], num_rows, device)

    def __call__(self, x):
        if x.shape[0] != self.num_rows:
            raise ValueError(f"x has {x.shape[0]} rows, expected {self.num_rows}")
        return _RowGatherFn.apply(x, self)


def make_row_gather(ids, num_rows: int, device) -> RowGather:
    """The K10 closure of a static id vector into a table of num_rows rows."""
    return RowGather(ids, num_rows, device)


class _RowGatherFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gather):
        ctx.gather = gather
        return row_gather(x.contiguous(), gather.ids)

    @staticmethod
    def backward(ctx, g):
        gth = ctx.gather
        return segsum.sorted_segment_sum(row_gather(g.contiguous(), gth.perm),
                                         gth.scatter), None
