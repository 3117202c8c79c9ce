"""Sorted segment sum: CUDA kernel K9.

Port of complexhyperbolickge_tpu/kernels/segsum.py.  The GNN encoder sums
its edge messages (E, H) into the N receiving nodes over a STATIC edge list
whose halves are each sorted by receiving node (models/gnn/models.py).  For
such an index `make_sorted_segment_sum` builds, once, the CSR offsets
row_ptr (N + 1) of the sorted dst, and returns a callable
`SortedSegmentSum`: msgs (E, ...) -> (N, ...), differentiable.

  * forward: `sorted_segment_sum` launches `segsum_f32` / `segsum_f64` /
    `segsum_bf16` (csrc/segsum.cu) for a CUDA float32, float64 or bfloat16
    tensor: one warp per node row, the row's edges summed in edge order
    (bfloat16 in float32, rounded once on store), no atomics, so the
    result is deterministic; a node without edges gets 0.
  * backward: d_msgs = d_out[dst], a launch of the row gather K10
    (kernels/gather.py::row_gather).

For a CPU tensor both passes run the plain PyTorch versions,
`sorted_segment_sum_plain` (index_add_ into zeros; bfloat16 into float32
zeros, rounded once) and `gather.row_gather_plain`, which sum in another
order (within rounding of the kernel).  A CUDA tensor of another dtype
raises.  Each launch is counted in `launches`.
"""

from __future__ import annotations

import numpy as np
import torch

from complexhyperbolickge_torch.kernels._build import check_tensor, launch

# launches of the CUDA kernel since the last reset_launches()
launches = {"sorted_segment_sum": 0}

# the instantiations of csrc/segsum.cu and csrc/gather.cu
KERNEL_DTYPES = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}


def reset_launches():
    for k in launches:
        launches[k] = 0


def check_kernel_dtype(name: str, t: torch.Tensor):
    """Raise unless the GNN kernels have an instantiation for t's dtype."""
    if t.dtype not in KERNEL_DTYPES:
        raise TypeError(
            f"{name} has dtype {t.dtype}: the GNN kernels K9/K10 are built for "
            "float32, float64 and bfloat16")


class SortedSegmentSum:
    """K9 for one fixed dst-sorted index: a callable msgs (E, ...) ->
    (num_segments, ...), differentiable.  Holds `dst` (E,) int32 and the
    CSR offsets `row_ptr` (num_segments + 1,) int32 on `device`."""

    def __init__(self, dst_sorted, num_segments: int, device):
        d = np.asarray(torch.as_tensor(dst_sorted).cpu(), dtype=np.int64)
        if d.ndim != 1:
            raise ValueError(f"dst must be 1-D, got shape {d.shape}")
        if d.size and ((np.diff(d) < 0).any() or d[0] < 0 or d[-1] >= num_segments):
            raise ValueError(f"dst must be sorted, with ids in [0, {num_segments})")
        row_ptr = np.searchsorted(d, np.arange(num_segments + 1), "left")
        self.num_segments = num_segments
        self.num_edges = d.size
        self.dst = torch.as_tensor(d, dtype=torch.int32, device=device)
        self.row_ptr = torch.as_tensor(row_ptr, dtype=torch.int32, device=device)

    def __call__(self, msgs):
        return _SortedSegmentSumFn.apply(msgs, self)


def make_sorted_segment_sum(dst_sorted, num_segments: int, device) -> SortedSegmentSum:
    """The K9 closure of a fixed sorted destination vector (the full-graph
    GNN case: the edge structure is static across steps).  Raises
    ValueError on an unsorted or out-of-range dst."""
    return SortedSegmentSum(dst_sorted, num_segments, device)


# ------------------------------ plain version ---------------------------------


def sorted_segment_sum_plain(msgs, seg: SortedSegmentSum):
    """out[n] = sum of msgs[e] over dst[e] = n, by index_add_ into zeros; a
    bfloat16 sum is taken in float32 and rounded once, as the kernel does."""
    acc = msgs.float() if msgs.dtype == torch.bfloat16 else msgs
    out = acc.new_zeros((seg.num_segments, *msgs.shape[1:]))
    return out.index_add_(0, seg.dst, acc).to(msgs.dtype)


# --------------------------------- wrapper ------------------------------------


def sorted_segment_sum(msgs, seg: SortedSegmentSum):
    """K9 forward (no autograd): msgs (E, ...) summed into (N, ...) rows."""
    if msgs.device.type == "cpu":
        return sorted_segment_sum_plain(msgs, seg)
    if msgs.device.type != "cuda":
        raise ValueError(f"sorted_segment_sum takes CPU or CUDA tensors, got {msgs.device}")
    check_kernel_dtype("msgs", msgs)
    if msgs.dim() == 0 or msgs.shape[0] != seg.num_edges:
        raise ValueError(f"msgs has shape {tuple(msgs.shape)}, expected "
                         f"({seg.num_edges}, ...)")
    e, n = seg.num_edges, seg.num_segments
    h = int(np.prod(msgs.shape[1:], dtype=np.int64))
    check_tensor("msgs", msgs, msgs.dtype, msgs.shape, seg.row_ptr.device)
    out = torch.empty((n, *msgs.shape[1:]), dtype=msgs.dtype, device=msgs.device)
    launch("segsum", f"segsum_{KERNEL_DTYPES[msgs.dtype]}", msgs.device,
           msgs.reshape(e, h), seg.row_ptr, out, n, h)
    launches["sorted_segment_sum"] += 1
    return out


class _SortedSegmentSumFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msgs, seg):
        ctx.seg = seg
        return sorted_segment_sum(msgs.contiguous(), seg)

    @staticmethod
    def backward(ctx, g):
        # imported here: gather.py imports this module for K10's backward
        from complexhyperbolickge_torch.kernels import gather

        return gather.row_gather(g.contiguous(), ctx.seg.dst), None
