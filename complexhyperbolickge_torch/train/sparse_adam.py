"""Row-sparse (lazy) Adam over dense gradients.

Port of complexhyperbolickge_tpu/train/sparse_adam.py, the semantics of
torch.optim.SparseAdam: only the rows that received gradient this step are
updated.  Untouched rows keep their moments undecayed and their values;
dense Adam would decay every row's moments every step and keep pushing
rows that were not sampled.

The port's tables get dense gradients (the CUDA train-distance backward
writes the whole (N, D) entity gradient), which torch.optim.SparseAdam
refuses, so this optimizer takes dense gradients and reads "touched" from
them, as the JAX package does:

    touched = any(g != 0) over each row        (element-wise for 1-D params)
    m       = b1 m + (1 - b1) g                 on touched rows
    v       = b2 v + (1 - b2) g^2               on touched rows
    p      -= lr sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) + eps)   on touched rows

A row whose gradient is exactly zero counts as untouched (torch's
SparseAdam would count an explicitly stored zero as touched).  t is the
global step count: it advances for every parameter on every step, touched
or not, as JAX's single counter does.
"""

from __future__ import annotations

import math

import torch


class SparseAdam(torch.optim.Optimizer):
    """Lazy row-sparse Adam with torch's defaults (betas 0.9 / 0.999, eps
    1e-8).  State per parameter: step (the global count), exp_avg,
    exp_avg_sq, as torch.optim.Adam names them."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, (b1, b2), eps = group["lr"], group["betas"], group["eps"]
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                g = p.grad
                if g is None:
                    continue
                touched = g.ne(0).any(dim=tuple(range(1, g.dim()))) if g.dim() >= 2 else g.ne(0)
                w = touched.reshape(touched.shape + (1,) * (g.dim() - touched.dim())).to(g.dtype)
                m, v = st["exp_avg"], st["exp_avg_sq"]
                m.mul_(1 - w * (1 - b1)).add_(w * (1 - b1) * g)
                v.mul_(1 - w * (1 - b2)).add_(w * (1 - b2) * g * g)
                t = float(st["step"])
                step_size = lr * math.sqrt(1.0 - b2**t) / (1.0 - b1**t)
                p.sub_(step_size * w * m / (v.sqrt() + eps))
        return loss
