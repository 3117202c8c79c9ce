"""Small NN blocks with the JAX package's parameter layout.

Port of complexhyperbolickge_tpu/utils/nn.py.  Weights are laid out
(d_in, d_out) and applied as x @ w + b, as in JAX, so a JAX params list
[{"w", "b"}, ...] loads one to one: an MLP is an nn.ModuleList of Linear
layers, whose state_dict keys read "<i>.w", "<i>.b".  The GNN convs build
their relation and curvature updates from these (models/gnn/convs.py).
"""

from __future__ import annotations

import math

import torch
from torch import nn


class Linear(nn.Module):
    """x @ w + b with w (d_in, d_out); init draws w ~ N(0, 2 / (d_in + d_out))
    ("xavier", the JAX convs' init_linear) or N(0, 2 / d_in) ("kaiming"),
    and b = 0."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, init: str = "xavier",
                 dtype=None, device=None):
        super().__init__()
        self.init = init
        self.w = nn.Parameter(torch.empty((d_in, d_out), dtype=dtype, device=device))
        self.b = (nn.Parameter(torch.empty((d_out,), dtype=dtype, device=device))
                  if bias else None)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        d_in, d_out = self.w.shape
        var = 2.0 / (d_in + d_out) if self.init == "xavier" else 2.0 / d_in
        self.w.copy_(torch.randn((d_in, d_out), generator=generator) * math.sqrt(var))
        if self.b is not None:
            self.b.zero_()

    def forward(self, x):
        y = torch.matmul(x, self.w)
        return y if self.b is None else y + self.b


class MLP(nn.ModuleList):
    """Plain MLP (reference models/mlp.py): kaiming-initialized Linear
    layers with relu between them."""

    def __init__(self, d_in: int, d_hidden: int, d_out: int, num_layers: int = 2,
                 dtype=None, device=None):
        dims = [d_in] + [d_hidden] * (num_layers - 1) + [d_out]
        super().__init__([Linear(dims[i], dims[i + 1], init="kaiming", dtype=dtype,
                                 device=device) for i in range(num_layers)])

    def reset_parameters(self, generator: torch.Generator | None = None):
        for layer in self:
            layer.reset_parameters(generator)

    def forward(self, x):
        for i, layer in enumerate(self):
            x = layer(x)
            if i < len(self) - 1:
                x = torch.relu(x)
        return x


class MonotonicMLP(nn.ModuleList):
    """Monotonic MLP through absolute weights (reference
    models/monotonic.py): two Linear layers, w and b ~ U(-1/sqrt(fan_in),
    1/sqrt(fan_in))."""

    def __init__(self, d_in: int, d_out: int, d_hidden: int, dtype=None, device=None):
        dims = [d_in, d_hidden, d_out]
        super().__init__([Linear(dims[i], dims[i + 1], dtype=dtype, device=device)
                          for i in range(2)])

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        for layer in self:
            bound = 1.0 / math.sqrt(layer.w.shape[0])
            for p in (layer.w, layer.b):
                p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)

    def forward(self, x):
        for i, layer in enumerate(self):
            x = torch.matmul(x, torch.abs(layer.w)) + layer.b
            if i < len(self) - 1:
                x = torch.relu(x)
        return x
