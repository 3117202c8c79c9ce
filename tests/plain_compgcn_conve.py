"""Plain reference of CompGCN (Vashishth, Sanyal, Nitin and Talukdar,
Composition-based Multi-Relational Graph Convolutional Networks, ICLR 2020,
arXiv 1911.03082) with the circular-correlation composition (Corr) and the
ConvE decoder, as the port trains it on the full graph: the encoder over
the [forward; inverse] edges, ConvE over each query's encoded head and
relation rows, its dot with every encoded entity, the smoothed BCE against
multi-hot labels, and Adam.

Plain torch in the parameters' dtype with TF32 off; nothing of the program
and no FFT:
  * corr is its definition, ccorr(a, b)[k] = sum_i a[i] b[(i + k) mod d],
    a sum over the d shifts of b;
  * the interleave of [e; r] into the (2 k_w, k_h) image is written out
    (e0, r0, e1, r1, ... row by row, CompGCN's cat, transpose and reshape);
  * ConvE's convolution is unfold plus a matrix product;
  * each batch norm is written out: batch statistics (biased variance) in
    training, the running mean and unbiased variance updated by momentum
    0.1 (torch.nn.BatchNorm's rule); the running ones in eval.
Parameters are a dict named as the port model's state_dict (entity, rel,
bh, bt, gnn.<i>.w_in, ..., conve.conv, conve.fc, ...); the running
statistics a dict `stats` (bn<i>_mean, bn<i>_var), updated in place by a
training forward.

Departures from the published description: those of plain_compgcn.py (the
degree norm 1/deg(receiving node) per direction; no tanh after the last
layer; a head and a tail bias; eps/N label smoothing), and no dropout
(gcn_drop, hid_drop, feat_drop, hid_drop2): the comparison is
deterministic.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

import plain_compgcn as base

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BN_EPS, MOMENTUM = 1e-5, 0.1
edges, multi_hot, bce, adam = base.edges, base.multi_hot, base.bce, base.adam


def ccorr(a, b):
    """Circular correlation over the last axis by its definition."""
    d = a.shape[-1]
    k = torch.arange(d, device=a.device)
    shifted = b[..., (k[:, None] + k[None, :]) % d]  # [..., i, k] = b[(i + k) mod d]
    return torch.sum(a[..., :, None] * shifted, dim=-2)


def layer(P, i: int, x, rel, graph: dict, last: bool):
    """Layer i with corr: (1/3)(sum over in-edges + sum over out-edges +
    the self loop), batch norm with batch statistics, tanh unless last; and
    the relations' projection rel @ W_rel."""
    p = {k: P[f"gnn.{i}.{k}"] for k in ("w_in", "w_out", "w_loop", "w_rel", "loop_rel",
                                        "bn_scale", "bn_bias")}
    n = x.shape[0]
    total = 0.0
    for mode in ("in", "out"):
        head, tail, et = graph[mode]
        deg = torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(
            0, head, torch.ones_like(head, dtype=x.dtype))
        norm = 1.0 / deg[head]  # departure: 1/deg(head), not the symmetric norm
        msg = (ccorr(x[tail], rel[et]) @ p["w_" + mode]) * norm[:, None]
        total = total + torch.zeros((n, msg.shape[1]), dtype=x.dtype,
                                    device=x.device).index_add_(0, head, msg)
    out = (total + ccorr(x, p["loop_rel"]) @ p["w_loop"]) / 3.0
    mean = out.mean(dim=0, keepdim=True)
    var = ((out - mean) ** 2).mean(dim=0, keepdim=True)
    out = (out - mean) / torch.sqrt(var + BN_EPS) * p["bn_scale"] + p["bn_bias"]
    if not last:  # departure: CompGCN's one-layer model applies tanh here too
        out = torch.tanh(out)
    return out, rel @ p["w_rel"]


def encode(P, graph: dict, layers: int):
    """(x', rel'): the entity and relation tables after the layer stack."""
    x, rel = P["entity"], P["rel"]
    for i in range(layers):
        x, rel = layer(P, i, x, rel, graph, last=i == layers - 1)
    return x, rel


def interleave(e, r, k_w: int, k_h: int):
    """(B, h) rows -> (B, 1, 2 k_w, k_h): position 2 j holds e[j], 2 j + 1
    holds r[j], read row by row."""
    flat = torch.empty((e.shape[0], 2 * e.shape[1]), dtype=e.dtype, device=e.device)
    flat[:, 0::2] = e
    flat[:, 1::2] = r
    return flat.reshape(e.shape[0], 1, 2 * k_w, k_h)


def batch_norm(x, P, stats, i: int, training: bool):
    """Batch norm i over channel axis 1 of x."""
    dims = [d for d in range(x.dim()) if d != 1]
    shape = [1, x.shape[1]] + [1] * (x.dim() - 2)
    if training:
        mean = x.mean(dim=dims, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            stats[f"bn{i}_mean"] = ((1 - MOMENTUM) * stats[f"bn{i}_mean"]
                                    + MOMENTUM * mean.reshape(-1))
            stats[f"bn{i}_var"] = ((1 - MOMENTUM) * stats[f"bn{i}_var"]
                                   + MOMENTUM * var.reshape(-1) * n / (n - 1))
    else:
        mean = stats[f"bn{i}_mean"].reshape(shape)
        var = stats[f"bn{i}_var"].reshape(shape)
    out = (x - mean) / torch.sqrt(var + BN_EPS)
    return out * P[f"conve.bn{i}_scale"].reshape(shape) + P[f"conve.bn{i}_bias"].reshape(shape)


def fresh_stats(num_filt: int, h: int, dtype) -> dict:
    """Running statistics before any training step: means 0, variances 1."""
    out = {}
    for i, n in enumerate((1, num_filt, h)):
        out[f"bn{i}_mean"] = torch.zeros(n, dtype=dtype)
        out[f"bn{i}_var"] = torch.ones(n, dtype=dtype)
    return out


def conve(P, e, r, stats: dict, k_w: int, k_h: int, training: bool):
    """ConvE's (B, h) query rows: interleave, batch norm, the convolution
    (unfold and a product), batch norm, ReLU, fc, batch norm, ReLU."""
    w = P["conve.conv"]  # (F, 1, k, k)
    x = batch_norm(interleave(e, r, k_w, k_h), P, stats, 0, training)
    k = w.shape[-1]
    cols = F.unfold(x, k)  # (B, k k, L), output positions row by row
    oh, ow = 2 * k_w - k + 1, k_h - k + 1
    x = (w.reshape(w.shape[0], -1) @ cols).reshape(x.shape[0], w.shape[0], oh, ow)
    x = torch.relu(batch_norm(x, P, stats, 1, training))
    x = x.reshape(x.shape[0], -1) @ P["conve.fc"] + P["conve.fc_bias"]
    return torch.relu(batch_norm(x, P, stats, 2, training))


def score_all(P, x, rel, queries, stats, k_w: int, k_h: int, training: bool):
    """ConvE's rows dotted with every encoded entity, + bh[h] + bt[t]
    (departure: two biases)."""
    h, r = queries[:, 0], queries[:, 1]
    q = conve(P, x[h], rel[r], stats, k_w, k_h, training)
    return q @ x.T + P["bh"][h] + P["bt"][:, 0][None, :]


def loss(P, graph, batch, weights, labels, layers: int, smoothing: float, stats: dict,
         k_w: int, k_h: int):
    """A training step's loss (the decoder in training mode: its running
    statistics in `stats` move)."""
    x, rel = encode(P, graph, layers)
    return bce(score_all(P, x, rel, batch[:, :2], stats, k_w, k_h, True), labels, weights,
               smoothing)
