"""Plain reference of CompGCN (Vashishth, Sanyal, Nitin and Talukdar,
Composition-based Multi-Relational Graph Convolutional Networks, ICLR 2020,
arXiv 1911.03082) with the DistMult score, as the port trains it on the
full graph: the encoder over the [forward; inverse] edges, the all-entity
DistMult decoder, the smoothed BCE against multi-hot labels, and Adam.

Plain torch in the parameters' dtype (float32 or float64) with TF32 off; no
kernels, no sorted segments, no caches, no batching tricks: each message is
projected on its own edge and the sums over edges are index_add_.  It
imports nothing of the program.  Parameters are a dict named as the port
model's state_dict (entity, rel, bh, bt, gnn.<i>.w_in, ...).

Departures from the published description, each kept from the code the
port follows and marked where it is computed:
  * the degree norm is 1/deg(receiving node) per direction, where
    CompGCN's code takes the symmetric 1/sqrt(deg(head) deg(tail));
  * the last layer has no activation (with one layer CompGCN applies tanh);
  * no dropout (gcn_drop, hid_drop): the comparison is deterministic;
  * the decoder adds a head bias bh and a tail bias bt (CompGCN: one
    per-entity bias on the tail);
  * label smoothing puts eps/N on every entity (CompGCN's code adds 1/N).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BN_EPS = 1e-5
LOG_CLAMP = -100.0  # torch.nn.BCELoss's floor on each log term


def edges(train: np.ndarray, n_rel2: int, device=None) -> dict:
    """The encoder's edges: each train triple (h, r, t) once in direction
    "in" (h receives t's message through relation r) and once in "out" (t
    receives h's through its inverse r + n_rel2 / 2)."""
    tr = torch.as_tensor(np.asarray(train), dtype=torch.int64, device=device)
    h, r, t = tr[:, 0], tr[:, 1], tr[:, 2]
    return {"in": (h, t, r), "out": (t, h, r + n_rel2 // 2)}


def compose(x, r, opn: str = "mult"):
    """CompGCN's composition phi(x, r): Mult or Sub."""
    return x * r if opn == "mult" else x - r


def layer(P, i: int, x, rel, graph: dict, opn: str, last: bool):
    """Layer i: (1/3)(sum over in-edges + sum over out-edges + the self
    loop), batch norm with batch statistics, tanh unless last; and the
    relations' projection rel @ W_rel."""
    p = {k: P[f"gnn.{i}.{k}"] for k in ("w_in", "w_out", "w_loop", "w_rel", "loop_rel",
                                        "bn_scale", "bn_bias")}
    n = x.shape[0]
    total = 0.0
    for mode in ("in", "out"):
        head, tail, et = graph[mode]
        deg = torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(
            0, head, torch.ones_like(head, dtype=x.dtype))
        norm = 1.0 / deg[head]  # departure: 1/deg(head), not the symmetric norm
        msg = (compose(x[tail], rel[et], opn) @ p["w_" + mode]) * norm[:, None]
        total = total + torch.zeros((n, msg.shape[1]), dtype=x.dtype,
                                    device=x.device).index_add_(0, head, msg)
    out = (total + compose(x, p["loop_rel"], opn) @ p["w_loop"]) / 3.0
    mean = out.mean(dim=0, keepdim=True)
    var = ((out - mean) ** 2).mean(dim=0, keepdim=True)
    out = (out - mean) / torch.sqrt(var + BN_EPS) * p["bn_scale"] + p["bn_bias"]
    if not last:  # departure: CompGCN's one-layer model applies tanh here too
        out = torch.tanh(out)
    return out, rel @ p["w_rel"]


def encode(P, graph: dict, layers: int, opn: str = "mult"):
    """(x', rel'): the entity and relation tables after the layer stack."""
    x, rel = P["entity"], P["rel"]
    for i in range(layers):
        x, rel = layer(P, i, x, rel, graph, opn, last=i == layers - 1)
    return x, rel


def score_all(P, x, rel, queries):
    """DistMult over every entity: (x'[h] * rel'[r]) . x'[t] + bh[h] + bt[t]
    (departure: two biases)."""
    h, r = queries[:, 0], queries[:, 1]
    return (x[h] * rel[r]) @ x.T + P["bh"][h] + P["bt"][:, 0][None, :]


def multi_hot(examples: np.ndarray, batch, n_entities: int, dtype):
    """(B, N) 0/1: every t of `examples` (train triples with inverses) that
    shares a batch row's (h, r)."""
    ex = torch.as_tensor(np.asarray(examples), dtype=torch.int64, device=batch.device)
    same = (ex[None, :, 0] == batch[:, None, 0]) & (ex[None, :, 1] == batch[:, None, 1])
    rows, cols = torch.nonzero(same, as_tuple=True)
    out = torch.zeros((batch.shape[0], n_entities), dtype=dtype, device=batch.device)
    out[rows, ex[cols, 2]] = 1.0
    return out


def bce(scores, labels, weights, smoothing: float):
    """Mean over the valid rows' (B, N) entries of BCE(sigmoid(scores),
    (1 - eps) labels + eps / N), each log term floored at -100
    (departure: CompGCN's code adds 1 / N, not eps / N)."""
    n = scores.shape[1]
    y = (1.0 - smoothing) * labels + smoothing / n
    log_p = F.logsigmoid(scores).clamp_min(LOG_CLAMP)
    log_1mp = F.logsigmoid(-scores).clamp_min(LOG_CLAMP)
    per = -(y * log_p + (1.0 - y) * log_1mp)
    return torch.sum(weights[:, None] * per) / (torch.sum(weights) * n)


def loss(P, graph, batch, weights, labels, layers: int, smoothing: float,
         opn: str = "mult"):
    x, rel = encode(P, graph, layers, opn)
    return bce(score_all(P, x, rel, batch[:, :2]), labels, weights, smoothing)


def adam(P: dict, grads: dict, state: dict, t: int, lr: float, b1=0.9, b2=0.999,
         eps=1e-8) -> dict:
    """One Adam step (t from 1) of every leaf; state holds each leaf's
    moments (zeros when absent) and is updated in place."""
    out = {}
    for k, g in grads.items():
        m, v = state.get(k, (torch.zeros_like(g), torch.zeros_like(g)))
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        state[k] = (m, v)
        step = lr * (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps)
        out[k] = P[k].detach() - step
    return out
