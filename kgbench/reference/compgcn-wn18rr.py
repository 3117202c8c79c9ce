"""Plain reference of CompGCN (Vashishth, Sanyal, Nitin and Talukdar,
Composition-based Multi-Relational Graph Convolutional Networks, ICLR 2020,
arXiv 1911.03082) with the Mult composition and the DistMult score, as the
configuration compgcn-wn18rr trains it on the full graph: the encoder over
the [forward; inverse] edges, the all-entity DistMult decoder and the
smoothed BCE against multi-hot labels (Adam is protocol.train_steps').

The benchmark's copy of the repository's tests/plain_compgcn.py, with
PARAMS and INIT named as the program's state_dict, and every contraction
(the projections and the decoder's product) through `ar`, so that the
control (TF32) reaches them all.  Plain PyTorch, TF32 off, no kernels, no
sorted segments: each message is projected on its own edge and the sums
over edges are index_add_.

Departures from the published description, which the program keeps from
the code it follows: the degree norm is 1/deg(receiving node) per
direction (CompGCN's code: the symmetric 1/sqrt(deg(head) deg(tail)));
the last layer has no activation (with one layer CompGCN applies tanh);
no dropout; a head bias and a tail bias (CompGCN: one, on the tail); label
smoothing puts eps/N on every entity (CompGCN's code adds 1/N).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BN_EPS = 1e-5
LOG_CLAMP = -100.0  # torch.nn.BCELoss's floor on each log term


def _widths(cfg) -> list:
    return [cfg["rank"]] + [cfg["hidden_dim"]] * cfg["layers"]


def PARAMS(cfg) -> dict:
    if cfg.get("basis", 0) or cfg.get("opn", "mult") != "mult" or cfg.get(
            "interaction", "distmult") != "distmult":
        raise ValueError("the reference is CompGCN with mult and distmult, no basis")
    n, nr, w = cfg["n_entities"], cfg["n_relations"], _widths(cfg)
    out = {"entity": (n, w[0]), "rel": (nr, w[0]), "bh": (n, 1), "bt": (n, 1)}
    for i, (di, do) in enumerate(zip(w[:-1], w[1:])):
        out.update({f"gnn.{i}.w_loop": (di, do), f"gnn.{i}.w_in": (di, do),
                    f"gnn.{i}.w_out": (di, do), f"gnn.{i}.w_rel": (di, do),
                    f"gnn.{i}.loop_rel": (1, di), f"gnn.{i}.bn_scale": (do,),
                    f"gnn.{i}.bn_bias": (do,)})
    return out


def INIT(cfg) -> dict:
    """The model's initial distributions: the tables N(0, init_size), the
    projections xavier N(0, 2 / (fan_in + fan_out)), the self loop's
    relation N(0, 1), batch norm's scale 1 and shift 0."""
    s, w = cfg["init_size"], _widths(cfg)
    out = {"entity": ["normal", 0.0, s], "rel": ["normal", 0.0, s],
           "bh": ["const", 0.0], "bt": ["const", 0.0]}
    for i, (di, do) in enumerate(zip(w[:-1], w[1:])):
        xavier = ["normal", 0.0, math.sqrt(2.0 / (di + do))]
        out.update({f"gnn.{i}.w_loop": xavier, f"gnn.{i}.w_in": xavier,
                    f"gnn.{i}.w_out": xavier, f"gnn.{i}.w_rel": xavier,
                    f"gnn.{i}.loop_rel": ["normal", 0.0, 1.0],
                    f"gnn.{i}.bn_scale": ["const", 1.0], f"gnn.{i}.bn_bias": ["const", 0.0]})
    return out


def edges(train: np.ndarray, n_rel2: int, device=None) -> dict:
    """The encoder's edges: each train triple (h, r, t) once in direction
    "in" (h receives t's message through r) and once in "out" (t receives
    h's through the inverse r + n_rel2 / 2)."""
    tr = torch.as_tensor(np.asarray(train), dtype=torch.int64, device=device)
    h, r, t = tr[:, 0], tr[:, 1], tr[:, 2]
    return {"in": (h, t, r), "out": (t, h, r + n_rel2 // 2)}


def layer(P, i: int, x, rel, graph: dict, last: bool, ar):
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
        msg = ar.mm(x[tail] * rel[et], p["w_" + mode]) * norm[:, None]
        total = total + torch.zeros((n, msg.shape[1]), dtype=x.dtype,
                                    device=x.device).index_add_(0, head, msg)
    out = (total + ar.mm(x * p["loop_rel"], p["w_loop"])) / 3.0
    mean = out.mean(dim=0, keepdim=True)
    var = ((out - mean) ** 2).mean(dim=0, keepdim=True)
    out = (out - mean) / torch.sqrt(var + BN_EPS) * p["bn_scale"] + p["bn_bias"]
    if not last:  # departure: CompGCN's one-layer model applies tanh here too
        out = torch.tanh(out)
    return out, ar.mm(rel, p["w_rel"])


def encode(P, graph: dict, cfg, ar):
    """(x', rel'): the entity and relation tables after the layer stack."""
    x, rel = P["entity"], P["rel"]
    for i in range(cfg["layers"]):
        x, rel = layer(P, i, x, rel, graph, i == cfg["layers"] - 1, ar)
    return x, rel


def score_all(P, x, rel, queries, ar):
    """DistMult over every entity: (x'[h] * rel'[r]) . x'[t] + bh[h] + bt[t]
    (departure: two biases)."""
    h, r = queries[:, 0], queries[:, 1]
    return ar.mm(x[h] * rel[r], x.T) + P["bh"][h] + P["bt"][:, 0][None, :]


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


def loss(P, graph: dict, batch, weights, labels, cfg, ar):
    """The step's loss: encode the graph, score the batch's queries against
    every entity, the smoothed BCE over the valid rows."""
    x, rel = encode(P, graph, cfg, ar)
    return bce(score_all(P, x, rel, batch[:, :2], ar), labels, weights,
               cfg["smoothing"] or 0.0)
