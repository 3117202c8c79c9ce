"""Plain reference of CompGCN (Vashishth, Sanyal, Nitin and Talukdar,
Composition-based Multi-Relational Graph Convolutional Networks, ICLR 2020,
arXiv 1911.03082) with the circular-correlation composition (Corr) and the
ConvE decoder, as the configuration compgcn-conve-fb237 trains it on the
full graph: the encoder over the [forward; inverse] edges, ConvE over each
query's encoded head and relation rows, its dot with every encoded entity
and the smoothed BCE against multi-hot labels (Adam is
protocol.train_steps').

The benchmark's copy of the repository's tests/plain_compgcn_conve.py,
with PARAMS and INIT named as the program's state_dict.  Plain PyTorch,
TF32 off, no kernels, no sorted segments, no FFT:
  * corr is its definition, ccorr(a, b)[k] = sum_i a[i] b[(i + k) mod d],
    computed in float64 in blocks of edges, each block recomputed in the
    backward (torch.utils.checkpoint) so that the (edges, d, d) shifts of
    one block at a time are held;
  * every contraction (the projections, ConvE's convolution as unfold and
    a product, fc and the scores) goes through `ar`, so that the control
    (TF32) reaches them all; corr is no matrix product on the card
    (the program transforms it through cuFFT in float32) and stays exact;
  * the interleave of [e; r] into the (2 k_w, k_h) image is written out,
    and each batch norm takes its batch's statistics (training; the
    running statistics do not enter a training step's loss).

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
from torch.utils.checkpoint import checkpoint

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BN_EPS = 1e-5
LOG_CLAMP = -100.0  # torch.nn.BCELoss's floor on each log term
CORR_BLOCK = 4096  # edges a block of the definition's (block, d, d) shifts


def _widths(cfg) -> list:
    return [cfg["rank"]] + [cfg["hidden_dim"]] * cfg["layers"]


def conve_shape(cfg) -> tuple:
    """(k_w, k_h, num_filt, ker_sz, flat): the decoder's image, filters and
    the flattened width of its convolution's output."""
    k_w, k_h, f, k = cfg["k_w"], cfg["k_h"], cfg["num_filt"], cfg["ker_sz"]
    return k_w, k_h, f, k, f * (2 * k_w - k + 1) * (k_h - k + 1)


def PARAMS(cfg) -> dict:
    if cfg.get("basis", 0) or cfg.get("opn") != "corr" or cfg.get("interaction") != "conve":
        raise ValueError("the reference is CompGCN with corr and conve, no basis")
    n, nr, w = cfg["n_entities"], cfg["n_relations"], _widths(cfg)
    out = {"entity": (n, w[0]), "rel": (nr, w[0]), "bh": (n, 1), "bt": (n, 1)}
    for i, (di, do) in enumerate(zip(w[:-1], w[1:])):
        out.update({f"gnn.{i}.w_loop": (di, do), f"gnn.{i}.w_in": (di, do),
                    f"gnn.{i}.w_out": (di, do), f"gnn.{i}.w_rel": (di, do),
                    f"gnn.{i}.loop_rel": (1, di), f"gnn.{i}.bn_scale": (do,),
                    f"gnn.{i}.bn_bias": (do,)})
    _, _, f, k, flat = conve_shape(cfg)
    h = w[-1]
    out.update({"conve.bn0_scale": (1,), "conve.bn0_bias": (1,), "conve.conv": (f, 1, k, k),
                "conve.bn1_scale": (f,), "conve.bn1_bias": (f,), "conve.fc": (flat, h),
                "conve.fc_bias": (h,), "conve.bn2_scale": (h,), "conve.bn2_bias": (h,)})
    return out


def INIT(cfg) -> dict:
    """The model's initial distributions: the tables N(0, init_size), the
    projections xavier N(0, 2 / (fan_in + fan_out)), the self loop's
    relation N(0, 1), batch norms' scale 1 and shift 0, ConvE's conv and fc
    (with its bias) U(+-1 / sqrt(fan_in)) as torch's Conv2d and Linear draw
    them."""
    s, w = cfg["init_size"], _widths(cfg)
    out = {"entity": ["normal", 0.0, s], "rel": ["normal", 0.0, s],
           "bh": ["const", 0.0], "bt": ["const", 0.0]}
    for i, (di, do) in enumerate(zip(w[:-1], w[1:])):
        xavier = ["normal", 0.0, math.sqrt(2.0 / (di + do))]
        out.update({f"gnn.{i}.w_loop": xavier, f"gnn.{i}.w_in": xavier,
                    f"gnn.{i}.w_out": xavier, f"gnn.{i}.w_rel": xavier,
                    f"gnn.{i}.loop_rel": ["normal", 0.0, 1.0],
                    f"gnn.{i}.bn_scale": ["const", 1.0], f"gnn.{i}.bn_bias": ["const", 0.0]})
    _, _, _, k, flat = conve_shape(cfg)
    conv, fc = 1.0 / k, 1.0 / math.sqrt(flat)
    for j in range(3):
        out.update({f"conve.bn{j}_scale": ["const", 1.0], f"conve.bn{j}_bias": ["const", 0.0]})
    out.update({"conve.conv": ["uniform", -conv, conv], "conve.fc": ["uniform", -fc, fc],
                "conve.fc_bias": ["uniform", -fc, fc]})
    return out


def edges(train: np.ndarray, n_rel2: int, device=None) -> dict:
    """The encoder's edges: each train triple (h, r, t) once in direction
    "in" (h receives t's message through r) and once in "out" (t receives
    h's through the inverse r + n_rel2 / 2)."""
    tr = torch.as_tensor(np.asarray(train), dtype=torch.int64, device=device)
    h, r, t = tr[:, 0], tr[:, 1], tr[:, 2]
    return {"in": (h, t, r), "out": (t, h, r + n_rel2 // 2)}


def _ccorr_block(a, b):
    d = a.shape[-1]
    k = torch.arange(d, device=a.device)
    shifted = b[..., (k[:, None] + k[None, :]) % d]  # [..., i, k] = b[(i + k) mod d]
    return torch.sum(a[..., :, None] * shifted, dim=-2)


def ccorr(a, b):
    """Circular correlation over the last axis by its definition, in
    float64, in blocks of CORR_BLOCK rows (b broadcasts over a's rows when
    it has one); the result in a's dtype."""
    out = []
    for i in range(0, a.shape[0], CORR_BLOCK):
        ab = a[i:i + CORR_BLOCK].double()
        bb = (b if b.shape[0] == 1 else b[i:i + CORR_BLOCK]).double()
        out.append(checkpoint(_ccorr_block, ab, bb, use_reentrant=False))
    return torch.cat(out).to(a.dtype)


def layer(P, i: int, x, rel, graph: dict, last: bool, ar):
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
        msg = ar.mm(ccorr(x[tail], rel[et]), p["w_" + mode]) * norm[:, None]
        total = total + torch.zeros((n, msg.shape[1]), dtype=x.dtype,
                                    device=x.device).index_add_(0, head, msg)
    out = (total + ar.mm(ccorr(x, p["loop_rel"]), p["w_loop"])) / 3.0
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


def interleave(e, r, k_w: int, k_h: int):
    """(B, h) rows -> (B, 1, 2 k_w, k_h): position 2 j holds e[j], 2 j + 1
    holds r[j], read row by row."""
    flat = torch.empty((e.shape[0], 2 * e.shape[1]), dtype=e.dtype, device=e.device)
    flat[:, 0::2] = e
    flat[:, 1::2] = r
    return flat.reshape(e.shape[0], 1, 2 * k_w, k_h)


def batch_norm(x, P, j: int):
    """ConvE's batch norm j over channel axis 1 with batch statistics."""
    dims = [d for d in range(x.dim()) if d != 1]
    shape = [1, x.shape[1]] + [1] * (x.dim() - 2)
    mean = x.mean(dim=dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
    out = (x - mean) / torch.sqrt(var + BN_EPS)
    return out * P[f"conve.bn{j}_scale"].reshape(shape) + P[f"conve.bn{j}_bias"].reshape(shape)


def conve(P, e, r, cfg, ar):
    """ConvE's (B, h) query rows: interleave, batch norm, the convolution
    (unfold and a product), batch norm, ReLU, fc, batch norm, ReLU."""
    k_w, k_h, f, k, flat = conve_shape(cfg)
    x = batch_norm(interleave(e, r, k_w, k_h), P, 0)
    cols = F.unfold(x, k)  # (B, k k, L), output positions row by row
    x = ar.mm(P["conve.conv"].reshape(f, k * k), cols)  # (B, f, L)
    x = torch.relu(batch_norm(x.reshape(x.shape[0], f, 2 * k_w - k + 1, k_h - k + 1), P, 1))
    x = ar.mm(x.reshape(x.shape[0], flat), P["conve.fc"]) + P["conve.fc_bias"]
    return torch.relu(batch_norm(x, P, 2))


def score_all(P, x, rel, queries, cfg, ar):
    """ConvE's rows dotted with every encoded entity, + bh[h] + bt[t]
    (departure: two biases)."""
    h, r = queries[:, 0], queries[:, 1]
    return ar.mm(conve(P, x[h], rel[r], cfg, ar), x.T) + P["bh"][h] + P["bt"][:, 0][None, :]


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
    """The step's loss: encode the graph, ConvE over the batch's queries
    against every entity, the smoothed BCE over the valid rows."""
    x, rel = encode(P, graph, cfg, ar)
    return bce(score_all(P, x, rel, batch[:, :2], cfg, ar), labels, weights,
               cfg["smoothing"] or 0.0)
