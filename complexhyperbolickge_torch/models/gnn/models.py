"""GNN encoder-decoder KG models: CompGCN, PoincareGCN, PoincareGAT,
LorentzGCN.

Port of complexhyperbolickge_tpu/models/gnn/models.py.  The encoder runs
over the FULL train graph once per training step: the [forward; inverse]
edge layout, each half sorted by its receiving node, is built once at
construction (message.FullGraph, with the K9 CSR offsets and the K10
backward permutations of both halves), and the layer stack lives in the
nn.ModuleList `gnn`, so state_dict keys read gnn.<layer>.<name>[.<i>].<leaf>
as the JAX params["gnn"][layer][name][i][leaf].  The graph tensors are not
buffers: build the model on the device it runs on.

`encode_subgraph` is the encoder over a sampled, padded subgraph
(data/sampler.py) through each conv's forward_masked: the subgraph's rows
of the entity table, its unsorted edges with dir_w = 1 for a forward
edge, and node_w (or None) masking the padded node rows.

Scoring takes the encoder output as `cache` (x, rel_pack); without one it
encodes first.  `cached_encode` keeps the eval-mode encoding per params
version (the parameters and their `_version` counters), so evaluation and
serving encode once per checkpoint or optimizer step.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from complexhyperbolickge_torch.models.base import (
    KGModel,
    NoMask,
    _softplus,
    dot_all,
    dot_train,
    neg_sq_dist,
)
from complexhyperbolickge_torch.models.gnn import message as M
from complexhyperbolickge_torch.models.gnn.convs import (
    CompGCNConv,
    ConvE,
    LorentzConv,
    PoincareConv,
    PoincareGATConv,
)
from complexhyperbolickge_torch.ops import hyperbolic as H
from complexhyperbolickge_torch.ops.euclidean import givens_rotations
from complexhyperbolickge_torch.ops.math import tanh as _tanh
from complexhyperbolickge_torch.utils.profiling import span
from complexhyperbolickge_torch.utils.versions import is_current, params_key

GNN_MODELS = ["CompGCN", "PoincareGCN", "PoincareGAT", "LorentzGCN"]

# ConvE's published shape (CompGCN's run.py defaults): a 2 k_w x k_h image,
# num_filt filters of ker_sz x ker_sz
CONVE_DEFAULTS = {"k_w": 10, "k_h": 20, "num_filt": 200, "ker_sz": 7}


class TrainingEncoding(tuple):
    """A training encode's (x, rel_pack) with the step's generator: a
    decoder with state of its own (ConvE's batch norms and dropouts) runs in
    training mode on it, and in eval mode on a plain tuple."""

    def __new__(cls, cache, generator):
        out = super().__new__(cls, cache)
        out.generator = generator
        return out


class GNNModel(KGModel):
    """Shared encoder plumbing.  args: the run config (hidden_dim, layers,
    edge_dropout, dropout and the model's own flags); dataset: its
    data["train"] (forward triples) is the graph."""

    is_gnn = True
    conv_cls = None
    act_r_on_rel = True  # tanh on the relation part between layers

    def __init__(self, cfg, args, dataset, device=None,
                 generator: torch.Generator | None = None):
        self.hidden_dim = getattr(args, "hidden_dim", None) or cfg.rank
        self.n_layers = getattr(args, "layers", 2)
        self.edge_dropout = getattr(args, "edge_dropout", 0.0)
        self.feat_dropout = getattr(args, "dropout", 0.0)
        # feature dropout on x between layers, besides each conv's own
        # (CompGCN turns it on)
        self.drop_in_between = False
        super().__init__(cfg, device=device, generator=generator)
        train = np.asarray(dataset.data["train"])
        # each half sorted by its receiving node, stably
        pf = np.argsort(train[:, 0], kind="stable")
        pi = np.argsort(train[:, 2], kind="stable")
        self._perm = (torch.as_tensor(pf, device=device), torch.as_tensor(pi, device=device))
        self.graph = M.FullGraph(
            np.concatenate([train[pf, 0], train[pi, 2]]),
            np.concatenate([train[pf, 2], train[pi, 0]]),
            np.concatenate([train[pf, 1], train[pi, 1] + cfg.n_relations // 2]),
            cfg.n_entities, device)
        self.gnn = nn.ModuleList(
            self.conv_cls(*ch[:4], act=ch[4], dropout=ch[5], **self.conv_kwargs(i),
                          dtype=cfg.torch_dtype, device=device)
            for i, ch in enumerate(self._channels()))
        for layer in self.gnn:
            layer.reset_parameters(generator)
        self._encoded = None

    def reset_parameters(self, generator: torch.Generator | None = None):
        """The base tables' draws, then each layer's (from `generator`)."""
        super().reset_parameters(generator)
        for layer in getattr(self, "gnn", ()):
            layer.reset_parameters(generator)

    # ------------------------------ layer stack ------------------------------

    def _channels(self):
        """(d_in, d_out, d_in_r, d_out_r, act, dropout) per layer."""
        r, h = self.cfg.rank, self.hidden_dim
        rin, rh = self.rel_channels(r), self.rel_channels(h)
        if self.n_layers == 1:
            return [(r, h, rin, rh, None, 0.0)]
        out = [(r, h, rin, rh, _tanh, self.feat_dropout)]
        for _ in range(self.n_layers - 2):
            out.append((h, h, rh, rh, _tanh, self.feat_dropout))
        out.append((h, h, rh, rh, None, 0.0))
        return out

    def rel_channels(self, d):
        return 3 * d

    def conv_kwargs(self, layer_idx: int):
        return {}

    # -------------------------------- encoder --------------------------------

    def get_r(self):
        raise NotImplementedError

    def encode(self, generator: torch.Generator | None = None, training: bool = False):
        """The full-graph encoder: edge dropout as a weight mask (one draw
        per forward edge, shared by its inverse), then the layer stack with
        its dropouts.  Dropout draws from `generator` in training only.  A
        training encode is the profiler range kge.train.encode (inside the
        step's kge.train.loss)."""
        if not training:
            return self._encode(None)
        with span("train.encode"):
            return self._encode(generator)

    def _encode(self, generator):
        x = self.entity
        rel_pack = self.get_r()
        pf, pi = self._perm
        mask = M.edge_dropout_mask(generator, pf.shape[0], self.edge_dropout,
                                   dtype=x.dtype, device=x.device)
        edge_w = torch.cat([mask[pf], mask[pi]])
        last = len(self.gnn) - 1
        for i, layer in enumerate(self.gnn):
            x, rel_pack = layer(x, self.graph, rel_pack, edge_w, generator=generator)
            if i != last:
                if self.drop_in_between and self.feat_dropout > 0 and generator is not None:
                    x = M.dropout(generator, x, self.feat_dropout)
                rel_pack = self._act_r(rel_pack)
        return self.finish_cache(x, rel_pack)

    def encode_subgraph(self, node_ids, edges, edge_w, node_w,
                        generator: torch.Generator | None = None, training: bool = False):
        """The encoder over a sampled subgraph: node_ids (M,) global ids of
        its rows, edges (E, 3) (local head, type, local tail), edge_w (E,)
        masking padded (and non-train) edges, node_w (M,) masking padded
        rows (None: every row is real).  Edge dropout multiplies edge_w,
        then the layer stack with its dropouts; both draw from `generator`
        in training only."""
        if not training:
            generator = None
        x = self.entity[node_ids]
        rel_pack = self.get_r()
        head, etype, tail = edges[:, 0], edges[:, 1], edges[:, 2]
        dir_w = (etype < self.cfg.n_relations // 2).to(x.dtype)
        edge_w = edge_w.to(x.dtype)
        if node_w is not None:
            node_w = node_w.to(x.dtype)
        if generator is not None:
            edge_w = edge_w * M.edge_dropout_mask(generator, edge_w.shape[0], self.edge_dropout,
                                                  dtype=x.dtype, device=x.device)
        last = len(self.gnn) - 1
        for i, layer in enumerate(self.gnn):
            x, rel_pack = layer.forward_masked(x, (head, tail, etype), rel_pack, edge_w, dir_w,
                                               node_w, generator=generator)
            if i != last:
                if self.drop_in_between and self.feat_dropout > 0 and generator is not None:
                    x = M.dropout(generator, x, self.feat_dropout)
                rel_pack = self._act_r(rel_pack)
        return self.finish_cache(x, rel_pack)

    @torch.no_grad()
    def cached_encode(self):
        """encode() in eval mode, kept until a parameter changes (keyed on
        the parameter objects and their _version counters, which every
        in-place update bumps).  One slot, written at once, so a reader
        never pairs one version's params with another's encoding."""
        key = params_key(self.parameters())
        if self._encoded is None or not is_current(self._encoded[0], key):
            self._encoded = (key, self.encode())
        return self._encoded[1]

    def _act_r(self, rel_pack):
        if not self.act_r_on_rel:
            return rel_pack
        if isinstance(rel_pack, tuple):  # (rel, curvature): tanh on rel only
            return (_tanh(rel_pack[0]), rel_pack[1])
        return _tanh(rel_pack)

    def finish_cache(self, x, rel_pack):
        return (x, rel_pack)

    # -------------------------------- scoring --------------------------------

    def get_queries(self, queries, cache=None):
        raise NotImplementedError

    def score(self, queries, tails, cache=None):
        cache = cache if cache is not None else self.encode()
        lhs, lhs_b = self.get_queries(queries, cache)
        s = self.sim(lhs, cache[0][tails], all_pairs=False)
        return self._apply_bias(s, lhs_b, self.bt[tails], all_pairs=False)

    def score_all(self, queries, cache=None):
        cache = cache if cache is not None else self.encode()
        lhs, lhs_b = self.get_queries(queries, cache)
        s = self.sim(lhs, cache[0], all_pairs=True)
        return self._apply_bias(s, lhs_b, self.bt, all_pairs=True)

    def get_factors(self, queries=None, tails=None):
        """The encoder's regularizable weight matrices, each a NoMask: they
        are not batches, whatever their leading dim."""
        return tuple(NoMask(f) for layer in self.gnn for f in layer.regularizable())


class BoundGNN:
    """A GNN model with its encoder output bound: the losses call
    get_queries / score_ids / score on it as on any KGModel."""

    def __init__(self, model: GNNModel, cache):
        self.model = model
        self.cache = cache
        self.cfg = model.cfg

    def get_queries(self, queries):
        return self.model.get_queries(queries, self.cache)

    def get_rhs(self, tails=None):
        if tails is None:
            return self.cache[0], self.model.bt
        return self.cache[0][tails], self.model.bt[tails]

    def sim(self, lhs_pack, rhs_e, all_pairs: bool):
        return self.model.sim(lhs_pack, rhs_e, all_pairs)

    def _apply_bias(self, s, lhs_bias, rhs_bias, all_pairs: bool):
        return self.model._apply_bias(s, lhs_bias, rhs_bias, all_pairs)

    def score_ids(self, lhs_pack, lhs_bias, ids):
        return KGModel.score_ids(self, lhs_pack, lhs_bias, ids)

    def score(self, queries, tails):
        return self.model.score(queries, tails, cache=self.cache)

    def score_all(self, queries):
        return self.model.score_all(queries, cache=self.cache)

    def get_factors(self, queries=None, tails=None):
        return self.model.get_factors()


# -------------------------------- CompGCN ------------------------------------


class CompGCN(GNNModel):
    """CompGCN with optional basis decomposition and a distmult, transe or
    conve decoder.  conve (convs.ConvE) reads k_w, k_h, num_filt and ker_sz
    from the run config (CONVE_DEFAULTS where absent) and its dropouts
    from `dropout`; its module `conve` holds its parameters (conve.<name>)
    and its batch norms' running statistics.  A training encode returns a
    TrainingEncoding, on which get_queries runs the decoder in training
    mode inside the profiler range kge.train.decode."""

    conv_cls = CompGCNConv
    act_r_on_rel = False  # the reference's act_r is the identity
    INTERACTIONS = ("distmult", "transe", "conve")

    def __init__(self, cfg, args, dataset, device=None, generator=None):
        self.basis = getattr(args, "basis", 0) or 0
        self.opn = getattr(args, "opn", "mult") or "mult"
        self.interaction = (getattr(args, "interaction", "distmult") or "distmult").lower()
        if self.interaction not in self.INTERACTIONS:
            raise ValueError(f"unknown interaction {self.interaction!r}")
        super().__init__(cfg, args, dataset, device=device, generator=generator)
        self.drop_in_between = True
        self.conve = None
        if self.interaction == "conve":
            shape = {k: getattr(args, k, None) or v for k, v in CONVE_DEFAULTS.items()}
            self.conve = ConvE(self.hidden_dim, **shape,
                               dropout=self.feat_dropout, dtype=cfg.torch_dtype, device=device)
            self.conve.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """The tables' and layers' draws, then the decoder's."""
        super().reset_parameters(generator)
        if getattr(self, "conve", None) is not None:
            self.conve.reset_parameters(generator)

    def rel_channels(self, d):
        return d

    def conv_kwargs(self, layer_idx: int):
        return {"opn": self.opn}

    def extra_param_specs(self):
        if self.basis > 0:
            # a fresh nn.Embedding in the reference: N(0, 1), not init_size
            return {"rel_basis": ((self.basis, self.cfg.rank), ("normal", 0.0, 1.0))}
        return {}

    def param_specs(self):
        specs = super().param_specs()
        if self.basis > 0:  # rel holds the (Nr, B) basis coefficients
            specs["rel"] = ((self.cfg.n_relations, self.basis), ("normal", 0.0, 1.0))
        return specs

    def get_r(self):
        return torch.matmul(self.rel, self.rel_basis) if self.basis > 0 else self.rel

    def encode(self, generator: torch.Generator | None = None, training: bool = False):
        cache = super().encode(generator, training)
        return TrainingEncoding(cache, generator) if training and self.conve is not None else cache

    def encode_subgraph(self, *args, **kwargs):
        if self.conve is not None:
            raise ValueError("CompGCN's conve decoder trains on the full graph only, "
                             "not with --subgraph")
        return super().encode_subgraph(*args, **kwargs)

    def get_queries(self, queries, cache=None):
        x, r = cache if cache is not None else self.encode()
        head, rel = x[queries[..., 0]], r[queries[..., 1]]
        if self.interaction == "conve":
            if isinstance(cache, TrainingEncoding):
                with span("train.decode"):
                    lhs = self.conve(head, rel, cache.generator, training=True)
            else:
                lhs = self.conve(head, rel)
        elif self.interaction == "distmult":
            lhs = head * rel
        else:
            lhs = head + rel
        return (lhs,), self.bh[queries[..., 0]]

    def sim(self, lhs_pack, rhs_e, all_pairs: bool):
        (lhs,) = lhs_pack
        if self.interaction == "transe":
            return neg_sq_dist(lhs, rhs_e, all_pairs)
        return dot_all(lhs, rhs_e) if all_pairs else dot_train(lhs, rhs_e)


# ------------------------------- PoincareGCN ---------------------------------


class PoincareGCN(GNNModel):
    """Poincare-ball GCN; agg_method (--gnn_agg_method) selects the conv's
    aggregation (1, 2 or 3)."""

    conv_cls = PoincareConv

    def __init__(self, cfg, args, dataset, device=None, generator=None):
        self.agg_method = getattr(args, "gnn_agg_method", 1) or 1
        super().__init__(cfg, args, dataset, device=device, generator=generator)

    def conv_kwargs(self, layer_idx: int):
        return {"agg_method": self.agg_method}

    @property
    def rel_dim(self):
        return 2 * self.cfg.rank

    def extra_param_specs(self):
        nr = self.cfg.n_relations
        return {
            "rel_diag": ((nr, self.cfg.rank), "uniform"),
            # the first layer's raw per-relation curvature: a fresh
            # nn.Embedding (N(0, 1)) with multi_c, a zero scalar without
            "c_layer": (((nr, 1), ("normal", 0.0, 1.0)) if self.cfg.multi_c
                        else ((1, 1), "zeros")),
        }

    def get_r(self):
        r = torch.cat([self.rel, self.rel_diag], dim=-1)
        c = self.c_layer
        if not self.cfg.multi_c and c.shape[0] != r.shape[0]:
            c = c.expand(r.shape[0], 1)
        return (r, c)

    def finish_cache(self, x, rel_pack):
        r, c_raw = rel_pack
        c = _softplus(c_raw)
        if not self.cfg.multi_c:
            c = torch.mean(c, dim=0, keepdim=True)
        return (x, (r, c))

    def get_queries(self, queries, cache=None):
        x, (r, curv) = cache if cache is not None else self.encode()
        h, rid = queries[..., 0], queries[..., 1]
        rel1, rel2, rot = torch.chunk(r[rid], 3, dim=-1)
        c = curv[rid] if self.cfg.multi_c else curv  # (B, 1) or (1, 1)
        head = H.expmap0(x[h], c)
        lhs = H.project(H.mobius_add(H.expmap0(rel1, c), head, c), c)
        res2 = H.mobius_add(H.expmap0(rel2, c), givens_rotations(rot, lhs), c)
        return (res2, c), self.bh[h]

    def sim(self, lhs_pack, rhs_e, all_pairs: bool):
        lhs, c = lhs_pack
        if all_pairs:
            if self.cfg.multi_c:
                return -H.hyp_sim_expmap_all(lhs, rhs_e, c) ** 2
            return -H.hyp_plain_sim_expmap_all(lhs, rhs_e, c) ** 2
        c3 = c[..., None]
        rhs_h = H.expmap0(rhs_e, c3)
        if self.cfg.multi_c:
            return -H.hyp_distance_multi_c(lhs[:, None, :], rhs_h, c3)[..., 0] ** 2
        return -H.hyp_distance(lhs[:, None, :], rhs_h, c3)[..., 0] ** 2


# -------------------------------- PoincareGAT --------------------------------


class PoincareGAT(PoincareGCN):
    """Multi-head-attention Poincare GCN.  Head gather per layer: the first
    layer 'mean' with one layer and 'concat' otherwise, hidden layers
    'concat', the last layer 'mean'.  hidden_dim must be divisible by
    2 * heads (= 8) for the concat layers."""

    conv_cls = PoincareGATConv

    def conv_kwargs(self, layer_idx: int):
        n = self.n_layers
        if layer_idx == 0:
            gather = "mean" if n < 2 else "concat"
        elif layer_idx == n - 1:
            gather = "mean"
        else:
            gather = "concat"
        return {"gather": gather, "agg_method": self.agg_method}


# -------------------------------- LorentzGCN ---------------------------------


class LorentzGCN(GNNModel):
    """Hyperboloid GCN."""

    conv_cls = LorentzConv

    @property
    def rel_dim(self):
        return 2 * self.cfg.rank

    def extra_param_specs(self):
        nr = self.cfg.n_relations
        # c_layer: per relation always, a fresh nn.Embedding (N(0, 1))
        return {"rel_diag": ((nr, self.cfg.rank), "uniform"),
                "c_layer": ((nr, 1), ("normal", 0.0, 1.0))}

    def get_r(self):
        return (torch.cat([self.rel, self.rel_diag], dim=-1), self.c_layer)

    finish_cache = PoincareGCN.finish_cache

    def get_queries(self, queries, cache=None):
        x, (r, curv) = cache if cache is not None else self.encode()
        h, rid = queries[..., 0], queries[..., 1]
        rel1, rel2, rot = torch.chunk(r[rid], 3, dim=-1)
        c = curv[rid] if self.cfg.multi_c else curv
        lhs = H.lorentz_boost(H.expmap0_lorentz(x[h], c), rel1, c)
        res2 = H.lorentz_boost(givens_rotations(rot, lhs), rel2, c)
        return (res2, c), self.bh[h]

    def sim(self, lhs_pack, rhs_e, all_pairs: bool):
        lhs, c = lhs_pack
        if all_pairs:
            return -H.lorentz_sim_expmap_all(lhs, rhs_e, c) ** 2
        c3 = c[..., None]
        rhs_h = H.expmap0_lorentz(rhs_e, c3)
        return -H.hyp_distance_multi_c_lorentz(lhs[:, None, :], rhs_h, c3)[..., 0] ** 2
