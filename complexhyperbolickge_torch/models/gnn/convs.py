"""Graph convolution layers: CompGCN, Poincare, Lorentz, Poincare GAT.

Port of complexhyperbolickge_tpu/models/gnn/convs.py.  Each conv is an
nn.Module whose parameters carry the JAX names (w_loop, w_in, ..., w_rel.w,
mlp_curvature.<i>.w), so a JAX layer dict loads one to one, and has two
forwards:
  * forward(x, graph, rel_pack, edge_w, generator) is JAX's apply(p, x,
    edges, rel_pack, edge_w, key) over a message.FullGraph: the edge gathers
    x[tail[half]] run through K10 and every sum over the receiving-node
    halves through K9;
  * forward_masked(x, (head, tail, etype), rel_pack, edge_w, dir_w, node_w,
    generator) is JAX's apply_masked over a sampled subgraph: the edges are
    unsorted, dir_w is 1 for a forward edge and selects the in / out
    weights per edge, node_w masks padded node rows (CompGCN's batch norm).
    Its gathers are plain indexing and its sums the unsorted
    message.segment_sum (index_add_), as JAX's masked forms use
    jax.ops.segment_sum.
The message and mixing math is shared; only the index forms handed to the
sums differ.  The per-edge lookups of a relation table (rel[etype], and
the curvature's and attention's) go through message.relation_rows, whose
backward is the range kge.train.rel_grad; forward passes each half's
relation-sorted layout (graph.rel_layouts, shifted for the swapped types),
so on the card that backward is the split-segment kernels.  The masked
forms and PoincareGATConv's attention term (over both halves at once)
pass none; CompGCN's forward_masked keeps plain indexing.

The JAX code's documented quirks are kept:
  * PoincareConv uses the softplused curvature for both b_rel Mobius adds.
  * LorentzConv and PoincareGATConv message with the swapped relation type,
    per edge: a forward edge of type t with t + n_rel/2, an inverse edge
    with t - n_rel/2 (the halves are sorted, not edge-aligned).
  * PoincareGATConv's attention term uses the unswapped edge type.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from complexhyperbolickge_torch.models.base import _softplus
from complexhyperbolickge_torch.models.gnn import message as M
from complexhyperbolickge_torch.ops import hyperbolic as H
from complexhyperbolickge_torch.ops.euclidean import givens_rotations
from complexhyperbolickge_torch.ops.fft import _fft_dtype
from complexhyperbolickge_torch.utils.nn import MLP, Linear
from complexhyperbolickge_torch.utils.profiling import span

# since the last reset_counts(): CompGCN compositions that took `corr`, and
# ConvE decoder calls
counts = {"corr": 0, "conve": 0}

OPNS = ("mult", "add", "corr")


def reset_counts():
    for k in counts:
        counts[k] = 0


def ccorr(a, b):
    """Circular correlation over the last axis, CompGCN's `corr`:
    ccorr(a, b)[k] = sum_i a[i] b[(i + k) mod d], computed as CompGCN
    computes it, irfft(conj(rfft(a)) * rfft(b)) with torch.fft's default
    norms (rfft unnormalised, irfft over d), which give the definition
    exactly; ops/fft.py's norm="ortho" transforms would give it over
    sqrt(d).  bfloat16 runs its transforms in float32."""
    d = a.shape[-1]
    ft = _fft_dtype(a.dtype)
    fa = torch.fft.rfft(a.to(ft), dim=-1)
    fb = torch.fft.rfft(b.to(ft), dim=-1)
    return torch.fft.irfft(torch.conj(fa) * fb, n=d, dim=-1).to(a.dtype)


def _draw(kind: str, shape, generator):
    """A CPU draw of one init kind: xavier N(0, 2 / (fan_in + fan_out)) on
    the last two axes; xavier_torch with torch's fans for >= 2-D tensors;
    normal N(0, 1); zeros; ones."""
    if kind == "xavier":
        std = math.sqrt(2.0 / (shape[-2] + shape[-1]))
    elif kind == "xavier_torch":
        rf = math.prod(shape[2:]) if len(shape) > 2 else 1
        std = math.sqrt(2.0 / ((shape[0] + shape[1]) * rf))
    elif kind == "normal":
        std = 1.0
    elif kind in ("zeros", "ones"):
        return (torch.zeros if kind == "zeros" else torch.ones)(shape)
    else:
        raise ValueError(f"unknown init kind {kind}")
    return torch.randn(shape, generator=generator) * std


class _Conv(nn.Module):
    """Parameters from `param_specs` (name -> (shape, init kind)) plus any
    submodules with their own reset_parameters."""

    def _register(self, dtype, device):
        for name, (shape, _) in self.param_specs().items():
            setattr(self, name, nn.Parameter(torch.empty(shape, dtype=dtype, device=device)))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        for name, (shape, kind) in self.param_specs().items():
            getattr(self, name).copy_(_draw(kind, shape, generator))
        for m in self.children():
            m.reset_parameters(generator)


# -------------------------------- CompGCN ------------------------------------


class CompGCNConv(_Conv):
    """Composition GCN layer: message = composition(x_tail, rel) @ W_dir for
    dir in {in, out, loop}; 1/3 each of the degree-normalized in and out
    sums and the self loop; batch norm over nodes with batch statistics;
    activation; rel' = rel @ W_rel.  The composition (opn) is mult (x * r),
    add (x - r, CompGCN's sub) or corr (ccorr(x, r)); a corr composition's
    forward is the profiler range kge.train.corr and counts in
    counts["corr"]."""

    def __init__(self, d_in, d_out, d_in_r, d_out_r, act, dropout=0.0, opn="mult",
                 dtype=None, device=None):
        super().__init__()
        if opn not in OPNS:
            raise ValueError(f"unknown composition {opn!r} (one of {', '.join(OPNS)})")
        self.d_in, self.d_out, self.d_in_r, self.d_out_r = d_in, d_out, d_in_r, d_out_r
        self.act, self.dropout, self.opn = act, dropout, opn
        self._register(dtype, device)

    def param_specs(self):
        di, do = self.d_in, self.d_out
        return {"w_loop": ((di, do), "xavier"), "w_in": ((di, do), "xavier"),
                "w_out": ((di, do), "xavier"),
                "w_rel": ((self.d_in_r, self.d_out_r), "xavier"),
                "loop_rel": ((1, di), "normal"), "bn_scale": ((do,), "ones"),
                "bn_bias": ((do,), "zeros")}

    def _compose(self, x, r):
        if self.opn == "corr":
            counts["corr"] += 1
            with span("train.corr"):
                return ccorr(x, r)
        return x - r if self.opn == "add" else x * r

    def _bn(self, out, node_w=None):
        """Batch norm with batch statistics; node_w (N,) keeps padded rows
        out of them."""
        if node_w is None:
            mean = torch.mean(out, dim=0, keepdim=True)
            var = torch.var(out, dim=0, keepdim=True, unbiased=False)
        else:
            w = node_w[:, None]
            n = torch.clamp_min(torch.sum(w), 1.0)
            mean = torch.sum(out * w, dim=0, keepdim=True) / n
            var = torch.sum(w * (out - mean) ** 2, dim=0, keepdim=True) / n
        return (out - mean) / torch.sqrt(var + 1e-5) * self.bn_scale + self.bn_bias

    @staticmethod
    def _direction(comp, seg, w_edge, w_mat, n_ent):
        """The degree-normalized sum of comp over one direction's edges
        (seg: their receiving-node index form), times w_mat.  The matmul
        comes after the sum: the sum is linear and w_mat the same for every
        edge."""
        norm = M.compute_norm(seg, w_edge, n_ent)
        return torch.matmul(M.segment_sum(norm[:, None] * comp, seg, n_ent), w_mat)

    def _finish(self, agg_in, agg_out, x, rel, generator, node_w=None):
        loop = torch.matmul(self._compose(x, self.loop_rel), self.w_loop)
        if generator is not None and self.dropout > 0:
            agg_in = M.dropout(generator, agg_in, self.dropout)
            agg_out = M.dropout(generator, agg_out, self.dropout)
        out = self._bn((agg_in + agg_out + loop) / 3.0, node_w)
        if self.act is not None:
            out = self.act(out)
        return out, torch.matmul(rel, self.w_rel)

    def forward(self, x, graph, rel, edge_w, generator=None):
        n_ent = x.shape[0]

        def direction(i, w):
            sl = graph.half_slice(i)
            rel_e = M.relation_rows(rel, graph.etype[sl], graph.rel_layouts[i])
            comp = self._compose(graph.tail_gathers[i](x), rel_e)
            return self._direction(comp, graph.heads.halves[i], edge_w[sl], w, n_ent)

        return self._finish(direction(0, self.w_in), direction(1, self.w_out), x, rel,
                            generator)

    def forward_masked(self, x, edges, rel, edge_w, dir_w, node_w, generator=None):
        head, tail, etype = edges
        n_ent = x.shape[0]
        comp = self._compose(x[tail], rel[etype])
        agg_in = self._direction(comp, head, edge_w * dir_w, self.w_in, n_ent)
        agg_out = self._direction(comp, head, edge_w * (1.0 - dir_w), self.w_out, n_ent)
        return self._finish(agg_in, agg_out, x, rel, generator, node_w)

    def regularizable(self):
        return [self.w_loop, self.w_in, self.w_out, self.w_rel]


# ------------------------------ ConvE decoder --------------------------------


class ConvE(nn.Module):
    """CompGCN's ConvE decoder (model/models.py CompGCN_ConvE) over a batch
    of encoded (head, relation) rows (B, h), h = k_w * k_h:
      1. interleave [e; r] into a (B, 1, 2 k_w, k_h) image (e0, r0, e1, r1,
         ... row by row: CompGCN's cat, transpose(2, 1) and reshape);
      2. batch norm over the one channel;
      3. a num_filt x ker_sz x ker_sz convolution, no bias;
      4. batch norm over the filters, ReLU;
      5. flatten, a linear map (fc, fc_bias) to h;
      6. batch norm over the h features, ReLU.
    The caller takes the result's dot with every encoded entity.  Each batch
    norm takes batch statistics in training and updates its running mean
    and (unbiased) variance by momentum 0.1, as torch.nn.BatchNorm does;
    out of training it normalizes by the running ones.  The running
    statistics are buffers outside state_dict() (persistent=False), so the
    state_dict holds the parameters alone; checkpoints carry them beside
    the parameters (train/checkpoint.py::state_buffers).

    Dropout, in training with a generator, at the `dropout` rate: on the
    head rows before the interleave (CompGCN's hid_drop drops the whole
    encoded table, the candidates too), after the convolution's ReLU
    (feat_drop) and after fc (hid_drop2).  Parameters: conv (num_filt, 1,
    ker_sz, ker_sz) and fc (flat, h) with fc_bias (h,) drawn as torch's
    Conv2d and Linear draw them (kaiming_uniform_(a=sqrt(5)): U(+-1 /
    sqrt(fan_in))), each batch norm's scale 1 and shift 0."""

    MOMENTUM, EPS = 0.1, 1e-5

    def __init__(self, h: int, k_w: int, k_h: int, num_filt: int, ker_sz: int,
                 dropout: float = 0.0, dtype=None, device=None):
        super().__init__()
        if h != k_w * k_h:
            raise ValueError(f"ConvE needs the last layer's width {h} to equal k_w * k_h = "
                             f"{k_w} * {k_h}")
        if ker_sz > min(2 * k_w, k_h):
            raise ValueError(f"ConvE's kernel {ker_sz} exceeds its {2 * k_w} x {k_h} image")
        self.h, self.k_w, self.k_h, self.num_filt, self.ker_sz = h, k_w, k_h, num_filt, ker_sz
        self.dropout = dropout
        self.flat = num_filt * (2 * k_w - ker_sz + 1) * (k_h - ker_sz + 1)
        for name, (shape, _) in self.param_specs().items():
            setattr(self, name, nn.Parameter(torch.empty(shape, dtype=dtype, device=device)))
        for i, n in enumerate((1, num_filt, h)):
            self.register_buffer(f"bn{i}_mean", torch.zeros(n, dtype=dtype, device=device),
                                 persistent=False)
            self.register_buffer(f"bn{i}_var", torch.ones(n, dtype=dtype, device=device),
                                 persistent=False)

    def param_specs(self):
        """name -> (shape, fan_in for U(+-1 / sqrt(fan_in)), or "ones" / "zeros")."""
        f, k, h = self.num_filt, self.ker_sz, self.h
        return {"bn0_scale": ((1,), "ones"), "bn0_bias": ((1,), "zeros"),
                "conv": ((f, 1, k, k), k * k),
                "bn1_scale": ((f,), "ones"), "bn1_bias": ((f,), "zeros"),
                "fc": ((self.flat, h), self.flat), "fc_bias": ((h,), self.flat),
                "bn2_scale": ((h,), "ones"), "bn2_bias": ((h,), "zeros")}

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Draws on the CPU from `generator`, in param_specs' order; fresh
        running statistics (mean 0, variance 1)."""
        for name, (shape, kind) in self.param_specs().items():
            if kind == "ones":
                v = torch.ones(shape)
            elif kind == "zeros":
                v = torch.zeros(shape)
            else:
                v = (torch.rand(shape, generator=generator) * 2.0 - 1.0) / math.sqrt(kind)
            getattr(self, name).copy_(v)
        for name, buf in self.named_buffers():
            buf.fill_(0.0 if name.endswith("_mean") else 1.0)

    def interleave(self, e, r):
        """(B, h) head and relation rows -> the (B, 1, 2 k_w, k_h) image."""
        return torch.stack([e, r], dim=-1).reshape(e.shape[0], 1, 2 * self.k_w, self.k_h)

    def _bn(self, x, i: int, training: bool):
        return torch.nn.functional.batch_norm(
            x, getattr(self, f"bn{i}_mean"), getattr(self, f"bn{i}_var"),
            getattr(self, f"bn{i}_scale"), getattr(self, f"bn{i}_bias"), training,
            self.MOMENTUM, self.EPS)

    def forward(self, e, r, generator=None, training: bool = False):
        """The decoder's (B, h) query rows of head rows e and relation rows
        r; dropout draws from `generator` in training only."""
        counts["conve"] += 1
        gen = generator if training else None
        x = self.interleave(M.dropout(gen, e, self.dropout), r)
        x = self._bn(x, 0, training)
        x = torch.nn.functional.conv2d(x, self.conv)
        x = M.dropout(gen, torch.relu(self._bn(x, 1, training)), self.dropout)
        x = torch.matmul(x.reshape(x.shape[0], self.flat), self.fc) + self.fc_bias
        x = M.dropout(gen, x, self.dropout)
        return torch.relu(self._bn(x, 2, training))


# ------------------------------ PoincareConv ---------------------------------


class PoincareConv(_Conv):
    """Poincare-ball conv: RotH-style relation transform per edge in the
    tangent space, then one of three aggregation methods (agg_method, the
    --gnn_agg_method flag):
      1: symmetric-normalized tangent aggregation, gyro-midpoint mixing with
         the self-loop message;
      2: gyromidpoint over [edges; self-loops] jointly;
      3: per-direction 1/deg tangent means, 1/3 mix with the self loop.
    Relation and curvature update by a learned linear map and MLP."""

    # forward_masked messages with each edge's own relation type; LorentzConv
    # and PoincareGATConv swap it (_swapped_etype), as their forward does
    swapped_types = False

    def __init__(self, d_in, d_out, d_in_r, d_out_r, act, dropout=0.0,
                 agg_method: int = 1, dtype=None, device=None):
        super().__init__()
        self.d_in, self.d_out, self.d_in_r, self.d_out_r = d_in, d_out, d_in_r, d_out_r
        self.act, self.dropout = act, dropout
        if agg_method not in (1, 2, 3):
            raise ValueError(f"agg_method must be 1, 2 or 3, got {agg_method}")
        self.agg_method = agg_method
        self._register(dtype, device)
        self.w_rel = Linear(3 * d_in + 1, 3 * d_out, dtype=dtype, device=device)
        self.mlp_curvature = MLP(3 * d_in + 1, 3 * d_in, 1, dtype=dtype, device=device)

    def param_specs(self):
        di, do = self.d_in, self.d_out
        return {"w_loop": ((di, do), "xavier"), "w_in": ((di, do), "xavier"),
                "w_out": ((di, do), "xavier"), "b_loop": ((1, do), "zeros"),
                "b_in": ((1, do), "zeros"), "b_out": ((1, do), "zeros"),
                "b_rel1": ((1, do), "zeros"), "b_rel2": ((1, do), "zeros"),
                "loop_curvature": ((1,), "ones"), "loop_weight": ((1,), "zeros")}

    # ---- manifold pieces (Poincare) ----

    def _rel_transform(self, ent, rel_emb, c):
        """RotH-style inverse isometry in the ball, back to the tangent space."""
        rel1, rel2, rot = torch.chunk(rel_emb, 3, dim=-1)
        lhs = H.expmap0(ent, c)
        rel1 = H.expmap0(rel1, c)
        rel2 = H.expmap0(rel2, c)
        lhs = H.project(H.mobius_add(-rel2, lhs, c), c)
        lhs = givens_rotations(rot, lhs, inverse=True)
        lhs = H.mobius_add(-rel1, lhs, c)
        return H.logmap0(lhs, c)

    def _message(self, x_j, etype, rel, curv, mode, layout=None):
        lc = _softplus(self.loop_curvature)
        xj = H.expmap0(torch.matmul(x_j, getattr(self, "w_" + mode)), lc)
        bias = H.expmap0(getattr(self, "b_" + mode), lc)
        xj = H.logmap0(H.project(H.mobius_add(xj, bias, lc), lc), lc)
        if mode != "loop":
            xj = self._rel_transform(xj, M.relation_rows(rel, etype, layout),
                                     M.relation_rows(curv, etype, layout))
        return xj

    def _update_rel(self, rel, curv_raw):
        """w_rel linear, curvature MLP, then the b_rel1 / b_rel2 Mobius adds
        (with the softplused curvature for both)."""
        trc = torch.cat([rel[..., : 3 * self.d_in], curv_raw], dim=-1)
        out_rel = self.w_rel(trc)
        c_out_raw = self.mlp_curvature(trc)
        c_out = _softplus(c_out_raw)
        rel1, rel2, rot = torch.chunk(out_rel, 3, dim=-1)
        rel1 = H.mobius_add(H.expmap0(rel1, c_out), H.expmap0(self.b_rel1, c_out), c_out)
        rel2 = H.mobius_add(H.expmap0(rel2, c_out), H.expmap0(self.b_rel2, c_out), c_out)
        out_rel = torch.cat([H.logmap0(rel1, c_out), H.logmap0(rel2, c_out), rot], dim=-1)
        return out_rel, c_out, c_out_raw

    def forward(self, x, graph, rel_pack, edge_w, generator=None):
        rel, curv_raw = rel_pack  # (Nr, >= 3 d_in), (Nr, 1) before softplus
        out_rel, c_out, c_out_raw = self._update_rel(rel, curv_raw)
        out = self._propagate(x, graph, out_rel, c_out, edge_w)
        return self._finish(out, out_rel, c_out_raw, generator)

    def forward_masked(self, x, edges, rel_pack, edge_w, dir_w, node_w, generator=None):
        """node_w is unused: no statistic of this conv crosses rows."""
        rel, curv_raw = rel_pack
        out_rel, c_out, c_out_raw = self._update_rel(rel, curv_raw)
        out = self._propagate_masked(x, edges, out_rel, c_out, edge_w, dir_w)
        return self._finish(out, out_rel, c_out_raw, generator)

    def _finish(self, out, out_rel, c_out_raw, generator):
        if self.act is not None:
            out = self.act(out)
        if generator is not None and self.dropout > 0:
            out = M.dropout(generator, out, self.dropout)
            out_rel = M.dropout(generator, out_rel, self.dropout)
        return out, (out_rel, c_out_raw)

    def _masked_messages(self, x, edges, rel, curv, dir_w):
        """Each edge's message in the masked layout: both directions'
        messages of every edge, blended by dir_w (exactly one of them, as
        dir_w is 0 or 1); and the self-loop message.  The swapped-type convs
        message with _swapped_etype's types."""
        _, tail, etype = edges
        n_rel = rel.shape[0]
        x_t = x[tail]

        def types(mode):
            return _swapped_etype(etype, dir_w, n_rel, mode) if self.swapped_types else etype

        m_in = self._message(x_t, types("in"), rel, curv, "in")
        m_out = self._message(x_t, types("out"), rel, curv, "out")
        d = dir_w.reshape(-1, *[1] * (m_in.dim() - 1))
        return d * m_in + (1.0 - d) * m_out, self._message(x, None, None, None, "loop")

    def _propagate(self, x, graph, rel, curv, edge_w):
        h = graph.half
        msg_in = self._message(graph.tail_gathers[0](x), graph.etype[:h], rel, curv, "in",
                               graph.rel_layouts[0])
        msg_out = self._message(graph.tail_gathers[1](x), graph.etype[h:], rel, curv, "out",
                                graph.rel_layouts[1])
        msg_loop = self._message(x, None, None, None, "loop")
        msgs = torch.cat([msg_in, msg_out], dim=0)
        lc = _softplus(self.loop_curvature)
        n_ent = x.shape[0]
        if self.agg_method == 2:
            return self._aggregate_gyromidpoint(msgs, msg_loop, graph.head, edge_w, n_ent, lc)
        if self.agg_method == 3:
            parts = [(graph.heads.halves[i], edge_w[graph.half_slice(i)],
                      msgs[graph.half_slice(i)]) for i in (0, 1)]
            return self._aggregate_thirds(parts, msg_loop, n_ent)
        return self._aggregate_and_mix(msgs, msg_loop, graph.heads, graph.tail, edge_w, n_ent,
                                       lc)

    def _propagate_masked(self, x, edges, rel, curv, edge_w, dir_w):
        head, tail, _ = edges
        msgs, msg_loop = self._masked_messages(x, edges, rel, curv, dir_w)
        lc = _softplus(self.loop_curvature)
        n_ent = x.shape[0]
        if self.agg_method == 2:
            return self._aggregate_gyromidpoint(msgs, msg_loop, head, edge_w, n_ent, lc)
        if self.agg_method == 3:
            parts = [(head, edge_w * dir_w, msgs), (head, edge_w * (1.0 - dir_w), msgs)]
            return self._aggregate_thirds(parts, msg_loop, n_ent)
        return self._aggregate_and_mix(msgs, msg_loop, head, tail, edge_w, n_ent, lc)

    def _gyromidpoint_update(self, out, edge_norm, idx, lc, n_ent):
        """Weighted gyro-midpoint of hyperbolic points, back to the tangent
        plane.  Rows (M, D) or per-head rows (M, K, D), weights with a
        trailing 1 axis; segment index idx over axis 0 (unsorted)."""
        out = H.expmap0(out, lc)
        gamma = 2.0 / (1.0 - lc * torch.sum(out * out, dim=-1, keepdim=True))
        den = M.segment_sum(edge_norm * (gamma - 1.0), idx, n_ent)
        wts = gamma * edge_norm / (den[idx] + 1e-5)
        agg = M.segment_sum(wts * out, idx, n_ent)
        factor = 1.0 / (1.0 + torch.sqrt(1.0 - lc * torch.sum(agg * agg, dim=-1, keepdim=True)))
        return H.logmap0(factor * agg, lc)

    def _aggregate_gyromidpoint(self, msgs, msg_loop, head, edge_w, n_ent, lc):
        """Method 2: gyromidpoint over the [edges; self-loops] union with
        1/deg weights (the loops keep every segment non-empty)."""
        idx = torch.cat([head, torch.arange(n_ent, dtype=head.dtype, device=head.device)])
        w = torch.cat([edge_w, edge_w.new_ones((n_ent,))])
        deg = M.segment_sum(w, idx, n_ent)
        norm = (M._inv_deg(deg)[idx] * w)[:, None]
        return self._gyromidpoint_update(torch.cat([msgs, msg_loop], dim=0), norm, idx, lc,
                                         n_ent)

    def _aggregate_thirds(self, parts, msg_loop, n_ent):
        """Method 3: per-direction 1/deg tangent means, mixed 1/3 each with
        the self-loop message.  parts: (receiving-node index form, edge
        weights, messages) of the in and the out direction."""

        def mean(seg, w, msgs):
            return M.segment_sum(M.compute_norm(seg, w, n_ent)[:, None] * msgs, seg, n_ent)

        return (mean(*parts[0]) + mean(*parts[1]) + msg_loop) / 3.0

    def _aggregate_and_mix(self, msgs, msg_loop, heads, tail, edge_w, n_ent, lc):
        """Method 1: symmetric-normalized sum, then the gyro-barycenter of
        (aggregate, self-loop) with the learned loop weight; nodes without
        edges keep the self-loop message.  heads: the receiving-node index
        in any index form."""
        norm = M.compute_symmetric_norm(heads, tail, edge_w, n_ent)
        agg = M.segment_sum(norm[:, None] * msgs, heads, n_ent)
        degs = M.segment_sum(edge_w, heads, n_ent)
        lw = torch.sigmoid(self.loop_weight)
        hb = H.expmap0(agg, lc)
        hl = H.expmap0(msg_loop, lc)
        gamma_rel = 2.0 / (1.0 - lc * torch.sum(hb * hb, dim=-1, keepdim=True))
        gamma_loop = 2.0 / (1.0 - lc * torch.sum(hl * hl, dim=-1, keepdim=True))
        den = (1 - lw) * (gamma_rel - 1) + lw * (gamma_loop - 1)
        m = ((1 - lw) * gamma_rel / den) * hb + (lw * gamma_loop / den) * hl
        factor = 1.0 / (1.0 + torch.sqrt(1.0 - lc * torch.sum(m * m, dim=-1, keepdim=True)))
        mixed = H.logmap0(factor * m, lc)
        return torch.where(degs[:, None] > 0, mixed, msg_loop)

    def regularizable(self):
        return [self.w_loop, self.w_in, self.w_out, self.w_rel.w]


# ------------------------------- LorentzConv ---------------------------------


def _swapped_etype(etype, dir_w, n_rel: int, mode: str):
    """The swapped relation type of the masked layout (LorentzConv,
    PoincareGATConv): for 'in', a forward edge's type + n_rel/2; for 'out',
    an inverse edge's type - n_rel/2; otherwise the edge's own."""
    half = n_rel // 2
    fwd = dir_w > 0.5
    if mode == "in":
        return torch.where(fwd, etype + half, etype)
    return torch.where(fwd, etype, etype - half)


class LorentzConv(PoincareConv):
    """Hyperboloid conv: boost-based relation transform, 1/deg tangent
    aggregation, Lorentz-centroid mixing with the self-loop message (one
    aggregation method only)."""

    swapped_types = True

    def __init__(self, *args, **kwargs):
        if kwargs.get("agg_method", 1) != 1:
            raise ValueError("LorentzConv has only the centroid aggregation (method 1)")
        super().__init__(*args, **kwargs)

    def _rel_transform(self, ent, rel_emb, c):
        """Boost, rotate, boost."""
        rel1, rel2, rot = torch.chunk(rel_emb, 3, dim=-1)
        lhs = H.lorentz_boost(H.expmap0_lorentz(ent, c), rel1, c)
        lhs = H.lorentz_boost(givens_rotations(rot, lhs), rel2, c)
        return H.logmap0_lorentz(lhs, c)

    def _message(self, x_j, etype, rel, curv, mode, layout=None):
        lc = _softplus(self.loop_curvature)
        xj = H.expmap0_lorentz(torch.matmul(x_j, getattr(self, "w_" + mode)), lc)
        xj = H.logmap0_lorentz(H.lorentz_boost(xj, getattr(self, "b_" + mode), lc), lc)
        if mode != "loop":
            xj = self._rel_transform(xj, M.relation_rows(rel, etype, layout),
                                     M.relation_rows(curv, etype, layout))
        return xj

    def _update_rel(self, rel, curv_raw):
        """No b_rel Mobius adds."""
        trc = torch.cat([rel[..., : 3 * self.d_in], curv_raw], dim=-1)
        c_out_raw = self.mlp_curvature(trc)
        return self.w_rel(trc), _softplus(c_out_raw), c_out_raw

    def _propagate(self, x, graph, rel, curv, edge_w):
        """Messages with the swapped relation type per edge (type +- n_rel/2)."""
        h, half_rel = graph.half, rel.shape[0] // 2
        msg_in = self._message(graph.tail_gathers[0](x), graph.etype[:h] + half_rel,
                               rel, curv, "in", graph.rel_layouts[0].shifted(half_rel))
        msg_out = self._message(graph.tail_gathers[1](x), graph.etype[h:] - half_rel,
                                rel, curv, "out", graph.rel_layouts[1].shifted(-half_rel))
        msg_loop = self._message(x, None, None, None, "loop")
        msgs = torch.cat([msg_in, msg_out], dim=0)
        return self._aggregate_and_mix(msgs, msg_loop, graph.heads, graph.tail, edge_w,
                                       x.shape[0], _softplus(self.loop_curvature))

    def _aggregate_and_mix(self, msgs, msg_loop, heads, tail, edge_w, n_ent, lc):
        norm = M.compute_norm(heads, edge_w, n_ent)
        agg = M.segment_sum(norm[:, None] * msgs, heads, n_ent)
        lw = torch.sigmoid(self.loop_weight)
        hb = H.explicit_lorentz(H.expmap0_lorentz(agg, lc), lc)
        hl = H.explicit_lorentz(H.expmap0_lorentz(msg_loop, lc), lc)
        mix = (1 - lw) * hb + lw * hl
        mix_l = -mix[..., :1] ** 2 + torch.sum(mix[..., 1:] ** 2, dim=-1, keepdim=True)
        mix_l = (1.0 / torch.sqrt(lc)) * torch.sqrt(torch.abs(mix_l)) + 1e-6
        return H.logmap0_lorentz((mix / mix_l)[..., 1:], lc)


# ------------------------------ PoincareGATConv -------------------------------


class PoincareGATConv(PoincareConv):
    """Multi-head attention variant of PoincareConv: per-head messages
    through (K, d_in, out_att) weights with the swapped relation type;
    LeakyReLU additive attention a_h.loop(head) + a_t.msg + a_r.W_r(rel)
    with a softmax over [edges; self-loops] per receiving node; a
    gyromidpoint update per head; head gather by mean or concat.  The
    relation stream is PoincareConv's."""

    swapped_types = True

    def __init__(self, d_in, d_out, d_in_r, d_out_r, act, dropout=0.0, gather="mean",
                 heads=4, agg_method: int = 1, dtype=None, device=None):
        if agg_method != 1:
            raise ValueError("PoincareGATConv has only the method-1 propagation")
        if gather not in ("mean", "concat"):
            raise ValueError(f"gather must be mean or concat, got {gather}")
        self.gather, self.heads = gather, heads
        self.out_att = d_out if gather == "mean" else d_out // heads
        if self.out_att * (1 if gather == "mean" else heads) != d_out or self.out_att % 2:
            raise ValueError(f"d_out={d_out} with gather={gather} needs an even per-head "
                             "width (Givens rotations act on pairs)")
        super().__init__(d_in, d_out, d_in_r, d_out_r, act, dropout=dropout,
                         agg_method=agg_method, dtype=dtype, device=device)

    def param_specs(self):
        specs = super().param_specs()
        k, oa, di = self.heads, self.out_att, self.d_in
        specs.update({
            "w_loop": ((k, di, oa), "xavier"), "w_in": ((k, di, oa), "xavier"),
            "w_out": ((k, di, oa), "xavier"), "b_loop": ((k, oa), "zeros"),
            "b_in": ((k, oa), "zeros"), "b_out": ((k, oa), "zeros"),
            "loop_rel": ((1, 3 * oa), "normal"),
            "w_k_r": ((k, 3 * self.d_out, 3 * oa), "normal"),
            "W_r": ((k, 3 * oa, oa), "xavier"), "a_h": ((1, k, oa), "xavier_torch"),
            "a_r": ((1, k, oa), "xavier_torch"), "a_t": ((1, k, oa), "xavier_torch")})
        return specs

    def _message(self, x_j, etype, relh, curv, mode, layout=None):
        """Per-head message; relh is the per-head relation table (Nr, K,
        3 out_att) and etype arrives already swapped (layout with it)."""
        lc = _softplus(self.loop_curvature)
        xj = H.expmap0(torch.einsum("ed,kdo->eko", x_j, getattr(self, "w_" + mode)), lc)
        bias = H.expmap0(getattr(self, "b_" + mode), lc)
        xj = H.logmap0(H.project(H.mobius_add(xj, bias, lc), lc), lc)
        if mode != "loop":
            xj = self._rel_transform(xj, M.relation_rows(relh, etype, layout),
                                     M.relation_rows(curv, etype, layout)[:, None, :])
        return xj

    def _propagate(self, x, graph, rel, curv, edge_w):
        h, half_rel = graph.half, rel.shape[0] // 2
        relh = torch.einsum("nd,kde->nke", rel, self.w_k_r)  # (Nr, K, 3 out_att)
        msg_in = self._message(graph.tail_gathers[0](x), graph.etype[:h] + half_rel,
                               relh, curv, "in", graph.rel_layouts[0].shifted(half_rel))
        msg_out = self._message(graph.tail_gathers[1](x), graph.etype[h:] - half_rel,
                                relh, curv, "out", graph.rel_layouts[1].shifted(-half_rel))
        msg_loop = self._message(x, None, None, None, "loop")
        msgs = torch.cat([msg_in, msg_out], dim=0)  # (E, K, d)
        return self._attend_and_update(msgs, msg_loop, graph.head, graph.etype, relh, edge_w,
                                       x.shape[0], _softplus(self.loop_curvature))

    def _propagate_masked(self, x, edges, rel, curv, edge_w, dir_w):
        head, _, etype = edges
        relh = torch.einsum("nd,kde->nke", rel, self.w_k_r)
        msgs, msg_loop = self._masked_messages(x, edges, relh, curv, dir_w)
        return self._attend_and_update(msgs, msg_loop, head, etype, relh, edge_w, x.shape[0],
                                       _softplus(self.loop_curvature))

    def _attend_and_update(self, msgs, msg_loop, head, etype, relh, edge_w, n_ent, lc):
        """Scatter-softmax attention, per-head gyromidpoint update, head
        gather.  Dropped edges (weight 0) leave the max and the sum."""
        idx = torch.cat([head, torch.arange(n_ent, dtype=head.dtype, device=head.device)])
        w_all = torch.cat([edge_w, edge_w.new_ones((n_ent,))])
        h_all = torch.cat([msgs, msg_loop], dim=0)  # (E+N, K, d)
        r_proj = torch.einsum("nke,keo->nko", relh, self.W_r)
        r_self = torch.einsum("e,keo->ko", self.loop_rel[0], self.W_r)  # (K, oa)
        a_head = torch.sum(self.a_h * msg_loop, dim=-1, keepdim=True)  # (N, K, 1)
        a = a_head[idx] + torch.sum(self.a_t * h_all, dim=-1, keepdim=True)
        r_edge = M.relation_rows(torch.sum(self.a_r * r_proj, dim=-1, keepdim=True), etype)
        r_loop = torch.sum(self.a_r[0] * r_self, dim=-1, keepdim=True)[None].expand(
            n_ent, self.heads, 1)
        a = torch.nn.functional.leaky_relu(a + torch.cat([r_edge, r_loop], dim=0), 0.2)
        a_m = torch.where(w_all[:, None, None] > 0, a, torch.full_like(a, -1e30))
        mx = M.segment_max(a_m[..., 0], idx, n_ent)  # (N, K)
        aexp = torch.exp(a_m - mx[idx][..., None]) * w_all[:, None, None]
        alpha = aexp / (M.segment_sum(aexp, idx, n_ent)[idx] + 1e-8)
        out = self._gyromidpoint_update(h_all, alpha, idx, lc, n_ent)
        if self.gather == "mean":
            return torch.mean(out, dim=1)
        return out.reshape(n_ent, -1)

    def regularizable(self):
        return [self.w_loop, self.w_in, self.w_out, self.w_rel.w, self.w_k_r, self.W_r]
