"""Sampled-subgraph training for GNN models.

Port of complexhyperbolickge_tpu/train/subgraph.py.  Per batch of seed
edges, the neighbour sampler (data/sampler.py) yields a fixed-capacity
padded subgraph; the step encodes it over its train edges only
(GNNModel.encode_subgraph), scores the seed queries against all of the
subgraph's nodes, and applies cross-entropy or label-smoothed BCE over
those nodes.

As in JAX:
  * the head bias is indexed with the query's GLOBAL head id (the
    reference indexes it with the local one, a bug JAX documents and
    corrects): scores are bh[global head] + bt[node_ids] + sim;
  * a batch is cut to the subgraph's real nodes and edges (_prep_host),
    where JAX keeps the sampler's padded capacity at weight 0 and scores
    the padded columns -1e9: the same loss, and CE's smoothing mass and
    BCE's mean over the real nodes only;
  * BCE's labels (build_subgraph_labels) travel as uint8 and are cast on
    the device; log_sigmoid is computed once and both log terms clamped at
    -100;
  * query_weight masks the rows padding an epoch's last batch;
  * with update_steps k > 1, gradients are summed over k batches and
    applied on every k-th batch, and a partial window is applied at the
    end of the epoch.

The epoch is double-buffered: a producer thread runs the sampler and the
host-side preparation of each batch into a 2-deep queue (pinned for the
card) while the consumer uploads and steps; sampler errors re-raise in
order, and per-step losses stay on the device until one sync at the end of
the epoch.  Randomness (edge and feature dropout) draws from the epoch's
torch.Generator, where JAX splits a key per step: the bits cannot match
across the frameworks, so the parity tests run with dropout 0.

On a mesh (parallel/mesh.py, D x M ranks) the step keeps JAX's layout:
  * every rank samples the whole step's subgraph (the epoch's rng and
    seed_base are the same everywhere and the C++ sampler is deterministic
    given its seed), so the node ids, edges, train mask and the encoder
    over them are replicated; the dropouts draw from the same generator in
    the same order on every rank, so a mesh run is one process's run;
  * each data row keeps its slice of the query rows (queries, their global
    form, the BCE labels, query_weight), and divides by the whole batch's
    normalizers (Mesh.data_total);
  * the entity tables are row-sharded over 'model' as the full-graph
    Trainer shards them, and a step gathers only its subgraph's rows
    (parallel/mesh.py::gather_rows: entity, bh and bt at node_ids; the
    queries' heads are subgraph nodes, so bh[global head] is that table at
    the local head) and runs the one-process loss on them, the tables
    swapped in through call_with_tables with local ids; no collective of a
    step carries more than the subgraph's rows of a table;
  * the replicated parameters' gradients are summed over the data group
    once per optimizer step (parallel/mesh.py::sum_grads, which also
    averages the model group's copies: the masked convs' index_add_ sums
    leave them an ulp apart on the card), and the encoder's regularizer,
    which is no batch, is added by data row 0 only.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from complexhyperbolickge_torch.data.sampler import NeighborSampler, Subgraph
from complexhyperbolickge_torch.parallel.mesh import (
    ENTITY_PARAMS,
    batch_rows,
    call_with_tables,
    gather_rows,
    shard_model_,
    sum_grads,
)
from complexhyperbolickge_torch.train.regularizers import get_regularizer
from complexhyperbolickge_torch.train.trainer import TrainConfig, make_optimizer
from complexhyperbolickge_torch.utils.profiling import nan_check


def build_subgraph_labels(sub: Subgraph, max_nodes: int) -> np.ndarray:
    """Multi-hot (B, max_nodes) uint8 labels: each query's true local tails
    among the subgraph's train edges, plus the query's own tail.  A
    vectorized group-by over (head, rel) keys (sort + searchsorted), so the
    producer thread never loops over edges in Python."""
    b = len(sub.queries)
    labels = np.zeros((b, max_nodes), dtype=np.uint8)
    q = np.asarray(sub.queries)
    labels[np.arange(b), q[:, 2]] = 1
    tmask = sub.train_mask[: sub.n_edges] > 0
    e = sub.edges[: sub.n_edges][tmask]
    if len(e) == 0:
        return labels
    mult = int(max(e[:, 1].max(), q[:, 1].max())) + 1
    ekey = e[:, 0].astype(np.int64) * mult + e[:, 1]
    qkey = q[:, 0].astype(np.int64) * mult + q[:, 1]
    order = np.argsort(ekey, kind="stable")
    ekey_s = ekey[order]
    tails_s = e[order, 2]
    lo = np.searchsorted(ekey_s, qkey, side="left")
    counts = np.searchsorted(ekey_s, qkey, side="right") - lo
    total = int(counts.sum())
    if total:
        rows = np.repeat(np.arange(b), counts)
        # the concatenated [lo_i, hi_i) ranges
        offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
        labels[rows, tails_s[np.repeat(lo, counts) + offs]] = 1
    return labels


class SubgraphTrainer:
    """The sampler-driven training loop of a GNNModel.

    optimizer: the torch optimizer over the model's parameters to step
    (cli/run.py passes the full-graph Trainer's, so its checkpoint and
    resume code serve both); None builds one with make_optimizer (float32
    state for bfloat16 params).  mesh: a parallel/mesh.py Mesh, or None for
    one process; with M > 1 an unsharded model's entity tables are cut to
    this rank's rows here, before the optimizer is built (the CLI passes a
    model the full-graph Trainer sharded).  A batch_size that the data
    axis does not divide raises ValueError."""

    debug_nans = False  # --debug_nans: check every step (utils/profiling.py)

    def __init__(self, model, cfg: TrainConfig, dataset, fanouts=(20, 20),
                 max_nodes: int = 4096, max_edges: int = 32768, mesh=None, optimizer=None):
        if not getattr(model, "is_gnn", False):
            raise ValueError("subgraph mode is GNN-only")
        if cfg.neg_sample_size > 0:
            raise ValueError("subgraph mode uses CE/BCE over subgraph nodes; set "
                             "neg_sample_size 0")
        if cfg.loss not in ("crossentropy", "binarycrossentropy"):
            raise ValueError(f"unknown loss {cfg.loss!r}")
        if mesh is not None and cfg.batch_size % mesh.n_data:
            raise ValueError(f"subgraph batch_size {cfg.batch_size} must divide by the mesh's "
                             f"'data' axis {mesh.n_data}")
        self.mesh = mesh if mesh is not None and mesh.collective else None
        # the tables a step gathers at its subgraph's rows (on a mesh)
        self.rows = ()
        if self.mesh is not None:
            self.rows = tuple(k for k in ENTITY_PARAMS if k in model._parameters)
            if self.mesh.n_model > 1 and model.entity.shape[0] == model.cfg.n_entities:
                shard_model_(model, self.mesh.m, self.mesh.n_model)
        self.model = model
        self.cfg = cfg
        self.sampler = NeighborSampler(dataset, fanouts=fanouts, max_nodes=max_nodes,
                                       max_edges=max_edges)
        self.optimizer = (optimizer if optimizer is not None else
                          make_optimizer(cfg.optimizer, cfg.learning_rate, model.parameters()))
        self.reg_fn = get_regularizer(cfg.regularizer)
        self._k_acc = max(1, cfg.update_steps)

    def steps(self, batch_size: int) -> int:
        """Steps an epoch: every train edge (with inverses) seeds once."""
        return -(-self.sampler.n_train_edges // batch_size)

    # --------------------------------- step ----------------------------------

    def _loss(self, node_ids, edges, train_mask, queries, gqueries, labels, qw,
              generator=None):
        """The loss of one subgraph batch (tensors on the model's device, as
        _to_device gives them; labels None for CE).  On a mesh: the loss of
        this rank's query rows, over the subgraph's gathered table rows."""
        if not self.rows:
            return self._subgraph_loss(node_ids, edges, train_mask, queries, gqueries, labels,
                                       qw, generator)
        tables = {k: gather_rows(self.model, k, node_ids, self.mesh) for k in self.rows}
        local = torch.arange(node_ids.shape[0], device=node_ids.device)
        # in the swapped-in tables a node's id is its local id, a query's
        # head too
        return call_with_tables(self.model, tables, self._subgraph_loss, local, edges,
                                train_mask, queries, queries, labels, qw, generator)

    def _subgraph_loss(self, node_ids, edges, train_mask, queries, gqueries, labels, qw,
                       generator):
        model, cfg, mesh = self.model, self.cfg, self.mesh
        total = mesh.data_total if mesh is not None else (lambda x: x)
        cache = model.encode_subgraph(node_ids, edges, train_mask, None, generator,
                                      training=True)
        x = cache[0]
        n_nodes = x.shape[0]
        lhs, _ = model.get_queries(queries[:, :2], cache)
        s = model.sim(lhs, x, all_pairs=True)  # (B, n_nodes)
        if model.cfg.bias == "learn":
            s = model.bh[gqueries[:, 0]] + model.bt[node_ids][None, :, 0] + s
        elif model.cfg.bias == "constant":
            s = s + model.cfg.gamma
        eps = cfg.smoothing or 0.0
        if cfg.loss == "crossentropy":
            logp = torch.log_softmax(s, dim=-1)
            nll = -torch.gather(logp, 1, queries[:, 2:3])[:, 0]
            if eps:
                nll = (1 - eps) * nll + eps * torch.sum(-logp, dim=-1) / n_nodes
            loss = torch.sum(qw * nll) / total(torch.sum(qw))
        else:
            y = labels.to(s.dtype)
            if eps:
                y = (1 - eps) * y + eps / n_nodes
            ls = torch.nn.functional.logsigmoid(s)
            log_p = torch.clamp_min(ls, -100.0)
            log_1mp = torch.clamp_min(ls - s, -100.0)
            per = -(y * log_p + (1 - y) * log_1mp)
            loss = torch.sum(per * qw[:, None]) / (total(torch.sum(qw)) * n_nodes)
        if not cfg.reg or (mesh is not None and mesh.d != 0):
            # the encoder's weights are no batch: data row 0 adds them, once
            return loss
        factors = model.get_factors()
        return loss + self.reg_fn(factors, cfg.reg, factors[0].shape[0])

    def _prep_host(self, sub: Subgraph):
        """The host-side preparation of one batch (on the producer thread):
        (node_ids, edges, train_mask, queries, global queries, labels or
        None, query_weight), numpy.  The batch is cut to its real nodes and
        edges: JAX keeps the sampler's padded rows, for one compiled shape,
        at weight 0 (edge_weight, node_w), so they add nothing to a sum, a
        norm or the loss; here they would only add work, and their shared
        id 0 would serialize the gathers' backward on one row."""
        n, e = sub.n_nodes, sub.n_edges
        labels = (build_subgraph_labels(sub, n)
                  if self.cfg.loss == "binarycrossentropy" else None)
        gq = np.stack([sub.node_ids[sub.queries[:, 0]], sub.queries[:, 1],
                       sub.node_ids[sub.queries[:, 2]]], axis=1)
        qw = (sub.query_weight if sub.query_weight is not None
              else np.ones(len(sub.queries), np.float32))
        queries = sub.queries
        if self.mesh is not None:  # this data row's query rows
            rows = batch_rows(self.mesh, len(queries))
            queries, gq, qw = queries[rows], gq[rows], qw[rows]
            labels = None if labels is None else labels[rows]
        return sub.node_ids[:n], sub.edges[:e], sub.train_mask[:e], queries, gq, labels, qw

    def _host_tensors(self, prepped):
        """_prep_host's arrays as CPU tensors (ids int64), pinned when the
        model is on the card so their uploads run asynchronously."""
        pin = next(self.model.parameters()).is_cuda
        ids = (0, 1, 3, 4)

        def tensor(i, a):
            if a is None:
                return a
            t = torch.from_numpy(np.ascontiguousarray(a))
            t = t.long() if i in ids else t
            return t.pin_memory() if pin else t

        return tuple(tensor(i, a) for i, a in enumerate(prepped))

    def _to_device(self, host):
        p = next(self.model.parameters())
        out = [a if a is None else a.to(p.device, non_blocking=True) for a in host]
        out[6] = out[6].to(p.dtype)  # query weights
        return out

    def _apply(self):
        sum_grads(self.model, self.mesh, self.rows)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    # --------------------------------- epoch ---------------------------------

    def run_epoch(self, batch_size: int, rng: np.random.Generator, generator=None,
                  epoch_id: int = 0, max_steps: int | None = None) -> float:
        """One epoch of seed batches shuffled by `rng` (the sampler's seeds
        derive from epoch_id), dropout drawn from `generator`; max_steps
        stops after that many batches (a profiling window).  Returns the
        mean loss, synced once (on a mesh, the ranks' shares summed over the
        data group first)."""
        q: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()

        def _put(item) -> bool:
            # bounded, so a consumer that bailed never leaves this thread
            # blocked on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for i, sub in enumerate(self.sampler.epoch(batch_size, rng,
                                                           seed_base=epoch_id)):
                    if max_steps is not None and i >= max_steps:
                        break
                    if not _put(self._host_tensors(self._prep_host(sub))):
                        return
                _put(None)
            except BaseException as e:  # surface sampler errors in order
                _put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        losses = []
        n_pending = 0
        self.optimizer.zero_grad(set_to_none=True)
        try:
            with nan_check(self.debug_nans, epoch_id, self.mesh, self.model) as check:
                while True:
                    item = q.get()
                    if item is None:
                        break
                    if isinstance(item, BaseException):
                        raise item
                    loss = self._loss(*self._to_device(item), generator=generator)
                    if check is None:
                        loss.backward()
                    else:
                        check.backward(loss)
                    losses.append(loss.detach())
                    n_pending += 1
                    if n_pending == self._k_acc:
                        self._apply()
                        n_pending = 0
                if n_pending:  # the epoch's partial accumulation window
                    self._apply()
        finally:
            stop.set()
            t.join()
        if not losses:
            return 0.0
        losses = torch.stack(losses)
        if self.mesh is not None:
            losses = self.mesh.sum_data(losses)
        return float(torch.sum(losses)) / len(losses)
