"""Traffic `train_full_graph`: a closed loop of consecutive training epochs
of a full-graph GNN under an all-entity loss, drawn as the program's
command line draws them (cli/run.py::train): the train triples and their
inverses with their label rows (KGData.label_pack("train")), shuffled by
numpy's generator of [seed, e] into static batches (epoch_batches, the
labels under the same permutation), with epoch_generator(seed, 2 e) for
the step's draws; Trainer.run_epoch steps them.  Every step encodes the
whole graph (each directed edge's gather, composition and sum, each node's
self loop) and scores the batch's queries against every entity.

The rest is `train_epochs`' (whose Session this one extends): set-up steps
the first `checked_steps` batches one call each, reading the losses, the
first gradient (from Adam's first moment) and the change, then the rest of
the first slice as warm-up; each window call steps `slice_steps` batches
and ends in the trainer's host sync of the mean loss; train_triples_per_s
counts every example stepped in the window; `trace_at` and `trace_steps`
place the profiled call.  The info the per-layer readers get adds the
encoder's work a step: `encoder_edges` (directed edges, inverses
included) and `encoder_nodes` (self loops).

The check: the plain reference (reference/<config>.py) follows the checked
steps from the same weights, rows and label rows (its own multi-hot of the
train triples, not the program's packs) in float64, with Adam
(protocol.train_steps); the numbers are train_epochs': the worst step's
loss gap, and the worst leaf's gaps of the first gradient's norm and of
the change's norm.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from kgbench import harness
from kgbench.inputs import draw_weights, make_graph, seed_words
from kgbench.reference import protocol

epochs = harness.load_module("traffic", "train_epochs")

# the configuration keys the GNN models read from the run config
GNN_FLAGS = ("hidden_dim", "layers", "edge_dropout", "dropout", "opn", "interaction", "basis")


def build_model(cell, device):
    """The program's GNN of the cell's configuration on `device`, built as
    cli/run.py::build_model builds it over the graph, its Trainer, and the
    graph, the train examples and their label rows."""
    from complexhyperbolickge_torch.data.dataset import KGData
    from complexhyperbolickge_torch.models import ModelConfig, get_model
    from complexhyperbolickge_torch.train.trainer import TrainConfig, Trainer

    cfg = cell.config
    graph = make_graph(cell.seed, cfg["entities"], cfg["relations"], cfg["train_triples"],
                       cfg["valid_triples"], cfg["test_triples"])
    data = KGData(splits=graph, filters={"lhs": {}, "rhs": {}})  # training ranks nothing
    n_ent, n_rel, _ = data.get_shape()
    if (n_ent, n_rel) != (cfg["n_entities"], cfg["n_relations"]):
        raise ValueError(f"graph shape {(n_ent, n_rel)} is not the configuration's")
    model = get_model(cfg["model"])(
        ModelConfig(n_entities=n_ent, n_relations=n_rel, rank=cfg["rank"],
                    init_size=cfg["init_size"], bias=cfg["bias"], multi_c=cfg["multi_c"],
                    dtype=cfg["dtype"], dropout=cfg["dropout"]),
        argparse.Namespace(**{k: cfg[k] for k in GNN_FLAGS}), data, device=device)
    trainer = Trainer(model, TrainConfig(
        regularizer=cfg["regularizer"], reg=cfg["reg"], optimizer=cfg["optimizer"],
        learning_rate=cfg["learning_rate"], batch_size=cfg["batch_size"],
        neg_sample_size=cfg["neg_sample_size"], loss=cfg["loss"],
        smoothing=cfg["smoothing"]), n_ent, n_rel)
    rows, labels = data.label_pack("train")
    return graph, rows, labels, model, trainer


class Session(epochs.Session):
    def __init__(self, cell, spans):
        from complexhyperbolickge_torch.cli.run import epoch_generator
        from complexhyperbolickge_torch.data.dataset import epoch_batches

        self.cell, self.spans = cell, spans
        self.p = cell.params
        self.seed = seed_words(cell.seed)
        self.device = torch.device(cell.device)
        self.cuda = self.device.type == "cuda"
        self._epoch_batches, self._epoch_generator = epoch_batches, epoch_generator
        with spans.span("setup.model"):
            (self.graph, self.examples, self.labels, self.model,
             self.trainer) = build_model(cell, self.device)
        self.encoder = {"encoder_edges": 2 * len(self.graph["train"]),
                        "encoder_nodes": cell.config["n_entities"]}
        ref, cfg = cell.reference, cell.config
        with spans.span("setup.weights"):
            w0 = draw_weights(ref.PARAMS(cfg), ref.INIT(cfg), cell.seed, self.device,
                              torch.float32)
            self.model.load_state_dict(w0)
        self.n_params = sum(v.numel() for v in w0.values())
        self.epoch, self.pos = -1, 0
        self._next_epoch()
        k = self.p["checked_steps"]
        self.losses = []
        with spans.span("setup.checked_steps"):
            for i in range(k):
                self.losses.append(self._call(i, i + 1))
                if i == 0:
                    self.first_grad_norms = protocol.leaf_norms(
                        {n: m / (1 - epochs.BETA1)
                         for n, m in epochs.first_moments(self.trainer, self.model).items()})
            self.change_norms = protocol.leaf_norms(
                {n: p.detach().float() - w0[n] for n, p in self.model.named_parameters()})
        del w0
        with spans.span("setup.warmup"):
            self._call(k, self.p["slice_steps"])  # the rest of the first slice

    def _next_epoch(self):
        self.epoch += 1
        rng = np.random.default_rng([self.seed, self.epoch])
        self.b, self.w, self.lab = self._epoch_batches(
            self.examples, self.cell.config["batch_size"], rng, self.labels)
        self.gen = self._epoch_generator(self.seed, 2 * self.epoch, self.device)
        self.nb, self.pos = len(self.b), 0

    def _call(self, i: int, j: int) -> float:
        """Trainer.run_epoch over batches [i, j) of the current epoch and
        their label rows."""
        j = min(j, self.nb)
        examples = int(self.w[i:j].sum())
        with self.spans.span("run_epoch", steps=j - i, examples=examples):
            loss = self.trainer.run_epoch(self.b[i:j], self.w[i:j], self.gen, self.lab[i:j],
                                          epoch_id=self.epoch)
        self.pos = j
        return loss

    def window(self, seconds: float, profile: bool = False) -> dict:
        out = super().window(seconds, profile)
        out["info"].update(self.encoder)
        return out

    def free(self):
        super().free()
        self.lab = self.labels = None

    def reference_steps(self, ar, half: bool = False):
        """The reference's losses, first gradient norms and change norms over
        the checked steps, from the same weights, rows and labels; `half`
        leaves the second half of each batch out of the loss (the mean over
        the rest: a fault)."""
        ref, cfg = self.cell.reference, self.cell.config
        w0 = draw_weights(ref.PARAMS(cfg), ref.INIT(cfg), self.cell.seed, self.device,
                          torch.float32)
        examples = protocol.train_examples(self.graph["train"], cfg["n_relations"])
        rows = protocol.epoch_rows(examples, self.seed, 0)
        bsz, k = cfg["batch_size"], self.p["checked_steps"]
        if k * bsz > len(rows):
            raise ValueError("the checked steps are not full batches")
        batches = [torch.as_tensor(rows[i * bsz:(i + 1) * bsz], device=self.device)
                   for i in range(k)]
        graph = ref.edges(self.graph["train"], cfg["n_relations"], self.device)

        def loss_fn(_ref, cfg, P, batch, _gen, ar):
            w = torch.ones(batch.shape[0], dtype=ar.dtype, device=batch.device)
            if half:
                w[batch.shape[0] // 2:] = 0.0
            labels = ref.multi_hot(examples, batch, cfg["n_entities"], ar.dtype)
            return ref.loss(P, graph, batch, w, labels, cfg, ar)

        losses, g1, pk = protocol.train_steps(ref, cfg, w0, batches, None, ar, loss_fn)
        return (losses, protocol.leaf_norms(g1),
                protocol.leaf_norms({k: pk[k].double() - w0[k].double() for k in pk}))
