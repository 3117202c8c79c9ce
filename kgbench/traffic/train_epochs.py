"""Traffic `train_epochs`: a closed loop of consecutive training epochs of
one model, drawn as the program's command line draws them
(cli/run.py::train): epoch e shuffles the train triples and their inverses
with numpy's generator of [seed, e] into static batches
(data/dataset.py::epoch_batches) and draws its negatives from
epoch_generator(seed, 2 e) on the card; Trainer.run_epoch steps them.

Set-up builds the graph and the weights (the model's initial
distributions) from the seed, the model and its Trainer, and steps the
first `checked_steps` batches of epoch 0 one call each, reading the losses,
the first gradient (from Adam's first moment after one step) and the
parameters' change after the last of them, for the check; then the rest of
the first slice, as warm-up.  The window goes on with the same trainer from
there: each Trainer.run_epoch call steps a contiguous slice of
`slice_steps` batches of the current epoch (each call ends in the
trainer's host sync of the mean loss), until --seconds have passed.

End to end: train_triples_per_s, every training example stepped in the
window (a row of the batches, inverses included; a padded row is no
example) over the window's wall time, which ends on a synchronize.  With a
profiled sub-window (`trace_at` of the way into the window, one call of
`trace_steps` batches), the info the per-layer readers get counts it apart.

The check: the plain reference follows the checked steps from the same
weights, rows and negative draws (the same generator stream) in float64,
and the numbers are the worst step's loss gap, and the worst leaf's gap
between the program's and the reference's norms of the first gradient and
of the change (kgbench/reference/protocol.py).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from kgbench.inputs import draw_weights, make_graph, seed_words
from kgbench.reference import protocol
from kgbench.trace import Profiled

BETA1 = 0.9  # the configurations' Adam


def build_model(cell, device):
    """The program's model of the cell's configuration on `device`, its
    Trainer, and the graph and train examples it trains on."""
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
    model = get_model(cfg["model"])(ModelConfig(
        n_entities=n_ent, n_relations=n_rel, rank=cfg["rank"], init_size=cfg["init_size"],
        bias=cfg["bias"], multi_c=cfg["multi_c"], dtype=cfg["dtype"]), device=device)
    trainer = Trainer(model, TrainConfig(
        regularizer=cfg["regularizer"], reg=cfg["reg"], optimizer=cfg["optimizer"],
        learning_rate=cfg["learning_rate"], batch_size=cfg["batch_size"],
        neg_sample_size=cfg["neg_sample_size"], double_neg=cfg["double_neg"],
        neg_mode=cfg["neg_mode"]), n_ent, n_rel)
    return graph, data.get_examples("train"), model, trainer


def first_moments(trainer, model) -> dict:
    """name -> Adam's first moment of each parameter (through the float32
    state of a bfloat16 model's optimizer); zeros where the optimizer
    holds none (it never stepped)."""
    opt = trainer.optimizer
    inner = getattr(opt, "inner", None)
    out = {}
    for i, (name, p) in enumerate(model.named_parameters()):
        state = inner.state[opt.shadow.get(i, p)] if inner is not None else opt.state[p]
        out[name] = state.get("exp_avg", torch.zeros_like(p, dtype=torch.float32))
    return out


class Session:
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
            self.graph, self.examples, self.model, self.trainer = build_model(cell, self.device)
        ref, cfg = cell.reference, cell.config
        with spans.span("setup.weights"):
            # drawn in float32 and loaded into the model's dtype
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
                        {n: m / (1 - BETA1)
                         for n, m in first_moments(self.trainer, self.model).items()})
            self.change_norms = protocol.leaf_norms(
                {n: p.detach().float() - w0[n] for n, p in self.model.named_parameters()})
        del w0
        with spans.span("setup.warmup"):
            self._call(k, self.p["slice_steps"])  # the rest of the first slice

    def _next_epoch(self):
        self.epoch += 1
        rng = np.random.default_rng([self.seed, self.epoch])
        self.b, self.w, _ = self._epoch_batches(self.examples, self.cell.config["batch_size"], rng)
        self.gen = self._epoch_generator(self.seed, 2 * self.epoch, self.device)
        self.nb, self.pos = len(self.b), 0

    def _call(self, i: int, j: int) -> float:
        """Trainer.run_epoch over batches [i, j) of the current epoch."""
        j = min(j, self.nb)
        examples = int(self.w[i:j].sum())
        with self.spans.span("run_epoch", steps=j - i, examples=examples):
            loss = self.trainer.run_epoch(self.b[i:j], self.w[i:j], self.gen,
                                          epoch_id=self.epoch)
        self.pos = j
        return loss

    def window(self, seconds: float, profile: bool = False) -> dict:
        p = self.p
        prof = Profiled(self.spans, self.cuda) if profile else None
        steps = examples = failed = prof_steps = 0
        prof_s = 0.0
        t0 = time.perf_counter()
        while True:
            if self.pos >= self.nb:
                self._next_epoch()
            i = self.pos
            if (prof is not None and prof.prof is None and not prof_steps
                    and time.perf_counter() - t0 >= p["trace_at"] * seconds):
                t1 = time.perf_counter()
                prof.run(lambda: self._call(i, i + p["trace_steps"]))
                prof_s += time.perf_counter() - t1
                prof_steps = self.pos - i
                continue
            loss = self._call(i, i + p["slice_steps"])
            steps += self.pos - i
            examples += int(self.w[i:self.pos].sum())
            failed += 0 if math.isfinite(loss) else self.pos - i
            if time.perf_counter() - t0 >= seconds:
                break
        if self.cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        info = {"kind": "train", "window_start": t0, "steps": steps, "examples": examples,
                "wall_s": wall - prof_s, "profiled_steps": prof_steps, "n_params": self.n_params}
        return {"end_to_end": {"train_triples_per_s": examples / (wall - prof_s)},
                "attempted": steps, "failed": failed, "info": info,
                "trace": prof.read() if prof is not None and prof.prof is not None else None}

    def free(self):
        self.model = self.trainer = self.b = self.w = self.gen = None

    def reference_steps(self, ar, loss_fn=None):
        """The reference's losses, first gradient norms and change norms over
        the checked steps, from the same weights, rows and negatives."""
        ref, cfg = self.cell.reference, self.cell.config
        w0 = draw_weights(ref.PARAMS(cfg), ref.INIT(cfg), self.cell.seed, self.device,
                          torch.float32)
        rows = protocol.epoch_rows(protocol.train_examples(self.graph["train"],
                                                           cfg["n_relations"]), self.seed, 0)
        bsz = cfg["batch_size"]
        batches = [torch.as_tensor(rows[i * bsz:(i + 1) * bsz], device=self.device)
                   for i in range(self.p["checked_steps"])]
        gen = protocol.generator(self.seed, 0, self.device)
        losses, g1, pk = protocol.train_steps(ref, cfg, w0, batches, gen, ar, loss_fn)
        return (losses, protocol.leaf_norms(g1),
                protocol.leaf_norms({k: pk[k].double() - w0[k].double() for k in pk}))

    def numbers(self, losses, grad_norms, change_norms, ref) -> dict:
        """The compared numbers of (losses, first gradient norms, change
        norms) against the reference's."""
        r_losses, r_grads, r_change = ref
        return {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses)),
            "grad_norm_gap": protocol.norm_gap(grad_norms, r_grads),
            "change_norm_gap": protocol.norm_gap(change_norms, r_change,
                                                 protocol.moved_leaves(r_grads)),
        }

    def check(self) -> dict:
        ref = self.reference_steps(protocol.Arith("float64"))
        return self.numbers(self.losses, self.first_grad_norms, self.change_norms, ref)
