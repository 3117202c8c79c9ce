"""Training engine: optimizer wiring and the epoch loop.

Port of complexhyperbolickge_tpu/train/trainer.py.  The JAX package runs an
epoch as one jitted lax.scan; here it is a Python loop over the epoch's
static-shape batches, uploaded once, with one host sync per epoch (the mean
loss).  Parameters live in the model, optimizer state in a torch.optim
optimizer.

Optimizers: torch.optim's Adam (betas 0.9/0.999, eps 1e-8), Adagrad
(initial accumulator 0, eps 1e-10; the rule the JAX package re-implemented
to match torch) and SGD, and train/sparse_adam.py's lazy row-sparse Adam
(SparseAdam) over the dense gradients.  For bfloat16 params the optimizer
keeps its state and update arithmetic in float32 and adds the update, cast
to bfloat16, to the param, as the JAX trainer's _f32_state_for_bf16 does
(F32StateForBF16).

Gradient accumulation (`update_steps`): gradients are summed over k batches
(.backward() accumulates by sum) and applied on every k-th batch and on the
last batch of the epoch.

Randomness comes from the torch.Generator the caller passes per epoch (the
CLI derives it from (seed, epoch), so --resume reproduces a continuous
run).  The loss is chosen as in JAX: with neg_sample_size > 0 per-query,
shared or pooled negatives (neg_mode); otherwise the all-entity
cross-entropy, or for loss binarycrossentropy the BCE against label packs
when the batches carry them and the signed-logsigmoid CE when not.  The
regularizer is added once on every branch (the reference adds it twice on
the binarycrossentropy branch; every published config has reg 0).

GNN models encode the full graph once per training step, with edge and
feature dropout drawn from the step's generator, and score through a
BoundGNN; the validation loss scores against the eval-mode encoding, cached
per params version (GNNModel.cached_encode).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from complexhyperbolickge_torch.train import losses as L
from complexhyperbolickge_torch.train.regularizers import get_regularizer
from complexhyperbolickge_torch.train.sparse_adam import SparseAdam


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The training-relevant run config (the JAX TrainConfig, field for
    field).  fused_scorer is kept for config parity: the train-shape
    distance takes the CUDA kernels on a CUDA float32 model whatever it says
    (ops/chyperbolic.py)."""

    regularizer: str = "N3"
    reg: float = 0.0
    optimizer: str = "Adam"
    learning_rate: float = 1e-3
    batch_size: int = 500
    update_steps: int = 1
    neg_sample_size: int = 100  # <= 0 to disable negative sampling
    loss: str = "crossentropy"  # crossentropy | binarycrossentropy
    smoothing: Optional[float] = None
    double_neg: bool = False
    neg_mode: str = "per_query"  # per_query (reference) | shared | pool
    neg_pool_size: int = 512
    fused_scorer: bool = False
    scan_unroll: int = 1  # the JAX epoch scan's unroll; no meaning here


class F32StateForBF16:
    """A torch.optim optimizer whose bfloat16 params are stepped through
    float32 copies: the state (exp_avg, exp_avg_sq, sum) and the update
    arithmetic are float32, and each step adds the float32 update, cast to
    bfloat16, to the bfloat16 param; optax's apply_updates after the JAX
    trainer's _f32_state_for_bf16.  Params of other dtypes are the inner
    optimizer's own.  Only five members exist, what the port uses of an
    optimizer: param_groups (the inner optimizer's, so reduce_lr reaches
    it), state_dict / load_state_dict (the float32 state), step and
    zero_grad.  It is not a torch.optim.Optimizer: no .state,
    add_param_group or hooks, so code that needs those (an LR scheduler)
    takes .inner, whose params are the float32 copies."""

    def __init__(self, make, params):
        self.params = params
        self.shadow = {i: p.detach().float() for i, p in enumerate(params)
                       if p.dtype == torch.bfloat16}
        self.inner = make([self.shadow.get(i, p) for i, p in enumerate(params)])

    @property
    def param_groups(self):
        return self.inner.param_groups

    def state_dict(self):
        return self.inner.state_dict()

    def load_state_dict(self, sd):
        self.inner.load_state_dict(sd)

    @torch.no_grad()
    def step(self):
        for i, s in self.shadow.items():
            p = self.params[i]
            s.copy_(p)  # exact: every bfloat16 is a float32
            s.grad = None if p.grad is None else p.grad.float()
        self.inner.step()
        for i, s in self.shadow.items():
            p = self.params[i]
            if p.grad is not None:  # (p + u) - p in float32 is u to float32 rounding
                p.add_((s - p.float()).to(p.dtype))

    def zero_grad(self, set_to_none: bool = True):
        self.inner.zero_grad(set_to_none=set_to_none)
        for i in self.shadow:
            p = self.params[i]
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()


def _torch_optimizer(name: str, lr: float, params) -> torch.optim.Optimizer:
    if name == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "Adagrad":
        return torch.optim.Adagrad(params, lr=lr, initial_accumulator_value=0.0,
                                   eps=1e-10)
    if name == "SGD":  # not in the reference's choices; used by parity tests
        return torch.optim.SGD(params, lr=lr)
    if name == "SparseAdam":
        return SparseAdam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    raise ValueError(f"unknown optimizer {name!r}")


def make_optimizer(name: str, lr: float, params):
    """The torch.optim optimizer `name` over params; with bfloat16 params,
    wrapped in F32StateForBF16."""
    params = list(params)
    if any(p.dtype == torch.bfloat16 for p in params):
        return F32StateForBF16(lambda ps: _torch_optimizer(name, lr, ps), params)
    return _torch_optimizer(name, lr, params)


def reduce_lr(optimizer: torch.optim.Optimizer, factor: float = 0.8):
    """Scale the learning rate of every param group (the reference
    KGOptimizer.reduce_lr)."""
    for group in optimizer.param_groups:
        group["lr"] *= factor


class Trainer:
    """Train and validation-loss loops over a fixed model and config.

    sampler: the per-query negative sampler, losses.sample_negatives; draw:
    the shared and pooled modes' uniform draws, losses.uniform_ids.  Tests
    inject others with their signatures."""

    def __init__(self, model, cfg: TrainConfig, n_entities: int,
                 n_relations: int, sampler=L.sample_negatives, draw=L.uniform_ids):
        self.is_gnn = getattr(model, "is_gnn", False)
        if self.is_gnn and cfg.neg_mode in ("shared", "pool"):
            raise ValueError(f"neg_mode={cfg.neg_mode!r} is not supported for GNN models")
        if cfg.neg_mode not in ("per_query", "shared", "pool"):
            raise ValueError(f"unknown neg_mode {cfg.neg_mode!r}")
        if cfg.neg_sample_size <= 0 and cfg.loss not in ("crossentropy", "binarycrossentropy"):
            raise ValueError(f"unknown loss {cfg.loss!r}")
        self.model = model
        self.cfg = cfg
        self.n_entities = n_entities
        self.n_relations = n_relations
        self.sampler = sampler
        self.draw = draw
        self.reg_fn = get_regularizer(cfg.regularizer)
        self.optimizer = make_optimizer(cfg.optimizer, cfg.learning_rate,
                                        model.parameters())

    # ------------------------------- loss core -------------------------------

    def _loss(self, batch, weights, generator, training: bool = True, labels=None):
        cfg = self.cfg
        model = self.model
        if self.is_gnn:
            from complexhyperbolickge_torch.models.gnn import BoundGNN

            # the full-graph encoder once per step, with its dropouts when
            # training; validation scores against the eval-mode encoding
            cache = (model.encode(generator, training=True) if training
                     else model.cached_encode())
            model = BoundGNN(model, cache)
        neg = (model, batch, weights, generator, self.n_entities, cfg.neg_sample_size,
               cfg.double_neg, self.n_relations)
        if cfg.neg_sample_size > 0 and cfg.neg_mode == "shared":
            loss, factors = L.neg_sampling_loss_shared(*neg, draw=self.draw)
        elif cfg.neg_sample_size > 0 and cfg.neg_mode == "pool":
            loss, factors = L.neg_sampling_loss_pooled(*neg, cfg.neg_pool_size, draw=self.draw)
        elif cfg.neg_sample_size > 0:
            loss, factors = L.neg_sampling_loss(*neg, sampler=self.sampler)
        elif cfg.loss == "crossentropy":
            loss, factors = L.cross_entropy_loss(model, batch, weights, cfg.smoothing,
                                                 n_entities=self.n_entities)
        elif labels is not None:
            loss, factors = L.bce_loss(model, batch, weights, labels, self.n_entities,
                                       cfg.smoothing)
        else:
            loss, factors = L.signed_logsigmoid_ce_loss(model, batch, weights,
                                                        n_entities=self.n_entities)
        if not cfg.reg:
            # reg weight 0 (every published config): no factor gathers
            return loss
        if self.is_gnn:
            # the factors are encoder weight matrices, normalized by the
            # first one's leading dim as the reference does
            return loss + self.reg_fn(factors, cfg.reg, factors[0].shape[0])
        return loss + self.reg_fn(factors, cfg.reg, torch.sum(weights), weights)

    def _upload(self, batches, weights, labels=None):
        """The epoch's arrays on the model's device: int64 batches and
        labels, weights in the param dtype; labels None stays None."""
        p = next(self.model.parameters())

        def ids(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=p.device)

        return (ids(batches), torch.as_tensor(np.asarray(weights), dtype=p.dtype, device=p.device),
                None if labels is None else ids(labels))

    # -------------------------------- public ---------------------------------

    def init(self, generator: torch.Generator | None = None):
        """Fresh params drawn from `generator` and a fresh optimizer."""
        self.model.reset_parameters(generator)
        self.optimizer = make_optimizer(self.cfg.optimizer, self.cfg.learning_rate,
                                        self.model.parameters())

    def train_step(self, batch, weights, generator, apply: bool = True, labels=None):
        """Loss and backward of one batch (gradients add to those already
        accumulated); with apply, one optimizer step and cleared gradients.
        labels: the batch's label rows (B, L) for BCE, else None.  Returns
        the loss as a device scalar."""
        loss = self._loss(batch, weights, generator, labels=labels)
        loss.backward()
        if apply:
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    def run_epoch(self, batches, weights, generator, labels=None) -> float:
        """One epoch over batches (nb, B, 3) with weights (nb, B) and, for
        BCE, label batches (nb, B, L) (numpy, as data/dataset.py::
        epoch_batches gives them); returns the mean loss."""
        b, w, lab = self._upload(batches, weights, labels)
        k_acc = max(1, self.cfg.update_steps)
        nb = b.shape[0]
        self.optimizer.zero_grad(set_to_none=True)
        losses = [self.train_step(b[i], w[i], generator,
                                  apply=(i + 1) % k_acc == 0 or i == nb - 1,
                                  labels=None if lab is None else lab[i])
                  for i in range(nb)]
        return float(torch.stack(losses).mean())

    @torch.no_grad()
    def valid_loss(self, batches, weights, generator, labels=None) -> float:
        """Mean loss over validation batches (and their label batches),
        without autograd."""
        b, w, lab = self._upload(batches, weights, labels)
        return float(torch.stack([
            self._loss(b[i], w[i], generator, training=False,
                       labels=None if lab is None else lab[i])
            for i in range(b.shape[0])]).mean())

    # ---------------------------- optimizer state ----------------------------

    def opt_state(self) -> dict:
        """The optimizer state as the checkpoint's opt_state: {"lr": float,
        "state": {param name: {torch state key: numpy array}}}.  Numbers and
        arrays only, so the JAX package's loader reads the checkpoint too."""
        names = [n for n, _ in self.model.named_parameters()]
        sd = self.optimizer.state_dict()
        return {
            "lr": float(sd["param_groups"][0]["lr"]),
            "state": {names[i]: {k: v.detach().cpu().numpy()
                                 for k, v in st.items() if v is not None}
                      for i, st in sd["state"].items()},
        }

    def load_opt_state(self, opt_state: dict):
        """Restore what opt_state() returned (or checkpoint.opt_state_from_jax
        made of a JAX checkpoint's state)."""
        names = [n for n, _ in self.model.named_parameters()]
        sd = self.optimizer.state_dict()
        sd["state"] = {i: {k: torch.as_tensor(np.asarray(v))
                           for k, v in opt_state["state"][n].items()}
                       for i, n in enumerate(names) if n in opt_state["state"]}
        for group in sd["param_groups"]:
            group["lr"] = float(opt_state["lr"])
        self.optimizer.load_state_dict(sd)
