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
per params version (GNNModel.cached_encode).  Sampled-subgraph training of
a GNN is train/subgraph.py's SubgraphTrainer.

With `debug_nans` set (--debug_nans), an epoch runs under
utils/profiling.py's NanCheck: each step's loss is checked before its
backward, which runs in anomaly mode, and the first non-finite value raises
FloatingPointError naming the epoch and the step.

Under a torch.profiler (--profile_dir, or one a caller runs) each
train_step is a range kge.train.step in the trace, holding kge.train.loss
(the negative draws, get_queries, the scores, the loss and the
regularizer), kge.train.backward (autograd; on the card its kernels are
launched from the autograd engine's thread while the range is open on the
calling thread) and kge.train.optimizer (the mesh's gradient sum, the
update and the cleared gradients; only on the steps that apply them).

On a mesh (parallel/mesh.py, `mesh` of D x M ranks) the steps are data
parallel: run_epoch and valid_loss take the full epoch arrays, which every
rank builds from the epoch seed, and each data row trains on its slice of
every batch.  Each rank draws the whole batch's negatives (and a GNN its
dropout masks, over the whole graph) from the step generator and keeps its
rows, so the ranks train on the negatives one process draws; each divides
its slice's sums by the global normalizers (losses.py `total`), and the
gradients of the replicated parameters are summed over the data group
before the optimizer step (parallel/mesh.py::sum_grads, which also makes
the model group's copies one).  A regularizer term that does not depend on
the batch (a NoMask factor: the whole entity table, a GNN's weights) is
added by data row 0 alone.  With M > 1 the entity tables are row-sharded: the
model holds its own rows of entity, bh and bt (and the optimizer their
moments), and each step runs the loss through torch.func.functional_call
on the tables gathered inside the model group, so K3 reads candidate rows
by id and K4 writes the dense gradient of the gathered table, which the
gather's backward sums over the data group and cuts to the rank's rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from complexhyperbolickge_torch.models.base import NoMask
from complexhyperbolickge_torch.parallel.mesh import (
    call_with_tables,
    gather_tables,
    shard_epoch_arrays,
    shard_model_,
    sum_grads,
)
from complexhyperbolickge_torch.train import losses as L
from complexhyperbolickge_torch.train.regularizers import get_regularizer
from complexhyperbolickge_torch.train.sparse_adam import SparseAdam
from complexhyperbolickge_torch.utils.profiling import nan_check, span


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The training-relevant run config (the JAX TrainConfig's fields that
    mean something here)."""

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
    inject others with their signatures.  mesh: a parallel/mesh.py Mesh
    (None, or 1 x 1 without groups: one process); with M > 1 the model's
    entity tables are cut to this rank's rows here, before the optimizer is
    built."""

    debug_nans = False  # --debug_nans: check every step (utils/profiling.py)

    def __init__(self, model, cfg: TrainConfig, n_entities: int,
                 n_relations: int, sampler=L.sample_negatives, draw=L.uniform_ids,
                 mesh=None):
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
        self.mesh = mesh if mesh is not None and mesh.collective else None
        if (self.mesh is not None and self.mesh.n_data > 1
                and getattr(model, "conve", None) is not None):
            raise ValueError("CompGCN's conve decoder normalizes by its batch's statistics; "
                             "a mesh's data axis would split them over the ranks")
        # names of the row-sharded parameters (M > 1)
        self.sharded = ()
        if self.mesh is not None and self.mesh.n_model > 1:
            self.sharded = tuple(shard_model_(model, self.mesh.m, self.mesh.n_model))
        self.optimizer = make_optimizer(cfg.optimizer, cfg.learning_rate,
                                        model.parameters())

    # ------------------------------- loss core -------------------------------

    def _loss(self, batch, weights, generator, training: bool = True, labels=None):
        if self.sharded:
            return call_with_tables(self.model, self.gathered(), self._local_loss, batch,
                                    weights, generator, training, labels)
        return self._local_loss(batch, weights, generator, training, labels)

    def gathered(self) -> dict:
        """The row-sharded tables gathered to full size (differentiable)."""
        return gather_tables(self.model, self.sharded, self.mesh)

    def _full_batch_draws(self, b: int):
        """The sampler and draw of a data-parallel rank whose batch slice
        has b rows: each draws at the whole batch's shape and keeps this
        rank's rows, so the generator's stream is the one process's."""
        mesh = self.mesh
        rows = slice(mesh.d * b, (mesh.d + 1) * b)
        full = b * mesh.n_data

        def sampler(generator, batch, n_entities, k):
            whole = batch.new_zeros((full,) + tuple(batch.shape[1:]))
            whole[rows] = batch
            return self.sampler(generator, whole, n_entities, k)[rows]

        def draw(generator, high, shape, device):
            if len(shape) == 2 and shape[0] == b:  # one row per query
                return self.draw(generator, high, (full, shape[1]), device)[rows]
            return self.draw(generator, high, shape, device)

        return sampler, draw

    def _local_loss(self, batch, weights, generator, training: bool = True, labels=None):
        cfg = self.cfg
        model = self.model
        mesh = self.mesh
        sampler, draw, total = self.sampler, self.draw, L._same
        if mesh is not None and mesh.data_group is not None:
            sampler, draw = self._full_batch_draws(batch.shape[0])
            total = mesh.data_total
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
            loss, factors = L.neg_sampling_loss_shared(*neg, draw=draw, total=total)
        elif cfg.neg_sample_size > 0 and cfg.neg_mode == "pool":
            loss, factors = L.neg_sampling_loss_pooled(*neg, cfg.neg_pool_size, draw=draw,
                                                       total=total)
        elif cfg.neg_sample_size > 0:
            loss, factors = L.neg_sampling_loss(*neg, sampler=sampler, total=total)
        elif cfg.loss == "crossentropy":
            loss, factors = L.cross_entropy_loss(model, batch, weights, cfg.smoothing,
                                                 n_entities=self.n_entities, total=total)
        elif labels is not None:
            loss, factors = L.bce_loss(model, batch, weights, labels, self.n_entities,
                                       cfg.smoothing, total=total)
        else:
            loss, factors = L.signed_logsigmoid_ce_loss(model, batch, weights,
                                                        n_entities=self.n_entities,
                                                        total=total)
        if not cfg.reg:
            # reg weight 0 (every published config): no factor gathers
            return loss
        if mesh is not None and mesh.d != 0:
            # batch-independent terms: data row 0 adds them, once
            factors = tuple(f for f in factors if not isinstance(f, NoMask))
            if not factors:
                return loss
        if self.is_gnn:
            # the factors are encoder weight matrices, normalized by the
            # first one's leading dim as the reference does
            return loss + self.reg_fn(factors, cfg.reg, factors[0].shape[0])
        return loss + self.reg_fn(factors, cfg.reg, total(torch.sum(weights)), weights)

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
        """Fresh params drawn from `generator` and a fresh optimizer.  Row-
        sharded tables are drawn at full size, as one process draws them,
        and cut to this rank's rows again."""
        m = self.model
        for k in self.sharded:
            full = m.param_specs()[k][0]
            m._parameters[k] = torch.nn.Parameter(getattr(m, k).new_empty(full))
        m.reset_parameters(generator)
        if self.sharded:
            shard_model_(m, self.mesh.m, self.mesh.n_model)
        self.optimizer = make_optimizer(self.cfg.optimizer, self.cfg.learning_rate,
                                        m.parameters())

    def train_step(self, batch, weights, generator, apply: bool = True, labels=None,
                   check=None):
        """Loss and backward of one batch (gradients add to those already
        accumulated); with apply, one optimizer step and cleared gradients.
        labels: the batch's label rows (B, L) for BCE, else None; check: a
        NanCheck, whose backward then runs in place of loss.backward().
        Returns the loss as a device scalar.  Under a torch.profiler the
        step is a range kge.train.step holding kge.train.loss,
        kge.train.backward and (with apply) kge.train.optimizer
        (utils/profiling.py::span)."""
        with span("train.step"):
            with span("train.loss"):
                loss = self._loss(batch, weights, generator, labels=labels)
            with span("train.backward"):
                if check is None:
                    loss.backward()
                else:
                    check.backward(loss)
            if apply:
                with span("train.optimizer"):
                    sum_grads(self.model, self.mesh, self.sharded)
                    self.optimizer.step()
                    self.optimizer.zero_grad(set_to_none=True)
            return loss.detach()

    def _mean(self, losses) -> float:
        """The mean of the batches' losses; on a mesh each rank's losses
        are its slice's shares, summed over the data group first."""
        losses = torch.stack(losses)
        if self.mesh is not None:
            losses = self.mesh.sum_data(losses.contiguous())
        return float(losses.mean())

    def run_epoch(self, batches, weights, generator, labels=None, epoch_id: int = 0) -> float:
        """One epoch over batches (nb, B, 3) with weights (nb, B) and, for
        BCE, label batches (nb, B, L) (numpy, as data/dataset.py::
        epoch_batches gives them; on a mesh the full arrays, of which this
        rank trains on its slice); returns the mean loss.  epoch_id names
        the epoch in a --debug_nans error."""
        if self.mesh is not None:
            batches, weights, labels = shard_epoch_arrays(self.mesh, batches, weights, labels)
        b, w, lab = self._upload(batches, weights, labels)
        k_acc = max(1, self.cfg.update_steps)
        nb = b.shape[0]
        self.optimizer.zero_grad(set_to_none=True)
        with nan_check(self.debug_nans, epoch_id, self.mesh, self.model) as check:
            losses = [self.train_step(b[i], w[i], generator,
                                      apply=(i + 1) % k_acc == 0 or i == nb - 1,
                                      labels=None if lab is None else lab[i], check=check)
                      for i in range(nb)]
        return self._mean(losses)

    @torch.no_grad()
    def valid_loss(self, batches, weights, generator, labels=None) -> float:
        """Mean loss over validation batches (and their label batches),
        without autograd; on a mesh as run_epoch, with the row-sharded
        tables gathered once for all batches."""
        if self.mesh is not None:
            batches, weights, labels = shard_epoch_arrays(self.mesh, batches, weights, labels)
        b, w, lab = self._upload(batches, weights, labels)

        def losses():
            return [self._local_loss(b[i], w[i], generator, training=False,
                                     labels=None if lab is None else lab[i])
                    for i in range(b.shape[0])]

        if self.sharded:
            return self._mean(call_with_tables(self.model, self.gathered(), losses))
        return self._mean(losses())

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
