"""bfloat16 in the port against the JAX package, on the CPU.

* Optimizer: for bfloat16 params the JAX trainer keeps the optimizer state
  and the update arithmetic in float32 and adds the update, cast back to
  bfloat16, to the param (`_f32_state_for_bf16`, optax's apply_updates).
  The same bfloat16 params and bfloat16 grads go into the JAX Trainer's
  `tx` and into the port's optimizer (so the bfloat16 forward's summation
  order does not enter), for Adam and Adagrad.  Tolerance: one bfloat16
  ulp a step (optax computes Adam's bias corrections in float32, torch in
  float64, and the two update expressions round differently in float32;
  that can move a bfloat16 rounding by one).  The state must be float32,
  and a JAX checkpoint's state must load without a cast.
* GNN: CompGCN's encode in bfloat16, port against JAX.  Both round every
  operation to bfloat16, in other places (XLA's scatter adds in bfloat16,
  the port's sorted sums in float32 with one rounding), so the encodings
  agree within a few bfloat16 ulps: rtol 2^-6 with an absolute floor of
  2^-5 times the array's largest magnitude (the measured largest
  difference is 2^-5 at a magnitude of 3.2, two ulps there).
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from complexhyperbolickge_torch.data.dataset import synthetic_kg
from complexhyperbolickge_torch.models import ModelConfig, get_model
from complexhyperbolickge_torch.train import checkpoint as ckpt
from complexhyperbolickge_torch.train.trainer import (
    F32StateForBF16,
    TrainConfig,
    Trainer,
    make_optimizer,
    reduce_lr,
)
from complexhyperbolickge_tpu.data.dataset import synthetic_kg as jax_synthetic_kg
from complexhyperbolickge_tpu.models import ModelConfig as JaxConfig
from complexhyperbolickge_tpu.models import get_model as jax_get_model
from complexhyperbolickge_tpu.train import checkpoint as jax_ckpt
from complexhyperbolickge_tpu.train.trainer import TrainConfig as JaxTrainConfig
from complexhyperbolickge_tpu.train.trainer import Trainer as JaxTrainer

N_ENT, N_REL, RANK = 40, 6, 5
CFG = dict(n_entities=N_ENT, n_relations=N_REL, rank=RANK, bias="learn", multi_c=True,
           dtype="bfloat16")
LRS = {"Adam": 2.0 ** -6, "Adagrad": 2.0 ** -4}  # exact in float32


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance between two bfloat16 tensors in units in the
    last place (signs across zero counted through it)."""
    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def bf16_arrays(seed: int, shapes: dict, scale: float, shift_c: bool = False) -> dict:
    """name -> float32 numpy arrays whose values are bfloat16 numbers."""
    r = np.random.default_rng(seed)
    out = {}
    for k, s in shapes.items():
        v = r.normal(0.0, scale, s) + (1.0 if shift_c and k == "c" else 0.0)
        out[k] = np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32)
    return out


def to_port(arrays: dict) -> dict:
    return {k: torch.as_tensor(v).to(torch.bfloat16) for k, v in arrays.items()}


def jax_fft_roth():
    jm = jax_get_model("FFTRotH")(JaxConfig(**CFG))
    shapes = {k: np.shape(v) for k, v in jm.init(jax.random.PRNGKey(0)).items()}
    return jm, shapes


@pytest.mark.parametrize("optimizer", ["Adam", "Adagrad"])
def test_bf16_optimizer_step_matches_jax(optimizer):
    """Two steps from the same bfloat16 params with injected bfloat16 grads:
    the port's params within one bfloat16 ulp of JAX's after each step,
    its state float32."""
    jm, shapes = jax_fft_roth()
    params = bf16_arrays(0, shapes, 0.15, shift_c=True)
    tx = JaxTrainer(jm, JaxTrainConfig(optimizer=optimizer, learning_rate=LRS[optimizer]),
                    N_ENT, N_REL).tx
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    state = tx.init(jp)
    model = get_model("FFTRotH")(ModelConfig(**CFG))
    model.load_state_dict(to_port(params))
    opt = make_optimizer(optimizer, LRS[optimizer], model.parameters())
    assert isinstance(opt, F32StateForBF16)
    named = dict(model.named_parameters())
    for step in range(2):
        grads = bf16_arrays(10 + step, shapes, 0.5)
        updates, state = tx.update({k: jnp.asarray(v, jnp.bfloat16) for k, v in grads.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, g in to_port(grads).items():
            named[k].grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)
        for k, p in named.items():
            want = torch.as_tensor(np.asarray(jp[k], np.float32)).to(torch.bfloat16)
            assert p.dtype == torch.bfloat16
            assert bf16_ulps(p.detach(), want) <= 1, (step, k)
    moved = max(float((named[k].detach().float() - torch.as_tensor(params[k])).abs().max())
                for k in named)
    assert moved > LRS[optimizer] / 2  # the steps moved the params
    for st in opt.state_dict()["state"].values():
        assert st and all(v.dtype == torch.float32 for v in st.values())


@pytest.mark.parametrize("optimizer", ["Adam", "Adagrad"])
def test_bf16_opt_state_from_jax_loads_float32_and_resumes(optimizer, tmp_path):
    """A JAX bfloat16 run's checkpointed state (float32 moments) goes
    through opt_state_from_jax into the port bit for bit, and the next step
    agrees within one bfloat16 ulp; the port's own opt_state() is float32."""
    jm, shapes = jax_fft_roth()
    params = bf16_arrays(1, shapes, 0.15, shift_c=True)
    lr = LRS[optimizer]
    tx = JaxTrainer(jm, JaxTrainConfig(optimizer=optimizer, learning_rate=lr), N_ENT, N_REL).tx
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    grads = [{k: jnp.asarray(v, jnp.bfloat16) for k, v in bf16_arrays(20 + i, shapes, 0.5).items()}
             for i in range(2)]
    updates, state = tx.update(grads[0], tx.init(jp), jp)
    jp = optax.apply_updates(jp, updates)
    jax_ckpt.save_checkpoint(str(tmp_path), jp, state, epoch=1)
    loaded = ckpt.load_checkpoint(str(tmp_path))
    converted = ckpt.opt_state_from_jax(loaded["opt_state"])
    jstate = state.inner_state[0]
    for name in params:
        st = converted["state"][name]
        if optimizer == "Adam":
            want = {"exp_avg": jstate.mu[name], "exp_avg_sq": jstate.nu[name]}
        else:
            want = {"sum": jstate.sum_of_squares[name]}
        for key, v in want.items():
            assert st[key].dtype == np.float32
            np.testing.assert_array_equal(st[key], np.asarray(v))

    model = get_model("FFTRotH")(ModelConfig(**CFG))
    model.load_state_dict(to_port({k: np.asarray(v, np.float32) for k, v in jp.items()}))
    trainer = Trainer(model, TrainConfig(optimizer=optimizer, learning_rate=lr), N_ENT, N_REL)
    trainer.load_opt_state(converted)
    for name, st in trainer.opt_state()["state"].items():
        for key, v in st.items():
            assert v.dtype == np.float32
            if key != "step":
                np.testing.assert_array_equal(v, converted["state"][name][key])
    updates, state = tx.update(grads[1], state, jp)
    jp = optax.apply_updates(jp, updates)
    named = dict(model.named_parameters())
    for k, g in grads[1].items():
        named[k].grad = torch.as_tensor(np.asarray(g, np.float32)).to(torch.bfloat16)
    trainer.optimizer.step()
    for k, p in named.items():
        want = torch.as_tensor(np.asarray(jp[k], np.float32)).to(torch.bfloat16)
        assert bf16_ulps(p.detach(), want) <= 1, k


@pytest.mark.parametrize("optimizer", ["Adam", "Adagrad"])
def test_bf16_trainer_reduce_lr_reaches_the_float32_optimizer(optimizer):
    """reduce_lr on a bfloat16 trainer scales the float32 optimizer's
    learning rate: a step after halving it agrees with a JAX step at half
    the rate, within one bfloat16 ulp."""
    jm, shapes = jax_fft_roth()
    params = bf16_arrays(2, shapes, 0.15, shift_c=True)
    lr = LRS[optimizer]
    model = get_model("FFTRotH")(ModelConfig(**CFG))
    model.load_state_dict(to_port(params))
    trainer = Trainer(model, TrainConfig(optimizer=optimizer, learning_rate=2 * lr), N_ENT, N_REL)
    reduce_lr(trainer.optimizer, 0.5)
    assert [g["lr"] for g in trainer.optimizer.inner.param_groups] == [lr]
    tx = JaxTrainer(jm, JaxTrainConfig(optimizer=optimizer, learning_rate=lr), N_ENT, N_REL).tx
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    grads = bf16_arrays(30, shapes, 0.5)
    updates, _ = tx.update({k: jnp.asarray(v, jnp.bfloat16) for k, v in grads.items()},
                           tx.init(jp), jp)
    jp = optax.apply_updates(jp, updates)
    named = dict(model.named_parameters())
    for k, g in to_port(grads).items():
        named[k].grad = g
    trainer.optimizer.step()
    for k, p in named.items():
        want = torch.as_tensor(np.asarray(jp[k], np.float32)).to(torch.bfloat16)
        assert bf16_ulps(p.detach(), want) <= 1, k


def test_float32_params_keep_the_plain_torch_optimizer():
    """f32 and f64 params go to torch.optim as they are (their parity tests
    are unchanged)."""
    for dtype in (torch.float32, torch.float64):
        p = torch.nn.Parameter(torch.ones(3, dtype=dtype))
        assert isinstance(make_optimizer("Adam", 0.1, [p]), torch.optim.Adam)


# ----------------------------- bfloat16 CompGCN ---------------------------------

DATA = dict(n_entities=40, n_relations=4, n_train=300, n_valid=40, n_test=40, seed=5)
ARGS = dict(hidden_dim=16, layers=2, edge_dropout=0.0, dropout=0.0, opn="mult",
            interaction="distmult", basis=0, gnn_agg_method=1)
GNN_RTOL, GNN_ATOL = 2.0 ** -6, 2.0 ** -5  # the atol scales with the largest magnitude


def test_bf16_compgcn_encode_matches_jax():
    """CompGCN's encode with bfloat16 weights, port (sorted sums through
    K9's plain version: float32 sums rounded once) against JAX, within
    GNN_RTOL and GNN_ATOL; every output bfloat16 and finite."""
    tdata, jdata = synthetic_kg(**DATA), jax_synthetic_kg(**DATA)
    args = argparse.Namespace(**ARGS)
    n_ent, n_rel, _ = tdata.get_shape()
    cfg = dict(n_entities=n_ent, n_relations=n_rel, rank=8, multi_c=True, dtype="bfloat16")
    jm = jax_get_model("CompGCN")(JaxConfig(**cfg), args, jdata)
    rng = np.random.default_rng(0)
    jp = jax.tree.map(lambda v: np.asarray(jnp.asarray(
        np.asarray(v, np.float32) + rng.normal(0.0, 0.1, np.shape(v)), jnp.bfloat16),
        np.float32), jm.init(jax.random.PRNGKey(0)))
    tm = get_model("CompGCN")(ModelConfig(**cfg), args, tdata)
    tm.load_state_dict(ckpt.params_from_jax(jp, "cpu", torch.bfloat16))
    assert {p.dtype for p in tm.parameters()} == {torch.bfloat16}
    want = jm.encode(jax.tree.map(lambda v: jnp.asarray(v, jnp.bfloat16), jp))
    with torch.no_grad():
        got = tm.encode()
    leaves_got, leaves_want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(leaves_got) == len(leaves_want)
    for a, b in zip(leaves_got, leaves_want):
        b = np.asarray(b, np.float32)
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all()
        np.testing.assert_allclose(a.float().numpy(), b, rtol=GNN_RTOL,
                                   atol=GNN_ATOL * max(1.0, float(np.abs(b).max())))
