"""The port's losses, regularizers, batching and Trainer against the JAX
package, in float64 on the CPU.

Negatives cannot come from one seed in both packages (jax.random and
torch.Generator differ), so the tests rebuild JAX's: the epoch key splits
into one key per step, each step key splits in two, and the first half
draws the tail negatives (the second the head negatives under double_neg),
as trainer.py and losses.py do.  The port's Trainer gets them through an
injected sampler.  Trajectories are compared with SGD: Adam and Adagrad
turn sub-ulp gradient sign flips into full +-lr steps, so for them one step
is checked.  JAX holds the optimizers' hyperparameters in float32, so the
learning rates here are exact in float32.  Tolerance: rtol 1e-9, atol 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.data.dataset import epoch_batches, synthetic_kg
from complexhyperbolickge_torch.models import ModelConfig, get_model
from complexhyperbolickge_torch.models.base import NoMask
from complexhyperbolickge_torch.train import losses as TL
from complexhyperbolickge_torch.train import regularizers as TR
from complexhyperbolickge_torch.train.checkpoint import load_checkpoint, opt_state_from_jax, params_from_jax
from complexhyperbolickge_torch.train.trainer import TrainConfig, Trainer, make_optimizer, reduce_lr
from complexhyperbolickge_tpu.data import dataset as jax_dataset
from complexhyperbolickge_tpu.models import ModelConfig as JaxConfig
from complexhyperbolickge_tpu.models import get_model as jax_get_model
from complexhyperbolickge_tpu.train import checkpoint as jax_ckpt
from complexhyperbolickge_tpu.train import losses as JL
from complexhyperbolickge_tpu.train import regularizers as JR
from complexhyperbolickge_tpu.train.trainer import TrainConfig as JaxTrainConfig
from complexhyperbolickge_tpu.train.trainer import Trainer as JaxTrainer

TOL = dict(rtol=1e-9, atol=1e-12)
LR = 2.0**-7  # exact in float32
N_ENT, N_REL, RANK, B, K = 40, 6, 5, 16, 4
CFG = dict(n_entities=N_ENT, n_relations=N_REL, rank=RANK, bias="learn",
           multi_c=True, dtype="float64")


def make_params(seed=0):
    shapes = {k: np.shape(v) for k, v in
              jax_get_model("FFTRotH")(JaxConfig(**CFG)).init(jax.random.PRNGKey(0)).items()}
    r = np.random.default_rng(seed)
    return {k: r.normal(0.0, 0.15, s) + (1.0 if k == "c" else 0.0) for k, s in shapes.items()}


def port_model(params):
    m = get_model("FFTRotH")(ModelConfig(**CFG))
    m.load_state_dict(params_from_jax(params, "cpu"))
    return m


def make_batches(n_batches, n_pad=5, seed=1):
    """n_batches of B triples; the last is padded by n_pad rows at weight 0."""
    r = np.random.default_rng(seed)
    ex = np.stack([r.integers(0, N_ENT, n_batches * B - n_pad),
                   r.integers(0, N_REL, n_batches * B - n_pad),
                   r.integers(0, N_ENT, n_batches * B - n_pad)], axis=1).astype(np.int32)
    return epoch_batches(ex, B, np.random.default_rng(seed))


def jax_negatives(key, batches, double_neg=False):
    """The negative ids JAX's epoch draws, in the port sampler's call order."""
    out = []
    for step_key, batch in zip(jax.random.split(key, len(batches)), batches):
        k_tail, k_head = jax.random.split(step_key, 2)
        out.append(np.asarray(JL.sample_negatives(k_tail, jnp.asarray(batch), N_ENT, K)))
        if double_neg:
            inv = np.stack([batch[:, 2], batch[:, 1], batch[:, 0]], axis=1)
            out.append(np.asarray(JL.sample_negatives(k_head, jnp.asarray(inv), N_ENT, K)))
    return out


def replay(negatives):
    """A sampler that returns the given draws in order."""
    it = iter(negatives)

    def sampler(generator, batch, n_entities, k):
        neg = torch.tensor(np.array(next(it)), dtype=torch.int64)
        assert neg.shape == (batch.shape[0], k)
        return neg

    return sampler


def run_both(cfg_kw, params, batches, weights, key=jax.random.PRNGKey(3), steps=1):
    """`steps` epochs over the same batches in both packages; returns the
    port trainer, the JAX params and both mean losses of the last epoch."""
    jcfg = JaxTrainConfig(neg_sample_size=K, **cfg_kw)
    jt = JaxTrainer(jax_get_model("FFTRotH")(JaxConfig(**CFG)), jcfg, N_ENT, N_REL)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jo = jt.tx.init(jp)
    keys = [jax.random.fold_in(key, i) for i in range(steps)]
    negs = [n for ek in keys for n in jax_negatives(ek, batches, jcfg.double_neg)]
    pt = Trainer(port_model(params), TrainConfig(neg_sample_size=K, **cfg_kw),
                 N_ENT, N_REL, sampler=replay(negs))
    for ek in keys:
        jp, jo, jloss = jt.run_epoch(jp, jo, batches, weights, ek)
        ploss = pt.run_epoch(batches, weights, None)
    return pt, jp, jo, jloss, ploss


def assert_params_close(model, jax_params, **tol):
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jax_params[name]),
                                   err_msg=name, **(tol or TOL))


# ------------------------------ data and losses -------------------------------


def test_epoch_batches_equal_jax():
    ex = synthetic_kg(n_entities=50, n_train=301, seed=2).get_examples("train")
    for rng_seed in ([0, 1], [0, 2], None):
        got = epoch_batches(ex, 64, None if rng_seed is None else np.random.default_rng(rng_seed))
        want = jax_dataset.epoch_batches(ex, 64, None if rng_seed is None
                                         else np.random.default_rng(rng_seed))
        for a, b in zip(got, want[:2]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got[1][-1, -1] == 0.0 and got[1][0, 0] == 1.0


@pytest.mark.parametrize("double_neg", [False, True])
def test_neg_sampling_loss_equals_jax(double_neg):
    params = make_params()
    batches, weights = make_batches(1)
    batch, w = batches[0], weights[0]
    key = jax.random.PRNGKey(11)
    jm = jax_get_model("FFTRotH")(JaxConfig(**CFG))
    jp = {k: jnp.asarray(v) for k, v in params.items()}

    def jax_loss(p):
        return JL.neg_sampling_loss(jm, p, jnp.asarray(batch), jnp.asarray(w), key,
                                    N_ENT, K, double_neg, N_REL)[0]

    want_loss, want_grad = jax.jit(jax.value_and_grad(jax_loss))(jp)
    ks = jax.random.split(key, 2)
    negs = [np.asarray(JL.sample_negatives(ks[0], jnp.asarray(batch), N_ENT, K))]
    if double_neg:
        inv = jnp.asarray(batch[:, [2, 1, 0]])
        negs.append(np.asarray(JL.sample_negatives(ks[1], inv, N_ENT, K)))
    tm = port_model(params)
    loss, factors = TL.neg_sampling_loss(
        tm, torch.as_tensor(batch, dtype=torch.int64), torch.as_tensor(w, dtype=torch.float64),
        None, N_ENT, K, double_neg, N_REL, sampler=replay(negs))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **TOL)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad[name]),
                                   err_msg=name, **TOL)
    assert len(factors) == 3 and factors[2].shape == (B, 1, 2 * RANK)


@pytest.mark.parametrize("double_neg", [False, True])
def test_fft_ids_route_f32_loss_and_grads_equal_jax_fused_scorer(double_neg, monkeypatch):
    """FFTRotH in float32 with the training scores forced onto the id form
    of K3/K4 (ops.chyperbolic.use_train_kernel patched to accept CPU
    tensors, so chyp_train_distance_ids runs its plain version) against the
    JAX Trainer's loss and gradients through its fused Pallas scorer
    (set_fused_train_scorer(True), the kernels in interpret mode), within
    the train-distance kernels' gradient tolerance."""
    from complexhyperbolickge_torch.kernels import chyp_train as CT
    from complexhyperbolickge_torch.ops import chyperbolic as CH
    from complexhyperbolickge_tpu.kernels import chyp_train as jax_ct
    from complexhyperbolickge_tpu.ops.chyperbolic import set_fused_train_scorer

    grad_tol = dict(rtol=1e-4, atol=1e-6)  # tests/test_torch_chyp_train.py GRAD_TOL
    cfg32 = dict(CFG, dtype="float32")
    params = {k: v.astype(np.float32) for k, v in make_params().items()}
    batches, weights = make_batches(1)
    batch, w = batches[0], weights[0]
    key = jax.random.PRNGKey(12)
    jt = JaxTrainer(jax_get_model("FFTRotH")(JaxConfig(**cfg32)),
                    JaxTrainConfig(neg_sample_size=K, double_neg=double_neg), N_ENT, N_REL)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    monkeypatch.setattr(jax_ct, "INTERPRET", True)
    set_fused_train_scorer(True)
    try:
        want_loss, want_grad = jax.value_and_grad(
            lambda p: jt._loss(p, jnp.asarray(batch), jnp.asarray(w), None, key))(jp)
    finally:
        set_fused_train_scorer(False)
    ks = jax.random.split(key, 2)
    negs = [np.asarray(JL.sample_negatives(ks[0], jnp.asarray(batch), N_ENT, K))]
    if double_neg:
        negs.append(np.asarray(JL.sample_negatives(ks[1], jnp.asarray(batch[:, [2, 1, 0]]),
                                                   N_ENT, K)))

    calls = []
    real = CT.chyp_train_distance_ids
    monkeypatch.setattr(CH, "use_train_kernel", lambda lhs, rhs: lhs.dtype == torch.float32)
    monkeypatch.setattr(CT, "chyp_train_distance_ids",
                        lambda *a: calls.append(a[2].shape) or real(*a))
    model = get_model("FFTRotH")(ModelConfig(**cfg32))
    model.load_state_dict(params_from_jax(params, "cpu"))
    pt = Trainer(model, TrainConfig(neg_sample_size=K, double_neg=double_neg), N_ENT, N_REL,
                 sampler=replay(negs))
    loss = pt._loss(torch.as_tensor(batch, dtype=torch.int64), torch.as_tensor(w), None)
    loss.backward()
    # one (B, 1 + K) id block for the tails, and (B, K) for the heads
    assert calls == [(B, 1 + K)] + [(B, K)] * double_neg
    np.testing.assert_allclose(loss.item(), float(want_loss), **grad_tol)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad[name]),
                                   err_msg=name, **grad_tol)


def test_sample_negatives_excludes_gold_and_stays_in_range():
    batch = torch.as_tensor(np.random.default_rng(0).integers(0, 7, (200, 3)))
    neg = TL.sample_negatives(torch.Generator().manual_seed(0), batch, 7, 50)
    assert neg.shape == (200, 50) and neg.min() >= 0 and neg.max() <= 6
    assert not (neg == batch[:, 2:3]).any()


@pytest.mark.parametrize("name", ["N3", "F2", "L2"])
@pytest.mark.parametrize("tails", ["rows", "full_table"])
def test_regularizers_equal_jax(name, tails):
    r = np.random.default_rng(4)
    head, rel = r.normal(size=(B, 10)), r.normal(size=(B, 16))
    table = r.normal(size=(B, 10))  # n_entities == batch size: the NoMask trap
    w = np.ones(B, np.float32)
    w[-3:] = 0.0
    third_t = NoMask(torch.as_tensor(table)) if tails == "full_table" else torch.as_tensor(table)
    third_j = JR.NoMask(jnp.asarray(table)) if tails == "full_table" else jnp.asarray(table)
    got = TR.get_regularizer(name)(
        (torch.as_tensor(head), torch.as_tensor(rel), third_t), 0.05,
        torch.as_tensor(w).sum(), torch.as_tensor(w))
    want = JR.get_regularizer(name)((jnp.asarray(head), jnp.asarray(rel), third_j),
                                    0.05, jnp.sum(jnp.asarray(w)), jnp.asarray(w))
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_unported_losses_and_modes_raise():
    with pytest.raises(NotImplementedError, match="item 10"):
        TL.cross_entropy_loss()
    model = port_model(make_params())
    for kw in (dict(neg_mode="pool"), dict(neg_sample_size=0), dict(optimizer="SparseAdam")):
        with pytest.raises(NotImplementedError, match="item 10"):
            Trainer(model, TrainConfig(**kw), N_ENT, N_REL)


# --------------------------------- trainer ------------------------------------


def test_sgd_trajectory_matches_jax():
    """5 SGD steps (the last batch padded), then the validation loss."""
    params = make_params()
    batches, weights = make_batches(5)
    pt, jp, jo, jloss, ploss = run_both(dict(optimizer="SGD", learning_rate=0.5),
                                        params, batches, weights)
    np.testing.assert_allclose(ploss, jloss, **TOL)
    assert_params_close(pt.model, jp)
    moved = max(np.abs(p.detach().numpy() - params[n]).max()
                for n, p in pt.model.named_parameters())
    assert moved > 1e-3
    jt = JaxTrainer(jax_get_model("FFTRotH")(JaxConfig(**CFG)),
                    JaxTrainConfig(neg_sample_size=K), N_ENT, N_REL)
    vkey = jax.random.PRNGKey(8)
    want = jt.valid_loss(jp, batches[:2], weights[:2], vkey)
    pt.sampler = replay(jax_negatives(vkey, batches[:2]))
    assert pt.valid_loss(batches[:2], weights[:2], None) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("optimizer", ["Adam", "Adagrad"])
def test_one_adaptive_step_matches_jax(optimizer):
    params = make_params()
    batches, weights = make_batches(1)
    pt, jp, _, jloss, ploss = run_both(dict(optimizer=optimizer, learning_rate=LR),
                                       params, batches, weights)
    np.testing.assert_allclose(ploss, jloss, **TOL)
    assert_params_close(pt.model, jp)


def test_update_steps_double_neg_and_reg_match_jax():
    """update_steps=2 over 3 batches (steps after batch 2 and after the
    last), with head corruption and an N3 term in the loss."""
    params = make_params()
    batches, weights = make_batches(3)
    pt, jp, _, jloss, ploss = run_both(dict(optimizer="SGD", learning_rate=0.5,
                                            update_steps=2, double_neg=True,
                                            regularizer="N3", reg=0.1),
                                       params, batches, weights)
    np.testing.assert_allclose(ploss, jloss, **TOL)
    assert_params_close(pt.model, jp)


def test_opt_state_from_jax_resumes_a_jax_adam_run(tmp_path):
    """2 Adam steps in JAX, its checkpoint through the jax-free loader and
    opt_state_from_jax into the port, then a third step in both."""
    params = make_params()
    batches, weights = make_batches(3)
    cfg = dict(optimizer="Adam", learning_rate=LR)
    jt = JaxTrainer(jax_get_model("FFTRotH")(JaxConfig(**CFG)),
                    JaxTrainConfig(neg_sample_size=K, **cfg), N_ENT, N_REL)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jp, jo, _ = jt.run_epoch(jp, jt.tx.init(jp), batches[:2], weights[:2],
                             jax.random.PRNGKey(5))
    jax_ckpt.save_checkpoint(str(tmp_path), jp, jo, epoch=1)
    state = load_checkpoint(str(tmp_path))
    converted = opt_state_from_jax(state["opt_state"])
    adam = jo.inner_state[0]
    assert converted["lr"] == LR
    for name in params:
        st = converted["state"][name]
        assert float(st["step"]) == 2.0
        np.testing.assert_array_equal(st["exp_avg"], np.asarray(adam.mu[name]))
        np.testing.assert_array_equal(st["exp_avg_sq"], np.asarray(adam.nu[name]))

    key3 = jax.random.PRNGKey(6)
    pt = Trainer(port_model(state["params"]), TrainConfig(neg_sample_size=K, **cfg),
                 N_ENT, N_REL, sampler=replay(jax_negatives(key3, batches[2:])))
    pt.load_opt_state(converted)
    jp, _, _ = jt.run_epoch(jp, jo, batches[2:], weights[2:], key3)
    pt.run_epoch(batches[2:], weights[2:], None)
    # optax computes the bias corrections 1 - b**t in float32 (float32
    # hyperparameters, int32 count): ~2e-5 relative at t = 3, where
    # torch.optim.Adam computes them in float64
    assert_params_close(pt.model, jp, rtol=1e-4, atol=1e-9)
    # and the port's own state round-trips through its checkpoint form
    again = Trainer(port_model(state["params"]), TrainConfig(**cfg), N_ENT, N_REL)
    again.load_opt_state(pt.opt_state())
    for name, st in pt.opt_state()["state"].items():
        for k, v in st.items():
            np.testing.assert_array_equal(again.opt_state()["state"][name][k], v)


@pytest.mark.parametrize("optimizer", ["Adagrad", "SGD"])
def test_opt_state_from_jax_adagrad_and_sgd(optimizer, tmp_path):
    params = make_params()
    jt = JaxTrainer(jax_get_model("FFTRotH")(JaxConfig(**CFG)),
                    JaxTrainConfig(optimizer=optimizer, learning_rate=LR), N_ENT, N_REL)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jax_ckpt.save_checkpoint(str(tmp_path), jp, jt.tx.init(jp), epoch=0)
    converted = opt_state_from_jax(load_checkpoint(str(tmp_path))["opt_state"])
    assert converted["lr"] == LR
    if optimizer == "SGD":
        assert converted["state"] == {}
    else:
        assert sorted(converted["state"]["entity"]) == ["step", "sum"]
    pt = Trainer(port_model(params), TrainConfig(optimizer=optimizer), N_ENT, N_REL)
    pt.load_opt_state(converted)
    assert pt.optimizer.param_groups[0]["lr"] == LR


def test_reduce_lr_scales_every_group():
    opt = make_optimizer("Adam", 0.1, [torch.nn.Parameter(torch.zeros(2))])
    reduce_lr(opt, 0.5)
    assert opt.param_groups[0]["lr"] == pytest.approx(0.05)


def test_init_redraws_params_and_resets_the_optimizer():
    params = make_params()
    batches, weights = make_batches(1)
    pt = Trainer(port_model(params), TrainConfig(optimizer="Adam", neg_sample_size=K),
                 N_ENT, N_REL)
    pt.run_epoch(batches, weights, torch.Generator().manual_seed(0))
    pt.init(torch.Generator().manual_seed(4))
    want = get_model("FFTRotH")(ModelConfig(**CFG), generator=torch.Generator().manual_seed(4))
    for (name, p), q in zip(pt.model.named_parameters(), want.parameters()):
        assert torch.equal(p, q), name
    assert pt.opt_state()["state"] == {}


# ------------------------------ GNN training ----------------------------------

GNN_ARGS = dict(hidden_dim=8, layers=2, edge_dropout=0.0, dropout=0.0, opn="mult",
                interaction="distmult", basis=0, gnn_agg_method=1)
GNN_DATA = dict(n_entities=N_ENT, n_relations=3, n_train=150, n_valid=20, n_test=20, seed=2)


def gnn_negatives(key, batches):
    """JAX's GNN step splits its key into (loss key, encoder key) first;
    the loss key's first half draws the tail negatives."""
    out = []
    for step_key, batch in zip(jax.random.split(key, len(batches)), batches):
        loss_key, _ = jax.random.split(step_key)
        k_tail, _ = jax.random.split(loss_key, 2)
        out.append(np.asarray(JL.sample_negatives(k_tail, jnp.asarray(batch), N_ENT, K)))
    return out


@pytest.mark.parametrize("name,reg", [("CompGCN", 0.0), ("PoincareGCN", 0.1)])
def test_gnn_sgd_trajectory_matches_jax(name, reg):
    """4 SGD steps of a GNN (the encoder re-run every step, edge dropout 0)
    over the synthetic graph's train triples, then the validation loss; with
    an N3 term over the encoder weights for PoincareGCN."""
    import argparse

    from complexhyperbolickge_tpu.data.dataset import synthetic_kg as jax_synthetic_kg

    args = argparse.Namespace(**GNN_ARGS)
    data, jdata = synthetic_kg(**GNN_DATA), jax_synthetic_kg(**GNN_DATA)
    n_ent, n_rel, _ = data.get_shape()
    cfg = dict(n_entities=n_ent, n_relations=n_rel, rank=RANK, bias="learn",
               multi_c=True, dtype="float64")
    jm = jax_get_model(name)(JaxConfig(**cfg), args, jdata)
    r = np.random.default_rng(0)
    jp = jax.tree.map(lambda v: jnp.asarray(np.asarray(v) + r.normal(0.0, 0.1, np.shape(v))),
                      jm.init(jax.random.PRNGKey(0)))
    init = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")  # JAX donates jp
    tm = get_model(name)(ModelConfig(**cfg), args, data)
    tm.load_state_dict(init)
    batches, weights = epoch_batches(data.get_examples("train")[:4 * B - 3], B,
                                     np.random.default_rng(1))
    tcfg = dict(optimizer="SGD", learning_rate=0.125, neg_sample_size=K, regularizer="N3", reg=reg)
    jt = JaxTrainer(jm, JaxTrainConfig(**tcfg), n_ent, n_rel)
    key = jax.random.PRNGKey(3)
    pt = Trainer(tm, TrainConfig(**tcfg), n_ent, n_rel, sampler=replay(gnn_negatives(key, batches)))
    jp2, _, jloss = jt.run_epoch(jp, jt.tx.init(jp), batches, weights, key)
    ploss = pt.run_epoch(batches, weights, None)
    np.testing.assert_allclose(ploss, jloss, **TOL)
    want = params_from_jax(jax.tree.map(np.asarray, jp2), "cpu")
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), err_msg=n,
                                   rtol=1e-9, atol=1e-11)
    assert max(float((p - init[n]).abs().max()) for n, p in tm.named_parameters()) > 1e-3
    vkey = jax.random.PRNGKey(8)
    want_v = jt.valid_loss(jp2, batches[:2], weights[:2], vkey)
    pt.sampler = replay(gnn_negatives(vkey, batches[:2]))
    assert pt.valid_loss(batches[:2], weights[:2], None) == pytest.approx(want_v, rel=1e-9)


def test_gnn_trainer_rejects_shared_and_pooled_negatives():
    import argparse

    model = get_model("CompGCN")(ModelConfig(n_entities=N_ENT, n_relations=6, rank=RANK),
                                 argparse.Namespace(**GNN_ARGS), synthetic_kg(**GNN_DATA))
    for mode in ("shared", "pool"):
        with pytest.raises(ValueError, match="GNN"):
            Trainer(model, TrainConfig(neg_mode=mode), N_ENT, 6)
