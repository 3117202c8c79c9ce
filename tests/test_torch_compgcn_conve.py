"""The port's CompGCN with the corr composition and the ConvE decoder
(models/gnn/convs.py ccorr, ConvE; models/gnn/models.py CompGCN) against
the plain reference tests/plain_compgcn_conve.py on the CPU, on seeded
random weights at a small size (30 entities, 3 relations, 150 triples,
rank 8, hidden 8, ConvE k_w 2, k_h 4, ker_sz 3, 4 filters), in float64 and
float32: the loss, every leaf's gradient and the parameters after each of
two Adam steps through Trainer.train_step over batches of the label packs,
the running statistics they leave, then eval-mode scores and filtered
ranks through the dense ranker after a checkpoint round trip.

Tolerances are on the largest entry of each quantity: 1e-10 in float64,
where only the order of sums differs (the port sums before it projects and
transforms corr through FFTs); 1e-5 in float32, as
test_torch_compgcn_reference.py's, where each rounding is carried through
four batch norms' divisions by deviations taken over a handful of rows and
through Adam's division by the gradient's own size (the largest seen:
under 5e-6, the parameters after two steps).

Batch norm with batch statistics takes away any constant shift of its
input, so the gradients of conve.fc_bias and conve.bn0_bias (each feeds a
batch norm through maps that carry a shift through whole) are zero but for
round-off: each leaf's gradient is compared on the larger of its own scale
and the median leaf's (as kgbench's protocol.norm_gap compares norms), and
Adam's steps on the leaves whose reference gradient reaches 1e-3 of the
median leaf's (protocol.moved_leaves), since Adam's first step moves a
round-off gradient by a full learning rate of either sign; the reference
then takes the port's step of the other leaves, because the shifts they
make, which training's batch statistics take away, reach the running
means and so the eval scores.

Also: ccorr against its definition (and ops/fft.py's ortho transforms,
which would give it over sqrt(d)); the interleave against a hand-built
image; forward_masked with corr; the counters and ranges of a step;
mult / add and distmult / transe unchanged against the parent's code; the
refusals.
"""

import argparse
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import plain_compgcn_conve as ref
from complexhyperbolickge_torch.cli.export import export
from complexhyperbolickge_torch.data.dataset import epoch_batches, synthetic_kg
from complexhyperbolickge_torch.models import ModelConfig, get_model
from complexhyperbolickge_torch.models.base import dot_all, dot_train, neg_sq_dist
from complexhyperbolickge_torch.models.gnn import convs as C
from complexhyperbolickge_torch.ops.fft import irfft_packed, rfft_packed
from complexhyperbolickge_torch.train.checkpoint import load_into, save_checkpoint, state_buffers
from complexhyperbolickge_torch.train.evaluate import make_ranker
from complexhyperbolickge_torch.train.trainer import TrainConfig, Trainer

RANK, HIDDEN, K_W, K_H, KER, FILT = 8, 8, 2, 4, 3, 4
BATCH, LR, SMOOTH = 32, 1e-2, 0.1
DATA = dict(n_entities=30, n_relations=3, n_train=150, n_valid=10, n_test=10, seed=5)
TOL = {torch.float64: 1e-10, torch.float32: 1e-5}
CASES = [(torch.float64, 1), (torch.float32, 1), (torch.float64, 2)]
IDS = ["float64-1layer", "float32-1layer", "float64-2layer"]


@pytest.fixture(scope="module")
def kg():
    return synthetic_kg(**DATA)


def gnn_args(layers, opn="corr", interaction="conve", hidden=HIDDEN, **kw):
    return argparse.Namespace(hidden_dim=hidden, layers=layers, edge_dropout=0.0, dropout=0.0,
                              opn=opn, interaction=interaction, basis=0, k_w=K_W, k_h=K_H,
                              num_filt=FILT, ker_sz=KER, **kw)


def build(kg, dtype=torch.float64, layers=1, seed=3, **kw):
    n_ent, n_rel, _ = kg.get_shape()
    cfg = ModelConfig(n_entities=n_ent, n_relations=n_rel, rank=RANK, bias="learn",
                      dtype=str(dtype)[6:])
    return get_model("CompGCN")(cfg, gnn_args(layers, **kw), kg,
                                generator=torch.Generator().manual_seed(seed))


def random_weights(model, seed):
    """Every parameter at a scale where no term of the step is negligible:
    tables N(0, 1), projections N(0, 1 / fan_in), batch norms' scales
    around 1 and shifts around 0, conv and fc N(0, 1 / fan_in)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            v = torch.randn(p.shape, generator=gen, dtype=torch.float64)
            if name.endswith("_scale"):
                v = 1.0 + 0.1 * v
            elif name.endswith("_bias") and "conve" in name:
                v = 0.1 * v
            elif name.endswith(("w_in", "w_out", "w_loop", "w_rel", "conve.fc")):
                v = v / p.shape[0] ** 0.5
            elif name.endswith("conve.conv"):
                v = v / (p.shape[-1] * p.shape[-2]) ** 0.5
            p.copy_(v.to(p.dtype))


def close(got, want, tol, name=""):
    got, want = got.detach(), want.detach()
    assert got.shape == want.shape, name
    err = float((got - want).abs().max())
    assert err <= tol * max(float(want.abs().max()), 1e-300), f"{name}: {err}"


def leaf_floor(leaves: dict) -> float:
    """The median leaf's largest magnitude."""
    return float(np.median([float(v.abs().max()) for v in leaves.values()]))


def moved(grads: dict) -> list:
    """The leaves whose largest gradient reaches 1e-3 of the median leaf's."""
    floor = leaf_floor(grads)
    return [k for k, v in grads.items() if float(v.abs().max()) >= 1e-3 * floor]


def batches(kg, dtype):
    """Two batches of the shuffled label packs (the second one padded)."""
    examples = kg.get_examples("train")
    _, labels = kg.label_pack("train")
    b, w, lab = epoch_batches(examples, BATCH, np.random.default_rng(9), labels)
    return examples, [(torch.as_tensor(b[i], dtype=torch.int64),
                       torch.as_tensor(w[i], dtype=dtype),
                       torch.as_tensor(lab[i], dtype=torch.int64)) for i in (0, len(b) - 1)]


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def run(request, kg, tmp_path_factory):
    """Two Trainer.train_step calls of the port with Adam (gradients read
    before each update) and the reference's, from the same weights; then
    the trained model's eval scores and a fresh model loaded from its
    checkpoint."""
    dtype, layers = request.param
    model = build(kg, dtype, layers)
    random_weights(model, seed=11 + layers)
    w0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    n_ent, n_rel, _ = kg.get_shape()
    trainer = Trainer(model, TrainConfig(optimizer="Adam", learning_rate=LR, batch_size=BATCH,
                                         neg_sample_size=0, loss="binarycrossentropy",
                                         smoothing=SMOOTH), n_ent, n_rel)
    examples, steps = batches(kg, dtype)
    port = {"loss": [], "grads": [], "after": []}
    for batch, weights, labels in steps:
        trainer.optimizer.zero_grad(set_to_none=True)
        port["loss"].append(trainer.train_step(batch, weights, None, apply=False,
                                               labels=labels))
        port["grads"].append({k: p.grad.detach().clone() for k, p in model.named_parameters()})
        trainer.optimizer.step()
        port["after"].append({k: p.detach().clone() for k, p in model.named_parameters()})
    queries = torch.as_tensor(kg.get_examples("test")[:, :3], dtype=torch.int64)
    with torch.no_grad():
        port["scores"] = model.score_all(queries[:, :2])
    path = str(tmp_path_factory.mktemp("ckpt"))
    save_checkpoint(path, model.state_dict(), buffers=state_buffers(model))
    fresh = build(kg, dtype, layers, seed=99)
    load_into(fresh, path)
    port["buffers"] = {k: v.clone() for k, v in state_buffers(model).items()}

    graph = ref.edges(kg.data["train"], n_rel)
    stats = ref.fresh_stats(FILT, HIDDEN, dtype)
    P, state = dict(w0), {}
    want = {"loss": [], "grads": [], "after": []}
    for t, (batch, weights, labels) in enumerate(steps, start=1):
        P = {k: v.detach().clone().requires_grad_() for k, v in P.items()}
        multi_hot = ref.multi_hot(examples, batch, n_ent, dtype)
        loss = ref.loss(P, graph, batch, weights, multi_hot, layers, SMOOTH, stats, K_W, K_H)
        names = sorted(P)
        grads = dict(zip(names, torch.autograd.grad(loss, [P[k] for k in names])))
        want["loss"].append(loss)
        want["grads"].append(grads)
        P = ref.adam(P, grads, state, t, LR)
        # the leaves whose step is round-off take the port's step, so that
        # both follow one trajectory (the running means see their shifts)
        keep = moved(grads)
        P.update({k: port["after"][t - 1][k].clone() for k in P if k not in keep})
        want["after"].append(P)
    with torch.no_grad():
        x, rel = ref.encode(P, graph, layers)
        want["scores"] = ref.score_all(P, x, rel, queries, stats, K_W, K_H, False)
    want["buffers"] = {f"conve.{k}": v for k, v in stats.items()}
    return dict(tol=TOL[dtype], port=port, want=want, model=model, fresh=fresh,
                queries=queries)


def test_loss_matches_reference(run):
    for got, want in zip(run["port"]["loss"], run["want"]["loss"]):
        close(got, want, run["tol"], "loss")


def test_every_gradient_matches_reference(run):
    for got, want in zip(run["port"]["grads"], run["want"]["grads"]):
        assert set(got) == set(want)
        floor = leaf_floor(want)
        for k in sorted(want):
            err = float((got[k] - want[k]).abs().max())
            assert err <= run["tol"] * max(float(want[k].abs().max()), floor), (k, err)
    # batch norm takes away the shifts: the two biases' gradients are round-off
    assert not {"conve.fc_bias", "conve.bn0_bias"} & set(moved(run["want"]["grads"][0]))


def test_two_adam_steps_match_reference(run):
    keep = moved(run["want"]["grads"][0])
    for got, want in zip(run["port"]["after"], run["want"]["after"]):
        assert set(got) == set(want)
        for k in keep:
            close(got[k], want[k], run["tol"], k)


def test_running_statistics_match_reference(run):
    got, want = run["port"]["buffers"], run["want"]["buffers"]
    assert set(got) == set(want)
    for k in sorted(want):
        close(got[k], want[k], run["tol"], k)


def test_eval_scores_use_running_statistics_through_a_checkpoint(run):
    close(run["port"]["scores"], run["want"]["scores"], run["tol"], "scores")
    with torch.no_grad():
        again = run["fresh"].score_all(run["queries"][:, :2])
    assert torch.equal(again, run["port"]["scores"])


def test_ranks_through_the_dense_ranker(run, kg):
    q = run["queries"]
    n = kg.get_shape()[0]
    fidx = torch.full((q.shape[0], 1), n, dtype=torch.int64)
    fidx[:, 0] = q[:, 2]  # the gold alone is filtered
    got = make_ranker(run["fresh"])(q, fidx)
    s = run["want"]["scores"]
    want = 1 + torch.sum(s > torch.gather(s, 1, q[:, 2:3]), dim=1)
    assert torch.equal(got.to(torch.int64), want)


def test_state_dict_holds_the_parameters_alone(kg):
    model = build(kg)
    assert set(model.state_dict()) == {k for k, _ in model.named_parameters()}
    conve = {k for k in model.state_dict() if k.startswith("conve.")}
    assert conve == {f"conve.{k}" for k in ("bn0_scale", "bn0_bias", "conv", "bn1_scale",
                                            "bn1_bias", "fc", "fc_bias", "bn2_scale",
                                            "bn2_bias")}
    assert model.conve.fc.shape == (FILT * (2 * K_W - KER + 1) * (K_H - KER + 1), HIDDEN)
    assert set(state_buffers(model)) == {f"conve.bn{i}_{s}" for i in range(3)
                                         for s in ("mean", "var")}


@pytest.mark.parametrize("d", [7, 8, 100])
def test_ccorr_is_its_definition(d):
    gen = torch.Generator().manual_seed(d)
    a = torch.randn((5, d), generator=gen, dtype=torch.float64)
    b = torch.randn((5, d), generator=gen, dtype=torch.float64)
    want = ref.ccorr(a, b)
    close(C.ccorr(a, b), want, 1e-13, "ccorr")
    close(C.ccorr(a.float(), b.float()).double(), want, 1e-6, "ccorr f32")
    # ops/fft.py's ortho transforms give the definition over sqrt(d)
    fa, fb = rfft_packed(a), rfft_packed(b)
    r = fa.shape[-1] // 2
    conj_prod = torch.cat([fa[:, :r] * fb[:, :r] + fa[:, r:] * fb[:, r:],
                           fa[:, :r] * fb[:, r:] - fa[:, r:] * fb[:, :r]], dim=-1)
    close(irfft_packed(conj_prod, n=d) * d ** 0.5, want, 1e-13, "ortho")


def test_interleave_is_the_hand_built_image():
    conve = C.ConvE(HIDDEN, K_W, K_H, FILT, KER, dtype=torch.float64)
    e = torch.arange(HIDDEN, dtype=torch.float64)[None] + 100.0
    r = torch.arange(HIDDEN, dtype=torch.float64)[None] + 200.0
    want = torch.tensor([[100, 200, 101, 201], [102, 202, 103, 203],
                         [104, 204, 105, 205], [106, 206, 107, 207]], dtype=torch.float64)
    assert torch.equal(conve.interleave(e, r)[0, 0], want)
    assert torch.equal(ref.interleave(e, r, K_W, K_H)[0, 0], want)


def test_forward_masked_with_corr_is_the_definition():
    """A conv's masked forward (dropped edges, padded node rows) with corr
    against the same conv whose composition is the definition."""
    rng = np.random.default_rng(3)
    n, nr, ne, d = 30, 6, 120, 8
    conv = C.CompGCNConv(d, d, d, d, None, opn="corr", dtype=torch.float64)
    conv.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.as_tensor(rng.normal(0, 1, (n, d))).requires_grad_()
    rel = torch.as_tensor(rng.normal(0, 1, (nr, d))).requires_grad_()
    head, tail = (torch.as_tensor(rng.integers(0, n - 4, ne)) for _ in range(2))
    etype = torch.as_tensor(rng.integers(0, nr, ne))
    edge_w = torch.as_tensor((rng.random(ne) > 0.25).astype(np.float64))
    dir_w = (etype < nr // 2).to(torch.float64)
    node_w = torch.as_tensor((np.arange(n) < n - 4).astype(np.float64))
    args = (x, (head, tail, etype), rel, edge_w, dir_w, node_w)

    C.reset_counts()
    got, got_rel = conv.forward_masked(*args)
    assert C.counts["corr"] == 2  # the edges once (both directions' sums), the self loop
    g = torch.autograd.grad((got ** 2).sum() + got_rel.sum(), [x, rel, conv.loop_rel])

    class Definition(C.CompGCNConv):
        def _compose(self, a, b):
            return ref.ccorr(a, b)

    plain = Definition(d, d, d, d, None, opn="corr", dtype=torch.float64)
    plain.load_state_dict(conv.state_dict())
    want, want_rel = plain.forward_masked(*args)
    w = torch.autograd.grad((want ** 2).sum() + want_rel.sum(), [x, rel, plain.loop_rel])
    close(got, want, 1e-12, "x")
    for a, b in zip(g, w):
        close(a, b, 1e-12, "grad")


def _ranges(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("cat") == "cpu_op" and e["name"].startswith("kge.")]


def test_a_step_counts_and_marks_corr_and_the_decoder(kg, tmp_path):
    model = build(kg, torch.float32)
    n_ent, n_rel, _ = kg.get_shape()
    trainer = Trainer(model, TrainConfig(optimizer="Adam", batch_size=BATCH,
                                         neg_sample_size=0, loss="binarycrossentropy"),
                      n_ent, n_rel)
    _, steps = batches(kg, torch.float32)
    batch, weights, labels = steps[0]
    C.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(batch, weights, None, labels=labels)
    assert C.counts == {"corr": 3, "conve": 1}  # two directions and the self loop
    ops = _ranges(prof, tmp_path)

    def named(n):
        return [o for o in ops if o[0] == n]

    def inside(a, b):
        return b[1] <= a[1] and a[2] <= b[2]

    (encode,), (loss,) = named("kge.train.encode"), named("kge.train.loss")
    corr, (decode,) = named("kge.train.corr"), named("kge.train.decode")
    assert len(corr) == 3 and all(inside(o, encode) for o in corr)
    assert inside(decode, loss) and not inside(decode, encode)
    # eval (ranking) runs the decoder outside any training range
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            model.score_all(batch[:, :2])
    assert not [o for o in _ranges(prof, tmp_path) if o[0] == "kge.train.decode"]


def test_mult_add_distmult_transe_are_the_parents(kg):
    """The compositions and decoders the parent had, as the parent wrote
    them, against the port's, bit for bit."""

    def parent_compose(opn, x, r):
        return x - r if opn == "add" else x * r

    def parent_decode(interaction, head, rel, rhs, all_pairs):
        lhs = head * rel if interaction == "distmult" else head + rel
        if interaction == "distmult":
            return dot_all(lhs, rhs) if all_pairs else dot_train(lhs, rhs)
        return neg_sq_dist(lhs, rhs, all_pairs)

    gen = torch.Generator().manual_seed(4)
    x, r = torch.randn((6, 8), generator=gen), torch.randn((6, 8), generator=gen)
    for opn in ("mult", "add"):
        conv = C.CompGCNConv(8, 8, 8, 8, None, opn=opn)
        C.reset_counts()
        assert torch.equal(conv._compose(x, r), parent_compose(opn, x, r))
        assert C.counts["corr"] == 0
    for interaction in ("distmult", "transe"):
        model = build(kg, torch.float32, opn="mult", interaction=interaction, hidden=16)
        assert model.conve is None
        cache = model.encode()
        q = torch.as_tensor(kg.get_examples("test")[:4, :2], dtype=torch.int64)
        (lhs,), _ = model.get_queries(q, cache)
        head, rel = cache[0][q[:, 0]], cache[1][q[:, 1]]
        for all_pairs, rhs in ((True, cache[0]), (False, cache[0][:4, None, :].expand(4, 3, 16))):
            assert torch.equal(model.sim((lhs,), rhs, all_pairs),
                               parent_decode(interaction, head, rel, rhs, all_pairs))


def test_refusals(kg, tmp_path):
    with pytest.raises(ValueError, match="k_w \\* k_h"):
        build(kg, hidden=10)
    with pytest.raises(ValueError, match="unknown composition"):
        build(kg, opn="sub")
    with pytest.raises(ValueError, match="unknown interaction"):
        build(kg, interaction="rotate")
    with pytest.raises(ValueError, match="full graph only"):
        build(kg).encode_subgraph(None, None, None, None)
    for opn, interaction in (("corr", "distmult"), ("mult", "conve")):
        run_dir = tmp_path / f"{opn}-{interaction}"
        save_checkpoint(str(run_dir), {"entity": torch.zeros(2, 2)},
                        config={"args": {"model": "CompGCN", "opn": opn,
                                         "interaction": interaction}})
        with pytest.raises(ValueError, match="JAX package has no corr"):
            export(str(run_dir))


CLI = ["--dataset", "synthetic", "--synthetic_entities", "60", "--model", "CompGCN",
       "--rank", "8", "--hidden_dim", "8", "--layers", "1", "--opn", "corr",
       "--interaction", "conve", "--k_w", "2", "--k_h", "4", "--num_filt", "4", "--ker_sz", "3",
       "--batch_size", "256", "--eval_batch_size", "128", "--neg_sample_size", "0",
       "--loss", "binarycrossentropy", "--smoothing", "0.1", "--optimizer", "Adam",
       "--learning_rate", "0.01", "--bias", "learn", "--dtype", "float64", "--valid", "1",
       "--edge_dropout", "0.0", "--dropout", "0.3", "--device", "cpu", "--seed", "3"]


def test_cli_trains_and_its_checkpoints_carry_the_running_statistics(tmp_path):
    """cli.run trains corr + conve (its dropouts on); state.pkl carries the
    decoder's running statistics, so kge-test of the run dir repeats the
    final metrics, and a resumed run equals the continuous one."""
    from complexhyperbolickge_torch.cli import run as R
    from complexhyperbolickge_torch.cli.test import test as kge_test
    from complexhyperbolickge_torch.train.checkpoint import load_checkpoint

    def train(d, *extra):
        return R.train(R.build_parser().parse_args(CLI + ["--save_dir", str(d), *extra]))

    out = train(tmp_path / "run", "--max_epochs", "2")
    losses = [h["train_loss"] for h in out["history"]]
    assert np.isfinite(losses).all() and 0.0 < out["test"]["MRR"] <= 1.0
    st = load_checkpoint(str(tmp_path / "run"))
    assert sorted(st["buffers"]) == sorted(f"conve.bn{i}_{s}" for i in range(3)
                                           for s in ("mean", "var"))
    assert not np.array_equal(st["buffers"]["conve.bn2_var"], np.ones(HIDDEN))  # trained
    assert kge_test(str(tmp_path / "run"), device="cpu") == out["test"]
    train(tmp_path / "resumed", "--max_epochs", "1")
    resumed = train(tmp_path / "resumed", "--max_epochs", "2", "--resume")
    assert resumed["history"][0]["train_loss"] == out["history"][1]["train_loss"]
    assert resumed["test"] == out["test"]
