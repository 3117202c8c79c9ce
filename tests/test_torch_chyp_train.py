"""The train-mode distance kernels K3/K4 (kernels/chyp_train.py).

On the CPU: the plain versions (float32) against the JAX Pallas kernel in
interpret mode, at a B that is not a multiple of its 64-row tile, to the
JAX kernel test's tolerances (forward rtol 1e-5; gradients rtol 1e-4, atol
1e-6), in the clamped-at-init (1e-3) and the unclamped (0.4) regimes: the
gathered form, and the id form against chyp_train_distance(lhs,
entity[ids]) with repeated ids (gradients to lhs and the table).  The id
form's table gradient is the fp64 sum of the gathered form's d_rhs in
ascending pair order, and its identity form equals the gathered plain
version bit for bit.

On a card (the `cuda` marker; these skip without one): the CUDA kernels
against the plain version on the card at the same tolerances, at ragged
shapes, the WN18RR train shape (500, 100, 66) and the id form's step
(500 x 101 ids over a 40,943 x 66 table), K = 1 and heavy duplicates;
K4's bits on two runs; no read outside the table; K4's index preparation
(the pair lists' counting sort) equal to its plain version.  They need
no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_chyp_train.py
"""

import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.kernels import chyp_train as CT
from complexhyperbolickge_torch.ops import chyperbolic as CH

FWD_TOL = dict(rtol=1e-5, atol=0.0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
SCALES = [0.4, 1e-3]


def make_pair(b, k, d, scale, seed=1):
    r = np.random.default_rng(seed)
    lhs = r.normal(0, scale, (b, d)).astype(np.float32)
    rhs = r.normal(0, scale, (b, k, d)).astype(np.float32)
    g = r.normal(size=(b, k)).astype(np.float32)
    return lhs, rhs, g


def value_and_grads(fn, lhs, rhs, g, device="cpu"):
    l = torch.tensor(lhs, device=device, requires_grad=True)
    r = torch.tensor(rhs, device=device, requires_grad=True)
    d = fn(l, r)
    (d * torch.tensor(g, device=device)).sum().backward()
    return [t.detach().cpu().numpy() for t in (d, l.grad, r.grad)]


def make_ids_case(b, k, n, d, scale, seed=1, heavy=0):
    """lhs (B, D), table (N, D) ~ N(0, scale), ids (B, K) uniform over
    [0, N) with `heavy` of them set to one id, and a cotangent g (B, K)."""
    r = np.random.default_rng(seed)
    lhs = r.normal(0, scale, (b, d)).astype(np.float32)
    table = r.normal(0, scale, (n, d)).astype(np.float32)
    ids = r.integers(0, n, (b, k))
    ids.flat[r.choice(b * k, heavy, replace=False)] = n // 3
    g = r.normal(size=(b, k)).astype(np.float32)
    return lhs, table, ids, g


def ids_value_and_grads(fn, lhs, table, ids, g, device="cpu"):
    l = torch.tensor(lhs, device=device, requires_grad=True)
    t = torch.tensor(table, device=device, requires_grad=True)
    i = None if ids is None else torch.tensor(ids, dtype=torch.int64, device=device)
    d = fn(l, t, i)
    (d * torch.tensor(g, device=device)).sum().backward()
    return [x.detach().cpu().numpy() for x in (d, l.grad, t.grad)]


@pytest.mark.parametrize("scale", SCALES)
def test_plain_matches_jax_pallas_interpret(scale, monkeypatch):
    jax = pytest.importorskip("jax")
    from complexhyperbolickge_tpu.kernels import chyp_train as jax_ct

    monkeypatch.setattr(jax_ct, "INTERPRET", True)
    lhs, rhs, g = make_pair(70, 7, 18, scale)  # B = 70: the JAX padding path

    def f(l, r):
        return jax.numpy.sum(jax_ct.chyp_train_distance(l, r) * g)

    want_d = np.asarray(jax_ct.chyp_train_distance(lhs, rhs))
    want_gl, want_gr = jax.grad(f, argnums=(0, 1))(lhs, rhs)
    got_d, got_gl, got_gr = value_and_grads(CT.chyp_train_distance_plain, lhs, rhs, g)
    np.testing.assert_allclose(got_d, want_d, **FWD_TOL)
    np.testing.assert_allclose(got_gl, np.asarray(want_gl), **GRAD_TOL)
    np.testing.assert_allclose(got_gr, np.asarray(want_gr), **GRAD_TOL)


@pytest.mark.parametrize("scale", SCALES)
def test_ids_plain_matches_jax_pallas_interpret(scale, monkeypatch):
    """chyp_train_distance_ids_plain against JAX's chyp_train_distance(lhs,
    entity[ids]): B = 70 (the JAX padding path), 1 + K = 8, N = 40, one id
    drawn 25 times; gradients to lhs and the table."""
    jax = pytest.importorskip("jax")
    from complexhyperbolickge_tpu.kernels import chyp_train as jax_ct

    monkeypatch.setattr(jax_ct, "INTERPRET", True)
    lhs, table, ids, g = make_ids_case(70, 8, 40, 18, scale, heavy=25)
    assert np.bincount(ids.ravel()).max() >= 20

    def f(l, t):
        return jax.numpy.sum(jax_ct.chyp_train_distance(l, t[ids]) * g)

    want_d = np.asarray(jax_ct.chyp_train_distance(lhs, table[ids]))
    want_gl, want_gt = jax.grad(f, argnums=(0, 1))(lhs, table)
    got_d, got_gl, got_gt = ids_value_and_grads(CT.chyp_train_distance_ids_plain,
                                                lhs, table, ids, g)
    exact_gl, exact_gt = exact_ids_grads(lhs, table, ids, g)
    np.testing.assert_allclose(got_d, want_d, **FWD_TOL)
    assert_matches_jax(got_gl, np.asarray(want_gl), exact_gl, GRAD_TOL)
    assert_matches_jax(got_gt, np.asarray(want_gt), exact_gt, GRAD_TOL)


def exact_ids_grads(lhs, table, ids, g):
    """d_lhs and d_table from the float32 residuals and coefficients (the
    values both packages compute) with every product and sum in float64:
    what the float32 sums of either package round towards."""
    l, t = torch.tensor(lhs), torch.tensor(table)
    rhs = t[torch.tensor(ids)]
    sr, si, wn, x, zn = CH.chyp_core_residuals(l, rhs)
    coef = CH.clamped_coefficients(torch.tensor(g), sr, si, zn, wn, x)
    ca_z, cb_z, cz, ca_w, cb_w, cw = [c.double()[..., None] for c in coef]
    l64, r64 = l.double(), rhs.double()
    m_a, m_b = (ca_z * r64).sum(1), (cb_z * r64).sum(1)
    d_lhs = m_a - CH.swap_neg(m_b) + cz.sum(1) * l64
    d_rhs = ca_w * l64[:, None] + cb_w * CH.swap_neg(l64)[:, None] + cw * r64
    d_table = torch.zeros(t.shape, dtype=torch.float64).index_add_(
        0, torch.tensor(ids).reshape(-1), d_rhs.reshape(-1, t.shape[1]))
    return d_lhs.numpy(), d_table.numpy()


def assert_matches_jax(got, want, exact, tol):
    """got within tol of JAX's want, except where JAX's own float32 sum
    misses the float64 evaluation by more than tol (cancellation in a sum
    of large terms; the port sums in float64): there got must be within tol
    of the float64 evaluation.  Such entries stay rare."""
    jax_off = ~np.isclose(want, exact, **tol)
    np.testing.assert_allclose(got[~jax_off], want[~jax_off], **tol)
    np.testing.assert_allclose(got[jax_off], exact[jax_off], **tol)
    assert jax_off.mean() < 0.01, f"JAX misses the float64 sums at {jax_off.sum()} entries"


def test_identity_form_equals_the_gathered_plain_version_bit_for_bit():
    """ids None on a (B K, D) table, and ids = arange, give the gathered
    plain version's values, d_lhs and d_rhs (chyp_core_residuals,
    chyp_core_grads) exactly."""
    lhs, rhs, g = make_pair(9, 5, 14, 0.3)
    b, k, d = rhs.shape
    l, r = torch.tensor(lhs), torch.tensor(rhs)
    sr, si, wn, x, zn = CH.chyp_core_residuals(l, r)
    want_d = torch.log(x + torch.sqrt(x * x - 1.0)).numpy()
    want_gl, want_gr = CH.chyp_core_grads(torch.tensor(g), l, r, sr, si, wn, x, zn)
    table = rhs.reshape(b * k, d)
    identity = ids_value_and_grads(CT.chyp_train_distance_ids_plain, lhs, table, None, g)
    arange = ids_value_and_grads(CT.chyp_train_distance_ids_plain, lhs, table,
                                 np.arange(b * k).reshape(b, k), g)
    gathered = value_and_grads(CT.chyp_train_distance_plain, lhs, rhs, g)
    for got in (identity, arange):
        np.testing.assert_array_equal(got[0], want_d)
        np.testing.assert_array_equal(got[1], want_gl.numpy())
        np.testing.assert_array_equal(got[2], want_gr.reshape(b * k, d).numpy())
    for a, c in zip(gathered, identity):
        np.testing.assert_array_equal(a.reshape(c.shape), c)


def test_ids_plain_table_grad_is_the_ascending_fp64_sum_of_d_rhs():
    """Each table row's gradient is its pairs' gathered-form d_rhs terms,
    in float64, added in ascending pair order from 0 and rounded once;
    rows no id names get zeros."""
    lhs, table, ids, g = make_ids_case(12, 6, 10, 8, 0.4, heavy=20)
    _, got_gl, got_gt = ids_value_and_grads(CT.chyp_train_distance_ids_plain,
                                            lhs, table, ids, g)
    _, want_gl, d_rhs = value_and_grads(CT.chyp_train_distance_plain, lhs, table[ids], g)
    np.testing.assert_array_equal(got_gl, want_gl)
    want = np.zeros(table.shape, np.float64)
    for p, e in enumerate(ids.ravel()):
        want[e] += d_rhs.reshape(-1, table.shape[1])[p].astype(np.float64)
    np.testing.assert_array_equal(got_gt, want.astype(np.float32))
    assert not got_gt[np.setdiff1d(np.arange(10), ids)].any()


def lists_case(b, k, n, heavy=0, outside=0, seed=7, device="cpu"):
    """ids (B, K) over N rows (`heavy` of them one id, `outside` of them
    outside [0, N)), with the residuals K3 gives for random lhs and table
    rows and a cotangent g: K4's index preparation's inputs."""
    r = np.random.default_rng(seed)
    ids = r.integers(0, n, (b, k))
    ids.flat[r.choice(b * k, heavy, replace=False)] = n // 2
    ids.flat[r.choice(b * k, outside, replace=False)] = r.choice([-3, -1, n, n + 7], outside)
    lhs = torch.tensor(r.normal(0, 0.3, (b, 10)), dtype=torch.float32, device=device)
    rows = torch.tensor(r.normal(0, 0.3, (b, k, 10)), dtype=torch.float32, device=device)
    g = torch.tensor(r.normal(size=(b, k)), dtype=torch.float32, device=device)
    sr, si, wn, x, zn = CH.chyp_core_residuals(lhs, rows)
    return torch.tensor(ids, device=device), (g, sr, si, wn, x, zn)


def lists_reference(ids, n):
    """offsets and each row's pairs in ascending order, by a Python walk."""
    rows = [[] for _ in range(n)]
    for p, e in enumerate(ids):
        if 0 <= e < n:
            rows[e].append(p)
    offsets = np.cumsum([0] + [len(r) for r in rows])
    return offsets, np.array([p for r in rows for p in r], dtype=np.int64)


@pytest.mark.parametrize("case", ["uniform", "heavy", "outside", "identity"])
def test_lists_plain_is_the_stable_counting_sort_with_coefficients(case):
    """chyp_train_lists_plain: CSR offsets over the N rows, each row's pairs
    in ascending order (ids outside [0, N) left out, trailing records zero;
    the identity form: pair p alone in row p), each with its table-side
    coefficients ca_w, cb_w, cw as chyp_core_grads computes them."""
    n = 200 if case == "identity" else 30
    ids, (g, sr, si, wn, x, zn) = lists_case(20, 10, n, heavy=120 * (case == "heavy"),
                                             outside=3 * (case == "outside"))
    flat = None if case == "identity" else ids.reshape(-1)
    offsets, lists = CT.chyp_train_lists_plain(g, flat, sr, si, wn, x, zn, n)
    want_off, want_perm = lists_reference(np.arange(200) if flat is None else flat.numpy(), n)
    m = want_off[-1]
    assert offsets.dtype == torch.int32 and lists.shape == (200, 4)
    np.testing.assert_array_equal(offsets.numpy(), want_off)
    np.testing.assert_array_equal(lists[:m, 0].view(torch.int32).numpy(), want_perm)
    coef = CH.clamped_coefficients(g, sr, si, zn, wn, x)[3:]
    for col, c in enumerate(coef, 1):
        np.testing.assert_array_equal(lists[:m, col].numpy(), c.reshape(-1)[want_perm].numpy())
    assert not lists[m:].any()


@pytest.mark.parametrize("scale", SCALES)
def test_cpu_ids_wrapper_is_the_plain_version_and_launches_nothing(scale):
    lhs, table, ids, g = make_ids_case(7, 4, 9, 10, scale, heavy=6)
    CT.reset_launches()
    got = ids_value_and_grads(CT.chyp_train_distance_ids, lhs, table, ids, g)
    want = ids_value_and_grads(CT.chyp_train_distance_ids_plain, lhs, table, ids, g)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert CT.launches == {"chyp_train_fwd": 0, "chyp_train_bwd": 0, "chyp_train_lists": 0}


@pytest.mark.parametrize("scale", SCALES)
def test_cpu_wrapper_is_the_plain_version_and_launches_nothing(scale):
    lhs, rhs, g = make_pair(5, 3, 10, scale)
    CT.reset_launches()
    got = value_and_grads(CT.chyp_train_distance, lhs, rhs, g)
    want = value_and_grads(CT.chyp_train_distance_plain, lhs, rhs, g)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert CT.launches == {"chyp_train_fwd": 0, "chyp_train_bwd": 0, "chyp_train_lists": 0}


def test_plain_forward_matches_distance_core():
    """The plain version is ChypDistanceCore with acosh as log(x + sqrt(x^2-1))."""
    lhs, rhs, g = make_pair(6, 4, 12, 0.2)
    plain = value_and_grads(CT.chyp_train_distance_plain, lhs, rhs, g)
    core = value_and_grads(CH.ChypDistanceCore.apply, lhs, rhs, g)
    for a, b in zip(plain, core):
        np.testing.assert_allclose(a, b, **FWD_TOL)


# ------------------------------- on the card ----------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("shape", [(500, 100, 66), (37, 7, 18), (3, 1, 70), (64, 33, 2)])
def test_kernels_match_plain_on_card(shape, scale):
    dev = _cuda_or_skip()
    lhs, rhs, g = make_pair(*shape, scale)
    CT.reset_launches()
    got = value_and_grads(CT.chyp_train_distance, lhs, rhs, g, dev)
    torch.cuda.synchronize()
    # the identity form's lists are trivial (pair p alone in row p), yet K4 reads them
    assert CT.launches == {"chyp_train_fwd": 1, "chyp_train_bwd": 1, "chyp_train_lists": 1}
    want = value_and_grads(CT.chyp_train_distance_plain, lhs, rhs, g, dev)
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL)
    np.testing.assert_allclose(got[1], want[1], **GRAD_TOL)
    np.testing.assert_allclose(got[2], want[2], **GRAD_TOL)


# (B, K, N, D, heavy): the training step's id block over the WN18RR table;
# the positive alone (K = 1); one id drawn 3,000 times among few rows;
# B K = 259, 39 and 15 (not multiples of the 128-pair tile) at D = 18, a
# D of 400 (chunks of 128 columns) and D = 2; every id drawn (N < B K)
IDS_CASES = [(500, 101, 40943, 66, 0), (500, 1, 40943, 66, 0), (300, 33, 50, 66, 3000),
             (37, 7, 100, 18, 0), (13, 3, 20, 400, 5), (5, 3, 4, 2, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("case", IDS_CASES)
def test_ids_kernels_match_plain_on_card(case, scale):
    dev = _cuda_or_skip()
    b, k, n, d, heavy = case
    lhs, table, ids, g = make_ids_case(b, k, n, d, scale, heavy=heavy)
    CT.reset_launches()
    got = ids_value_and_grads(CT.chyp_train_distance_ids, lhs, table, ids, g, dev)
    torch.cuda.synchronize()
    assert CT.launches == {"chyp_train_fwd": 1, "chyp_train_bwd": 1, "chyp_train_lists": 1}
    want = ids_value_and_grads(CT.chyp_train_distance_ids_plain, lhs, table, ids, g, dev)
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL)
    np.testing.assert_allclose(got[1], want[1], **GRAD_TOL)
    np.testing.assert_allclose(got[2], want[2], **GRAD_TOL)
    unnamed = np.setdiff1d(np.arange(n), ids)
    assert not got[2][unnamed].any()  # rows no id names: zeros, written


@pytest.mark.cuda
def test_ids_backward_gives_the_same_bits_twice():
    dev = _cuda_or_skip()
    lhs, table, ids, g = make_ids_case(300, 33, 50, 66, 0.4, heavy=3000)
    a = ids_value_and_grads(CT.chyp_train_distance_ids, lhs, table, ids, g, dev)
    b = ids_value_and_grads(CT.chyp_train_distance_ids, lhs, table, ids, g, dev)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(500, 101, 40943, 0, 0), (30, 100, 20, 2000, 0),
                                  (7, 111, 5000, 0, 9), (1, 1, 1, 0, 0), (10, 10, 100000, 0, 0),
                                  (50, 20, None, 0, 0)])
def test_lists_kernel_equals_plain_on_card(case):
    """K4's index preparation on the card gives the plain version's offsets
    and records bit for bit, on two runs: the training step's ids, heavy
    duplicates, ids outside [0, N) (left out), one pair, more rows than
    pairs, the identity form (N None)."""
    dev = _cuda_or_skip()
    b, k, n, heavy, outside = case
    ids, res = lists_case(b, k, n or b * k, heavy, outside, device=dev)
    flat = None if n is None else ids.reshape(-1)
    CT.reset_launches()
    got = CT.chyp_train_lists(res[0], flat, *res[1:], n or b * k)
    again = CT.chyp_train_lists(res[0], flat, *res[1:], n or b * k)
    torch.cuda.synchronize()
    assert CT.launches["chyp_train_lists"] == 2
    want_off, want_lists = CT.chyp_train_lists_plain(res[0], flat, *res[1:], n or b * k)
    m = int(want_off[-1])
    for off, lists in (got, again):
        assert torch.equal(off, want_off)
        assert torch.equal(lists[:m].view(torch.int32), want_lists[:m].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(500, 100, 66), (37, 7, 18)])
def test_identity_form_equals_ids_form_on_card(shape):
    """The gathered form (the identity form on rhs as a (B K, D) table)
    and the id form with ids = arange give the same bits; both hold
    against the gathered plain version."""
    dev = _cuda_or_skip()
    lhs, rhs, g = make_pair(*shape, 0.4)
    b, k, d = shape
    gathered = value_and_grads(CT.chyp_train_distance, lhs, rhs, g, dev)
    arange = ids_value_and_grads(CT.chyp_train_distance_ids, lhs, rhs.reshape(b * k, d),
                                 np.arange(b * k).reshape(b, k), g, dev)
    for x, y in zip(gathered, arange):
        np.testing.assert_array_equal(x.reshape(y.shape), y)


@pytest.mark.cuda
def test_ids_kernels_read_nothing_outside_the_table():
    """The table is rows 1 .. N of a buffer whose rows 0 and N + 1 are NaN:
    ids in [0, N), the first and the last row among them, give finite
    values and gradients; an id of -1 or N gives a NaN distance, reads no
    row and adds to none."""
    dev = _cuda_or_skip()
    b, k, n, d = 40, 9, 30, 66
    lhs, table, ids, g = make_ids_case(b, k, n, d, 0.05)
    ids[0, :2] = (0, n - 1)
    buf = torch.full((n + 2, d), float("nan"), device=dev)
    buf[1:n + 1] = torch.tensor(table, device=dev)
    t = buf[1:n + 1].requires_grad_()
    l = torch.tensor(lhs, device=dev, requires_grad=True)
    i = torch.tensor(ids, device=dev)
    dist = CT.chyp_train_distance_ids(l, t, i)
    (dist * torch.tensor(g, device=dev)).sum().backward()
    assert bool(torch.isfinite(dist).all() and torch.isfinite(l.grad).all()
                and torch.isfinite(t.grad).all())
    bad = i.clone()
    bad[3, 4], bad[5, 0] = -1, n
    t.grad = None
    dist = CT.chyp_train_distance_ids(l.detach(), t, bad)
    (dist * torch.tensor(g, device=dev)).sum().backward()
    nan = torch.isnan(dist).cpu().numpy()
    assert nan[3, 4] and nan[5, 0] and nan.sum() == 2
    assert bool(torch.isfinite(t.grad).all())


@pytest.mark.cuda
def test_fft_training_scores_take_the_id_form():
    """FFTRotH's loss on the card launches one K3 and one K4 for the (B,
    1 + K) block (no gathered block), and its loss and gradients hold
    against the same model scored through the plain versions."""
    dev = _cuda_or_skip()
    from complexhyperbolickge_torch.models import ModelConfig, get_model
    from complexhyperbolickge_torch.train import losses as TL

    cfg = ModelConfig(n_entities=300, n_relations=6, rank=33, init_size=0.05,
                      bias="learn", multi_c=True, dtype="float32")
    r = np.random.default_rng(3)
    batch = torch.tensor(np.stack([r.integers(0, 300, 64), r.integers(0, 6, 64),
                                   r.integers(0, 300, 64)], 1), device=dev)
    weights = torch.ones(64, device=dev)

    def loss_and_grads(route):
        model = get_model("FFTRotH")(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        gen = torch.Generator(device=dev).manual_seed(1)
        CT.reset_launches()
        real = CT.chyp_train_distance_ids
        if route == "plain":
            CT.chyp_train_distance_ids = CT.chyp_train_distance_ids_plain
        try:
            loss, _ = TL.neg_sampling_loss(model, batch, weights, gen, 300, 20, False, 6)
            loss.backward()
        finally:
            CT.chyp_train_distance_ids = real
        torch.cuda.synchronize()
        return loss.item(), {n: p.grad for n, p in model.named_parameters()}, dict(CT.launches)

    got_loss, got, launched = loss_and_grads("kernel")
    want_loss, want, plain_launched = loss_and_grads("plain")
    assert launched == {"chyp_train_fwd": 1, "chyp_train_bwd": 1, "chyp_train_lists": 1}
    assert plain_launched == {"chyp_train_fwd": 0, "chyp_train_bwd": 0, "chyp_train_lists": 0}
    np.testing.assert_allclose(got_loss, want_loss, **FWD_TOL)
    for name in got:
        np.testing.assert_allclose(got[name].cpu().numpy(), want[name].cpu().numpy(),
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.cuda
def test_dispatcher_routes_train_shape_to_kernel():
    dev = _cuda_or_skip()
    lhs, rhs, g = make_pair(8, 5, 18, 0.2)
    l = torch.tensor(lhs, device=dev)
    r = torch.tensor(rhs, device=dev)
    CT.reset_launches()
    CH.chyp_distance(l[:, None, :], r)
    CH.chyp_distance(l.double()[:, None, :], r.double())  # float64: the core
    CH.chyp_distance(l, r[:, 0])  # not the train shape
    assert CT.launches["chyp_train_fwd"] == 1


@pytest.mark.cuda
def test_backward_is_deterministic_and_checks_inputs():
    dev = _cuda_or_skip()
    lhs, rhs, g = make_pair(50, 20, 66, 0.4)
    a = value_and_grads(CT.chyp_train_distance, lhs, rhs, g, dev)
    b = value_and_grads(CT.chyp_train_distance, lhs, rhs, g, dev)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    l = torch.tensor(lhs, device=dev)
    t = torch.tensor(rhs.reshape(-1, 66), device=dev)
    ids = torch.randint(0, t.shape[0], (50, 20), device=dev)
    with pytest.raises(TypeError, match="dtype"):
        CT.chyp_train_ids_forward(l.double(), t.double(), ids)
    with pytest.raises(TypeError, match="dtype"):
        CT.chyp_train_ids_forward(l, t, ids.int())
    with pytest.raises(ValueError, match="is on"):
        CT.chyp_train_ids_forward(l, t.cpu(), ids)
    with pytest.raises(ValueError, match="D even"):
        CT.chyp_train_ids_forward(l[:, :65].contiguous(), t[:, :65].contiguous(), ids)
    with pytest.raises(ValueError, match="shape"):
        CT.chyp_train_ids_forward(l, t, ids[:, None])
    with pytest.raises(ValueError, match="identity form"):
        CT.chyp_train_ids_forward(l, t[:-1], None)
    with pytest.raises(ValueError, match="no pairs"):
        CT.chyp_train_ids_forward(l, t, ids[:, :0])
    with pytest.raises(ValueError, match="8-byte"):
        CT.chyp_train_ids_forward(l, t.reshape(-1)[1:1 + 999 * 66].reshape(999, 66), ids)
    CT.reset_launches()
    _, res = CT.chyp_train_ids_forward(l, t, ids)
    CT.chyp_train_ids_backward(torch.ones_like(res[0]), l, t, ids, *res)
    assert CT.launches == {"chyp_train_fwd": 1, "chyp_train_bwd": 1, "chyp_train_lists": 1}
    with pytest.raises(TypeError, match="dtype"):
        CT.chyp_train_lists(torch.ones_like(res[0]), ids.reshape(-1).int(), *res, 1000)
