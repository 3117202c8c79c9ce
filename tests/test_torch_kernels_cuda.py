"""The chyp_rank CUDA kernels against their plain PyTorch versions.

Needs a CUDA card, the CUDA toolkit and no JAX; on a machine without a card
every test skips (they carry the `cuda` marker).  On one with a card:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerance: kernel and plain version sum the Hermitian form in different
orders, so a query's count may differ by at most the number of entities
whose plain score lies within 1e-5 * (1 + |t2|) of its threshold t2.
Between the kernels the scores are bit-identical, so the maskless count
(sweep - subtraction) equals the masked count exactly.
"""

import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.kernels import chyp_rank as K

pytestmark = pytest.mark.cuda

# (B, N, D, L): the ragged edges of every tile shape — queries not a
# multiple of 32, entities not of 128, features below / across / above one
# 32-wide chunk
SHAPES = [(48, 300, 18, 6), (37, 1000, 66, 9), (5, 129, 70, 3), (500, 4000, 66, 12)]


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda")


def make_inputs(b, n, d, l, seed=0):
    """Ranking inputs on the CPU: thresholds at each query's gold score,
    filter rows holding the gold once, pad = n."""
    rng = np.random.default_rng(seed)
    np_ = -(-(n + 1) // 128) * 128
    lhs = torch.as_tensor(rng.normal(0, 0.15, (b, d)), dtype=torch.float32)
    r = d // 2
    lhs2 = torch.cat([lhs, torch.cat([lhs[:, r:], -lhs[:, :r]], 1)]).contiguous()
    rhs = torch.zeros((np_, d), dtype=torch.float32)
    rhs[:n] = torch.as_tensor(rng.normal(0, 0.15, (n, d)), dtype=torch.float32)
    bt = torch.full((np_,), -1e30, dtype=torch.float32)
    bt[:n] = torch.as_tensor(rng.normal(0, 0.3, n), dtype=torch.float32)
    eps = 4e-3
    zn = (torch.sum(lhs * lhs, -1) - 1.0).clamp(-1.0, -eps)
    wn = (torch.sum(rhs * rhs, -1) - 1.0).clamp(-1.0, -eps)
    gold = rng.integers(0, n, b)
    fidx = np.full((b, l), n, np.int32)
    for i in range(b):
        others = rng.choice(np.setdiff1d(np.arange(n), [gold[i]]), rng.integers(0, l), False)
        fidx[i, :len(others)] = others
        fidx[i, len(others)] = gold[i]
    scores = K.chyp_scores_plain(lhs2, zn, rhs, wn, bt)
    t2 = scores[torch.arange(b), torch.as_tensor(gold)].contiguous()
    mask = torch.zeros((b, np_), dtype=torch.int8)
    mask[:, n:] = 1
    mask.scatter_(1, torch.as_tensor(fidx, dtype=torch.int64), 1)
    near = ((scores - t2[:, None]).abs() <= (1e-5 * (1 + t2.abs()))[:, None]).sum(1)
    return dict(lhs2=lhs2, zn=zn, t2=t2, rhs=rhs, wn=wn, bt=bt, mask=mask,
                gold=torch.as_tensor(gold, dtype=torch.int32),
                fidx=torch.as_tensor(fidx)), near


BASE = ("lhs2", "zn", "t2", "rhs", "wn", "bt")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kernel", ["masked", "nomask", "filtered_sub"])
def test_kernel_matches_plain(kernel, shape):
    dev = _cuda_or_skip()
    t, near = make_inputs(*shape)
    c = {k: v.to(dev) for k, v in t.items()}
    fn, plain, extra = {
        "masked": (K.chyp_rank_counts, K.chyp_rank_counts_plain, ("mask",)),
        "nomask": (K.chyp_rank_sweep_nomask, K.chyp_rank_sweep_nomask_plain, ("gold",)),
        "filtered_sub": (K.chyp_rank_filtered_sub, K.chyp_rank_filtered_sub_plain,
                         ("fidx", "gold")),
    }[kernel]
    got = fn(*[c[k] for k in BASE + extra])
    torch.cuda.synchronize()
    want = plain(*[t[k] for k in BASE + extra])
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert ((got.cpu() - want).abs() <= near).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_maskless_equals_masked_exactly(shape):
    dev = _cuda_or_skip()
    t, _ = make_inputs(*shape)
    c = {k: v.to(dev) for k, v in t.items()}
    masked = K.chyp_rank_counts(*[c[k] for k in BASE], c["mask"])
    nomask = K.chyp_rank_counts_nomask(*[c[k] for k in BASE], c["fidx"], c["gold"])
    assert torch.equal(masked, nomask)


def test_wrappers_check_inputs_and_count_launches():
    dev = _cuda_or_skip()
    t, _ = make_inputs(*SHAPES[0])
    c = {k: v.to(dev) for k, v in t.items()}
    K.reset_launches()
    K.chyp_rank_counts(*[c[k] for k in BASE], c["mask"])
    assert K.launches["chyp_rank_sweep_masked"] == 1
    with pytest.raises(TypeError, match="dtype"):
        K.chyp_rank_counts(*[c[k] for k in BASE], c["mask"].to(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        K.chyp_rank_counts(c["lhs2"], c["zn"], c["t2"], c["rhs"].T.contiguous().T,
                           c["wn"], c["bt"], c["mask"])
    with pytest.raises(ValueError, match="is on"):
        K.chyp_rank_counts(*[c[k] for k in BASE], t["mask"])
    assert K.launches["chyp_rank_sweep_masked"] == 1
