"""Fused filtered ranking for the complex-hyperbolic (FFT) family.

Port of complexhyperbolickge_tpu/kernels/chyp_rank.py.  Filtered ranking
scores every query against ALL entities; materialized, that is a (B, N)
score matrix written and re-read per batch (82 MB at WN18RR, B = 500).  The
CUDA kernels in csrc/chyp_rank.cu fuse, per entity tile,

    Hermitian form -> cross-ratio x -> acosh -> score = bt - dist^2
    -> count of {score >= t2} over the kept entities

so the only outputs are (B,) int32 counts.  Three kernels, one wrapper each:

  * chyp_rank_counts        (K1, TPU chyp_rank_counts): masked sweep; an
    int8 (B, Np) mask marks filtered entities and pad rows.
  * chyp_rank_sweep_nomask  (K2, TPU chyp_rank_counts_nomask's kernel):
    counts every row except the gold, with no mask.
  * chyp_rank_filtered_sub  (K2's subtraction): re-scores each query's
    filtered ids with the same arithmetic, for subtraction.

Inputs, all float32 and contiguous: lhs2 (2B, D) = [lhs; swap_neg(lhs)],
zn (B,) the clamped Hermitian norm of lhs, t2 (B,) the gold-target score
minus the lhs bias, rhs (Np, ld) the entity table with >= 1 zero pad row
and rows of ld >= D floats, of which the first D are the features, wn (Np,)
= clamp(|w|^2 - 1, -1, -eps), bt (Np,) tail biases with -1e30 on pad rows.
ChypRanker pads the table's rows to a multiple of 4 floats (68 at rank 33:
D = 66), which the sweeps copy into shared memory 16 bytes at a time; the
query rows stay at D.  The sweeps take wn and bt on a 16-byte boundary.

Each wrapper launches its kernel for CUDA tensors and counts the launch in
`launches`; for CPU tensors it runs the plain PyTorch version beside it,
which repeats the arithmetic with a matmul over the table's first D columns
(a different summation order, so counts may differ on scores within float
rounding of t2).

precision="default" (--eval_precision default, kernels/_ranker.py) takes
each kernel's bf16 tensor-core instance (launch counters `<name>_bf16`):
lhs2 (2B, Dp) and rhs (Np, Dp) bfloat16 with Dp a multiple of 16, zero
past D (bf16_rows); zn, t2, wn and bt stay float32, from the unrounded
rows.  Its plain versions also take float32 operands and round them.
Its sweep scores pairs in a branch-free batched epilogue whose bits equal
the exact arithmetic's (csrc/chyp_rank.cu, bf16 namespace);
chyp_scores_bf16 proves that on the card and is not a path kernel.
"""

from __future__ import annotations

import torch

from complexhyperbolickge_torch.kernels._build import check_aligned
from complexhyperbolickge_torch.kernels._build import check_tensor as _check
from complexhyperbolickge_torch.kernels._build import kernel_info, launch
from complexhyperbolickge_torch.kernels._ranker import (
    BF16_K,
    ROW_TILE,
    FusedRanker,
    plain_mm,
    plain_rows,
)
from complexhyperbolickge_torch.ops.chyperbolic import chyp_distance, swap_neg
from complexhyperbolickge_torch.ops.math import ball_eps, check_precision, round_up

KERNELS = ("chyp_rank_sweep_masked", "chyp_rank_sweep_nomask", "chyp_rank_filtered_sub")
# launches of each CUDA kernel since the last reset_launches(): the exact
# instances and the bf16 ones (precision "default")
launches = {**{k + sfx: 0 for sfx in ("", "_bf16") for k in KERNELS},
            # the proof of the bf16 sweep's epilogue (chyp_scores_bf16)
            "chyp_rank_scores_bf16": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


_EPS = ball_eps(torch.float32)
# lower clamp of the cross-ratio, passed to the kernels as one f32 value so
# kernel and plain versions round it identically
X_MIN = 1.0 + _EPS


# ------------------------------ plain versions --------------------------------


def _score_epilogue(acc_re, acc_im, zn, wn, bt):
    sr = acc_re - 1.0
    x = 2.0 * (sr * sr + acc_im * acc_im) / (zn * wn) - 1.0
    x = torch.clamp_min(x, X_MIN)
    d = torch.log(x + torch.sqrt(x * x - 1.0))
    return bt - d * d


def _features(rhs, d):
    """The table's first d columns, contiguous (the table itself when its
    rows are d wide), so a padded table contracts as the unpadded one."""
    return rhs if rhs.shape[1] == d else rhs[:, :d].contiguous()


def chyp_contract_plain(lhs2, rhs, precision: str = "highest"):
    """The Hermitian form's contraction (2B, Np): lhs2 against the table's
    first lhs2.shape[1] features (kernels/_ranker.py::plain_mm)."""
    return plain_mm(lhs2, _features(rhs, lhs2.shape[1]), precision)


def chyp_scores_plain(lhs2, zn, rhs, wn, bt, precision: str = "highest"):
    """All-entity scores (B, Np) in plain PyTorch: bt - dist^2."""
    b = lhs2.shape[0] // 2
    acc = chyp_contract_plain(lhs2, rhs, precision)
    return _score_epilogue(acc[:b], acc[b:], zn[:, None], wn[None, :], bt[None, :])


def chyp_rank_counts_plain(lhs2, zn, t2, rhs, wn, bt, mask, precision: str = "highest"):
    scores = chyp_scores_plain(lhs2, zn, rhs, wn, bt, precision)
    return ((scores >= t2[:, None]) & (mask == 0)).sum(1, dtype=torch.int32)


def chyp_rank_sweep_nomask_plain(lhs2, zn, t2, rhs, wn, bt, gold, precision: str = "highest"):
    scores = chyp_scores_plain(lhs2, zn, rhs, wn, bt, precision)
    cols = torch.arange(rhs.shape[0], device=rhs.device)
    keep = cols[None, :] != gold[:, None]
    return ((scores >= t2[:, None]) & keep).sum(1, dtype=torch.int32)


def chyp_rank_filtered_sub_plain(lhs2, zn, t2, rhs, wn, bt, fidx, gold,
                                 precision: str = "highest"):
    b = lhs2.shape[0] // 2
    np_ = rhs.shape[0]
    ok = (fidx >= 0) & (fidx < np_) & (fidx != gold[:, None])
    f = fidx.long().clamp(0, np_ - 1)
    rows = _features(rhs, lhs2.shape[1])[f]  # (B, L, D)
    acc_re = plain_rows(lhs2[:b], rows, precision)
    acc_im = plain_rows(lhs2[b:], rows, precision)
    scores = _score_epilogue(acc_re, acc_im, zn[:, None], wn[f], bt[f])
    return (ok & (scores >= t2[:, None])).sum(1, dtype=torch.int32)


# --------------------------------- wrappers -----------------------------------


def _check_common(lhs2, zn, t2, rhs, wn, bt, precision):
    """Validate the shared inputs of a CUDA launch; returns (B, Np, D, ld).
    precision "default": lhs2 and rhs bfloat16 of one width D, a multiple
    of 16 (ld = D)."""
    dev = lhs2.device
    if dev.type != "cuda":
        raise ValueError(f"chyp_rank kernels take CPU or CUDA tensors, got {dev}")
    if lhs2.dim() != 2 or lhs2.shape[0] % 2 or rhs.dim() != 2:
        raise ValueError("lhs2 must be (2B, D) and rhs (Np, ld)")
    b, d = lhs2.shape[0] // 2, lhs2.shape[1]
    np_, ld = rhs.shape
    f32, op = torch.float32, torch.float32
    if check_precision(precision) == "default":
        op = torch.bfloat16
        if ld != d or d % BF16_K:
            raise ValueError(f"the bf16 kernels take lhs2 and rhs of one width, a multiple "
                             f"of {BF16_K} (bf16_rows), got {d} and {ld}")
        check_aligned(lhs2=lhs2, rhs=rhs)
    if ld < d:
        raise ValueError(f"rhs rows hold {ld} floats, fewer than the {d} features")
    _check("lhs2", lhs2, op, (2 * b, d), dev)
    _check("zn", zn, f32, (b,), dev)
    _check("t2", t2, f32, (b,), dev)
    _check("rhs", rhs, op, (np_, ld), dev)
    _check("wn", wn, f32, (np_,), dev)
    _check("bt", bt, f32, (np_,), dev)
    return b, np_, d, ld


def _launch(name, precision, device, *args):
    """Launch `name`'s instance for `precision` (both take the same
    arguments)."""
    if precision == "default":
        name += "_bf16"
    launch("chyp_rank", name, device, *args)
    launches[name] += 1


def chyp_rank_counts(lhs2, zn, t2, rhs, wn, bt, mask, precision: str = "highest"):
    """K1: #{j : mask[b, j] == 0 and score(b, j) >= t2[b]} per query, int32
    (B,).  mask is int8 (B, Np), 1 = filtered out (and on pad rows)."""
    if lhs2.device.type == "cpu":
        return chyp_rank_counts_plain(lhs2, zn, t2, rhs, wn, bt, mask, precision)
    b, np_, d, ld = _check_common(lhs2, zn, t2, rhs, wn, bt, precision)
    _check("mask", mask, torch.int8, (b, np_), lhs2.device)
    check_aligned(wn=wn, bt=bt)
    counts = torch.zeros(b, dtype=torch.int32, device=lhs2.device)
    _launch("chyp_rank_sweep_masked", precision, lhs2.device, lhs2, zn, t2, rhs, wn, bt,
            mask, counts, b, np_, d, ld, X_MIN)
    return counts


def chyp_rank_sweep_nomask(lhs2, zn, t2, rhs, wn, bt, gold, precision: str = "highest"):
    """K2 sweep: #{j != gold[b] : score(b, j) >= t2[b]} per query, int32
    (B,).  gold is int32 (B,), a row of this table or -1."""
    if lhs2.device.type == "cpu":
        return chyp_rank_sweep_nomask_plain(lhs2, zn, t2, rhs, wn, bt, gold, precision)
    b, np_, d, ld = _check_common(lhs2, zn, t2, rhs, wn, bt, precision)
    _check("gold", gold, torch.int32, (b,), lhs2.device)
    check_aligned(wn=wn, bt=bt)
    counts = torch.zeros(b, dtype=torch.int32, device=lhs2.device)
    _launch("chyp_rank_sweep_nomask", precision, lhs2.device, lhs2, zn, t2, rhs, wn, bt,
            gold, counts, b, np_, d, ld, X_MIN)
    return counts


def chyp_rank_filtered_sub(lhs2, zn, t2, rhs, wn, bt, fidx, gold, precision: str = "highest"):
    """K2 subtraction: #{l : fidx[b, l] in [0, Np), != gold[b], score >=
    t2[b]} per query, int32 (B,).  fidx is int32 (B, L), rows deduplicated
    (data/dataset.py::eval_pack)."""
    if lhs2.device.type == "cpu":
        return chyp_rank_filtered_sub_plain(lhs2, zn, t2, rhs, wn, bt, fidx, gold, precision)
    b, np_, d, ld = _check_common(lhs2, zn, t2, rhs, wn, bt, precision)
    if fidx.dim() != 2:
        raise ValueError("fidx must be (B, L)")
    _check("fidx", fidx, torch.int32, (b, fidx.shape[1]), lhs2.device)
    _check("gold", gold, torch.int32, (b,), lhs2.device)
    sub = torch.empty(b, dtype=torch.int32, device=lhs2.device)
    _launch("chyp_rank_filtered_sub", precision, lhs2.device, lhs2, zn, t2, rhs, wn, bt,
            fidx, gold, sub, b, np_, d, ld, fidx.shape[1], X_MIN)
    return sub


def sweep_info(device, d: int, masked: bool = True, precision: str = "highest") -> dict:
    """Registers and local (spill) bytes a thread, resident blocks per SM
    and shared bytes a block of the masked or maskless sweep (its bf16
    instance for precision "default", d then the padded width) at feature
    width d on `device`, as the CUDA runtime reports them."""
    fn = "chyp_rank_sweep_bf16_info" if precision == "default" else "chyp_rank_sweep_info"
    vals = kernel_info("chyp_rank", fn, device, int(masked), d)
    return dict(zip(("regs_per_thread", "local_bytes", "blocks_per_sm", "smem_bytes"), vals))


def chyp_scores_bf16(lhs2, zn, rhs, wn, bt, ieee: bool = False):
    """Every pair's score, float32 (B, Np), from K1/K2's bf16 sweep (inputs
    as chyp_rank_sweep_nomask takes them at precision "default", without t2
    and gold): through its batched epilogue, or (ieee) through chyp_score()'s
    __fdiv_rn / __fsqrt_rn / logf on the same score tile; and the pairs of
    the batch (queries < B, rows < Np) whose FastArith range flag sent them
    through chyp_score() again (0 for ieee).  The two give the same scores
    bit for bit.  A proof of the card's kernel: a CPU tensor raises."""
    if lhs2.device.type != "cuda":
        raise ValueError(f"chyp_scores_bf16 proves the card's kernel, got {lhs2.device}")
    b, np_, d, ld = _check_common(lhs2, zn, zn, rhs, wn, bt, "default")
    check_aligned(wn=wn, bt=bt)
    scores = torch.empty((b, np_), dtype=torch.float32, device=lhs2.device)
    flagged = torch.zeros(1, dtype=torch.int32, device=lhs2.device)
    launch("chyp_rank", "chyp_rank_scores_bf16", lhs2.device, lhs2, zn, rhs, wn, bt, scores,
           flagged, b, np_, d, ld, X_MIN, int(ieee))
    launches["chyp_rank_scores_bf16"] += 1
    return scores, int(flagged.item())


def chyp_rank_counts_nomask(lhs2, zn, t2, rhs, wn, bt, fidx, gold, precision: str = "highest"):
    """K2: #{non-filtered, non-gold j : score >= t2} without a (B, Np) mask:
    the sweep counts every non-gold row and the filtered ids it counted are
    subtracted.  Both kernels share one score routine (in the bf16
    instances: one mma chain per pair, tile against tile), so a filtered id
    is subtracted exactly when the sweep counted it."""
    return (chyp_rank_sweep_nomask(lhs2, zn, t2, rhs, wn, bt, gold, precision)
            - chyp_rank_filtered_sub(lhs2, zn, t2, rhs, wn, bt, fidx, gold, precision))


# ---------------------------------- ranker ------------------------------------


class ChypRanker(FusedRanker):
    """Filtered ranker for FFTUnitBall-family models; the counterpart of the
    JAX PallasChypRanker (interface: kernels/_ranker.py).  masked=True
    streams an int8 (B, Np) mask through K1; masked=False runs K2 (sweep +
    filtered subtraction) with no mask."""

    TABLES = ("rhs", "bt", "wn")
    QUERIES = ("lhs2", "zn", "t2")

    def __init__(self, model, masked: bool = True, precision: str = "highest"):
        from complexhyperbolickge_torch.models.chyperbolic import FFTUnitBall

        if not isinstance(model, FFTUnitBall):
            raise TypeError("ChypRanker ranks FFTUnitBall-family models only, "
                            f"got {type(model).__name__}")
        super().__init__(model, masked, precision)

    def _prepare_tables(self):
        ent = self.model.entity.detach().to(torch.float32)
        n, d = ent.shape
        # n + 1: at least one pad row, where the masked form's filter ids
        # outside the held rows land (FusedRanker._filter); bt = -1e30 on
        # every pad row keeps them below the thresholds in K2
        np_ = round_up(n + 1, ROW_TILE)
        rows = torch.zeros((np_, d), dtype=torch.float32, device=ent.device)
        rows[:n] = ent
        # wn from the unpadded rows, so its bits do not depend on the stride
        wn = (torch.sum(rows * rows, dim=-1) - 1.0).clamp(-1.0, -_EPS)
        # rows padded with zeros to a multiple of 4 floats: 16-byte copies
        rhs = torch.nn.functional.pad(rows, (0, round_up(d, 4) - d))
        return rhs, self._padded_bias(np_, ent.device), wn

    def _queries_core(self, q, tables):
        """(lhs2, zn, t2) of a batch: query embeddings, their clamped norm,
        and the gold-target threshold with the lhs bias folded out."""
        m = self.model
        (lhs,), _ = m.get_queries(q[:, :2])
        lhs = lhs.to(torch.float32)
        lhs2 = torch.cat([lhs, swap_neg(lhs)], dim=0).contiguous()
        zn = (torch.sum(lhs * lhs, dim=-1) - 1.0).clamp(-1.0, -_EPS)
        gold = q[:, 2]
        d_gold = chyp_distance(lhs, m.entity[gold].to(torch.float32))
        return lhs2, zn, self._gold_threshold(-(d_gold**2), gold)

    def _counts(self, x, masked):
        base = (x["lhs2"], x["zn"], x["t2"], x["rhs"], x["wn"], x["bt"])
        if masked:
            return chyp_rank_counts(*base, x["mask"], precision=self.precision)
        return chyp_rank_counts_nomask(*base, x["fidx"], x["gold"], precision=self.precision)
