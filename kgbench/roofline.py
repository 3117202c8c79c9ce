"""Frozen work counts and peak rates: the yardstick of every roofline share
and `mfu` metric of the benchmark.

A copy of the counts behind the port's kernel table (chip_smoke.py's
PEAKS, bound_ms and chyp_row_work, and the real-hyperbolic sweep's count),
kept here so that a change to the program cannot move the yardstick.
Each count is the work that the inputs need, whatever implements it: a
ranker's every (query, entity) pair's contraction and epilogue, a training
step's every scored pair forward and backward, and its dense optimizer
update.  Bytes count each input once and each output once.
"""

from __future__ import annotations

# peak rates by card, from NVIDIA's data sheets (dense, no sparsity): fp32
# outside the tensor cores, memory bandwidth, fp64 outside the tensor
# cores, bf16 on the tensor cores
PEAKS = {"H100 PCIe": (51.2e12, 2.0e12, 25.6e12, 756e12),
         "H100 NVL": (60.0e12, 3.9e12, 30.0e12, 835e12),
         "H100": (67.0e12, 3.35e12, 34.0e12, 989e12),
         "H200": (67.0e12, 4.8e12, 34.0e12, 989e12)}

# fp32 operations of one pair's score epilogue after the contraction, as
# the port's kernel table counts them (every +, -, *, /, sqrt, clamp and
# transcendental call as one)
EPILOGUE_OPS = {"poincare": 54, "lorentz": 23, "attrh": 93, "chyp": 16}

# Adam's fp32 operations a parameter (two moment updates, the bias
# corrections, the square root, the division and the step) and its memory
# passes a parameter: read param, grad, exp_avg, exp_avg_sq, write param,
# exp_avg, exp_avg_sq
ADAM_OPS = 13
ADAM_PASSES = 7


def entity_width(family: str, rank: int) -> int:
    """Floats of an entity row: the FFT family stores rank complex bins
    [Re | Im], the real-hyperbolic families rank reals."""
    return 2 * rank if family == "chyp" else rank


def peak_rates(device_name: str):
    """The PEAKS entry of a card named `device_name` (the SXM H100 when the
    name matches no other)."""
    squeezed = device_name.replace(" ", "").lower()
    for key in ("H100 PCIe", "H100 NVL", "H200", "H100"):
        if key.replace(" ", "").lower() in squeezed:
            return PEAKS[key]
    return PEAKS["H100"]


def bound_ms(peaks, nbytes, f32_ops=0, f64_ops=0, tc_ops=0) -> float:
    """The least time (ms) a card of `peaks` takes for a piece of work: the
    largest of its fp32 and fp64 operations over those rates (one term:
    both issue on the SMs' cores), its tensor-core operations over the bf16
    rate, and its bytes over the memory rate."""
    f32_peak, bw_peak, f64_peak, bf16_peak = peaks
    return max((f32_ops / f32_peak + f64_ops / f64_peak) * 1e3,
               tc_ops / bf16_peak * 1e3, nbytes / bw_peak * 1e3)


# ------------------------------- the rankers ---------------------------------


def chyp_sweep_work(b: int, n: int, d: int):
    """(fp32 operations, bytes) of the masked FFT-family sweep (K1) for B
    queries over N entities of D features: per pair the contraction's
    2 (2D) operations (real and imaginary parts) and the epilogue; bytes
    the query rows [lhs; swap(lhs)], zn, t2, the table, wn, bt, the int8
    mask and the counts."""
    pair_ops = 2 * (2 * d) + EPILOGUE_OPS["chyp"]
    vec = 4 * (2 * b * d + 2 * b + 2 * n + n * d)
    return b * n * pair_ops, vec + b * n + 4 * b


def hyp_sweep_work(b: int, n: int, d: int, n_c: int, family: str = "poincare"):
    """(fp32 operations, bytes) of the masked real-hyperbolic sweep (K5)
    for B queries over N entities of D features and n_c curvatures: per
    pair the contraction's 2 D operations and the family's epilogue (its
    radius part counted per pair, whatever the radius table hoists); bytes
    the query rows and x2, c, t2, the table, its norms and biases, the
    radius table (4 floats a (curvature, entity) for Poincare, 2 for
    Lorentz) and cvals, the int8 mask and the counts."""
    pair_ops = 2 * d + EPILOGUE_OPS[family]
    vec = 4 * (b * d + n * d + 3 * b + 2 * n)
    width = 4 if family == "poincare" else 2
    return b * n * pair_ops, vec + b * n + 4 * (n_c * width * n + n_c) + 4 * b


def rank_pass_work(kind: str, n_queries: int, n: int, d: int):
    """(fp32 operations, bytes) of one whole-split pass of `n_queries`
    filtered queries over N entities: every (query, entity) pair scored and
    compared once, the table read once, the queries' rows and the counts
    once.  kind "chyp" (the FFT family: complex contraction) or a real-
    hyperbolic family."""
    if kind == "chyp":
        ops = n_queries * n * (2 * (2 * d) + EPILOGUE_OPS["chyp"])
        nbytes = 4 * (n * d + 2 * n + 2 * n_queries * d + 3 * n_queries)
    else:
        ops = n_queries * n * (2 * d + EPILOGUE_OPS[kind])
        nbytes = 4 * (n * d + 2 * n + n_queries * d + 4 * n_queries)
    return ops, nbytes


# ------------------------------ training steps -------------------------------


def distinct_expected(n_rows: int, n_draws: int) -> float:
    """Expected number of distinct rows among n_draws uniform draws of
    n_rows: the rows a step's candidate block reads."""
    return n_rows * (1.0 - (1.0 - 1.0 / n_rows) ** n_draws)


def chyp_train_fwd_work(b: int, k: int, n: int, d: int):
    """(fp32 operations, fp64 operations, bytes) of the FFT family's train
    distance forward (K3) for B queries and K candidate ids each over an N
    x D table: per pair three fp64 dots of D multiply-adds and ~16 fp32
    epilogue operations; reads the query rows, the ids and each distinct
    row once, writes the distance and its residuals (sr, si, wn, x) and
    zn."""
    tp = b * k
    distinct = distinct_expected(n, tp)
    return 16 * tp, 6 * tp * d, 4 * (b * d + distinct * d + 5 * tp + b) + 8 * tp


def chyp_train_bwd_work(b: int, k: int, n: int, d: int):
    """(fp32 operations, fp64 operations, bytes) of the train distance's
    backward (K4 with its index preparation) for B x K ids over an N x D
    table: per pair ~20 fp32 operations for the coefficients and 5 per
    column for its table term, per column two fp64 multiply-adds for the
    query side and one fp64 add into its row; reads the cotangent, the
    residuals, the query rows, the ids and the distinct rows, writes the
    query gradient and the dense (N, D) table gradient."""
    tp = b * k
    distinct = distinct_expected(n, tp)
    return (20 * tp + 5 * tp * d, 5 * tp * d,
            4 * (5 * tp + b + 2 * b * d + distinct * d + n * d) + 8 * tp)


def adam_work(n_params: int):
    """(fp32 operations, bytes) of one dense Adam update of n_params
    float32 parameters, the gradient written once before it."""
    return ADAM_OPS * n_params, 4 * (ADAM_PASSES + 1) * n_params


def train_step_work(kind: str, b: int, k: int, n: int, d: int, n_params: int,
                    double_neg: bool):
    """(fp32 operations, fp64 operations, bytes) of one training step with
    per-query negatives: the tail block of B x (1 + K) scored pairs and,
    with double_neg, the head block of B x K, each forward and backward,
    then the dense Adam update of every parameter (which writes each
    gradient once).  Per pair, kind "chyp": the operations of K3 and K4
    above; a real-hyperbolic family: the candidate's expmap0 and the
    distance, 8 D + 60 fp32 operations forward and twice that backward.
    Bytes: each block's distinct candidate rows, its query rows and its
    ids once, and the update's passes."""
    blocks = [1 + k] + ([k] if double_neg else [])
    f32 = f64 = nbytes = 0.0
    for kk in blocks:
        tp = b * kk
        if kind == "chyp":
            f32 += (16 + 20 + 5 * d) * tp
            f64 += (6 + 5) * d * tp
        else:
            f32 += 3 * (8 * d + 60) * tp
        nbytes += 4 * (distinct_expected(n, tp) * d + b * d) + 8 * tp
    a_ops, a_bytes = adam_work(n_params)
    return f32 + a_ops, f64, nbytes + a_bytes
