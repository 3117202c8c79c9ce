"""The kernels line's bounds (chip_smoke.py::bound_ms, bf16_row_work): the
least time a card takes for a kernel's work, as the smoke reports it beside
each kernel's time.  Pure arithmetic on shapes; no card, no JAX.

A bf16 instance computes the same function as its exact instance, so its
bound counts the same work: the epilogue's fp32 operations a pair
(EPILOGUE_OPS, the exact rows' epilogue term) beside the contraction on
the tensor cores and the bytes.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402

H100 = S.PEAKS["H100"]
# the WN18RR eval shape of the rankers: B queries, N entities, 22 curvatures
B, N, N_C, L = 500, 40_943, 22, 5
BF16_ROWS = [(f"{k}_bf16", fam) for k in S.HYP_RANK_KERNELS for fam in ("poincare", "lorentz")]
BF16_ROWS += [(f"{k}_bf16", "attrh") for k in S.ATTRH_KERNELS]
BF16_ROWS += [(f"{k}_bf16", "chyp") for k in S.RANK_KERNELS]


def _work(kname, family, kept=2_000):
    d = 66 if family == "chyp" else 32
    width = {"poincare": 4, "lorentz": 2, "attrh": 2}.get(family, 0)
    return S.bf16_row_work(kname, family, B, N, d, kept=kept, n_rows=kept, l=L,
                           n_c=0 if family == "chyp" else N_C, table_width=width)


def test_k7_bf16_bound_at_wn18rr():
    """K7 bf16 at B 500, N 40,943, D 32: the epilogue's 93 fp32 operations
    a pair over 67 TFLOP/s, 0.0284 ms, above both the tensor-core term
    (1.3 us) and the bytes (the int8 mask and the radius table, 9.2 us)."""
    tc, f32, nbytes = _work("attrh_rank_sweep_masked_bf16", "attrh")
    assert tc == 2 * B * N * 32 and f32 == B * N * 93
    ms, by, term = S.bound_ms(H100, nbytes, f32, tc_ops=tc)
    assert ms == pytest.approx(0.0284, rel=0.01)
    assert (by, term) == ("operations", "cores")
    assert nbytes / H100[1] * 1e3 == pytest.approx(0.0092, rel=0.01)


@pytest.mark.parametrize("kname,family,want_ms,want_term", [
    ("hyp_rank_sweep_masked_bf16", "poincare", 0.0165, "cores"),
    ("hyp_rank_sweep_nomask_bf16", "poincare", 0.0165, "cores"),
    ("hyp_rank_sweep_masked_bf16", "lorentz", 0.0092, "bytes"),
    ("hyp_rank_sweep_nomask_bf16", "lorentz", 0.0070, "cores")])
def test_k5_k6_bf16_bounds_at_wn18rr(kname, family, want_ms, want_term):
    """K5 / K6 bf16's sweeps at B 500, N 40,943, D 32: Poincare's 54 fp32
    epilogue operations a pair over 67 TFLOP/s, 0.0165 ms; Lorentz's 23,
    0.0070 ms, below the masked sweep's bytes (the int8 mask and the
    float2 radius table, 0.0092 ms)."""
    tc, f32, nbytes = _work(kname, family)
    assert tc == 2 * B * N * 32 and f32 == B * N * S.EPILOGUE_OPS[family]
    ms, _, term = S.bound_ms(H100, nbytes, f32, tc_ops=tc)
    assert ms == pytest.approx(want_ms, rel=0.02)
    assert term == want_term


@pytest.mark.parametrize("kname,family", BF16_ROWS)
def test_bf16_bound_not_below_exact_epilogue(kname, family):
    """No bf16 row's bound lies below its exact row's epilogue term (the
    same pairs' EPILOGUE_OPS over the fp32 rate), which every family's
    rows count (the FFT family's chyp_score: 16 operations a pair)."""
    kept = 2_000
    tc, f32, nbytes = _work(kname, family, kept)
    ms, by, term = S.bound_ms(H100, nbytes, f32, tc_ops=tc)
    pairs = B * N if "_sweep_" in kname else kept
    epilogue = pairs * S.EPILOGUE_OPS[family] / H100[0] * 1e3
    assert epilogue > 0 and f32 == pairs * S.EPILOGUE_OPS[family]
    assert ms >= epilogue
    assert by in ("operations", "bytes") and term in ("cores", "tensor_cores", "bytes")


@pytest.mark.parametrize("kname,want_ms,want_term", [
    ("chyp_rank_sweep_masked", 0.0855, "cores"),
    ("chyp_rank_sweep_nomask", 0.0855, "cores"),
    ("chyp_rank_sweep_masked_bf16", 0.0079, "bytes"),
    ("chyp_rank_sweep_nomask_bf16", 0.0055, "tensor_cores")])
def test_k1_k2_bounds_at_wn18rr(kname, want_ms, want_term):
    """K1 / K2's sweeps at B 500, N 40,943, D 66: exact, per pair the
    contraction's 2 (2 D) fp32 operations and chyp_score's 16 over 67
    TFLOP/s, 0.0855 ms (the contraction alone: 0.0807); bf16, the masked
    sweep's bytes (the int8 mask, 0.0079 ms) and the maskless sweep's
    2 (2B) N D tensor-core operations (0.0055) stay above the epilogue's
    fp32 term (0.0049)."""
    if kname.endswith("_bf16"):
        tc, f32, nbytes = _work(kname, "chyp")
        assert f32 == B * N * 16
    else:
        tc, (f32, nbytes) = 0, S.chyp_row_work(kname, B, N, 66)
        assert f32 == B * N * (4 * 66 + 16)
    ms, _, term = S.bound_ms(H100, nbytes, f32, tc_ops=tc)
    assert ms == pytest.approx(want_ms, rel=0.02)
    assert term == want_term
    assert f32 / H100[0] * 1e3 == pytest.approx(0.0049 if tc else 0.0855, rel=0.02)


def test_bound_ms_picks_the_largest_term():
    f32_peak, bw_peak, f64_peak, bf16_peak = H100
    assert S.bound_ms(H100, bw_peak * 1e-3) == (1.0, "bytes", "bytes")
    ms, by, term = S.bound_ms(H100, 0, f32_ops=f32_peak * 1e-3, f64_ops=f64_peak * 1e-3)
    assert (ms, by, term) == (pytest.approx(2.0), "operations", "cores")
    ms, by, term = S.bound_ms(H100, 10.0, f32_ops=1.0, tc_ops=bf16_peak * 3e-3)
    assert (ms, by, term) == (pytest.approx(3.0), "operations", "tensor_cores")


@pytest.mark.parametrize("kname, want_ms, want_term", [
    ("fftroth_queries_fwd", 0.000285, "cores"),
    ("fftroth_queries_bwd", 0.00387, "bytes"),
])
def test_fused_chain_bounds_at_wn18rr(kname, want_ms, want_term):
    """FFTRotH's fused query chain for B 500 queries over the WN18RR tables
    (N 40,943, D 66, 22 relations): the forward is its two fp64 DFTs a row
    (0.28 us on the cores); the backward is the dense (N, D + 1) gradients
    it writes (~11 MB, 3.9 us)."""
    f32, f64, nbytes = S.chain_work(kname, B, N, 66, 22)
    ms, _, term = S.bound_ms(H100, nbytes, f32, f64)
    assert term == want_term
    assert ms == pytest.approx(want_ms, rel=0.01)
