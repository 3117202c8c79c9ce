"""The frozen work counts are pinned to the kernel table's bounds at the
cells' shapes, to the table's last digit (PERF.md, the port's kernel
table): K1 0.0855 ms, K5 0.0361, K3 0.0028, K4 0.0060 on the SXM H100's
peaks."""

import pytest

from kgbench import roofline as R

PEAKS = R.peak_rates("NVIDIA H100 80GB HBM3")
N = 40943


def test_k1_bound():
    ops, nbytes = R.chyp_sweep_work(500, N, 66)
    assert R.bound_ms(PEAKS, nbytes, ops) == pytest.approx(0.0855, abs=1e-4)


def test_k5_bound():
    ops, nbytes = R.hyp_sweep_work(500, N, 32, 22)
    assert R.bound_ms(PEAKS, nbytes, ops) == pytest.approx(0.0361, abs=1e-4)


@pytest.mark.parametrize("work, want", [(R.chyp_train_fwd_work, 0.0028),
                                        (R.chyp_train_bwd_work, 0.0060)])
def test_k3_k4_bounds(work, want):
    f32, f64, nbytes = work(500, 101, N, 66)
    assert R.bound_ms(PEAKS, nbytes, f32, f64) == pytest.approx(want, abs=1e-4)


def test_step_and_pass_counts():
    n_fft = N * 66 + 2 * N + 22 * 128 + 22 * 64 + 22
    f32, f64, nbytes = R.train_step_work("chyp", 500, 100, N, 66, n_fft, True)
    # bytes bound it: Adam's passes and the gradients' writes dominate
    assert R.bound_ms(PEAKS, nbytes, f32, f64) == pytest.approx(nbytes / 3.35e9)
    assert nbytes > 32 * n_fft
    ops, nbytes = R.rank_pass_work("chyp", 6268, N, 66)
    assert ops == 6268 * N * (4 * 66 + 16)
    assert R.bound_ms(PEAKS, nbytes, ops) == pytest.approx(1.0725, abs=1e-3)


def test_peaks_by_name():
    assert R.peak_rates("NVIDIA H100 PCIe") == R.PEAKS["H100 PCIe"]
    assert R.peak_rates("NVIDIA H100 80GB HBM3") == R.PEAKS["H100"]
