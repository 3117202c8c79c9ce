"""The port's leg of the MRR-gate rehearsal (scripts/torch_rehearsal_leg.py)
on the CPU in float64: the noisy generated KG at data seed 7, FFTRotH under
the gate's protocol, held to the gate's band around the JAX leg's recorded
MRR on the same data (0.6108, tests/test_mrr_gate_rehearsal.py).

Opt-in like the rehearsal itself (~30 min of CPU):

    RUN_REHEARSAL=1 python -m pytest tests/test_torch_rehearsal.py -v -s
"""

import importlib.util
import os
from pathlib import Path

import pytest

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(os.environ.get("RUN_REHEARSAL", "0") != "1",
                       reason="the rehearsal leg is opt-in (RUN_REHEARSAL=1): ~30 min of CPU"),
]

JAX_LEG_MRR = 0.6108  # data seed 7, noisy, training seed 0
BAND = 0.005  # the gate's +-0.5 pt


def test_port_leg_lands_in_the_gate_band():
    path = Path(__file__).resolve().parents[1] / "scripts" / "torch_rehearsal_leg.py"
    spec = importlib.util.spec_from_file_location("_torch_rehearsal_leg", path)
    leg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(leg)
    mrr = leg.main(["--seed", "7", "--noisy", "--device", "cpu"])
    assert abs(mrr - JAX_LEG_MRR) <= BAND, mrr
