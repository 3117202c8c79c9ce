"""The proofs of the bf16 sweeps' epilogue (kernels/hyp_rank.py:
hyp_scores_bf16, attrh_scores_bf16, fast_arith_sweep; kernels/chyp_rank.py:
chyp_scores_bf16) prove the card's kernels and have no plain version: a
CPU tensor or device raises.  Their card runs are in
tests/test_torch_kernels_cuda.py and in chip_smoke.py's bf16-bits phase;
the counts of K1/K2 and K5-K8 at precision "default" against JAX in
tests/test_torch_eval_precision.py."""

import pytest
import torch

from complexhyperbolickge_torch.kernels import chyp_rank as K
from complexhyperbolickge_torch.kernels import hyp_rank as H

B, NP, D, F32 = 4, 128, 32, torch.float32


def _scores_on_cpu():
    v = torch.zeros(B, dtype=F32)
    t = torch.zeros(NP, dtype=F32)
    return H.attrh_scores_bf16(torch.zeros((B, D), dtype=torch.bfloat16), v, v,
                               torch.zeros(B, dtype=torch.int32), torch.ones(1, dtype=F32), v, v,
                               torch.zeros((NP, D), dtype=torch.bfloat16), t, t, t,
                               torch.zeros((1, NP, 2), dtype=F32))


def _hyp_scores_on_cpu(family):
    t = torch.zeros(NP, dtype=F32)
    return H.hyp_scores_bf16(torch.zeros((B, D), dtype=torch.bfloat16), torch.zeros(B, dtype=F32),
                             torch.zeros(B, dtype=torch.int32), torch.ones(1, dtype=F32),
                             torch.zeros((NP, D), dtype=torch.bfloat16), t, t,
                             torch.zeros((1, NP, H.RADII_WIDTH[family]), dtype=F32),
                             family=family)


def _chyp_scores_on_cpu():
    v, t = torch.full((B,), -0.5, dtype=F32), torch.full((NP,), -0.5, dtype=F32)
    return K.chyp_scores_bf16(torch.zeros((2 * B, 80), dtype=torch.bfloat16), v,
                              torch.zeros((NP, 80), dtype=torch.bfloat16), t, t)


@pytest.mark.parametrize("proof", [lambda: H.fast_arith_sweep("cpu"), _scores_on_cpu,
                                   lambda: _hyp_scores_on_cpu("poincare"),
                                   lambda: _hyp_scores_on_cpu("lorentz"), _chyp_scores_on_cpu],
                         ids=["fast_arith_sweep", "attrh_scores_bf16", "hyp_scores_bf16-poincare",
                              "hyp_scores_bf16-lorentz", "chyp_scores_bf16"])
def test_proofs_need_the_card(proof):
    with pytest.raises(ValueError, match="card"):
        proof()
