"""The proofs of AttRH's bf16 epilogue (kernels/hyp_rank.py:
attrh_scores_bf16, fast_arith_sweep) prove the card's kernels and have no
plain version: a CPU tensor or device raises.  Their card runs are in
tests/test_torch_kernels_cuda.py and in chip_smoke.py's bf16-bits phase;
the counts of K7/K8 at precision "default" against JAX in
tests/test_torch_eval_precision.py."""

import pytest
import torch

from complexhyperbolickge_torch.kernels import hyp_rank as H


def _scores_on_cpu():
    b, np_, d, f32 = 4, 128, 32, torch.float32
    v = torch.zeros(b, dtype=f32)
    t = torch.zeros(np_, dtype=f32)
    return H.attrh_scores_bf16(torch.zeros((b, d), dtype=torch.bfloat16), v, v,
                               torch.zeros(b, dtype=torch.int32), torch.ones(1, dtype=f32), v, v,
                               torch.zeros((np_, d), dtype=torch.bfloat16), t, t, t,
                               torch.zeros((1, np_, 2), dtype=f32))


@pytest.mark.parametrize("proof", [lambda: H.fast_arith_sweep("cpu"), _scores_on_cpu],
                         ids=["fast_arith_sweep", "attrh_scores_bf16"])
def test_proofs_need_the_card(proof):
    with pytest.raises(ValueError, match="card"):
        proof()
