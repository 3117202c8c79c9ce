#!/usr/bin/env python3
"""Device time of the fused rankers (ChypRanker for FFTRotH, HypRanker for
RotH and RotLH, AttRHRanker for AttRH) per batch of 500, on one NVIDIA GPU,
measured two ways on the same calls: as chip_smoke.py's kernels line does
(`cuda_ms`, 4 back-to-back calls behind a sleep on the stream) and as the
busy time of the card's kernels under torch.profiler (`profile_window`, 5
calls).  The models are chip_smoke.py's planted runs at the WN18RR width
(rank 33 FFTRotH, rank 32 for the others; multi_c, bias learn, 40,943
entities), from --seed.

    python3 scripts/torch_ranker_bench.py [--tree DIR] [--seed 0]

--tree runs the port and chip_smoke.py found in DIR (for instance an
unpacked older commit), so two versions can be timed in one run.
Prints one JSON line per model and form, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    sys.path.insert(0, str(Path(a.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_ranker_bench: needs a CUDA card")
    import chip_smoke as S
    from complexhyperbolickge_torch.cli.predict import load_serving_state
    from complexhyperbolickge_torch.kernels.chyp_rank import ChypRanker
    from complexhyperbolickge_torch.kernels.hyp_rank import AttRHRanker, HypRanker

    rankers = {"FFTRotH": ChypRanker, "RotH": HypRanker, "RotLH": HypRanker,
               "AttRH": AttRHRanker}
    for name, cls in rankers.items():
        model, dataset = load_serving_state(S.write_run(a.seed, name)[0], "cuda")
        pack = dataset.eval_pack("test", "rhs")
        q = torch.as_tensor(pack.queries[:S.BATCH], dtype=torch.int64, device="cuda")
        f = torch.as_tensor(pack.filter_idx[:S.BATCH], dtype=torch.int64, device="cuda")
        for masked in (True, False):
            ranker = cls(model, masked=masked)
            queued = S.cuda_ms(lambda: ranker(q, f), reps=4)
            prof = S.profile_window(lambda: [ranker(q, f) for _ in range(5)])
            print(json.dumps({"tree": a.tree, "model": name, "masked": masked,
                              "cuda_ms_4_calls": queued,
                              "device_busy_ms_per_call": prof["device_busy_ms"] / 5,
                              "wall_ms_per_call": prof["wall_ms"] / 5,
                              "kernels_per_call": prof["device_kernels"] / 5}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
