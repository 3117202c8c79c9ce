#!/usr/bin/env python3
"""Where the time of subgraph-mode training goes on one NVIDIA GPU, at
chip_smoke.py's subgraph configuration (CompGCN, rank 32, hidden 200, 2
layers, edge dropout 0.1, dropout 0.1, Adam lr 1e-3, batches of 500 seed
edges, fanouts 20/20, at most 4,096 nodes and 32,768 edges a subgraph, CE)
on its synthetic WN18RR-shaped KG, from --seed.  After 5 warm-up steps:

  * producer: the host work of one batch alone (the C++ sampler, the
    host-side preparation, the pinned tensors), ms a batch;
  * consumer: the training steps alone over batches prepared beforehand
    (upload, loss, backward, Adam), ms a step;
  * run_epoch: SubgraphTrainer.run_epoch over --steps batches, the two
    overlapped through its producer thread, ms a step;
  * window: the same under torch.profiler: the card's busy ms, kernels
    and wall ms a step, the idle share, and the top kernels.

    python3 scripts/torch_subgraph_bench.py [--seed 0] [--steps 60]

Prints one JSON line, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=60)
    a = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from complexhyperbolickge_torch.cli.predict import load_serving_state

    name, smi = cs.phase_device()
    _, dataset = load_serving_state(cs.write_run(a.seed)[0], "cuda")
    tr = cs.subgraph_trainer(a.seed, dataset)
    gen = torch.Generator(device="cuda").manual_seed(a.seed)
    tr.run_epoch(cs.BATCH, np.random.default_rng(a.seed), gen, max_steps=5)
    torch.cuda.synchronize()
    n = a.steps
    out = {"bench": "subgraph", "card": smi, "steps": n}

    it = tr.sampler.epoch(cs.BATCH, np.random.default_rng(a.seed + 1), seed_base=1)
    t0 = time.perf_counter()
    subs = [next(it) for _ in range(n)]
    t1 = time.perf_counter()
    prepped = [tr._prep_host(s) for s in subs]
    t2 = time.perf_counter()
    host = [tr._host_tensors(p) for p in prepped]
    t3 = time.perf_counter()
    out["producer_ms_per_batch"] = {"sample": 1e3 * (t1 - t0) / n, "prep": 1e3 * (t2 - t1) / n,
                                    "host_tensors": 1e3 * (t3 - t2) / n}
    out["nodes_edges_per_batch"] = [float(np.mean([s.n_nodes for s in subs])),
                                    float(np.mean([s.n_edges for s in subs]))]

    def consume(batches):
        for h in batches:
            tr._loss(*tr._to_device(h), generator=gen).backward()
            tr._apply()

    consume(host[:3])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    consume(host)
    torch.cuda.synchronize()
    out["consumer_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / n

    def epoch():
        tr.run_epoch(cs.BATCH, np.random.default_rng(a.seed + 2), gen, epoch_id=2, max_steps=n)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch()
    torch.cuda.synchronize()
    out["run_epoch_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / n
    prof = cs.profile_window(epoch)
    out["window"] = {"busy_ms_per_step": prof["device_busy_ms"] / n,
                     "wall_ms_per_step": prof["wall_ms"] / n,
                     "idle_share": prof["device_idle_share"],
                     "kernels_per_step": prof["device_kernels"] / n,
                     "top_kernels_ms_per_step": {k: v / n
                                                 for k, v in prof["top_kernels_ms"].items()}}
    print(json.dumps(out), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
