#!/usr/bin/env python3
"""Device time of FFTRotH training on one NVIDIA GPU at chip_smoke.py's
training step (rank 33: a 40,943 x 66 f32 entity table; multi_c, bias
learn; batch 500 with 100 per-query negatives; Adam lr 3e-4), from --seed.
Two measurements, each under torch.profiler (the card's busy time is the
union of its kernels' intervals):

  * step: 20 training steps of cli.run's Trainer on the smoke's synthetic
    WN18RR-shaped KG (after 3 warm-up steps): busy ms, kernels launched
    and wall ms a step, the idle share, and the busy ms a step of each
    kernel name;
  * paths: the train distance's own work for one step's ids (the batch's
    tails and the sampler's negatives), on the model's table and query
    rows.  The K3 path is the forward: where the tree has the id form
    (`chyp_train_distance_ids`), the (B, 1 + K) id block and K3; else the
    gathers entity[tails], entity[negatives] and K3 on each.  The K4 path
    is the backward to the queries and the table: K4 with its sort of the
    ids; else K4 on each block, the gathers' backward (fill, sort,
    indexing_backward_kernel) and the sum of the two table gradients.

    python3 scripts/torch_train_bench.py [--tree DIR] [--seed 0] [--steps 20]

--tree runs the port and chip_smoke.py found in DIR (for instance an
unpacked older commit), so two versions can be timed in one run.  Prints
one JSON line per measurement, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def kernel_profile(fn, calls: int) -> dict:
    """fn() `calls` times under torch.profiler: the card's busy ms, the
    kernels launched and the wall ms per call, the idle share, and busy
    ms per call by kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kern = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: e.time_range.start)
    if not kern:
        raise SystemExit("torch_train_bench: torch.profiler saw no device time")
    busy, end, by_name = 0.0, float("-inf"), {}
    for e in kern:
        s, f = e.time_range.start, e.time_range.end
        busy += max(0.0, f - max(s, end))
        end = max(end, f)
        by_name[e.name] = by_name.get(e.name, 0.0) + (f - s)
    return {"busy_ms": busy / 1e3 / calls, "kernels": len(kern) / calls,
            "wall_ms": wall_us / 1e3 / calls, "idle_share": 1.0 - busy / wall_us,
            "by_kernel_ms": {n[:100]: t / 1e3 / calls
                             for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=20)
    a = p.parse_args(argv)
    sys.path.insert(0, str(Path(a.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_train_bench: needs a CUDA card")
    import chip_smoke as S
    from complexhyperbolickge_torch.cli.predict import load_serving_state
    from complexhyperbolickge_torch.kernels import chyp_train as CT
    from complexhyperbolickge_torch.train.losses import sample_negatives

    _, dataset = load_serving_state(S.write_run(a.seed)[0], "cuda")
    trainer, b, w, gen = S.train_window(dataset, a.seed)
    trainer.run_epoch(b[:3], w[:3], gen)  # warm-up
    steps = slice(3, 3 + a.steps)
    step = kernel_profile(lambda: trainer.run_epoch(b[steps], w[steps], gen), 1)
    step.update({k: step[k] / a.steps for k in ("busy_ms", "kernels", "wall_ms")})
    step["by_kernel_ms"] = {k: v / a.steps for k, v in step["by_kernel_ms"].items()}
    print(json.dumps({"tree": a.tree, "measure": "step", "steps": a.steps, **step}), flush=True)

    model = S.wn18rr_model(a.seed)
    batch = torch.as_tensor(b[3], dtype=torch.int64, device="cuda")
    with torch.no_grad():
        lhs = model.get_queries(batch[:, :2])[0][0].contiguous()
    lhs.requires_grad_()
    entity = model.entity
    negs = sample_negatives(torch.Generator(device="cuda").manual_seed(a.seed), batch,
                            entity.shape[0], S.NEG)
    tails = batch[:, 2:3]
    g = torch.randn((batch.shape[0], 1 + S.NEG), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(a.seed))
    fused = hasattr(CT, "chyp_train_distance_ids")

    def forward():
        if fused:
            return [CT.chyp_train_distance_ids(lhs, entity, torch.cat([tails, negs], dim=1))]
        return [CT.chyp_train_distance(lhs, entity[tails]),
                CT.chyp_train_distance(lhs, entity[negs])]

    outs = forward()
    cots = [g] if fused else [g[:, :1].contiguous(), g[:, 1:].contiguous()]
    for _ in range(3):  # warm-up
        forward()
        torch.autograd.grad(outs, [lhs, entity], cots, retain_graph=True)
    paths = {"k3_path": kernel_profile(forward, 20),
             "k4_path": kernel_profile(
                 lambda: torch.autograd.grad(outs, [lhs, entity], cots, retain_graph=True), 20)}
    print(json.dumps({"tree": a.tree, "measure": "paths", "id_form": fused,
                      "shape": {"B": batch.shape[0], "K": 1 + S.NEG, "N": entity.shape[0],
                                "D": entity.shape[1]}, **paths}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
