#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, on the card
the command runs on (the benchmark's own runs never run this):

    python3 kgbench/calibrate.py --workload <cell> --seeds <s1,s2,...> \
        --control-seeds <s1,s2,s3> [--seconds 1]

For each seed of --seeds, the program's numbers as a run compares them
(set-up, for a ranking cell a short window of --seconds, the check).  For
each seed of --control-seeds, the numbers of:
  control_tf32  the reference in float32 with TF32 contractions, put in
                the program's place (the nearest precision below the
                configurations' float32 with TF32 off);
  control_bf16  the program with its own lower precision switched on
                (a training cell: bfloat16 parameters; a ranking cell:
                --eval_precision default, the bf16 sweep);
  fault_half    (training) the reference whose loss leaves out the second
                half of each batch and takes the mean over the rest;
  fault_answer  (ranking) the program's ranks with one answer altered by
                one where it is produced (the first query's rank + 1).
A state left unchanged reads 1 in change_norm_gap by definition and is not
run.  One JSON line per reading, then a summary: per number the largest
sound reading and each control's and fault's smallest.
"""

import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def half_batch_loss(ref, cfg, P, batch, gen, ar):
    """The loss with the second half of the batch left out, the mean over
    the rest (the negatives still drawn for the whole batch)."""
    import torch
    import torch.nn.functional as F

    from kgbench.reference.protocol import sample

    n, k, n_rel = cfg["n_entities"], cfg["neg_sample_size"], cfg["n_relations"]
    half = batch.shape[0] // 2
    lhs, lb = ref.queries(P, batch[:, 0], batch[:, 1], cfg, ar)
    ids = torch.cat([batch[:, 2:3], sample(gen, batch[:, 2], n, k)], dim=1)
    s = ref.score_ids(P, lhs, lb, ids, cfg, ar)[:half]
    num = torch.sum(F.logsigmoid(s[:, :1])) + torch.sum(F.logsigmoid(-s[:, 1:]))
    den = half * (1 + k)
    if cfg["double_neg"]:
        neg_h = sample(gen, batch[:, 0], n, k)
        lhs_h, lb_h = ref.queries(P, batch[:, 2], (batch[:, 1] + n_rel // 2) % n_rel, cfg, ar)
        num = num + torch.sum(F.logsigmoid(-ref.score_ids(P, lhs_h, lb_h, neg_h, cfg, ar)[:half]))
        den = den + half * k
    return -num / den


def readings(name: str, seed: int, control: bool, seconds: float, device: str = "cuda",
             dirs=None) -> list:
    import torch

    from kgbench import harness
    from kgbench.reference import protocol
    from kgbench.trace import Spans

    out = []
    cell = harness.Cell.load(name, seed, device, dirs)
    traffic = harness.load_module("traffic", cell.traffic)
    s = traffic.Session(cell, Spans())
    if cell.traffic == "rank_split":
        s.window(seconds)
    s.free()
    if device == "cuda":
        torch.cuda.empty_cache()
    out.append(("program", s.check()))
    if not control:
        return out
    f64 = protocol.Arith("float64")
    if cell.traffic == "train_epochs":
        ref = s.reference_steps(f64)
        out.append(("control_tf32", s.numbers(*s.reference_steps(protocol.Arith("tf32")), ref)))
        out.append(("fault_half", s.numbers(*s.reference_steps(f64, half_batch_loss), ref)))
        low = copy.deepcopy(cell)
        low.config["dtype"] = "bfloat16"
        b = traffic.Session(low, Spans())
        b.free()
        out.append(("control_bf16", b.numbers(b.losses, b.first_grad_norms, b.change_norms, ref)))
    else:
        ctrl = s.control_ranks(protocol.Arith("tf32"))
        half = len(ctrl) // 2
        metrics = {"rhs": protocol.direction_metrics(ctrl[:half].cpu().numpy()),
                   "lhs": protocol.direction_metrics(ctrl[half:].cpu().numpy())}
        out.append(("control_tf32", s.numbers([(ctrl, metrics)])))
        ranks, m = next(iter(s.kept.values()))
        ranks = torch.cat(ranks).clone()
        ranks[0] += 1
        out.append(("fault_answer", s.numbers([(ranks, None)])))
        low = copy.deepcopy(cell)
        low.config["eval_precision"] = "default"
        b = traffic.Session(low, Spans())
        b.window(seconds)
        b.free()
        out.append(("control_bf16", b.check()))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda", help="cpu: a rehearsal, no reading")
    p.add_argument("--dirs", default=None, help="a directory of cut-down cell files")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no card", file=sys.stderr)
        return 3
    seeds = [int(x) for x in args.seeds.split(",") if x]
    controls = [int(x) for x in args.control_seeds.split(",") if x]
    summary: dict = {}
    for seed in seeds + [c for c in controls if c not in seeds]:
        t0 = time.perf_counter()
        for mode, numbers in readings(args.workload, seed, seed in controls, args.seconds,
                                      args.device, args.dirs and [args.dirs]):
            print(json.dumps({"workload": args.workload, "seed": seed, "mode": mode,
                              "numbers": numbers, "seconds": time.perf_counter() - t0}),
                  flush=True)
            for k, v in numbers.items():
                agg = summary.setdefault(mode, {}).setdefault(k, [])
                agg.append(v)
    print(json.dumps({"workload": args.workload, "summary": {
        mode: {k: (max(v) if mode == "program" else min(v)) for k, v in nums.items()}
        for mode, nums in summary.items()},
        "device": torch.cuda.get_device_name() if args.device == "cuda" else "cpu"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
