#!/usr/bin/env python3
"""The readings that a full-graph training cell's correctness limits are
set from (traffic `train_full_graph`), on the card the command runs on;
the benchmark's own runs never run this:

    python3 kgbench/calibrate_full_graph.py --workload <cell> --seeds <s1,s2,...> \
        --control-seeds <s1,s2,s3>

For each seed of --seeds, the program's numbers as a run compares them
(set-up, which steps the checked batches, then the check), with each
leaf's gap of the first gradient's norm and of the change's norm.  For
each seed of --control-seeds, the numbers of:
  control_tf32  the reference in float32 with TF32 contractions, put in
                the program's place (the nearest precision below the
                configuration's float32 with TF32 off);
  fault_half    the reference whose loss leaves out the second half of
                each batch (the mean over the rest).
A state left unchanged reads 1 in change_norm_gap by definition and is not
run.  One JSON line per reading, then a summary: per number the largest
sound reading, each control's and fault's smallest, and the limit they
give, the geometric mean of the largest sound reading and the smallest
reading above it that a control or a fault gives.
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """name -> |program - reference| over the larger of the leaf's and the
    median leaf's reference norm (protocol.norm_gap, leaf by leaf)."""
    med = float(np.median(list(ref.values())))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in sorted(ref)}


def readings(name: str, seed: int, control: bool, device: str = "cuda", dirs=None) -> list:
    import torch

    from kgbench import harness
    from kgbench.reference import protocol
    from kgbench.trace import Spans

    cell = harness.Cell.load(name, seed, device, dirs)
    s = harness.load_module("traffic", cell.traffic).Session(cell, Spans())
    s.free()
    if device == "cuda":
        torch.cuda.empty_cache()
    f64 = protocol.Arith("float64")
    ref = s.reference_steps(f64)
    out = [("program", s.numbers(s.losses, s.first_grad_norms, s.change_norms, ref),
            {"grad": leaf_gaps(s.first_grad_norms, ref[1]),
             "change": leaf_gaps(s.change_norms, ref[2])})]
    if control:
        out.append(("control_tf32", s.numbers(*s.reference_steps(protocol.Arith("tf32")), ref),
                    None))
        out.append(("fault_half", s.numbers(*s.reference_steps(f64, half=True), ref), None))
    return out


def limits(summary: dict) -> dict:
    """Per number: the geometric mean of the largest sound reading and the
    smallest control or fault reading above it (None where none is)."""
    out = {}
    for k, sound in summary.get("program", {}).items():
        fails = [v[k] for mode, v in summary.items() if mode != "program" and v[k] > sound]
        out[k] = math.sqrt(sound * min(fails)) if fails else None
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
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
    agg: dict = {}
    for seed in seeds + [c for c in controls if c not in seeds]:
        t0 = time.perf_counter()
        for mode, numbers, leaves in readings(args.workload, seed, seed in controls,
                                              args.device, args.dirs and [args.dirs]):
            print(json.dumps({"workload": args.workload, "seed": seed, "mode": mode,
                              "numbers": numbers, "leaves": leaves,
                              "seconds": time.perf_counter() - t0}), flush=True)
            for k, v in numbers.items():
                agg.setdefault(mode, {}).setdefault(k, []).append(v)
    summary = {mode: {k: (max(v) if mode == "program" else min(v)) for k, v in nums.items()}
               for mode, nums in agg.items()}
    print(json.dumps({"workload": args.workload, "summary": summary, "limits": limits(summary),
                      "device": torch.cuda.get_device_name() if args.device == "cuda" else "cpu"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
