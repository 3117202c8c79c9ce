#!/usr/bin/env python3
"""Times the hyp_rank kernels of the PyTorch/CUDA port (K5-K8 and the radius
launcher) on one NVIDIA GPU at the WN18RR eval shape: B = 500 queries, a
40,943-entity table padded to Np = 40,960 rows, D = 32, 22 curvatures
(multi_c), 5 filtered ids a query.  Inputs are drawn from --seed at the
scales of chip_smoke.py's planted runs (entity ~ N(0, 0.05), bt ~ N(0,
0.01)); thresholds are each query's gold score.

    python3 scripts/torch_hyp_rank_bench.py [--seed 0] [--reps 50]

Prints one JSON line per family: registers and resident blocks of the
masked sweep, the masked count against the maskless one (must be equal)
and the plain one (within the near-threshold count), and device times
(CUDA events, interleaved masked, maskless, maskless, masked), then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

B, N, NP, D, L, N_C = 500, 40_943, 40_960, 32, 5, 22


def cuda_ms(fn, reps: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def inputs(kind: str, seed: int):
    import numpy as np
    import torch

    from complexhyperbolickge_torch.kernels import hyp_rank as H

    rng = np.random.default_rng(seed)
    dev = "cuda"
    f32 = torch.float32
    rhs = torch.zeros((NP, D), dtype=f32)
    rhs[:N] = torch.as_tensor(rng.normal(0, 0.05, (N, D)), dtype=f32)
    bt = torch.full((NP,), -1e30, dtype=f32)
    bt[:N] = torch.as_tensor(rng.normal(0, 0.01, N), dtype=f32)
    lhs = torch.as_tensor(rng.normal(0, 0.1, (B, D)), dtype=f32)
    cvals = torch.as_tensor(np.log1p(np.exp(rng.normal(1.0, 0.05, N_C))), dtype=f32)
    cid = torch.as_tensor(rng.integers(0, N_C, B), dtype=torch.int32)
    # distinct filter ids a row (as eval_pack deduplicates them), the gold first
    fidx = torch.as_tensor(np.stack([rng.choice(N, L, replace=False) for _ in range(B)]))
    gold = fidx[:, 0].clone()
    t = {k: v.to(dev) for k, v in dict(lhs=lhs, rhs=rhs, bt=bt, cvals=cvals, cid=cid).items()}
    t["c"] = t["cvals"][t["cid"].long()]

    def norm(rows):
        return torch.sqrt(torch.sum(rows * rows, -1).clamp_min(1e-30))

    h = D // 2
    if kind == "attrh":
        w = torch.softmax(torch.as_tensor(rng.normal(0, 1, (B, 2)), dtype=f32), -1).to(dev)
        t.update(x2r=torch.sum(t["lhs"][:, :h] ** 2, -1), x2f=torch.sum(t["lhs"][:, h:] ** 2, -1),
                 w0=w[:, 0].contiguous(), w1=w[:, 1].contiguous(),
                 un_rot=norm(t["rhs"][:, :h]), un_ref=norm(t["rhs"][:, h:]))
        scores = H.attrh_scores_plain(*(t[k] for k in ("lhs", "x2r", "x2f", "c", "w0", "w1",
                                                       "rhs", "un_rot", "un_ref", "bt")))
        t["radii"] = H.hyp_rank_radii(t["cvals"], t["un_rot"], "attrh", t["un_ref"])
    else:
        t.update(x2=torch.sum(t["lhs"] ** 2, -1), un=norm(t["rhs"]))
        scores = H.hyp_scores_plain(t["lhs"], t["x2"], t["c"], t["rhs"], t["un"], t["bt"], kind)
        t["radii"] = H.hyp_rank_radii(t["cvals"], t["un"], kind)
    t["t2"] = scores[torch.arange(B, device=dev), gold.to(dev)].contiguous()
    t["near"] = ((scores - t["t2"][:, None]).abs()
                 <= (1e-5 * (1 + t["t2"].abs()))[:, None]).sum(1)
    mask = torch.zeros((B, NP), dtype=torch.int8, device=dev)
    mask[:, N:] = 1
    mask.scatter_(1, fidx.to(dev), 1)
    t.update(mask=mask, fidx=fidx.to(dev, torch.int32), gold=gold.to(dev, torch.int32))
    return t


def bench(kind: str, seed: int, reps: int) -> dict:
    import torch

    from complexhyperbolickge_torch.kernels import hyp_rank as H

    t = inputs(kind, seed)
    if kind == "attrh":
        masked_args = [t[k] for k in ("lhs", "x2r", "x2f", "cid", "cvals", "w0", "w1", "t2",
                                      "rhs", "un_rot", "un_ref", "bt", "radii", "mask")]
        base = [t[k] for k in ("lhs", "x2r", "x2f", "c", "w0", "w1", "t2", "rhs", "un_rot",
                               "un_ref", "bt")]

        def masked():
            return H.attrh_rank_counts(*masked_args)

        def sweep():
            return H.attrh_rank_sweep_nomask(*base, t["gold"])

        def maskless():
            return H.attrh_rank_counts_nomask(*base, t["fidx"], t["gold"])

        def plain():
            return H.attrh_rank_counts_plain(*masked_args)

        def radii():
            return H.hyp_rank_radii(t["cvals"], t["un_rot"], "attrh", t["un_ref"])
    else:
        masked_args = [t[k] for k in ("lhs", "x2", "cid", "cvals", "t2", "rhs", "un", "bt",
                                      "radii", "mask")]
        base = [t[k] for k in ("lhs", "x2", "c", "t2", "rhs", "un", "bt")]

        def masked():
            return H.hyp_rank_counts(*masked_args, family=kind)

        def sweep():
            return H.hyp_rank_sweep_nomask(*base, t["gold"], family=kind)

        def maskless():
            return H.hyp_rank_counts_nomask(*base, t["fidx"], t["gold"], family=kind)

        def plain():
            return H.hyp_rank_counts_plain(*masked_args, family=kind)

        def radii():
            return H.hyp_rank_radii(t["cvals"], t["un"], kind)

    got, want, ref = masked(), maskless(), plain()
    torch.cuda.synchronize()
    times = {"masked": [], "maskless_sweep": []}
    for name in ("masked", "maskless_sweep", "maskless_sweep", "masked"):
        times[name].append(cuda_ms(masked if name == "masked" else sweep, reps))
    return {"family": kind,
            **H.masked_sweep_info(kind, torch.device("cuda"), D),
            "masked_equals_maskless": bool(torch.equal(got, want)),
            "max_abs_err_vs_plain": int((got - ref).abs().max()),
            "within_near_threshold": bool(((got - ref).abs() <= t["near"]).all()),
            "ms": times, "radii_ms": cuda_ms(radii, reps)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=50)
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_hyp_rank_bench: needs a CUDA card")
    from complexhyperbolickge_torch.kernels import _build

    _build.build_all(["hyp_rank"])
    print(json.dumps({"ptxas": [ln.strip() for ln in _build.build_logs.get("hyp_rank", "")
                                .splitlines() if "registers" in ln or "spill" in ln]}))
    ok = True
    for kind in ("poincare", "lorentz", "attrh"):
        row = bench(kind, a.seed, a.reps)
        print(json.dumps(row), flush=True)
        ok &= row["masked_equals_maskless"] and row["within_near_threshold"]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
