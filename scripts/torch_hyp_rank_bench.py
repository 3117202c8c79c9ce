#!/usr/bin/env python3
"""Times the rank sweeps of the PyTorch/CUDA port (the hyp_rank sweeps K5-K8
and their radius launcher; with --family fft the chyp_rank sweeps K1/K2) and
the fused rankers on one NVIDIA GPU, at two eval shapes (B = 500 queries,
D = 32, or D = 66 for FFTRotH at rank 33; 5 filtered ids a query):

  wn18rr    40,943 entities padded to Np = 40,960 rows, 22 curvatures
            (11 relations with inverses, multi_c): a 14 MB Poincare table;
  yago3-10  123,182 entities padded to Np = 123,264, 74 curvatures (37
            relations with inverses): a 146 MB Poincare table, larger than
            the card's 50 MB L2; the size at which the JAX package's `auto`
            backend takes the maskless kernel (100,000 entities or more).

Inputs are drawn from --seed at the scales of chip_smoke.py's planted runs
(entity ~ N(0, 0.05), bt ~ N(0, 0.01)); thresholds are each query's gold
score.  The fft family takes its kernels' inputs from ChypRanker on an
FFTRotH model of the shape's size (its table's rows padded to 68 floats).

    python3 scripts/torch_hyp_rank_bench.py [--shape wn18rr yago3-10]
        [--family poincare lorentz attrh fft] [--seed 0] [--reps 50]

Prints one JSON line per shape and family: the sweeps' op bound (as
chip_smoke.py's kernels line counts it), registers and resident blocks of
the masked and the maskless sweep, the masked count against the maskless
one (must be equal) and against the plain version (within the
near-threshold count), device times (CUDA events; interleaved masked,
maskless, maskless, masked), the radius launcher's time, and the fused
ranker's busy time per call on the card (torch.profiler, 5 calls, masked
and maskless) for a RotH, RotLH, AttRH or FFTRotH model of the shape's
size; then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

B, D, L = 500, 32, 5
FFT_RANK = 33  # the published WN18RR FFTRotH config: D = 66
# shape -> (entities, padded rows, curvatures)
SHAPES = {"wn18rr": (40_943, 40_960, 22), "yago3-10": (123_182, 123_264, 74)}
MODELS = {"poincare": "RotH", "lorentz": "RotLH", "attrh": "AttRH", "fft": "FFTRotH"}


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


def fft_inputs(shape: str, seed: int):
    """K1/K2's inputs for one batch, from ChypRanker (masked and maskless
    forms) on model_and_batch's FFTRotH."""
    from complexhyperbolickge_torch.kernels import chyp_rank as K

    model, q, f = model_and_batch("fft", shape, seed)
    ranker = K.ChypRanker(model)
    t = ranker.kernel_inputs(q, f, masked=True)
    xn = ranker.kernel_inputs(q, f, masked=False)
    t.update(fidx=xn["fidx"], gold=xn["gold"])
    scores = K.chyp_scores_plain(t["lhs2"], t["zn"], t["rhs"], t["wn"], t["bt"])
    t["near"] = ((scores - t["t2"][:, None]).abs()
                 <= (1e-5 * (1 + t["t2"].abs()))[:, None]).sum(1)
    del scores
    return t


def inputs(kind: str, shape: str, seed: int):
    import numpy as np
    import torch

    from complexhyperbolickge_torch.kernels import hyp_rank as H

    n, np_, n_c = SHAPES[shape]
    rng = np.random.default_rng(seed)
    dev = "cuda"
    f32 = torch.float32
    rhs = torch.zeros((np_, D), dtype=f32)
    rhs[:n] = torch.as_tensor(rng.normal(0, 0.05, (n, D)), dtype=f32)
    bt = torch.full((np_,), -1e30, dtype=f32)
    bt[:n] = torch.as_tensor(rng.normal(0, 0.01, n), dtype=f32)
    lhs = torch.as_tensor(rng.normal(0, 0.1, (B, D)), dtype=f32)
    cvals = torch.as_tensor(np.log1p(np.exp(rng.normal(1.0, 0.05, n_c))), dtype=f32)
    cid = torch.as_tensor(rng.integers(0, n_c, B), dtype=torch.int32)
    # distinct filter ids a row (as eval_pack deduplicates them), the gold first
    fidx = torch.as_tensor(np.stack([rng.choice(n, L, replace=False) for _ in range(B)]))
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
    del scores
    mask = torch.zeros((B, np_), dtype=torch.int8, device=dev)
    mask[:, n:] = 1
    mask.scatter_(1, fidx.to(dev), 1)
    t.update(mask=mask, fidx=fidx.to(dev, torch.int32), gold=gold.to(dev, torch.int32))
    return t


def kernels(kind: str, t: dict):
    """(masked, maskless sweep, maskless count, plain masked count, radius
    launcher or None), each a function of no arguments."""
    from complexhyperbolickge_torch.kernels import chyp_rank as K
    from complexhyperbolickge_torch.kernels import hyp_rank as H

    if kind == "fft":
        pre = [t[k] for k in ("lhs2", "zn", "t2", "rhs", "wn", "bt")]
        return (lambda: K.chyp_rank_counts(*pre, t["mask"]),
                lambda: K.chyp_rank_sweep_nomask(*pre, t["gold"]),
                lambda: K.chyp_rank_counts_nomask(*pre, t["fidx"], t["gold"]),
                lambda: K.chyp_rank_counts_plain(*pre, t["mask"]), None)
    if kind == "attrh":
        pre = [t[k] for k in ("lhs", "x2r", "x2f", "cid", "cvals", "w0", "w1", "t2", "rhs",
                              "un_rot", "un_ref", "bt", "radii")]
        return (lambda: H.attrh_rank_counts(*pre, t["mask"]),
                lambda: H.attrh_rank_sweep_nomask(*pre, t["gold"]),
                lambda: H.attrh_rank_counts_nomask(*pre, t["fidx"], t["gold"]),
                lambda: H.attrh_rank_counts_plain(*pre, t["mask"]),
                lambda: H.hyp_rank_radii(t["cvals"], t["un_rot"], "attrh", t["un_ref"]))
    pre = [t[k] for k in ("lhs", "x2", "cid", "cvals", "t2", "rhs", "un", "bt", "radii")]
    return (lambda: H.hyp_rank_counts(*pre, t["mask"], family=kind),
            lambda: H.hyp_rank_sweep_nomask(*pre, t["gold"], family=kind),
            lambda: H.hyp_rank_counts_nomask(*pre, t["fidx"], t["gold"], family=kind),
            lambda: H.hyp_rank_counts_plain(*pre, t["mask"], family=kind),
            lambda: H.hyp_rank_radii(t["cvals"], t["un"], kind))


def bench(kind: str, shape: str, seed: int, reps: int) -> dict:
    import torch

    import chip_smoke as S
    from complexhyperbolickge_torch.kernels import chyp_rank as K
    from complexhyperbolickge_torch.kernels import hyp_rank as H

    fft = kind == "fft"
    t = fft_inputs(shape, seed) if fft else inputs(kind, shape, seed)
    masked, sweep, maskless, plain, radii = kernels(kind, t)
    got, nomask, ref = masked(), maskless(), plain()
    torch.cuda.synchronize()
    times = {}
    for name in ("masked", "maskless_sweep", "maskless_sweep", "masked"):
        times.setdefault(name, []).append(cuda_ms(masked if name == "masked" else sweep, reps))
    dev = torch.device("cuda")
    d = int(t["lhs2" if fft else "lhs"].shape[1])
    info = {"masked" if m else "maskless": (K.sweep_info(dev, d, masked=m) if fft
                                            else H.sweep_info(kind, dev, d, masked=m))
            for m in (True, False)}
    # the sweeps' op bound as chip_smoke.py's kernels line counts it: K1/K2
    # two D-long FMA chains a pair; K5-K8 per pair the contraction's 2 D
    # operations and the epilogue's (counted as if the radius part were
    # computed per pair)
    f32_peak = S.peak_rates(torch.cuda.get_device_name(0))[0]
    np_ = int(t["rhs"].shape[0])
    pair_ops = 4 * d if fft else 2 * d + S.EPILOGUE_OPS[kind]
    table = t["rhs"] if fft else t["radii"]
    return {"shape": shape, "family": kind, "Np": np_, "D": d,
            "n_curvatures": None if fft else int(t["cvals"].shape[0]),
            "bound_ms": B * np_ * pair_ops / f32_peak * 1e3,
            "table_mb": table.numel() * 4 / 1e6, "sweeps": info,
            "masked_equals_maskless": torch.equal(got, nomask),
            "max_abs_err_vs_plain": int((got - ref).abs().max()),
            "within_near_threshold": bool(((got - ref).abs() <= t["near"]).all()),
            "ms": times, "radii_ms": None if radii is None else cuda_ms(radii, reps)}


def model_and_batch(kind: str, shape: str, seed: int):
    """A model of the family at the shape's size (rank 32, FFTRotH 33;
    multi_c, bias learn) with entities drawn from the seed, and one batch:
    queries q (B, 3) and filter ids f (B, L), the gold first."""
    import numpy as np
    import torch

    from complexhyperbolickge_torch.models import ModelConfig, get_model

    n, _, n_c = SHAPES[shape]
    cfg = ModelConfig(n_entities=n, n_relations=n_c, rank=FFT_RANK if kind == "fft" else D,
                      bias="learn", multi_c=True, dtype="float32")
    model = get_model(MODELS[kind])(cfg, device="cuda",
                                    generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        model.entity.copy_(torch.as_tensor(rng.normal(0, 0.05, tuple(model.entity.shape)),
                                           dtype=torch.float32))
    q = torch.as_tensor(np.stack([rng.integers(0, n, B), rng.integers(0, n_c, B),
                                  rng.integers(0, n, B)], 1), device="cuda")
    f = torch.as_tensor(np.concatenate([q[:, 2:].cpu().numpy(),
                                        rng.integers(0, n, (B, L - 1))], 1), device="cuda")
    return model, q, f


def ranker_busy(kind: str, shape: str, seed: int) -> dict:
    """The fused ranker's busy time on the card per call of B queries
    (masked and maskless), for model_and_batch's model."""
    import chip_smoke as S
    from complexhyperbolickge_torch.kernels.chyp_rank import ChypRanker
    from complexhyperbolickge_torch.kernels.hyp_rank import AttRHRanker, HypRanker

    model, q, f = model_and_batch(kind, shape, seed)
    cls = {"fft": ChypRanker, "attrh": AttRHRanker}.get(kind, HypRanker)
    out = {"model": MODELS[kind]}
    for masked in (True, False):
        ranker = cls(model, masked=masked)
        ranker(q, f)  # tables and warm-up
        prof = S.profile_window(lambda: [ranker(q, f) for _ in range(5)])
        out["masked" if masked else "maskless"] = {
            "device_busy_ms_per_call": prof["device_busy_ms"] / 5,
            "kernels_per_call": prof["device_kernels"] / 5}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--shape", nargs="+", choices=sorted(SHAPES), default=["wn18rr"])
    p.add_argument("--family", nargs="+", choices=sorted(MODELS),
                   default=["poincare", "lorentz", "attrh"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=50)
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_hyp_rank_bench: needs a CUDA card")
    from complexhyperbolickge_torch.kernels import _build

    libs = ["chyp_rank"] * ("fft" in a.family) + ["hyp_rank"] * (a.family != ["fft"])
    _build.build_all(libs)
    print(json.dumps({"ptxas": {lib: [ln.strip() for ln in _build.build_logs.get(lib, "")
                                      .splitlines() if "registers" in ln or "spill" in ln]
                                for lib in libs}}))
    ok = True
    for shape in a.shape:
        for kind in a.family:
            row = bench(kind, shape, a.seed, a.reps)
            row["ranker"] = ranker_busy(kind, shape, a.seed)
            print(json.dumps(row), flush=True)
            ok &= row["masked_equals_maskless"] and row["within_near_threshold"]
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
