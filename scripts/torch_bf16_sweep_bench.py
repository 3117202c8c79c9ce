#!/usr/bin/env python3
"""The bf16 rank sweeps (--eval_precision default) of the PyTorch/CUDA
port on one NVIDIA GPU: K5/K6 for --family poincare or lorentz, K7/K8 for
attrh, K1/K2 for chyp, at the WN18RR eval shape (B = 500 queries, 40,943
entities padded to 40,960 rows, 5 filtered ids a query).  The real-
hyperbolic families: D = 32 in bf16 rows (AttRH: two halves of 16), 22
curvatures, inputs from scripts/torch_hyp_rank_bench.py's `inputs` at
--seed; chyp: FFTRotH at rank 33, D = 66 in bf16 rows of 80 (the exact
instance's float32 rows padded to 68), inputs from ChypRanker's
kernel_inputs on torch_hyp_rank_bench's model_and_batch.

    python3 scripts/torch_bf16_sweep_bench.py [--family attrh] [--tree DIR]
        [--seed 0] [--reps 50] [--sass] [--proofs] [--clocks]

--tree runs the port found in DIR (for instance an unpacked older commit),
so two versions can be timed in one run.  Prints JSON lines:

  times     device times (CUDA events, interleaved masked, maskless,
            maskless, masked) of the family's bf16 masked sweep (K5 / K7),
            the maskless sweep and its subtraction (K6 / K8) and the exact
            instances of both; the bf16 masked sweep against its plain
            default version (within the bf16 near-threshold count) and
            masked == maskless sweep - subtraction; the counts' sums (equal
            across trees: every score is the exact arithmetic's bits); the
            sweeps' registers, spill bytes, shared memory and blocks an SM;
            the family's default ranker's busy time a call (masked and
            maskless; torch.profiler, 5 calls) on a model of the shape
            (RotH, RotLH, AttRH, FFTRotH);
  proofs    (--proofs, trees that have them) the fast paths against
            __fsqrt_rn / __fdiv_rn (fast_arith_sweep) and the batched
            epilogue's scores against score_from_radii's / chyp_score()'s
            on this batch, bit for bit (hyp_scores_bf16 /
            attrh_scores_bf16 / chyp_scores_bf16, which also counts the
            pairs the fast path flagged);
  sass      (--sass) cuobjdump -sass of the tree's libhyp_rank.so (chyp:
            libchyp_rank.so): each bf16 sweep kernel's instructions, in all
            and between barriers (the segment with the most MUFU is the
            epilogue's), and, compiled from the tree's
            scripts/bf16_epilogue_probe.cu, the instructions of one pair
            of each family through score_from_radii / chyp_score() (IEEE,
            the epilogue scored in place) and with FastArith (a pair of the
            batched epilogue), less the probes' loads and store;
  clocks    (--clocks) the SM clock and power draw (nvidia-smi every 200 ms)
            while the bf16 masked sweep runs back to back for 3 s, and its
            launches;
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = Path(__file__).resolve().parent
FAMILIES = ("poincare", "lorentz", "attrh", "chyp")
# the masked and the maskless kernel of each family
NAMES = {"poincare": ("K5", "K6"), "lorentz": ("K5", "K6"), "attrh": ("K7", "K8"),
         "chyp": ("K1", "K2")}


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


def bf16_inputs(family: str, seed: int) -> dict:
    """torch_hyp_rank_bench's inputs of `family` at the WN18RR shape, with
    lhs and rhs as the default rankers' bf16 rows (AttRH: each half padded
    on its own) and the exact instances' float32 rows beside them; chyp:
    the exact and the default ChypRanker's kernel_inputs (masked and
    maskless) on FFTRotH."""
    import torch_hyp_rank_bench as HB

    from complexhyperbolickge_torch.kernels._ranker import bf16_rows

    if family == "chyp":
        from complexhyperbolickge_torch.kernels.chyp_rank import ChypRanker

        model, q, f = HB.model_and_batch("fft", "wn18rr", seed)
        x = {}
        for prec in ("highest", "default"):
            r = ChypRanker(model, precision=prec)
            x[prec] = {**r.kernel_inputs(q, f, masked=False), **r.kernel_inputs(q, f)}
        return {**x["default"], "lhs2_f32": x["highest"]["lhs2"], "rhs_f32": x["highest"]["rhs"]}
    t = HB.inputs(family, "wn18rr", seed)
    t["lhs_f32"], t["rhs_f32"] = t["lhs"], t["rhs"]
    halves = family == "attrh"
    t["lhs"], t["rhs"] = bf16_rows(t["lhs"], halves), bf16_rows(t["rhs"], halves)
    return t


SWEEP = {"attrh": ("lhs", "x2r", "x2f", "cid", "cvals", "w0", "w1", "t2", "rhs", "un_rot",
                   "un_ref", "bt", "radii"),
         "hyp": ("lhs", "x2", "cid", "cvals", "t2", "rhs", "un", "bt", "radii")}
SUB = {"attrh": ("lhs", "x2r", "x2f", "c", "w0", "w1", "t2", "rhs", "un_rot", "un_ref", "bt"),
       "hyp": ("lhs", "x2", "c", "t2", "rhs", "un", "bt")}


def _group(family: str) -> str:
    return {"attrh": "attrh", "chyp": "chyp"}.get(family, "hyp")


CHYP = ("lhs2", "zn", "t2", "rhs", "wn", "bt")


def chyp_calls(t: dict) -> dict:
    from complexhyperbolickge_torch.kernels import chyp_rank as K

    d = {"precision": "default"}
    base = [t[k] for k in CHYP]
    ex = [{**t, "lhs2": t["lhs2_f32"], "rhs": t["rhs_f32"]}[k] for k in CHYP]
    return {
        "K1_bf16": lambda: K.chyp_rank_counts(*base, t["mask"], **d),
        "K2_bf16_sweep": lambda: K.chyp_rank_sweep_nomask(*base, t["gold"], **d),
        "K2_bf16_sub": lambda: K.chyp_rank_filtered_sub(*base, t["fidx"], t["gold"], **d),
        "K1_exact": lambda: K.chyp_rank_counts(*ex, t["mask"]),
        "K2_exact_sweep": lambda: K.chyp_rank_sweep_nomask(*ex, t["gold"]),
    }


def calls(family: str, t: dict) -> dict:
    """name -> a function of no arguments."""
    from complexhyperbolickge_torch.kernels import hyp_rank as H

    g = _group(family)
    if g == "chyp":
        return chyp_calls(t)
    d = {"precision": "default"}
    fam = {} if g == "attrh" else {"family": family}
    sw, sb = [t[k] for k in SWEEP[g]], [t[k] for k in SUB[g]]
    ex = {**t, "lhs": t["lhs_f32"], "rhs": t["rhs_f32"]}
    esw = [ex[k] for k in SWEEP[g]]
    masked = H.attrh_rank_counts if g == "attrh" else H.hyp_rank_counts
    nomask = H.attrh_rank_sweep_nomask if g == "attrh" else H.hyp_rank_sweep_nomask
    sub = H.attrh_rank_filtered_sub if g == "attrh" else H.hyp_rank_filtered_sub
    km, kn = NAMES[family]
    return {
        f"{km}_bf16": lambda: masked(*sw, t["mask"], **fam, **d),
        f"{kn}_bf16_sweep": lambda: nomask(*sw, t["gold"], **fam, **d),
        f"{kn}_bf16_sub": lambda: sub(*sb, t["fidx"], t["gold"], **fam, **d),
        f"{km}_exact": lambda: masked(*esw, t["mask"], **fam),
        f"{kn}_exact_sweep": lambda: nomask(*esw, t["gold"], **fam),
    }


def times(family: str, t: dict, reps: int, seed: int) -> dict:
    import torch

    import chip_smoke as S
    import torch_hyp_rank_bench as HB
    from complexhyperbolickge_torch.kernels import chyp_rank as K
    from complexhyperbolickge_torch.kernels import hyp_rank as H
    from complexhyperbolickge_torch.kernels._ranker import (
        TC_REL,
        near_threshold,
        score_interval,
    )

    g = _group(family)
    km, kn = NAMES[family]
    fns = calls(family, t)
    masked, sweep, sub = fns[f"{km}_bf16"](), fns[f"{kn}_bf16_sweep"](), fns[f"{kn}_bf16_sub"]()
    if g == "chyp":
        plain = K.chyp_rank_counts_plain(*[t[k] for k in CHYP], t["mask"], "default")
    elif g == "attrh":
        plain = H.attrh_rank_counts_plain(*[t[k] for k in SWEEP[g]], t["mask"], "default")
    else:
        plain = H.hyp_rank_counts_plain(*[t[k] for k in SWEEP[g]], t["mask"], family, "default")
    near = near_threshold(*score_interval(family, t, TC_REL), t["t2"])
    torch.cuda.synchronize()
    order = [f"{km}_bf16", f"{kn}_bf16_sweep", f"{kn}_bf16_sub", f"{km}_exact",
             f"{kn}_exact_sweep"]
    ms = {}
    for name in (*order, *order[::-1]):
        ms.setdefault(name, []).append(cuda_ms(fns[name], reps))
    dev = torch.device("cuda")
    lhs = "lhs2" if g == "chyp" else "lhs"
    width = {"default": int(t[lhs].shape[1]), "highest": int(t[f"{lhs}_f32"].shape[1])}
    info_fn = K.sweep_info if g == "chyp" else partial(H.sweep_info, family)
    info = {f"{'masked' if m else 'maskless'}_{p}": info_fn(dev, width[p], masked=m, precision=p)
            for m in (True, False) for p in ("default", "highest")}
    model, q, f = HB.model_and_batch("fft" if g == "chyp" else family, "wn18rr", seed)
    ranker_cls = {"chyp": K.ChypRanker, "attrh": H.AttRHRanker}.get(g, H.HypRanker)
    busy = {}
    for m in (True, False):
        ranker = ranker_cls(model, masked=m, precision="default")
        ranker(q, f)  # tables and warm-up
        prof = S.profile_window(lambda: [ranker(q, f) for _ in range(5)])
        busy["masked" if m else "maskless"] = prof["device_busy_ms"] / 5
    return {"family": family, "ms": ms, "sweep_info": info,
            "count_sums": {"masked": int(masked.sum()), "sweep": int(sweep.sum()),
                           "sub": int(sub.sum())},
            "masked_equals_sweep_minus_sub": bool(torch.equal(masked, sweep - sub)),
            "max_abs_err_vs_plain": int((masked - plain).abs().max()),
            "within_near_threshold": bool(((masked - plain).abs() <= near).all()),
            "ranker_busy_ms_per_call": busy}


def clocks(family: str, t: dict, seconds: float = 3.0) -> dict:
    import torch

    fn = calls(family, t)[f"{NAMES[family][0]}_bf16"]
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "200"],
                           stdout=subprocess.PIPE, text=True)
    n, t0 = 0, time.perf_counter()
    try:
        while time.perf_counter() - t0 < seconds:
            for _ in range(200):
                fn()
            torch.cuda.synchronize()
            n += 200
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    samples = [[float(v) for v in ln.split(",")] for ln in out.splitlines() if ln.strip()]
    return {"launches": n, "seconds": time.perf_counter() - t0,
            "sm_mhz": [v[0] for v in samples], "power_w": [v[1] for v in samples]}


def proofs(family: str, t: dict) -> dict:
    import torch

    from complexhyperbolickge_torch.kernels import chyp_rank as K
    from complexhyperbolickge_torch.kernels import hyp_rank as H

    out = {"fast_arith": H.fast_arith_sweep("cuda")}
    g = _group(family)
    flagged = None
    if g == "chyp":
        args = [t[k] for k in ("lhs2", "zn", "rhs", "wn", "bt")]
        (fast, flagged), (ieee, _) = K.chyp_scores_bf16(*args), K.chyp_scores_bf16(*args, ieee=True)
    else:
        args = [t[k] for k in SWEEP[g] if k != "t2"]
        fn = H.attrh_scores_bf16 if g == "attrh" else partial(H.hyp_scores_bf16, family=family)
        fast, ieee = fn(*args), fn(*args, ieee=True)
    torch.cuda.synchronize()
    out["scores"] = {"pairs": fast.numel(), "flagged": flagged,
                     "mismatches": int((fast.view(torch.int32) != ieee.view(torch.int32)).sum())}
    out["ok"] = (out["fast_arith"]["sqrt_mismatches"] == 0
                 and out["fast_arith"]["quot_mismatches"] == 0
                 and out["scores"]["mismatches"] == 0)
    return out


def has_proofs(family: str) -> bool:
    from complexhyperbolickge_torch.kernels import chyp_rank as K
    from complexhyperbolickge_torch.kernels import hyp_rank as H

    if family == "chyp":
        return hasattr(K, "chyp_scores_bf16")
    return hasattr(H, "attrh_scores_bf16" if family == "attrh" else "hyp_scores_bf16")


# ------------------------------- SASS counts -------------------------------

_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    return str(Path(CUDA_HOME or "/usr/local/cuda") / "bin" / name)


def sass_functions(binary: Path) -> dict:
    """Mangled function name -> its SASS instructions' opcodes, in order."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(binary)], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
        elif cur is not None:
            m = _INSN.match(line)
            if m:
                words = m.group(2).split()
                cur.append(words[1] if words[0].startswith("@") else words[0])
    return funcs


def main_body(ops: list) -> list:
    """The instructions up to the last EXIT before the first RET (the slow
    paths' subroutines follow the function's own code)."""
    end = ops.index("RET.REL.NODEC") if "RET.REL.NODEC" in ops else len(ops)
    exits = [i for i, op in enumerate(ops[:end]) if op == "EXIT"]
    return ops[:exits[-1] + 1] if exits else ops[:end]


def histogram(ops: list, top: int = 14) -> dict:
    h = {}
    for op in ops:
        key = op.split(".")[0]
        h[key] = h.get(key, 0) + 1
    return dict(sorted(h.items(), key=lambda kv: -kv[1])[:top])


def demangle(names):
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if not tool:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    lines = out.stdout.splitlines()
    return dict(zip(names, lines)) if len(lines) == len(names) else {n: n for n in names}


def sass(tree: Path, lib: Path) -> dict:
    """The bf16 sweeps' instructions of `lib`, and the one-pair probes' of
    each family the tree's probe holds."""
    from complexhyperbolickge_torch.kernels import _build

    out = {"kernels": {}}
    funcs = sass_functions(lib)
    names = demangle([n for n in funcs if "sweep_bf16_kernel" in n])
    for mangled, pretty in names.items():
        ops = main_body(funcs[mangled])
        segs, cur = [], []
        for op in ops:
            cur.append(op)
            if op.startswith("BAR"):
                segs.append(cur)
                cur = []
        segs.append(cur)
        epi = max(segs, key=lambda s: sum(op.startswith("MUFU") for op in s))
        out["kernels"][pretty] = {
            "instructions": len(ops), "between_barriers": [len(s) for s in segs],
            "epilogue_segment": len(epi), "epilogue_histogram": histogram(epi)}
    src = tree / "scripts" / "bf16_epilogue_probe.cu"
    probe = tree / "build" / "bf16_probe" / "bf16_epilogue_probe.cubin"
    probe.parent.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_build._nvcc(), *flags, "-cubin", "-o", str(probe), str(src)], check=True,
                   capture_output=True)
    pf = sass_functions(probe)
    out["probes"] = {}
    for family in FAMILIES:
        if f"{family}_pair_base" not in pf:
            continue
        base = main_body(pf[f"{family}_pair_base"])
        overhead = len(base) - sum(op.startswith("FADD") for op in base)
        row = {"overhead": overhead}
        for kind in ("ieee", "fast"):
            ops = main_body(pf[f"{family}_pair_{kind}"])
            row[kind] = {"instructions": len(ops), "per_pair": len(ops) - overhead,
                         "branches": sum(op.startswith(("BRA", "CALL")) for op in ops),
                         "histogram": histogram(ops)}
        out["probes"][family] = row
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--family", choices=FAMILIES, default="attrh")
    p.add_argument("--tree", default=str(ROOT))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--sass", action="store_true")
    p.add_argument("--proofs", action="store_true")
    p.add_argument("--clocks", action="store_true")
    a = p.parse_args(argv)
    sys.path.insert(0, str(SCRIPTS))
    import torch_hyp_rank_bench  # noqa: F401  (puts this tree first on sys.path)

    tree = Path(a.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_bf16_sweep_bench: needs a CUDA card")
    from complexhyperbolickge_torch.kernels import _build

    _build.build_all(["chyp_rank", "hyp_rank"])
    t = bf16_inputs(a.family, a.seed)
    ok = True
    row = {"tree": a.tree, **times(a.family, t, a.reps, a.seed)}
    print(json.dumps(row), flush=True)
    ok &= row["masked_equals_sweep_minus_sub"] and row["within_near_threshold"]
    if a.proofs and has_proofs(a.family):
        row = {"tree": a.tree, "family": a.family, "proofs": proofs(a.family, t)}
        print(json.dumps(row), flush=True)
        ok &= row["proofs"]["ok"]
    if a.clocks:
        print(json.dumps({"tree": a.tree, "family": a.family, "clocks": clocks(a.family, t)}),
              flush=True)
    if a.sass:
        lib = Path(_build.BUILD_DIR) / f"lib{'chyp_rank' if a.family == 'chyp' else 'hyp_rank'}.so"
        print(json.dumps({"tree": a.tree, "sass": sass(tree, lib)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
