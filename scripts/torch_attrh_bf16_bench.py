#!/usr/bin/env python3
"""AttRH's bf16 rank sweeps (K7 and K8 at --eval_precision default) of the
PyTorch/CUDA port on one NVIDIA GPU, at the WN18RR eval shape (B = 500
queries, 40,943 entities padded to 40,960 rows, D = 32 in two bf16 halves
of 16, 22 curvatures, 5 filtered ids a query; inputs from
scripts/torch_hyp_rank_bench.py's `inputs` at --seed).

    python3 scripts/torch_attrh_bf16_bench.py [--tree DIR] [--seed 0] [--reps 50]
        [--sass] [--proofs] [--clocks]

--tree runs the port found in DIR (for instance an unpacked older commit),
so two versions can be timed in one run.  Prints JSON lines:

  times     device times (CUDA events, interleaved K7, K8, K8, K7) of the
            bf16 masked sweep (K7), the maskless sweep and its subtraction
            (K8) and the exact instances of both; K7 bf16 against its plain
            default version (within the bf16 near-threshold count) and
            K7 == K8 sweep - subtraction; the sweeps' registers, spill
            bytes, shared memory and blocks an SM; the AttRH default ranker's busy time a call (masked and
            maskless; torch.profiler, 5 calls) on a model of the shape;
  proofs    (--proofs, trees that have them) the fast paths against
            __fsqrt_rn / __fdiv_rn (fast_arith_sweep) and the batched
            epilogue's scores against score_from_radii's on this batch,
            bit for bit (attrh_scores_bf16);
  sass      (--sass) cuobjdump -sass of the tree's libhyp_rank.so: each bf16
            sweep kernel's instructions, in all and between barriers (the
            segment with the most MUFU is the epilogue's), and, compiled
            from scripts/attrh_epilogue_probe.cu, the instructions of one
            pair through score_from_radii (IEEE, the epilogue scored in
            place) and through attrh_score with FastArith (a pair of the
            batched epilogue), less the probes' loads and store;
  clocks    (--clocks) the SM clock and power draw (nvidia-smi every 200 ms)
            while K7 bf16 runs back to back for 3 s, and its launches;
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
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = Path(__file__).resolve().parent


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


def bf16_inputs(seed: int) -> dict:
    """torch_hyp_rank_bench's AttRH inputs at the WN18RR shape, with lhs and
    rhs as the default rankers' bf16 rows (each half padded on its own) and
    the exact instances' float32 rows beside them."""
    import torch_hyp_rank_bench as HB

    from complexhyperbolickge_torch.kernels._ranker import bf16_rows

    t = HB.inputs("attrh", "wn18rr", seed)
    t["lhs_f32"], t["rhs_f32"] = t["lhs"], t["rhs"]
    t["lhs"], t["rhs"] = bf16_rows(t["lhs"], True), bf16_rows(t["rhs"], True)
    return t


SWEEP = ("lhs", "x2r", "x2f", "cid", "cvals", "w0", "w1", "t2", "rhs", "un_rot", "un_ref", "bt",
         "radii")
SUB = ("lhs", "x2r", "x2f", "c", "w0", "w1", "t2", "rhs", "un_rot", "un_ref", "bt")


def calls(t: dict) -> dict:
    """name -> a function of no arguments."""
    from complexhyperbolickge_torch.kernels import hyp_rank as H

    d = {"precision": "default"}
    sw, sb = [t[k] for k in SWEEP], [t[k] for k in SUB]
    ex = {**t, "lhs": t["lhs_f32"], "rhs": t["rhs_f32"]}
    esw, esb = [ex[k] for k in SWEEP], [ex[k] for k in SUB]
    return {
        "K7_bf16": lambda: H.attrh_rank_counts(*sw, t["mask"], **d),
        "K8_bf16_sweep": lambda: H.attrh_rank_sweep_nomask(*sw, t["gold"], **d),
        "K8_bf16_sub": lambda: H.attrh_rank_filtered_sub(*sb, t["fidx"], t["gold"], **d),
        "K7_exact": lambda: H.attrh_rank_counts(*esw, t["mask"]),
        "K8_exact_sweep": lambda: H.attrh_rank_sweep_nomask(*esw, t["gold"]),
    }


def times(t: dict, reps: int, seed: int) -> dict:
    import torch

    import chip_smoke as S
    import torch_hyp_rank_bench as HB
    from complexhyperbolickge_torch.kernels import hyp_rank as H
    from complexhyperbolickge_torch.kernels._ranker import (
        TC_REL,
        near_threshold,
        score_interval,
    )

    fns = calls(t)
    masked, sweep, sub = fns["K7_bf16"](), fns["K8_bf16_sweep"](), fns["K8_bf16_sub"]()
    plain = H.attrh_rank_counts_plain(*[t[k] for k in SWEEP], t["mask"], "default")
    near = near_threshold(*score_interval("attrh", t, TC_REL), t["t2"])
    torch.cuda.synchronize()
    ms = {}
    for name in ("K7_bf16", "K8_bf16_sweep", "K8_bf16_sub", "K7_exact", "K8_exact_sweep",
                 "K8_exact_sweep", "K7_exact", "K8_bf16_sub", "K8_bf16_sweep", "K7_bf16"):
        ms.setdefault(name, []).append(cuda_ms(fns[name], reps))
    dev = torch.device("cuda")
    width = {"default": int(t["lhs"].shape[1]), "highest": int(t["lhs_f32"].shape[1])}
    info = {f"{'masked' if m else 'maskless'}_{p}": H.sweep_info(
        "attrh", dev, width[p], masked=m, precision=p)
        for m in (True, False) for p in ("default", "highest")}
    model, q, f = HB.model_and_batch("attrh", "wn18rr", seed)
    busy = {}
    for m in (True, False):
        ranker = H.AttRHRanker(model, masked=m, precision="default")
        ranker(q, f)  # tables and warm-up
        prof = S.profile_window(lambda: [ranker(q, f) for _ in range(5)])
        busy["masked" if m else "maskless"] = prof["device_busy_ms"] / 5
    return {"ms": ms, "sweep_info": info,
            "masked_equals_sweep_minus_sub": bool(torch.equal(masked, sweep - sub)),
            "max_abs_err_vs_plain": int((masked - plain).abs().max()),
            "within_near_threshold": bool(((masked - plain).abs() <= near).all()),
            "ranker_busy_ms_per_call": busy}


def clocks(t: dict, seconds: float = 3.0) -> dict:
    import torch

    fn = calls(t)["K7_bf16"]
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


def proofs(t: dict) -> dict:
    import torch

    from complexhyperbolickge_torch.kernels import hyp_rank as H

    out = {"fast_arith": H.fast_arith_sweep("cuda")}
    args = [t[k] for k in SWEEP if k != "t2"]
    fast, ieee = H.attrh_scores_bf16(*args), H.attrh_scores_bf16(*args, ieee=True)
    torch.cuda.synchronize()
    out["scores"] = {"pairs": fast.numel(),
                     "mismatches": int((fast.view(torch.int32) != ieee.view(torch.int32)).sum())}
    out["ok"] = (out["fast_arith"]["sqrt_mismatches"] == 0
                 and out["fast_arith"]["quot_mismatches"] == 0
                 and out["scores"]["mismatches"] == 0)
    return out


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


def sass(lib: Path) -> dict:
    """The AttRH bf16 sweeps' instructions, and the one-pair probes'."""
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
    probe = ROOT / "build" / "attrh_probe" / "attrh_epilogue_probe.cubin"
    probe.parent.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_build._nvcc(), *flags, "-cubin", "-o", str(probe),
                    str(SCRIPTS / "attrh_epilogue_probe.cu")], check=True, capture_output=True)
    pf = sass_functions(probe)
    base = main_body(pf["attrh_pair_base"])
    overhead = len(base) - sum(op.startswith("FADD") for op in base)
    out["probes"] = {"overhead": overhead}
    for name in ("attrh_pair_ieee", "attrh_pair_fast"):
        ops = main_body(pf[name])
        out["probes"][name] = {"instructions": len(ops), "per_pair": len(ops) - overhead,
                               "branches": sum(op.startswith(("BRA", "CALL")) for op in ops),
                               "histogram": histogram(ops)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", default=str(ROOT))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--sass", action="store_true")
    p.add_argument("--proofs", action="store_true")
    p.add_argument("--clocks", action="store_true")
    a = p.parse_args(argv)
    sys.path.insert(0, str(SCRIPTS))
    import torch_hyp_rank_bench  # noqa: F401  (puts this tree first on sys.path)

    sys.path.insert(0, str(Path(a.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_attrh_bf16_bench: needs a CUDA card")
    from complexhyperbolickge_torch.kernels import _build
    from complexhyperbolickge_torch.kernels import hyp_rank as H

    _build.build_all(["hyp_rank"])
    t = bf16_inputs(a.seed)
    ok = True
    row = {"tree": a.tree, **times(t, a.reps, a.seed)}
    print(json.dumps(row), flush=True)
    ok &= row["masked_equals_sweep_minus_sub"] and row["within_near_threshold"]
    if a.proofs and hasattr(H, "fast_arith_sweep"):
        row = {"tree": a.tree, "proofs": proofs(t)}
        print(json.dumps(row), flush=True)
        ok &= row["proofs"]["ok"]
    if a.clocks:
        print(json.dumps({"tree": a.tree, "clocks": clocks(t)}), flush=True)
    if a.sass:
        lib = Path(_build.BUILD_DIR) / "libhyp_rank.so"
        print(json.dumps({"tree": a.tree, "sass": sass(lib)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
