#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (complexhyperbolickge_torch) on one
NVIDIA GPU, at the width of the paper's model: FFTRotH, rank 33 (a 40,943 x
66 f32 entity table), bias=learn, multi_c, eval batch 500, on a synthetic KG
with WN18RR's shapes (40,943 entities, 11 relations, 86,835 / 3,034 / 3,134
train / valid / test triples).  Weights and data are drawn from --seed.

    python3 chip_smoke.py [--seed 0]

Phases, one JSON line each; any failure exits non-zero without the final
line:
  1 device   the card (torch.cuda), then nvidia-smi's name and power limit
  2 build    nvcc builds every kernel from csrc/ (one nvcc per source)
  3 kernels  each CUDA kernel against its plain PyTorch version at the main
             path's batch shapes; the maskless count must equal the masked
  4 kge-test cli.test.test() with the auto (masked kernel), pallas_maskless
             and dense rankers: MRR equal within 1e-4, fused ranks identical;
             plus whole-split ranking throughput per ranker
  5 serve    PredictService top-k (filtered and unfiltered) against the argmax
             of the dense score_all, and one POST /predict over HTTP
  6 launches  each kernel's launches on the main path (phases 4-5, counted
             from 0); a kernel that never launched fails the run
  7 profile   torch.profiler over one whole-split ranking per ranker: wall
             time, device busy time and idle share, top kernels and host ops
  8 the kernels line: launches, and the times of kernel, plain version and
             dense ranker beside the kernel's bound
  9 {"ok": true, "device": {...}}
Needs no network; the HTTP server listens on 127.0.0.1 and is shut down.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
import traceback
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

WN18RR = dict(synthetic_entities=40943, synthetic_relations=11,
              synthetic_train=86835, synthetic_valid=3034, synthetic_test=3134)
RANK, BATCH = 33, 500
REPS = 5  # timed repetitions of a whole-split ranking

# peak rates by card, from NVIDIA's data sheets (dense, no sparsity): fp32
# outside the tensor cores (the kernels are exact fp32) and memory bandwidth
PEAKS = {"H100 PCIe": (51.2e12, 2.0e12), "H100 NVL": (60.0e12, 3.9e12),
         "H100": (67.0e12, 3.35e12), "H200": (67.0e12, 4.8e12)}

KERNEL_META = {
    "chyp_rank_sweep_masked": "complexhyperbolickge_tpu/kernels/chyp_rank.py:147",
    "chyp_rank_sweep_nomask": "complexhyperbolickge_tpu/kernels/chyp_rank.py:213",
    "chyp_rank_filtered_sub": "complexhyperbolickge_tpu/kernels/chyp_rank.py:230",
}
SOURCE = "complexhyperbolickge_torch/kernels/csrc/chyp_rank.cu"


def emit(obj):
    print(json.dumps(obj), flush=True)


def peak_rates(name: str):
    for key in ("H100 PCIe", "H100 NVL", "H200", "H100"):
        if key.replace(" ", "").lower() in name.replace(" ", "").lower():
            return PEAKS[key]
    return PEAKS["H100"]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `reps` back-to-back calls (CUDA events).
    The stream first sleeps ~0.1 s on the card while the host enqueues all
    calls, so the host's launch overhead does not open gaps between them."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    return name, smi


def phase_build():
    from complexhyperbolickge_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for log in _build.build_logs.values()
             for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": secs, "sources": list(_build.SOURCES),
          "ptxas": ptxas})


def write_run(seed: int) -> str:
    """A run dir as the trainer writes it: config.json and state.pkl with
    FFTRotH weights drawn from `seed` (entity ~ N(0, 0.1) keeps the points
    well inside the ball and the scores distinct).  Random weights rank the
    gold near N/2, so the test answers are planted: each test tail's row is
    set to its (head, rel) query point, which puts the gold at distance ~0
    wherever the head's own row was not overwritten after.  Tail prediction
    then finds most golds at rank 1, and MRR says whether ranking works."""
    import numpy as np
    import torch

    from complexhyperbolickge_torch.cli.run import build_model, load_dataset
    from complexhyperbolickge_torch.train.checkpoint import save_checkpoint

    args = dict(dataset="synthetic", synthetic_seed=seed, data_path="data",
                debug=False, model="FFTRotH", rank=RANK, init_size=1e-3,
                bias="learn", gamma=0.0, multi_c=True, dtype="float32",
                dropout=0.0, eval_batch_size=BATCH, eval_backend="auto",
                eval_precision="highest", **WN18RR)
    ns = argparse.Namespace(**args)
    dataset = load_dataset(ns)
    model = build_model(ns, dataset, "cpu")
    rng = np.random.default_rng(seed)
    spread = {"entity": 0.1, "rel": 0.1, "bh": 0.1, "bt": 0.1, "c": 0.05}
    params = {}
    for k, v in model.state_dict().items():
        if k == "rel_diag":
            x = rng.uniform(-1.0, 1.0, v.shape)
        else:
            x = rng.normal(0.0, spread[k], v.shape) + (1.0 if k == "c" else 0.0)
        params[k] = torch.as_tensor(x, dtype=torch.float32)
    model.load_state_dict(params)
    test = dataset.get_examples("test").astype(np.int64)
    # a tail shared by several test triples takes its last triple's point
    # (chosen here: index_put with repeated indices picks no fixed winner)
    first_from_end = np.unique(test[::-1, 2], return_index=True)[1]
    test = torch.as_tensor(test[len(test) - 1 - first_from_end])
    with torch.no_grad():
        (lhs,), _ = model.get_queries(test[:, :2])
    params["entity"][test[:, 2]] = lhs
    WORK.mkdir(parents=True, exist_ok=True)
    save_checkpoint(str(WORK), params, config={"args": args})
    return str(WORK)


def near_threshold(scores, t2):
    """Per query: entities whose plain score is within 1e-5 (1 + |t2|) of t2."""
    return ((scores - t2[:, None]).abs() <= (1e-5 * (1 + t2.abs()))[:, None]).sum(1)


def phase_kernels(model, dataset):
    """Each kernel against its plain version on one main-path batch."""
    import torch

    from complexhyperbolickge_torch.kernels import chyp_rank as K

    dev = next(model.parameters()).device
    pack = dataset.eval_pack("test", "rhs")
    q = torch.as_tensor(pack.queries[:BATCH], dtype=torch.int64, device=dev)
    f = torch.as_tensor(pack.filter_idx[:BATCH], dtype=torch.int64, device=dev)
    ranker = K.ChypRanker(model)
    xm = ranker.kernel_inputs(q, f, masked=True)
    xn = ranker.kernel_inputs(q, f, masked=False)
    base = [xm[k] for k in ("lhs2", "zn", "t2", "rhs", "wn", "bt")]
    scores = K.chyp_scores_plain(*base[:2], *base[3:])
    near = near_threshold(scores, xm["t2"])
    pairs = {
        "chyp_rank_sweep_masked": (K.chyp_rank_counts, K.chyp_rank_counts_plain,
                                   [xm["mask"]]),
        "chyp_rank_sweep_nomask": (K.chyp_rank_sweep_nomask,
                                   K.chyp_rank_sweep_nomask_plain, [xn["gold"]]),
        "chyp_rank_filtered_sub": (K.chyp_rank_filtered_sub,
                                   K.chyp_rank_filtered_sub_plain,
                                   [xn["fidx"], xn["gold"]]),
    }
    result = {"phase": "kernels", "batch": BATCH, "Np": int(xm["rhs"].shape[0]),
              "D": int(xm["rhs"].shape[1]), "L": int(xn["fidx"].shape[1]),
              "max_near_threshold": int(near.max()), "kernels": {}}
    errors = {}
    for name, (kernel, plain, extra) in pairs.items():
        got = kernel(*base, *extra)
        want = plain(*base, *extra)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        errors[name] = int(diff.max())
        result["kernels"][name] = {"max_abs_err": errors[name],
                                   "queries_differing": int((diff > 0).sum()),
                                   "within_tolerance": bool((diff <= near).all())}
        if not (diff <= near).all():
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"beyond the near-threshold count: {result}")
    k1 = K.chyp_rank_counts(*base, xm["mask"])
    k2 = K.chyp_rank_counts_nomask(*base, xn["fidx"], xn["gold"])
    result["maskless_equals_masked"] = bool(torch.equal(k1, k2))
    emit(result)
    if not result["maskless_equals_masked"]:
        raise AssertionError("K2 (sweep - subtraction) != K1 on a batch whose "
                             "golds are all filtered")
    return (q, f, xm, xn), errors


def phase_kge_test(model_dir, model, dataset):
    """kge-test end to end with each ranker, then whole-split throughput."""
    import numpy as np
    import torch

    from complexhyperbolickge_torch.cli.test import test
    from complexhyperbolickge_torch.train.evaluate import get_ranking, make_best_ranker

    out = {"phase": "kge-test", "split": "test", "batch": BATCH, "backends": {}}
    for backend in ("auto", "pallas_maskless", "dense"):
        t0 = time.perf_counter()
        m = test(model_dir, device="cuda", eval_backend=backend)
        out["backends"][backend] = {"MRR": m["MRR"], "MR": m["MR"],
                                    "hits@[1,3,10]": m["hits@[1,3,10]"],
                                    "cli_seconds": time.perf_counter() - t0}
    mrrs = [v["MRR"] for v in out["backends"].values()]
    if not all(np.isfinite(mrrs)) or not 0.0 < min(mrrs) <= 1.0:
        raise AssertionError(f"bad MRR values: {out}")
    # tail prediction finds most planted golds at rank 1 (write_run); head
    # prediction stays near chance, so the mean of both is ~0.45
    if min(mrrs) < 0.25:
        raise AssertionError(f"the planted test answers were not found: {out}")
    if max(mrrs) - min(mrrs) > 1e-4:
        raise AssertionError(f"rankers disagree on MRR beyond 1e-4: {out}")

    # whole-split ranking throughput (both directions; median of REPS runs,
    # host clocks on a shared host vary), and rank identity of the two
    # fused rankers
    packs = [dataset.eval_pack("test", d) for d in ("rhs", "lhs")]
    n_q = sum(len(p.queries) for p in packs)
    n_b = sum(-(-len(p.queries) // BATCH) for p in packs)
    ranks = {}
    for backend in ("auto", "pallas_maskless", "dense"):
        rank_fn = make_best_ranker(model, BATCH, backend)
        get_ranking(model, packs[0], BATCH, rank_fn=rank_fn)  # warm-up
        secs = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ranks[backend] = [get_ranking(model, p, BATCH, rank_fn=rank_fn) for p in packs]
            secs.append(time.perf_counter() - t0)
        secs.sort()
        out["backends"][backend].update(
            {"queries_per_s": n_q / secs[REPS // 2],
             "ms_per_batch": 1e3 * secs[REPS // 2] / n_b,
             "ms_per_batch_min_max": [1e3 * secs[0] / n_b, 1e3 * secs[-1] / n_b]})
    out["queries"] = n_q
    out["fused_ranks_identical"] = all(
        np.array_equal(a, b) for a, b in zip(ranks["auto"], ranks["pallas_maskless"]))
    out["fused_vs_dense_rank_mismatches"] = int(sum(
        (a != b).sum() for a, b in zip(ranks["auto"], ranks["dense"])))
    emit(out)
    if not out["fused_ranks_identical"]:
        raise AssertionError("masked and maskless fused rankers gave different ranks")


def phase_serve(model_dir):
    import numpy as np
    import torch

    from complexhyperbolickge_torch.cli.predict import known_tail_filters
    from complexhyperbolickge_torch.cli.serve import PredictService, make_server

    svc = PredictService(model_dir, k=10, batch=32, device="cuda")
    rng = np.random.default_rng(1)
    ds = svc.dataset
    q = [[int(h), int(r)] for h, r in zip(rng.integers(0, ds.n_entities, 12),
                                           rng.integers(0, ds.n_predicates, 12))]
    qt = torch.as_tensor(q, device=svc.device)
    with torch.no_grad():
        dense = svc.model.score_all(qt)
    filtered = dense.clone()
    for i, row in enumerate(known_tail_filters(ds, q).tolist()):
        filtered[i, [t for t in row if t < ds.n_entities]] = -torch.inf
    checks = {}
    for filter_known, ref in ((False, dense), (True, filtered)):
        got = svc.predict(q, filter_known=filter_known)
        top1 = [g["tails"][0] for g in got]
        checks[f"top1_matches_dense_argmax_filter_{filter_known}"] = (
            top1 == ref.argmax(1).tolist())
    lat = []
    for i in range(20):
        t0 = time.perf_counter()
        svc.predict([q[i % len(q)]])
        lat.append(1e3 * (time.perf_counter() - t0))

    srv = make_server(svc, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        body = json.dumps({"queries": q[:4], "k": 5, "filter_known": True}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/predict", data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            http_status, http_out = r.status, json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    checks["http_matches_service"] = (
        http_status == 200 and http_out == svc.predict(q[:4], k=5, filter_known=True))
    lat.sort()
    emit({"phase": "serve", "requests": len(q) * 2 + 20 + 1, **checks,
          "single_query_latency_ms_p50": lat[len(lat) // 2],
          "single_query_latency_ms_max": lat[-1]})
    if not all(checks.values()):
        raise AssertionError(f"serving checks failed: {checks}")


def phase_profile(model, dataset):
    """Where a whole-split ranking's time goes: torch.profiler over the test
    split (both directions) per ranker; device busy time is the union of the
    CUDA kernels' intervals, idle share = 1 - busy / wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from complexhyperbolickge_torch.train.evaluate import get_ranking, make_best_ranker

    packs = [dataset.eval_pack("test", d) for d in ("rhs", "lhs")]
    out = {"phase": "profile", "split": "test", "batch": BATCH, "rankers": {}}
    for backend in ("auto", "pallas_maskless", "dense"):
        rank_fn = make_best_ranker(model, BATCH, backend)
        for p in packs:  # warm-up
            get_ranking(model, p, BATCH, rank_fn=rank_fn)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for p in packs:
                get_ranking(model, p, BATCH, rank_fn=rank_fn)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        kern = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
        busy, end, by_name = 0.0, float("-inf"), {}
        for e in kern:
            s, f = e.time_range.start, e.time_range.end
            busy += max(0.0, f - max(s, end))
            end = max(end, f)
            by_name[e.name] = by_name.get(e.name, 0.0) + (f - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out["rankers"][backend] = {
            "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3 if kern else "not measured",
            "device_idle_share": 1.0 - busy / wall_us if kern else "not measured",
            "device_kernels": len(kern),
            "top_kernels_ms": {n[:80]: t / 1e3 for n, t in top},
            "top_host_ops_self_ms": {
                e.key[:60]: e.self_cpu_time_total / 1e3
                for e in sorted(prof.key_averages(),
                                key=lambda e: -e.self_cpu_time_total)[:8]},
        }
    emit(out)


def phase_kernel_line(model, batch, launches, errors, smi, name):
    """Times of each kernel and its plain version on the main path's batch,
    beside the kernel's bound; dense_ms is the dense ranker's device time
    per batch and ranker_ms that of the fused ranker that launches the
    kernel, both with the query prep."""
    import numpy as np

    from complexhyperbolickge_torch.kernels import chyp_rank as K
    from complexhyperbolickge_torch.train.evaluate import make_ranker

    q, f, xm, xn = batch
    base = [xm[k] for k in ("lhs2", "zn", "t2", "rhs", "wn", "bt")]
    b, d = base[0].shape[0] // 2, base[0].shape[1]
    np_ = base[3].shape[0]
    l = xn["fidx"].shape[1]
    flops_peak, bw_peak = peak_rates(name)
    # whole rankers per batch, query prep included (~200 launches a call, so
    # few reps: the stream's queue of pending launches is bounded)
    dense = make_ranker(model)
    dense_ms = cuda_ms(lambda: dense(q, f), reps=4)
    ranker_ms = {}
    for masked in (True, False):
        ranker = K.ChypRanker(model, masked=masked)
        ranker_ms[masked] = cuda_ms(lambda: ranker(q, f), reps=4)
    n_rows = int(np.unique(xn["fidx"].cpu().numpy()).size)
    vec = 4 * (2 * b * d + 2 * b + 2 * np_ + np_ * d)  # lhs2, zn, t2, wn, bt, rhs
    work = {
        "chyp_rank_sweep_masked": (K.chyp_rank_counts, K.chyp_rank_counts_plain,
                                   [xm["mask"]], 4 * b * np_ * d,
                                   vec + b * np_ + 4 * b),
        "chyp_rank_sweep_nomask": (K.chyp_rank_sweep_nomask,
                                   K.chyp_rank_sweep_nomask_plain, [xn["gold"]],
                                   4 * b * np_ * d, vec + 4 * b + 4 * b),
        "chyp_rank_filtered_sub": (K.chyp_rank_filtered_sub,
                                   K.chyp_rank_filtered_sub_plain,
                                   [xn["fidx"], xn["gold"]], 4 * b * l * d,
                                   4 * (2 * b * d + 2 * b + n_rows * (d + 2))
                                   + 4 * b * l + 8 * b),
    }
    rows = []
    for kname, (kernel, plain, extra, flops, nbytes) in work.items():
        t_flops, t_bytes = flops / flops_peak * 1e3, nbytes / bw_peak * 1e3
        rows.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": KERNEL_META[kname], "launches": launches[kname],
            "max_abs_err": errors[kname],
            "ms": cuda_ms(lambda: kernel(*base, *extra), reps=50),
            "plain_ms": cuda_ms(lambda: plain(*base, *extra)),
            "bound_ms": max(t_flops, t_bytes),
            "bound_by": "operations" if t_flops >= t_bytes else "bytes",
            "library_ms": None, "dense_ms": dense_ms,
            "ranker_ms": ranker_ms[kname == "chyp_rank_sweep_masked"],
            "shape": {"B": b, "Np": np_, "D": d, "L": l}, "card": smi,
        })
    emit({"kernels": rows})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    try:
        import complexhyperbolickge_torch  # noqa: F401  the port beside this script

        name, smi = phase_device()
        phase_build()

        import torch

        from complexhyperbolickge_torch.cli.predict import load_serving_state
        from complexhyperbolickge_torch.kernels import chyp_rank as K

        model_dir = write_run(a.seed)
        model, dataset = load_serving_state(model_dir, "cuda")
        batch, errors = phase_kernels(model, dataset)

        K.reset_launches()  # the main path starts here
        phase_kge_test(model_dir, model, dataset)
        phase_serve(model_dir)
        launches = dict(K.launches)  # ... and ends here
        emit({"phase": "launches", **launches})
        if not all(launches.values()):
            raise AssertionError(f"a kernel of the main path never launched: {launches}")

        phase_profile(model, dataset)
        phase_kernel_line(model, batch, launches, errors, smi, name)
        torch.cuda.synchronize()
    except (Exception, SystemExit):  # report, then fail without the ok line
        traceback.print_exc()
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
