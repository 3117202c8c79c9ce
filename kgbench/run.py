#!/usr/bin/env python3
"""One run of one cell of the port's benchmark on the card it starts on.

    python3 kgbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the graph and weights from the seed, the program's
kernels loaded, built on a checkout's first run, its tables and packs,
warm-up, and for a training cell its first steps, read for the check) is
timed from the start of this process to the first timed call: `setup_s`.
The window then drives the program for --seconds.  With --trace 1 a short
sub-window inside it runs under torch.profiler and the cell's per-layer
metrics are read; with --trace 0 its end-to-end metrics.  After the
window, with the peak memory read and the program's state freed, the plain
reference judges what the window produced.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, (--trace 1) breakdown, and checks, each number
compared beside its limit; the checks are also the last lines of standard
error.  Without a card (torch.cuda.is_available() false, or fewer cards
than the cell asks for), or without the program beside the benchmark, the
run prints no result and exits non-zero; so it does if jax, jaxlib, flax
or the JAX package is loaded once the window has closed.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the kernel and compiler caches of anything the run loads, at fixed paths
# inside the checkout (the program builds its own kernels into build/kernels)
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "CUDA_CACHE_PATH": "nv_compute_cache"}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str, spec: dict,
             dirs=None, t0: float = _T0) -> dict:
    """One run of cell `name`; returns the result object."""
    import torch

    from kgbench import harness
    from kgbench.trace import Spans, busy_us, idle_gaps, top_device_ops

    cell = harness.Cell.load(name, seed, device, dirs)
    import complexhyperbolickge_torch  # noqa: F401  (the system under test)

    if cuda := device.startswith("cuda"):
        torch.zeros(1, device=device)  # the CUDA context

    traffic = harness.load_module("traffic", cell.traffic)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    spans = Spans()
    parts = {"before the cell (interpreter, imports, CUDA context)": time.perf_counter() - t0}
    session = traffic.Session(cell, spans)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    win = session.window(seconds, profile=trace)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    session.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    correct, checks = harness.check_lines(session.check(), cell.limits)

    out_metrics = {}
    if not trace:
        values = {"setup_s": setup_s, **win["end_to_end"]}
        for m in harness.cell_metrics(spec, name, "end_to_end"):
            out_metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        from kgbench.metrics_api import Reading

        reading = Reading(cell, win["trace"], spans, win["info"],
                          torch.cuda.get_device_name() if cuda else "cpu")
        for m in harness.cell_metrics(spec, name, "per_layer"):
            v = harness.load_module("metrics", m["name"]).read(reading)
            if v is not None:
                out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(win["attempted"]),
              "failed": int(win["failed"]), "metrics": out_metrics, "device": dev}
    tr = win.get("trace")
    if trace and tr is not None:
        dev["busy_s"] = busy_us(tr.device_ops) / 1e6
        dev["window_s"] = tr.wall_s
        result["breakdown"] = {"device_ops": top_device_ops(tr), "idle_gaps": idle_gaps(tr)}
    parts.update((s.name, s.seconds) for s in spans.records if s.name.startswith("setup."))
    result["setup_parts"] = parts
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "kgbench" / sub)

    from kgbench import harness

    spec = harness.benchmark_spec()
    entry = {w["name"]: w for w in spec["workloads"]}.get(args.workload)
    if entry is None:
        print(f"kgbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("kgbench: torch.cuda.is_available() is false; the benchmark runs on a card "
              "and has no CPU fallback", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < entry["chips"]:
        print(f"kgbench: {args.workload} needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", spec)
    found = harness.forbidden_modules()
    if found:
        print(f"kgbench: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 4
    for name, secs in result.pop("setup_parts").items():
        print(f"setup {name}: {secs:.3f} s", file=sys.stderr)
    print(f"correct = {result['correct']}; the numbers compared:", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
