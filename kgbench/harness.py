"""What every cell of the benchmark shares: finding a cell's files by name,
loading its modules, the statistics of the end-to-end metrics, and the
result line.

A cell (an entry of BENCHMARK.json's `workloads`) is found by name:
`workloads/<cell>.json` names its configuration, its traffic kind, the
traffic's parameters and the limits of its correctness numbers;
`configs/<config>.json` holds the configuration as it is run;
`traffic/<kind>.py` builds the inputs from the seed and drives the window;
`reference/<config>.py` is the configuration's plain reference; and
`metrics/<metric>.py` reads one per-layer metric.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import statistics
import sys
from pathlib import Path

KGBENCH = Path(__file__).resolve().parent
ROOT = KGBENCH.parent
# top-level module names that no process of the benchmark may hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "complexhyperbolickge_tpu")


def load_json(kind: str, name: str, dirs=None) -> dict:
    """`<dir>/<kind>/<name>.json` from the first of dirs (default: the
    benchmark's folder) that has it."""
    for d in [*(dirs or ()), KGBENCH]:
        path = Path(d) / kind / f"{name}.json"
        if path.is_file():
            with open(path) as f:
                return json.load(f)
    raise FileNotFoundError(f"no {kind}/{name}.json")


def load_module(kind: str, name: str):
    """The module `kgbench/<kind>/<name>.py` (names may hold dots and
    dashes), imported once."""
    key = f"kgbench.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = KGBENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind}/{name}.py")
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def benchmark_spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(spec: dict, cell: str, section: str) -> list[dict]:
    """The entries of `section` ("end_to_end" or "per_layer") that cell
    reports: those without a `workloads` key and those that list it."""
    return [m for m in spec[section] if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Cell:
    """One run of one cell: its name, configuration (with the graph's
    counts as the model sees them: n_entities, n_relations with inverses),
    traffic kind and parameters, correctness limits, seed and device."""

    name: str
    config_name: str
    config: dict
    traffic: str
    params: dict
    limits: dict
    seed: int
    device: str

    @classmethod
    def load(cls, name: str, seed: int, device: str, dirs=None) -> "Cell":
        w = load_json("workloads", name, dirs)
        cfg = dict(load_json("configs", w["config"], dirs))
        cfg.update(n_entities=cfg["entities"], n_relations=2 * cfg["relations"])
        return cls(name, w["config"], cfg, w["traffic"], w.get("params", {}),
                   w.get("limits", {}), int(seed), device)

    @property
    def reference(self):
        return load_module("reference", self.config_name)


# --------------------------------- statistics ---------------------------------


def p95(values) -> float:
    """The 95th percentile of values (statistics' exclusive method)."""
    values = list(values)
    if len(values) < 2:
        return float(values[0]) if values else math.nan
    return statistics.quantiles(values, n=20)[18]


def forbidden_modules() -> list[str]:
    """Top-level module names in sys.modules that are FORBIDDEN_MODULES,
    compared whole (the part before the first dot)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def check_lines(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}); a
    number without a limit, or that is not finite, fails."""
    out, ok = {}, True
    for k, v in numbers.items():
        lim = limits.get(k)
        fine = lim is not None and math.isfinite(v) and v <= lim
        ok &= fine
        out[k] = {"value": v, "limit": lim}
    return ok and bool(numbers), out
