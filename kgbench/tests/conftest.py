"""Fixtures of the benchmark's CPU tests: the repository root on sys.path,
and the benchmark's cells cut to a size a test run holds (the same
traffic, reference and limits, a 2,000-entity graph)."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

TINY_CONFIG = dict(entities=2000, train_triples=4000, valid_triples=100, test_triples=200,
                   batch_size=64, neg_sample_size=8, eval_batch_size=50)
TINY_PARAMS = dict(sample_range=5, sample_passes=2)


@pytest.fixture(scope="session")
def tiny_dir(tmp_path_factory):
    """A directory of the cells' configuration and workload files at the
    tiny size, which harness.Cell.load(..., dirs=[it]) finds first."""
    d = tmp_path_factory.mktemp("tiny")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for kind in ("configs", "workloads"):
        (d / kind).mkdir()
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(TINY_CONFIG)
        (d / "configs" / f"{c['name']}.json").write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        spec = json.loads((ROOT / "kgbench" / "workloads" / f"{w['name']}.json").read_text())
        if spec["traffic"] == "rank_split":
            spec["params"].update(TINY_PARAMS)
        (d / "workloads" / f"{w['name']}.json").write_text(json.dumps(spec))
    return d
