"""Without a card the command prints no result and exits non-zero (no
fallback to the CPU), and beside no program it cannot run a cell."""

import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT


def test_run_without_a_card_fails():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal is the CPU-only path")
    out = subprocess.run([sys.executable, "kgbench/run.py", "--workload", "fftroth-wn18rr.train",
                          "--seed", "5", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "torch.cuda.is_available() is false" in out.stderr


def test_benchmark_alone_has_no_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "kgbench", tmp_path / "kgbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    code = ("import sys; sys.path.insert(0, '.'); sys.path.insert(0, 'kgbench')\n"
            "import run\n"
            "from kgbench import harness\n"
            "run.run_cell('fftroth-wn18rr.train', 1, 0.1, False, 'cpu',"
            " harness.benchmark_spec())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert "No module named 'complexhyperbolickge_torch'" in out.stderr
    with pytest.raises(json.JSONDecodeError):
        json.loads(out.stdout.strip().splitlines()[-1] if out.stdout.strip() else "")
