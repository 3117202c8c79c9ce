"""Nothing under kgbench/ imports jax, jaxlib, flax or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), nothing under kgbench/reference/ imports the port, and a run
leaves none of them in sys.modules."""

import ast
import subprocess
import sys

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "complexhyperbolickge_tpu"}
FILES = sorted((ROOT / "kgbench").rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & FORBIDDEN
    assert "import_module" not in path.read_text() or path.name == "test_kgbench_imports.py"


@pytest.mark.parametrize("path", sorted((ROOT / "kgbench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "complexhyperbolickge_torch" not in top_level_imports(path)
    assert "complexhyperbolickge" not in path.read_text()


def test_a_run_loads_no_jax(tiny_dir):
    code = (
        "import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/kgbench']\n"
        "import run\n"
        "from kgbench import harness\n"
        "r = run.run_cell('roth-wn18rr.rank', 3, 0.2, False, 'cpu', harness.benchmark_spec(),"
        " dirs=[sys.argv[2]])\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax',"
        " 'complexhyperbolickge_tpu'}), 'complexhyperbolickge_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), str(tiny_dir)],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"
