"""The port stands alone: no module of complexhyperbolickge_torch, and not
chip_smoke.py, imports jax, optax or complexhyperbolickge_tpu — checked on
the source (AST scan, the GNN modules and kernels included) and at run time
(a fresh interpreter loads and ranks JAX-written FFTRotH and PoincareGCN
checkpoints, with their pickled optax state, through the port).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax

from complexhyperbolickge_tpu.train import checkpoint as jax_ckpt

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "optax", "chex", "complexhyperbolickge_tpu"}


def _port_sources():
    files = sorted((ROOT / "complexhyperbolickge_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax():
    files = _port_sources()
    assert len(files) > 10 and files[-1].exists()
    names = {str(f.relative_to(ROOT / "complexhyperbolickge_torch")) for f in files[:-1]}
    assert {"kernels/segsum.py", "kernels/gather.py", "models/gnn/message.py",
            "models/gnn/convs.py", "models/gnn/models.py", "utils/nn.py"} <= names
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & FORBIDDEN)
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_port_scripts_import_no_jax():
    """The port's scripts (scripts/torch_*.py, the rehearsal leg among
    them) stand alone too, as do the modules of the losses, SparseAdam and
    the Euclidean and complex families."""
    scripts = sorted((ROOT / "scripts").glob("torch_*.py"))
    assert ROOT / "scripts" / "torch_rehearsal_leg.py" in scripts
    pkg = ROOT / "complexhyperbolickge_torch"
    new = [pkg / p for p in ("train/sparse_adam.py", "train/losses.py", "models/euclidean.py",
                             "models/complexm.py", "data/preprocess.py")]
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & FORBIDDEN)
           for f in scripts + new}
    assert not {k: v for k, v in bad.items() if v}


def test_jax_checkpoint_loads_and_ranks_without_jax(tmp_path):
    rng = np.random.default_rng(0)
    n, nr, rank = 60, 22, 5
    shapes = {"entity": (n, 2 * rank), "rel": (nr, 4 * (rank - 1)), "bh": (n, 1),
              "bt": (n, 1), "rel_diag": (nr, 2 * (rank - 1)), "c": (1, 1)}
    params = {k: jax.numpy.asarray(rng.normal(0, 0.1, s).astype(np.float32) + (k == "c"))
              for k, s in shapes.items()}
    args = dict(dataset="synthetic", synthetic_entities=n, data_path="data", debug=False,
                model="FFTRotH", rank=rank, init_size=1e-3, bias="learn", gamma=0.0,
                multi_c=False, dtype="float32", dropout=0.0, eval_batch_size=32,
                eval_backend="auto", eval_precision="highest")
    jax_ckpt.save_checkpoint(str(tmp_path), params, optax.adam(1e-3).init(params),
                             epoch=1, best_mrr=0.1, config={"args": args})
    code = (
        "import sys\n"
        "from complexhyperbolickge_torch.train.checkpoint import load_checkpoint\n"
        "from complexhyperbolickge_torch.cli.test import test\n"
        f"state = load_checkpoint({str(tmp_path)!r})\n"
        "assert state['opt_state'] is not None\n"
        f"m = test({str(tmp_path)!r}, device='cpu')\n"
        "assert 0.0 < m['MRR'] <= 1.0, m\n"
        "leaked = sorted({k.split('.')[0] for k in sys.modules}"
        f" & set({sorted(FORBIDDEN)!r}))\n"
        "assert not leaked, leaked\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stdout + out.stderr


def test_jax_gnn_checkpoint_loads_ranks_and_serves_without_jax(tmp_path):
    """A JAX-written PoincareGCN dir (nested params["gnn"], optax state)
    through the port's kge-test and predict in a fresh interpreter: no JAX
    module is loaded."""
    from complexhyperbolickge_tpu.cli.run import build_model, build_parser, load_dataset

    args = build_parser().parse_args([
        "--dataset", "synthetic", "--synthetic_entities", "50", "--model", "PoincareGCN",
        "--rank", "6", "--hidden_dim", "8", "--bias", "learn", "--multi_c",
        "--dtype", "float32", "--eval_batch_size", "32"])
    params = build_model(args, load_dataset(args)).init(jax.random.PRNGKey(0))
    jax_ckpt.save_checkpoint(str(tmp_path), params, optax.adam(1e-3).init(params),
                             epoch=1, best_mrr=0.1, config={"args": vars(args)})
    code = (
        "import sys\n"
        "from complexhyperbolickge_torch.cli.test import test\n"
        "from complexhyperbolickge_torch.cli.predict import predict\n"
        f"m = test({str(tmp_path)!r}, device='cpu')\n"
        "assert 0.0 < m['MRR'] <= 1.0, m\n"
        f"out = predict({str(tmp_path)!r}, [(1, 2)], k=3, device='cpu')\n"
        "assert len(out[0]['tails']) == 3\n"
        "leaked = sorted({k.split('.')[0] for k in sys.modules}"
        f" & set({sorted(FORBIDDEN)!r}))\n"
        "assert not leaked, leaked\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stdout + out.stderr
