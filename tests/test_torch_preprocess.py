"""The port's raw-text preprocess (data/preprocess.py) against the JAX
package's, and the port rehearsal script's copy of the rehearsal data
generator against the original.

The generator writes the MRR-gate rehearsal's reference-format raw KG
(tests/test_mrr_gate_rehearsal.py::write_raw_dataset); the port's pickles
of it must equal JAX's process_dataset's, array for array and filter for
filter, and KGData must read them.
"""

import importlib.util
import os
import pickle
from pathlib import Path

import numpy as np
import pytest

from complexhyperbolickge_torch.data import preprocess as P
from complexhyperbolickge_torch.data.dataset import KGData
from complexhyperbolickge_tpu.data import preprocess as JP

ROOT = Path(__file__).resolve().parents[1]


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def generators():
    """(the rehearsal test module, the port's rehearsal script)."""
    return (load(ROOT / "tests" / "test_mrr_gate_rehearsal.py", "_rehearsal_test"),
            load(ROOT / "scripts" / "torch_rehearsal_leg.py", "_torch_rehearsal_leg"))


def read_dir(d):
    return {name: (Path(d) / "WN18RR" / name).read_bytes()
            for name in ("train", "valid", "test")}


@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("seed", [7, 8])
def test_generator_copy_writes_the_same_files(generators, tmp_path, monkeypatch, seed, noisy):
    original, script = generators
    monkeypatch.setattr(original, "DATA_SEED", seed)
    original.write_raw_dataset(str(tmp_path / "a"), noisy=noisy)
    script.write_raw_dataset(str(tmp_path / "b"), noisy=noisy, data_seed=seed)
    a, b = read_dir(tmp_path / "a"), read_dir(tmp_path / "b")
    assert a == b and all(len(v) > 1000 for v in a.values())


def test_process_dataset_pickles_equal_jax(generators, tmp_path):
    _, script = generators
    raw = tmp_path / "raw"
    script.write_raw_dataset(str(raw), noisy=True, data_seed=7)
    ex_t, filt_t = P.process_dataset(str(raw / "WN18RR"), str(tmp_path / "port"))
    ex_j, filt_j = JP.process_dataset(str(raw / "WN18RR"), str(tmp_path / "jax"))
    for name in ("train.pickle", "valid.pickle", "test.pickle", "to_skip.pickle"):
        with open(tmp_path / "port" / name, "rb") as f:
            got = pickle.load(f)
        with open(tmp_path / "jax" / name, "rb") as f:
            want = pickle.load(f)
        if name == "to_skip.pickle":
            assert got == want and set(got) == {"lhs", "rhs"} and got["rhs"]
        else:
            assert got.dtype == want.dtype == np.int64
            np.testing.assert_array_equal(got, want)
    assert filt_t == filt_j
    for s in P.SPLITS:
        np.testing.assert_array_equal(ex_t[s], ex_j[s])
    data = KGData(str(tmp_path / "port"))
    assert data.get_shape() == (800, 40, 800)


def test_vocab_is_sorted_and_unknown_names_are_dropped(tmp_path):
    d = tmp_path / "kg"
    d.mkdir()
    (d / "train").write_text("b\tr2\ta\nc\tr1\tb\n")
    (d / "valid").write_text("a\tr1\tc\n")
    (d / "test").write_text("c\tr2\ta\n")
    ent, rel = P.build_vocab(str(d))
    assert ent == {"a": 0, "b": 1, "c": 2} and rel == {"r1": 0, "r2": 1}
    (tmp_path / "extra").write_text("a\tr1\tz\nc\tr2\tb\n")
    got = P.read_triples(str(tmp_path / "extra"), ent, rel)
    np.testing.assert_array_equal(got, [[2, 1, 1]])
    assert P.read_triples(str(d / "valid"), {}, {}).shape == (0, 3)


def test_main_preprocesses_every_complete_dir(tmp_path, monkeypatch, capsys):
    for name in ("A", "B"):
        d = tmp_path / name
        d.mkdir()
        for s in P.SPLITS:
            (d / s).write_text("x\tr\ty\n")
    (tmp_path / "incomplete").mkdir()
    monkeypatch.setenv("DATA_PATH", str(tmp_path))
    P.main()
    assert capsys.readouterr().out.split() == ["processing", "A", "processing", "B"]
    assert os.path.exists(tmp_path / "B" / "to_skip.pickle")
    assert not os.listdir(tmp_path / "incomplete")
