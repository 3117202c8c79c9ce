"""The port's kge-export and kge-import (cli/export.py, cli/import_ref.py)
against the JAX package's, on the CPU.

Export: one run dir (a port-written FFTRotH checkpoint and a nested
CompGCN one) exported by both packages gives the same .npz: the same keys
in the same order, the same arrays and dtypes, the same __config__ bytes;
'.npz' is appended when missing; a checkpoint without an embedded config
falls back to config.json with a warning.  Import: a synthesized reference
run dir (config.json + a model.pt state_dict, with an extra unused entry)
of FFTRotH and RotH in float64 imports to the same checkpoint and
config.json as JAX's import_reference, and the port's kge-test ranks the
imported FFTRotH; GNN checkpoints, wrong shapes and missing tables are
refused by both.
"""

import json
import logging

import numpy as np
import pytest
import torch

from complexhyperbolickge_torch.cli.export import export
from complexhyperbolickge_torch.cli.import_ref import import_reference
from complexhyperbolickge_torch.cli.run import build_model, build_parser, load_dataset
from complexhyperbolickge_torch.cli.test import test as torch_test
from complexhyperbolickge_torch.train.checkpoint import load_checkpoint, save_checkpoint
from complexhyperbolickge_tpu.cli.export import export as jax_export
from complexhyperbolickge_tpu.cli.import_ref import import_reference as jax_import

TINY = ["--dataset", "synthetic", "--synthetic_entities", "40", "--rank", "6",
        "--bias", "learn", "--multi_c", "--dtype", "float64", "--eval_batch_size", "64",
        "--hidden_dim", "8", "--device", "cpu"]


def run_dir(path, model, embed_config=True):
    """A checkpoint of a freshly drawn `model` written by the port."""
    args = build_parser().parse_args(TINY + ["--model", model, "--save_dir", str(path)])
    m = build_model(args, load_dataset(args), "cpu", torch.Generator().manual_seed(0))
    save_checkpoint(str(path), m.state_dict(), None, 1, 0.5,
                    config={"args": vars(args)} if embed_config else None)
    if not embed_config:
        (path / "config.json").write_text(json.dumps({"args": vars(args)}))
    return m


def assert_same_npz(a, b):
    with np.load(a) as x, np.load(b) as y:
        assert list(x.keys()) == list(y.keys())
        for k in y.keys():
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("model", ["FFTRotH", "CompGCN"])
def test_export_equals_jax_export(tmp_path, model):
    run_dir(tmp_path, model)
    got = export(str(tmp_path), str(tmp_path / "port"))
    want = jax_export(str(tmp_path), str(tmp_path / "jax.npz"))
    assert got == str(tmp_path / "port.npz")
    assert_same_npz(got, want)
    st = load_checkpoint(str(tmp_path))
    with np.load(got) as z:
        assert json.loads(z["__config__"].tobytes())["model"] == model
        if model == "CompGCN":
            np.testing.assert_array_equal(z["gnn.0.w_rel"], st["params"]["gnn"][0]["w_rel"])
        np.testing.assert_array_equal(z["entity"], st["params"]["entity"])


def test_export_falls_back_to_config_json(tmp_path, capsys):
    run_dir(tmp_path, "RotH", embed_config=False)
    got = export(str(tmp_path))  # logs to stdout (cli.run.setup_logging)
    assert got == str(tmp_path / "embeddings.npz")
    assert "WARNING  checkpoint carries no embedded config" in capsys.readouterr().out
    assert_same_npz(got, jax_export(str(tmp_path), str(tmp_path / "jax.npz")))


def reference_dir(path, model, rank=6, n_ent=40):
    """A reference-style run dir: config.json (argparse keys plus sizes)
    and model.pt, the state_dict of nn.Embedding tables named
    <param>.weight, in float64, with one entry the import ignores."""
    args = build_parser().parse_args(TINY + ["--model", model, "--rank", str(rank),
                                             "--synthetic_entities", str(n_ent)])
    dataset = load_dataset(args)
    m = build_model(args, dataset, "cpu")
    rng = np.random.default_rng(1)
    sd = {f"{k}.weight": torch.as_tensor(rng.normal(0, 0.1, tuple(v.shape)))
          for k, v in m.state_dict().items()}
    sd["extra_buffer.weight"] = torch.zeros(3)
    path.mkdir(parents=True, exist_ok=True)
    torch.save(sd, path / "model.pt")
    cfg = {k: v for k, v in vars(args).items() if k not in ("device", "save_dir")}
    cfg.update(dtype="double", sizes=list(dataset.get_shape()))
    (path / "config.json").write_text(json.dumps(cfg))
    return sd


@pytest.mark.parametrize("model", ["FFTRotH", "RotH"])
def test_import_writes_the_checkpoint_jax_writes(tmp_path, model, caplog):
    sd = reference_dir(tmp_path / "ref", model)
    with caplog.at_level(logging.WARNING):
        got = import_reference(str(tmp_path / "ref"), str(tmp_path / "port"), eval_batch_size=32)
    assert "extra_buffer.weight" in caplog.text
    want = jax_import(str(tmp_path / "ref"), str(tmp_path / "jax"), eval_batch_size=32)
    assert sorted(got) == sorted(want)
    a, b = load_checkpoint(str(tmp_path / "port")), load_checkpoint(str(tmp_path / "jax"))
    assert a["param_schema"] == b["param_schema"]
    for k, v in b["params"].items():
        assert a["params"][k].dtype == v.dtype == np.float64
        np.testing.assert_array_equal(a["params"][k], v)
        np.testing.assert_array_equal(a["params"][k], sd[f"{k}.weight"].numpy())
    assert (a["epoch"], a["best_mrr"], a["opt_state"]) == (b["epoch"], b["best_mrr"],
                                                           b["opt_state"]) == (0, None, None)
    ca = json.loads((tmp_path / "port" / "config.json").read_text())["args"]
    cb = json.loads((tmp_path / "jax" / "config.json").read_text())["args"]
    assert ca.pop("save_dir") == str(tmp_path / "port")
    assert cb.pop("save_dir") == str(tmp_path / "jax")
    assert ca == cb and ca["eval_batch_size"] == 32 and ca["dtype"] == "float64"
    if model == "FFTRotH":  # the imported dir ranks through the port's kge-test
        metrics = torch_test(str(tmp_path / "port"), device="cpu")
        assert 0.0 < metrics["MRR"] <= 1.0


def test_import_refuses_gnn_wrong_shapes_and_missing_tables(tmp_path):
    reference_dir(tmp_path / "gnn", "RotH")
    cfg = json.loads((tmp_path / "gnn" / "config.json").read_text())
    (tmp_path / "gnn" / "config.json").write_text(json.dumps({**cfg, "model": "CompGCN"}))
    for fn in (import_reference, jax_import):
        with pytest.raises(ValueError, match="GNN checkpoint"):
            fn(str(tmp_path / "gnn"), str(tmp_path / "out"))
    sd = reference_dir(tmp_path / "shape", "RotH")
    sd["entity.weight"] = sd["entity.weight"][:, :-1]
    torch.save(sd, tmp_path / "shape" / "model.pt")
    for fn in (import_reference, jax_import):
        with pytest.raises(ValueError, match="reference shape"):
            fn(str(tmp_path / "shape"), str(tmp_path / "out"))
    del sd["entity.weight"]
    torch.save(sd, tmp_path / "shape" / "model.pt")
    for fn in (import_reference, jax_import):
        with pytest.raises(KeyError, match="entity.weight"):
            fn(str(tmp_path / "shape"), str(tmp_path / "out"))
