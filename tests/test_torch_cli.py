"""The port's kge-test and serving entry points on a checkpoint written by
the JAX package (with an optax Adam opt_state), against the JAX CLIs.

Both sides rank with the dense ranker in f64, so MRR agrees to 1e-9 (the
ranks are identical); the fused ranker's plain version agrees within 1e-4.
"""

import json
import threading
import urllib.request

import jax
import numpy as np
import optax
import pytest

from complexhyperbolickge_torch.cli.serve import PredictService, make_server
from complexhyperbolickge_torch.cli.test import test as torch_test
from complexhyperbolickge_torch.train.checkpoint import (
    load_checkpoint,
    load_config,
    save_checkpoint,
)
from complexhyperbolickge_tpu.cli.run import build_model as jax_build_model
from complexhyperbolickge_tpu.cli.run import build_parser as jax_build_parser
from complexhyperbolickge_tpu.cli.run import load_dataset as jax_load_dataset
from complexhyperbolickge_tpu.cli.serve import PredictService as JaxPredictService
from complexhyperbolickge_tpu.cli.test import test as jax_test
from complexhyperbolickge_tpu.train import checkpoint as jax_ckpt


def write_jax_checkpoint(path, dtype="float64", backend="dense", precision="highest"):
    """A FFTRotH run dir as the JAX trainer writes it: state.pkl with params
    and an optax Adam opt_state, config.json with the run args."""
    args = jax_build_parser().parse_args([
        "--dataset", "synthetic", "--synthetic_entities", "120",
        "--model", "FFTRotH", "--rank", "6", "--bias", "learn", "--multi_c",
        "--dtype", dtype, "--eval_batch_size", "64", "--eval_backend", backend,
        "--eval_precision", precision,
    ])
    model = jax_build_model(args, jax_load_dataset(args))
    rng = np.random.default_rng(7)
    params = {k: (rng.normal(0, 0.2, np.shape(v)) + (1.0 if k == "c" else 0.0)).astype(dtype)
              for k, v in model.init(jax.random.PRNGKey(0)).items()}
    params = jax.tree.map(jax.numpy.asarray, params)
    opt_state = optax.adam(1e-3).init(params)
    jax_ckpt.save_checkpoint(str(path), params, opt_state, epoch=3, best_mrr=0.25,
                             config={"args": vars(args)})
    return str(path)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return write_jax_checkpoint(tmp_path_factory.mktemp("jaxrun"))


def test_kge_test_dense_matches_jax(model_dir):
    want = jax_test(model_dir)
    got = torch_test(model_dir, device="cpu")
    assert abs(got["MRR"] - want["MRR"]) <= 1e-9
    assert got["MR"] == pytest.approx(want["MR"], abs=1e-9)
    np.testing.assert_allclose(got["hits@[1,3,10]"], want["hits@[1,3,10]"], atol=1e-9)


@pytest.mark.parametrize("backend", ["auto", "pallas_maskless"])
def test_kge_test_fused_rankers_match_dense(model_dir, backend):
    dense = torch_test(model_dir, device="cpu")
    fused = torch_test(model_dir, device="cpu", eval_backend=backend)
    assert abs(fused["MRR"] - dense["MRR"]) < 1e-4


def test_jax_checkpoint_loads_with_stubbed_opt_state(model_dir):
    state = load_checkpoint(model_dir)
    assert state["epoch"] == 3 and state["best_mrr"] == 0.25
    assert sorted(state["params"]) == ["bh", "bt", "c", "entity", "rel", "rel_diag"]
    adam = state["opt_state"][0]
    assert type(adam).__module__.startswith("optax")  # a stub, not optax's class
    assert load_config(model_dir)["args"]["model"] == "FFTRotH"


def test_port_checkpoint_loads_in_jax(model_dir, tmp_path):
    """save_checkpoint writes the JAX format: JAX's loader validates it."""
    state = load_checkpoint(model_dir)
    from complexhyperbolickge_torch.train.checkpoint import params_from_jax

    save_checkpoint(str(tmp_path), params_from_jax(state["params"], "cpu"),
                    epoch=4, config={"args": load_config(model_dir)["args"]})
    back = jax_ckpt.load_checkpoint(str(tmp_path), device_put=False)
    for k, v in state["params"].items():
        np.testing.assert_array_equal(back["params"][k], v)
    assert back["epoch"] == 4


def test_predict_service_topk_matches_jax(model_dir):
    queries = [[3, 1], [17, 2], [44, 0], [100, 13], [5, 20]]
    jax_svc = JaxPredictService(model_dir, k=5, batch=4)
    svc = PredictService(model_dir, k=5, batch=4, device="cpu")
    for filter_known in (False, True):
        want = jax_svc.predict(queries, filter_known=filter_known)
        got = svc.predict(queries, filter_known=filter_known)
        assert [g["tails"] for g in got] == [w["tails"] for w in want]
        np.testing.assert_allclose([g["scores"] for g in got],
                                   [w["scores"] for w in want], atol=1e-9)


def test_http_predict_and_errors(model_dir):
    svc = PredictService(model_dir, k=3, batch=8, device="cpu")
    srv = make_server(svc, "127.0.0.1", 0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        def post(payload):
            req = urllib.request.Request(url + "/predict", data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"},
                                         method="POST")
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        status, body = post({"queries": [[3, 1], [4, 2]], "filter_known": True})
        assert status == 200 and len(body) == 2 and len(body[0]["tails"]) == 3
        assert body == svc.predict([[3, 1], [4, 2]], filter_known=True)
        for bad in ({"queries": [[10**9, 0]]}, {"queries": [[0, 0]], "k": 9}, {}):
            assert post(bad)[0] == 400
        with urllib.request.urlopen(url + "/health", timeout=30) as r:
            assert json.loads(r.read())["model"] == "FFTRotH"
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_jax_serve_command_line_parses_and_warms_filters(model_dir, monkeypatch):
    """A kge-serve command line of the JAX package, --warm_filters
    included, parses in the port's server; with the flag the service runs
    one filtered call at start at the padded max_filter_len."""
    from complexhyperbolickge_torch.cli import serve as S
    from complexhyperbolickge_torch.train import evaluate as TEV

    argv = ["--model_dir", model_dir, "--host", "0.0.0.0", "--port", "9000", "--k", "7",
            "--batch", "16", "--max_filter_len", "12", "--warm_filters"]
    a = S.build_parser().parse_args(argv)
    assert (a.k, a.batch, a.max_filter_len, a.warm_filters, a.device) == (7, 16, 12, True,
                                                                          "cuda")
    calls = []
    real = TEV.make_predictor

    def recording(model, k=10):
        fn = real(model, k=k)

        def predict(q, fidx=None):
            calls.append(None if fidx is None else tuple(fidx.shape))
            return fn(q, fidx)
        return predict

    monkeypatch.setattr(TEV, "make_predictor", recording)
    S.PredictService(model_dir, k=3, batch=4, max_filter_len=12, device="cpu",
                     warm_filters=True)
    S.PredictService(model_dir, k=3, batch=4, max_filter_len=12, device="cpu")
    assert calls == [None, (4, 12), None]


@pytest.mark.parametrize("backend", ["dense", "auto", "pallas_maskless"])
def test_kge_test_of_a_jax_run_dir_saying_default(tmp_path, backend, monkeypatch):
    """A JAX-written run dir whose config.json says eval_precision
    "default": the port's kge-test (the function and the command line)
    ranks it in that mode with the run's backend; JAX's kge-test of it
    (full float32 on the CPU) gives an MRR within 1e-2 (bf16 rounding moves
    a few near-tied ranks)."""
    import sys

    from complexhyperbolickge_torch.cli import test as T

    d = write_jax_checkpoint(tmp_path, dtype="float32", backend=backend, precision="default")
    assert load_config(d)["args"]["eval_precision"] == "default"
    seen = []
    real = T.make_best_ranker

    def spy(model, bs, be="auto", precision="highest"):
        seen.append((be, precision))
        return real(model, bs, be, precision=precision)

    monkeypatch.setattr(T, "make_best_ranker", spy)
    got = torch_test(d, device="cpu")
    want = jax_test(d)
    assert np.isfinite(got["MRR"]) and abs(got["MRR"] - want["MRR"]) < 1e-2
    monkeypatch.setattr(sys, "argv", ["kge-test", "--model_dir", d, "--device", "cpu",
                                      "--eval_precision", "default"])
    T.main()
    assert seen == [(backend, "default")] * 2
