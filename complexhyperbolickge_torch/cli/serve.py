"""HTTP serving of top-k tail prediction, the counterpart of kge-serve
(complexhyperbolickge_tpu/cli/serve.py): a stdlib ThreadingHTTPServer
around train/evaluate.py::make_predictor.

    python -m complexhyperbolickge_torch.cli.serve --model_dir runs/fftroth \\
        --port 8080 --k 10 --batch 32

    GET  /health   -> {"status": "ok", "model": ..., "n_entities": ...}
    POST /predict  body: {"queries": [[head, rel], ...], "k": <= server k,
                          "filter_known": bool}
                   -> [{"head", "rel", "tails", "scores"}, ...]

Requests are cut into batches of --batch queries; device calls are
serialized by a lock, so concurrent clients queue instead of racing the
device.  Entity and relation identifiers are integer ids.
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch


class PredictService:
    """A loaded model and its top-k predictor."""

    def __init__(self, model_dir: str, k: int = 10, batch: int = 32,
                 max_filter_len: int | None = None, device: str = "cuda",
                 warm_filters: bool = False):
        from complexhyperbolickge_torch.cli.predict import (
            load_serving_state,
            max_known_tails,
        )
        from complexhyperbolickge_torch.train.evaluate import make_predictor

        self.model, self.dataset = load_serving_state(model_dir, device)
        self.device = next(self.model.parameters()).device
        self.k, self.batch = k, batch
        # sized to the dataset's longest known-tail list so filtering never
        # leaks a known fact; a smaller explicit width raises per request
        self.max_filter_len = (max_known_tails(self.dataset)
                               if max_filter_len is None else max_filter_len)
        self._fn = make_predictor(self.model, k=k)
        self._lock = threading.Lock()
        # warm-up: nvcc builds the CUDA kernels (a no-op when the libraries
        # are current), and one call creates the cuBLAS handle and the cuFFT
        # plans and runs the params finiteness check, so the first request
        # pays for none of them; warm_filters adds one filtered call at the
        # padded max_filter_len (the allocator's first scatter at that width)
        if self.device.type == "cuda":
            from complexhyperbolickge_torch.kernels._build import build_all

            build_all()
        pad_q = torch.zeros((batch, 2), dtype=torch.int64, device=self.device)
        self._fn(pad_q)
        if warm_filters:
            pad_f = torch.full((batch, self.max_filter_len), self.dataset.n_entities,
                               dtype=torch.int64, device=self.device)
            self._fn(pad_q, pad_f)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict(self, queries, k: int | None = None, filter_known: bool = False):
        from complexhyperbolickge_torch.cli.predict import (
            known_tail_filters,
            validate_queries,
        )

        k = self.k if k is None else k
        if not 1 <= k <= self.k:
            raise ValueError(f"k must be in [1, {self.k}] (server --k)")
        q = validate_queries(queries, self.dataset)
        out = []
        for lo in range(0, len(q), self.batch):
            chunk = q[lo: lo + self.batch]
            fidx = None
            if filter_known:
                fidx = known_tail_filters(self.dataset, chunk,
                                          lmax=self.max_filter_len,
                                          device=self.device)
            with self._lock:  # one in-flight device call
                ids, scores = self._fn(torch.as_tensor(chunk, device=self.device),
                                       fidx)
                ids = ids[:, :k].cpu().numpy()
                scores = scores[:, :k].cpu().numpy()
            for row_q, row_i, row_s in zip(chunk, ids, scores):
                out.append({
                    "head": int(row_q[0]), "rel": int(row_q[1]),
                    "tails": [int(x) for x in row_i],
                    "scores": [float(x) for x in np.asarray(row_s)],
                })
        return out


def make_server(service: PredictService, host: str = "127.0.0.1",
                port: int = 8080) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through logging
            logging.info("%s " + fmt, self.address_string(), *args)

        def _send(self, code: int, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {
                    "status": "ok",
                    "model": type(service.model).__name__,
                    "n_entities": service.dataset.n_entities,
                    "n_relations": service.dataset.n_predicates,
                    "k": service.k,
                })
            else:
                self._send(404, {"error": "unknown path (GET /health)"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "unknown path (POST /predict)"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                out = service.predict(
                    req["queries"], k=req.get("k"),
                    filter_known=bool(req.get("filter_known", False)),
                )
                self._send(200, out)
            except (KeyError, ValueError, TypeError) as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # noqa: BLE001 — a request must not kill the server
                logging.exception("prediction failed")
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def build_parser() -> argparse.ArgumentParser:
    """kge-serve's flags: JAX's (a JAX serve command line parses) plus
    --device."""
    p = argparse.ArgumentParser(description="HTTP top-k prediction server")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", default=8080, type=int)
    p.add_argument("--k", default=10, type=int, help="max top-k served")
    p.add_argument("--batch", default=32, type=int,
                   help="queries per device call (requests are chunked)")
    p.add_argument("--max_filter_len", default=None, type=int,
                   help="padded width of the known-fact filter rows "
                        "(default: the dataset's longest known-tail list)")
    p.add_argument("--warm_filters", action="store_true",
                   help="run the filtered predictor once at start, at the "
                        "padded max_filter_len")
    p.add_argument("--device", default="cuda")
    return p


def main():
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    a = build_parser().parse_args()
    service = PredictService(a.model_dir, k=a.k, batch=a.batch,
                             max_filter_len=a.max_filter_len, device=a.device,
                             warm_filters=a.warm_filters)
    server = make_server(service, a.host, a.port)
    logging.info("serving %s on http://%s:%d (k<=%d, batch %d)",
                 a.model_dir, a.host, a.port, a.k, a.batch)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
