"""Top-k tail prediction from a trained checkpoint, the counterpart of
kge-predict (complexhyperbolickge_tpu/cli/predict.py).

    python -m complexhyperbolickge_torch.cli.predict --model_dir runs/fftroth \\
        --queries 12:3 45:0 --k 10 --filter_known
"""

from __future__ import annotations

import argparse
import json
import logging

import numpy as np
import torch

from complexhyperbolickge_torch.cli.run import (
    apply_dtype_policy,
    build_model,
    load_dataset,
    setup_logging,
)
from complexhyperbolickge_torch.train.checkpoint import load_config, load_into
from complexhyperbolickge_torch.train.evaluate import make_predictor
from complexhyperbolickge_torch.utils.platform import resolve_device


def load_serving_state(model_dir: str, device: str = "cuda"):
    """(model, dataset) reloaded from a model dir, the model's params loaded
    on `device` — the shared loading path of predict and the server."""
    dev = resolve_device(device)
    args = apply_dtype_policy(argparse.Namespace(**load_config(model_dir)["args"]))
    dataset = load_dataset(args)
    model = build_model(args, dataset, dev)
    load_into(model, model_dir)
    return model, dataset


def max_known_tails(dataset) -> int:
    """Longest known-true-tail list over both filter directions: the padded
    width with which known_tail_filters never truncates."""
    skip = dataset.get_filters()
    return max(
        (len(v) for d in ("rhs", "lhs") for v in skip[d].values()), default=1
    ) or 1


def known_tail_filters(dataset, q, lmax: int | None = None, device="cpu"):
    """Padded known-true-tail ids (int64 tensor on `device`) for (head, rel)
    queries.  rhs filters are keyed by raw relation ids; inverse-relation
    queries (r >= n_rel/2) live in the lhs dict.  A list longer than lmax
    raises rather than leaking known facts into predictions."""
    skip = dataset.get_filters()
    n_ent = dataset.n_entities
    n_raw = dataset.n_predicates // 2
    lists = [
        skip["rhs" if int(r) < n_raw else "lhs"].get((int(h), int(r)), [])
        for h, r in q
    ]
    widest = max((len(v) for v in lists), default=0)
    if lmax is None:
        lmax = widest or 1
    elif widest > lmax:
        raise ValueError(
            f"known-fact filter list of length {widest} exceeds the padded "
            f"width {lmax}; raise max_filter_len (dataset max: "
            f"{max_known_tails(dataset)})"
        )
    fidx = np.full((len(q), lmax), n_ent, dtype=np.int64)
    for i, l in enumerate(lists):
        fidx[i, : len(l)] = l
    return torch.as_tensor(fidx, device=device)


def validate_queries(queries, dataset) -> np.ndarray:
    """(B, 2) int64 (head, rel) array; raises ValueError on bad input."""
    q = np.asarray(queries, dtype=np.int64)
    if q.ndim != 2 or q.shape[1] != 2:
        raise ValueError("queries must be (B, 2) (head, rel)")
    if not ((q[:, 0] >= 0) & (q[:, 0] < dataset.n_entities)).all():
        raise ValueError("head id out of range")
    if not ((q[:, 1] >= 0) & (q[:, 1] < dataset.n_predicates)).all():
        raise ValueError("relation id out of range")
    return q


def predict(model_dir: str, queries, k: int = 10, filter_known: bool = False,
            device: str = "cuda"):
    setup_logging(model_dir, to_file=False)
    model, dataset = load_serving_state(model_dir, device)
    dev = next(model.parameters()).device
    q = validate_queries(queries, dataset)
    fidx = known_tail_filters(dataset, q, device=dev) if filter_known else None
    ids, scores = make_predictor(model, k=k)(torch.as_tensor(q, device=dev), fidx)
    out = []
    for row_q, row_i, row_s in zip(q, ids.cpu().numpy(), scores.cpu().numpy()):
        out.append({
            "head": int(row_q[0]),
            "rel": int(row_q[1]),
            "tails": [int(x) for x in row_i],
            "scores": [float(x) for x in row_s],
        })
        logging.info("(%d, %d) -> %s", row_q[0], row_q[1],
                     list(zip(out[-1]["tails"], out[-1]["scores"])))
    print(json.dumps(out))
    return out


def main():
    p = argparse.ArgumentParser(description="Top-k tail prediction")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--queries", nargs="+", required=True,
                   help="queries as HEAD:REL id pairs, e.g. 12:3 45:0")
    p.add_argument("--k", default=10, type=int)
    p.add_argument("--filter_known", action="store_true",
                   help="mask tails already known from train/valid/test")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    qs = [tuple(int(x) for x in s.split(":")) for s in a.queries]
    predict(a.model_dir, qs, k=a.k, filter_known=a.filter_known, device=a.device)


if __name__ == "__main__":
    main()
