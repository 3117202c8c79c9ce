"""Evaluation-only CLI, the counterpart of kge-test
(complexhyperbolickge_tpu/cli/test.py).

Reloads config.json + state.pkl from a model dir (written by either
package), rebuilds the model on the device, and reports filtered metrics.

    python -m complexhyperbolickge_torch.cli.test --model_dir runs/fftroth
"""

from __future__ import annotations

import argparse
import logging

from complexhyperbolickge_torch.cli.run import (
    apply_dtype_policy,
    build_model,
    load_dataset,
    setup_logging,
)
from complexhyperbolickge_torch.kernels._ranker import BACKENDS
from complexhyperbolickge_torch.train.checkpoint import load_config, load_into
from complexhyperbolickge_torch.train.evaluate import (
    avg_both,
    compute_metrics,
    format_metrics,
    make_best_ranker,
)
from complexhyperbolickge_torch.utils.platform import resolve_device


def test(model_dir: str, split: str = "test",
         eval_precision: str | None = None, device: str = "cuda",
         eval_backend: str | None = None):
    """Filtered metrics of the checkpoint in `model_dir` on `split`.
    eval_precision / eval_backend override the saved run config."""
    dev = resolve_device(device)
    setup_logging(model_dir, to_file=False)
    args = argparse.Namespace(**load_config(model_dir)["args"])
    if eval_precision is not None:
        args.eval_precision = eval_precision
    if eval_backend is not None:
        args.eval_backend = eval_backend
    apply_dtype_policy(args)
    dataset = load_dataset(args)
    model = build_model(args, dataset, dev)
    load_into(model, model_dir)
    rank_fn = make_best_ranker(model, args.eval_batch_size,
                               getattr(args, "eval_backend", "auto"),
                               precision=getattr(args, "eval_precision",
                                                 "highest"))
    metrics = avg_both(
        compute_metrics(model, dataset, split, args.eval_batch_size,
                        rank_fn=rank_fn)
    )
    logging.info(format_metrics(metrics, split=split))
    return metrics


def main():
    p = argparse.ArgumentParser(description="Evaluate a trained KG embedding model")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--split", default="test", choices=["valid", "test"])
    p.add_argument("--eval_precision", default=None, choices=["highest", "default"],
                   help="override the run config's eval precision: highest "
                        "= exact fp32; default = the score contractions in "
                        "one bf16 pass with f32 accumulation (the fused "
                        "rankers' bf16 tensor-core kernels, the dense "
                        "rankers' operands rounded to bf16)")
    p.add_argument("--eval_backend", default=None,
                   choices=BACKENDS,
                   help="override the run config's ranker: auto/pallas = "
                        "masked fused CUDA kernel, pallas_maskless = "
                        "maskless fused CUDA kernels, dense = materialized "
                        "(B, N) scores")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    test(**vars(p.parse_args()))


if __name__ == "__main__":
    main()
