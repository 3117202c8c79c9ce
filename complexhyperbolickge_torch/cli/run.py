"""Helpers shared by the evaluation and serving CLIs.

Port of the shared helpers of complexhyperbolickge_tpu/cli/run.py
(setup_logging, apply_dtype_policy, load_dataset, build_model).  The
training entry point itself comes with the next slice (ROADMAP.md).
"""

from __future__ import annotations

import logging
import os
import sys

from complexhyperbolickge_torch.data.dataset import KGData, synthetic_kg
from complexhyperbolickge_torch.models import ModelConfig, get_model

_DTYPE_ALIASES = {"float": "float32", "single": "float32", "double": "float64"}


def setup_logging(save_dir: str, to_file: bool = True):
    """stdout, plus <save_dir>/train.log when to_file (the eval and serving
    CLIs pass to_file=False so they never append to a training record)."""
    handlers = [logging.StreamHandler(sys.stdout)]
    if to_file:
        try:
            os.makedirs(save_dir, exist_ok=True)
            handlers.append(
                logging.FileHandler(os.path.join(save_dir, "train.log"))
            )
        except OSError:
            pass  # unwritable dir: stdout only
    logging.basicConfig(
        format="%(asctime)s %(levelname)-8s %(message)s",
        level=logging.INFO,
        datefmt="%Y-%m-%d %H:%M:%S",
        handlers=handlers,
        force=True,
    )


def apply_dtype_policy(args):
    """Normalize the dtype aliases of a run config (float/single/double).
    The JAX package coerces double to float32 on a TPU, which has no f64;
    PyTorch runs f64 natively on the CPU and the GPU, so nothing is coerced
    here.  The fused CUDA rankers score in float32 whatever the model dtype,
    as the JAX Pallas rankers do."""
    args.dtype = _DTYPE_ALIASES.get(args.dtype, args.dtype)
    return args


def load_dataset(args) -> KGData:
    """The run config's dataset.  'synthetic' takes its shape from the
    optional synthetic_* keys (entities, relations, train/valid/test sizes,
    seed), with the JAX package's defaults when a key is absent."""
    if args.dataset == "synthetic":
        return synthetic_kg(
            n_entities=getattr(args, "synthetic_entities", 200),
            n_relations=getattr(args, "synthetic_relations", 11),
            n_train=getattr(args, "synthetic_train", 2000),
            n_valid=getattr(args, "synthetic_valid", 200),
            n_test=getattr(args, "synthetic_test", 200),
            seed=getattr(args, "synthetic_seed", 0),
        )
    return KGData(os.path.join(args.data_path, args.dataset), args.debug)


def build_model(args, dataset: KGData, device):
    """The run config's model on `device`, freshly initialized."""
    n_ent, n_rel, _ = dataset.get_shape()
    cfg = ModelConfig(
        n_entities=n_ent,
        n_relations=n_rel,
        rank=args.rank,
        init_size=args.init_size,
        bias=args.bias,
        gamma=args.gamma,
        multi_c=args.multi_c,
        dtype=args.dtype,
        dropout=args.dropout,
    )
    return get_model(args.model)(cfg, device=device)
