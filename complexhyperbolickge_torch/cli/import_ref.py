"""Import a reference-implementation checkpoint, the counterpart of
kge-import (complexhyperbolickge_tpu/cli/import_ref.py).

The reference saves `torch.save(model.cpu().state_dict(), <save_dir>/
model.pt)` beside a config.json of its argparse namespace (with `sizes`
from the dataset).  Every non-GNN reference model keeps its tables as
nn.Embedding attributes named as this package's parameters (entity, rel,
rel_diag, c, bh, bt, context_vec, ...), so the import is a rename:
params[name] = state_dict[f"{name}.weight"], each shape checked against
the model's param_specs.  The result is written through the port's
save_checkpoint with a config.json, so kge-test, predict and export run on
it directly:

    python -m complexhyperbolickge_torch.cli.import_ref \\
        --ref_dir /path/to/reference/run --out runs/imported --data_path data

GNN checkpoints (CompGCN, PoincareGCN, PoincareGAT, LorentzGCN) are
refused, as in JAX: their state dicts nest conv modules whose import
parity could not be verified.  Models with givens_reflection score
imported weights under the corrected involutive reflection (the JAX
package's documented divergence from the reference).  Reads and writes
files only: no device is touched.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

from complexhyperbolickge_torch.models import GNN_MODELS, ModelConfig, get_model
from complexhyperbolickge_torch.train.checkpoint import save_checkpoint

_DTYPE_ALIASES = {"float": "float32", "single": "float32", "double": "float64"}


def import_reference(ref_dir: str, out: str, data_path: str | None = None,
                     eval_batch_size: int | None = None) -> dict:
    """Convert <ref_dir>/{config.json, model.pt} into a checkpoint and
    config.json at `out`; returns the imported params (name -> numpy
    array)."""
    with open(os.path.join(ref_dir, "config.json")) as f:
        ref_cfg = json.load(f)
    model_name = ref_cfg["model"]
    if model_name in GNN_MODELS:
        raise ValueError(f"{model_name} is a GNN checkpoint; its import parity cannot be "
                         "verified, so it is not offered: retrain with cli.run instead")
    sizes = ref_cfg["sizes"]
    dtype = ref_cfg.get("dtype", "double")
    dtype = _DTYPE_ALIASES.get(dtype, dtype)
    cfg = ModelConfig(
        n_entities=sizes[0], n_relations=sizes[1], rank=ref_cfg["rank"],
        init_size=ref_cfg.get("init_size", 1e-3), bias=ref_cfg.get("bias", "learn"),
        gamma=ref_cfg.get("gamma", 0.0), multi_c=ref_cfg.get("multi_c", False),
        dtype=dtype, dropout=ref_cfg.get("dropout", 0.0))
    specs = get_model(model_name)(cfg, device="cpu").param_specs()

    sd = torch.load(os.path.join(ref_dir, "model.pt"), map_location="cpu",
                    weights_only=True)
    params = {}
    for name, (shape, _) in specs.items():
        key = f"{name}.weight"
        if key not in sd:
            raise KeyError(f"reference state_dict has no '{key}' (keys: {sorted(sd)}): "
                           "checkpoint/model mismatch?")
        w = sd[key].detach().to(torch.float64)
        if tuple(w.shape) != tuple(shape):
            raise ValueError(f"{model_name}.{name}: reference shape {tuple(w.shape)} != "
                             f"expected {tuple(shape)}")
        params[name] = w.to(cfg.torch_dtype).clone()
    unused = sorted(k for k in sd if k.split(".")[0] not in specs)
    if unused:
        logging.warning("ignored reference state entries: %s", unused)

    # a config the CLIs rebuild from: the reference's keys, with defaults
    our_args = dict(ref_cfg)
    our_args["dtype"] = dtype
    if data_path:
        our_args["data_path"] = data_path
    else:
        our_args.setdefault("data_path", "data")
    if eval_batch_size:
        our_args["eval_batch_size"] = eval_batch_size
    our_args.setdefault("eval_batch_size", 1000)
    our_args.setdefault("debug", False)
    our_args["save_dir"] = out
    our_args["imported_from"] = os.path.abspath(ref_dir)

    os.makedirs(out, exist_ok=True)
    save_checkpoint(out, params, opt_state=None, epoch=0, best_mrr=None,
                    config={"args": our_args})
    logging.info("imported %s (%d tables, %s) -> %s", model_name, len(params), dtype, out)
    return {k: v.numpy() for k, v in params.items()}


def main():
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    p = argparse.ArgumentParser(
        description="Import a reference-implementation checkpoint (config.json + model.pt) "
                    "as a checkpoint of this package")
    p.add_argument("--ref_dir", required=True,
                   help="reference run dir containing config.json + model.pt")
    p.add_argument("--out", required=True, help="output model dir")
    p.add_argument("--data_path", default=None,
                   help="dataset root for later kge-test / predict runs")
    p.add_argument("--eval_batch_size", default=None, type=int)
    import_reference(**vars(p.parse_args()))


if __name__ == "__main__":
    main()
