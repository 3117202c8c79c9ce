"""Export a checkpoint's parameters as .npz, the counterpart of kge-export
(complexhyperbolickge_tpu/cli/export.py).

Every parameter table of the best checkpoint (state.pkl) of a model dir,
written by either package, as a numpy array keyed by its dotted name
("entity", "rel", ..., "gnn.0.w_rel.w" for a GNN), plus `__config__`: the
run config as UTF-8 JSON bytes, taken from the checkpoint itself (or, for
a checkpoint without one, from config.json, with a warning).  Reads the
pickle only: no device, no dataset.  A CompGCN with the corr composition
or the conve decoder is refused: the JAX package has neither, so nothing
there could load the arrays.

    python -m complexhyperbolickge_torch.cli.export --model_dir runs/fftroth \\
        --out runs/fftroth/embeddings.npz
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np

from complexhyperbolickge_torch.cli.run import setup_logging
from complexhyperbolickge_torch.train.checkpoint import flatten, load_checkpoint, load_config


def export(model_dir: str, out: str | None = None) -> str:
    """Write model_dir's parameters to `out` (default
    <model_dir>/embeddings.npz; '.npz' is appended when missing, and its
    directory made); returns the path written."""
    setup_logging(model_dir, to_file=False)
    st = load_checkpoint(model_dir)
    if st.get("config"):
        cfg = st["config"]["args"]
    else:
        cfg = load_config(model_dir)["args"]
        logging.warning("checkpoint carries no embedded config (older format); using "
                        "config.json, which may postdate these weights")
    if cfg.get("opn") == "corr" or cfg.get("interaction") == "conve":
        raise ValueError(f"{model_dir}: a CompGCN with --opn {cfg.get('opn')} and "
                         f"--interaction {cfg.get('interaction')}; the JAX package has no "
                         "corr composition and no conve decoder, so it cannot load an export")
    out = out or os.path.join(model_dir, "embeddings.npz")
    if not out.endswith(".npz"):
        out += ".npz"  # np.savez would append it silently
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    flat = {k: np.asarray(v) for k, v in flatten(st["params"]).items()}
    np.savez(out, __config__=np.frombuffer(json.dumps(cfg).encode(), dtype=np.uint8), **flat)
    logging.info("exported %d arrays to %s", len(flat), out)
    return out


def main():
    p = argparse.ArgumentParser(description="Export checkpoint embeddings")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--out", default=None,
                   help="output .npz path (default <model_dir>/embeddings.npz)")
    a = p.parse_args()
    export(a.model_dir, a.out)


if __name__ == "__main__":
    main()
