"""Training CLI, flag-compatible with complexhyperbolickge_tpu/cli/run.py,
and the helpers the evaluation and serving CLIs share with it.

    python -m complexhyperbolickge_torch.cli.run --model FFTRotH --rank 33 \
        --optimizer Adam --learning_rate 3e-4 --batch_size 500 \
        --neg_sample_size 100 --multi_c --bias learn --dtype float32 \
        --save_dir runs/fftroth [--device cpu]

Protocol (the JAX package's): build dataset -> model -> trainer; an epoch
loop with per-epoch train and valid loss, filtered-metric validation every
`--valid` epochs (through make_best_ranker, so the family's fused CUDA
ranker: K1 for the FFT family, K5 or K7 for the real-hyperbolic ones),
best-MRR checkpointing and patience early stopping; then the best model is
reloaded and the valid, test and per-relation test metrics reported.
Checkpoints: state.pkl is the best model, latest.pkl the rolling resume
point, written at validation cadence and on SIGTERM (the run then finishes
its epoch, writes latest.pkl and stops).  `--resume` continues from the
newer of the two; a checkpoint without optimizer state (e.g. an import)
warm-starts with a fresh optimizer, and a JAX-written optax state is
converted (train/checkpoint.py::opt_state_from_jax).  Shuffles and
negatives derive from (seed, epoch), so a resumed run repeats a continuous
one.

The loss follows the flags as in JAX: per-query, shared (--neg_mode
shared) or pooled (--neg_mode pool) negatives when --neg_sample_size > 0;
otherwise the all-entity cross-entropy (--loss crossentropy) or, for --loss
binarycrossentropy, BCE against the label packs (KGData.label_pack: train
facts for the train batches, train and valid facts for the validation
loss), which epoch_batches permutes with the triples.

GNN models (CompGCN, PoincareGCN, PoincareGAT, LorentzGCN) train on the
full graph through the same loop; their flags are --hidden_dim, --layers,
--edge_dropout, --dropout, --opn, --interaction, --basis and
--gnn_agg_method.  Runs on the card unless --device cpu.  Flags of parts
not ported yet (--mesh, --distributed, --subgraph, --profile_dir,
--debug_nans) are accepted and raise when set, naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import threading
import time

import numpy as np
import torch

from complexhyperbolickge_torch.data.dataset import KGData, epoch_batches, synthetic_kg
from complexhyperbolickge_torch.models import GNN_MODELS, ModelConfig, get_model
from complexhyperbolickge_torch.train.checkpoint import (
    PickledStub,
    load_checkpoint,
    load_into,
    opt_state_from_jax,
    params_from_jax,
    save_checkpoint,
)
from complexhyperbolickge_torch.train.evaluate import (
    avg_both,
    compute_metrics,
    count_params,
    format_metrics,
    make_best_ranker,
)
from complexhyperbolickge_torch.train.trainer import TrainConfig, Trainer
from complexhyperbolickge_torch.utils.platform import resolve_device

DATASETS = ["FB15K", "WN", "WN18RR", "FB237", "YAGO3-10", "synthetic"]
# flags of parts not ported yet: flag -> ROADMAP.md Queue 1 item
_UNPORTED = {"mesh": 15, "distributed": 15, "subgraph": 14, "profile_dir": 16,
             "debug_nans": 16}
# the GNN flags and their defaults
_GNN_DEFAULTS = {"hidden_dim": 200, "edge_dropout": 0.3, "layers": 2,
                 "opn": "mult", "interaction": "distmult", "basis": 0,
                 "gnn_agg_method": 1}

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


def build_model(args, dataset: KGData, device, generator=None):
    """The run config's model on `device`, initialized from `generator`
    (a CPU torch.Generator).  A GNN takes the run config and the dataset
    too: its graph is the train split."""
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
    cls = get_model(args.model)
    if args.model in GNN_MODELS:
        return cls(cfg, args, dataset, device=device, generator=generator)
    return cls(cfg, device=device, generator=generator)


def build_parser() -> argparse.ArgumentParser:
    """The JAX package's flag surface, plus --device and the synthetic
    graph's shape."""
    p = argparse.ArgumentParser(description="KG embedding training (PyTorch + CUDA)")
    p.add_argument("--dataset", default="WN18RR", choices=DATASETS)
    p.add_argument("--data_path", default=os.environ.get("DATA_PATH", "data"))
    p.add_argument("--model", default="FFTRotH")
    p.add_argument("--regularizer", default="N3", choices=["N3", "F2", "L2"])
    p.add_argument("--reg", default=0.0, type=float)
    p.add_argument("--optimizer", default="Adagrad",
                   choices=["Adagrad", "Adam", "SparseAdam"])
    p.add_argument("--max_epochs", default=50, type=int)
    p.add_argument("--patience", default=10, type=int)
    p.add_argument("--valid", default=3, type=int, help="epochs between validation")
    p.add_argument("--rank", default=1000, type=int)
    p.add_argument("--batch_size", default=1000, type=int)
    p.add_argument("--eval_batch_size", default=1000, type=int)
    p.add_argument("--update_steps", default=1, type=int)
    p.add_argument("--neg_sample_size", default=50, type=int)
    p.add_argument("--neg_mode", default="per_query",
                   choices=["per_query", "shared", "pool"],
                   help="per_query = the reference sampler; shared = one "
                        "negative set a batch; pool = per-query windows of a "
                        "per-step pool of --neg_pool_size")
    p.add_argument("--neg_pool_size", default=512, type=int)
    p.add_argument("--loss", default="crossentropy",
                   choices=["crossentropy", "binarycrossentropy"])
    p.add_argument("--dropout", default=0.0, type=float)
    p.add_argument("--init_size", default=1e-3, type=float)
    p.add_argument("--learning_rate", default=1e-1, type=float)
    p.add_argument("--gamma", default=0.0, type=float)
    p.add_argument("--bias", default="constant", choices=["constant", "learn", "none"])
    p.add_argument("--dtype", default="double",
                   choices=["float", "double", "single", "float32", "float64",
                            "bfloat16"])
    # the reference defines this store_true but its sweep passes 0/1
    p.add_argument("--double_neg", nargs="?", const=True, default=False,
                   type=lambda s: bool(int(s)))
    p.add_argument("--debug", action="store_true")
    p.add_argument("--synthetic_entities", default=200, type=int)
    p.add_argument("--synthetic_relations", default=11, type=int)
    p.add_argument("--synthetic_train", default=2000, type=int)
    p.add_argument("--synthetic_valid", default=200, type=int)
    p.add_argument("--synthetic_test", default=200, type=int)
    p.add_argument("--multi_c", action="store_true")
    p.add_argument("--smoothing", default=None, type=float)
    p.add_argument("--save_dir", default=".")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--resume", action="store_true",
                   help="resume from save_dir's checkpoint")
    p.add_argument("--eval_backend", default="auto",
                   choices=["auto", "dense", "pallas", "pallas_maskless"],
                   help="auto/pallas = masked fused CUDA ranker (K1 FFT, K5 "
                        "Poincare and Lorentz, K7 AttRH), pallas_maskless = "
                        "maskless fused rankers (K2, K6, K8), dense = "
                        "materialized (B, N) scores")
    p.add_argument("--eval_precision", default="highest",
                   choices=["highest", "default"])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    for flag in ("mesh", "coordinator", "profile_dir"):
        p.add_argument(f"--{flag}", default=None)
    p.add_argument("--num_processes", default=None, type=int)
    p.add_argument("--process_id", default=None, type=int)
    for flag in ("distributed", "debug_nans", "subgraph"):
        p.add_argument(f"--{flag}", action="store_true")
    for flag, default in _GNN_DEFAULTS.items():
        p.add_argument(f"--{flag}", default=default, type=type(default))
    return p


def _refuse_unported(args):
    for flag, item in _UNPORTED.items():
        if getattr(args, flag, None):
            raise NotImplementedError(f"--{flag} has no PyTorch port yet "
                                      f"(ROADMAP.md Queue 1 item {item})")


def epoch_generator(seed: int, stream: int, device) -> torch.Generator:
    """The torch.Generator of one (seed, stream) pair on `device`, as the
    JAX package folds `stream` into PRNGKey(seed): stream 2 * epoch draws
    the epoch's training negatives, 2 * epoch + 1 its validation ones."""
    state = np.random.SeedSequence([seed, stream]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def _resume(save_dir, model, trainer):
    """Load the newer of latest.pkl and state.pkl (latest.pkl on a tie: it
    carries counter and best_epoch) into model and trainer; returns the
    checkpoint, or None when there is none."""
    found = [load_checkpoint(save_dir, expect_params=model.state_dict(), filename=fn)
             for fn in ("latest.pkl", "state.pkl")
             if os.path.exists(os.path.join(save_dir, fn))]
    if not found:
        return None
    st = max(found, key=lambda s: s["epoch"])
    model.load_state_dict(params_from_jax(st["params"], next(model.parameters()).device))
    opt_state = st["opt_state"]
    if opt_state is None:
        logging.info("Checkpoint has no optimizer state: warm-starting from "
                     "its params with a fresh optimizer")
    else:
        if isinstance(opt_state, PickledStub):  # written by the JAX package
            opt_state = opt_state_from_jax(opt_state)
        trainer.load_opt_state(opt_state)
    logging.info("Resumed from epoch %d", st["epoch"])
    return st


def train(args) -> dict:
    """Train per the run config `args` (build_parser's namespace); returns
    the final valid and test metrics and the per-epoch history."""
    _refuse_unported(args)
    dev = resolve_device(getattr(args, "device", "cuda"))
    save_dir = args.save_dir
    os.makedirs(save_dir, exist_ok=True)
    setup_logging(save_dir)
    logging.info("Saving logs in: %s", save_dir)
    apply_dtype_policy(args)

    dataset = load_dataset(args)
    sizes = dataset.get_shape()
    logging.info("\t %s", str(sizes))
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump(vars(args), f, indent=2)

    model = build_model(args, dataset, dev,
                        generator=torch.Generator().manual_seed(args.seed))
    tcfg = TrainConfig(
        regularizer=args.regularizer, reg=args.reg, optimizer=args.optimizer,
        learning_rate=args.learning_rate, batch_size=args.batch_size,
        update_steps=args.update_steps, neg_sample_size=args.neg_sample_size,
        neg_mode=args.neg_mode, neg_pool_size=args.neg_pool_size,
        loss=args.loss, smoothing=args.smoothing, double_neg=args.double_neg,
    )
    trainer = Trainer(model, tcfg, sizes[0], sizes[1])
    logging.info("Total number of parameters %d", count_params(model))

    train_examples = dataset.get_examples("train")
    labels, valid_labels = None, None
    if tcfg.neg_sample_size <= 0 and tcfg.loss == "binarycrossentropy":
        # BCE labels: train facts for train, train + valid facts for valid
        _, labels = dataset.label_pack("train")
        _, valid_labels = dataset.label_pack("valid")
    start_epoch, best_mrr, best_epoch, counter = 1, None, None, 0
    if args.resume:
        st = _resume(save_dir, model, trainer)
        if st is not None:
            start_epoch = st["epoch"] + 1
            best_mrr = st["best_mrr"]
            counter = st.get("counter", 0)
            best_epoch = st.get("best_epoch", None)

    rank_fn = make_best_ranker(model, args.eval_batch_size, args.eval_backend,
                               precision=args.eval_precision)
    vb, vw, vlab = epoch_batches(dataset.get_examples("valid"), args.batch_size, None,
                                 valid_labels)

    def save(filename="state.pkl", **kw):
        save_checkpoint(save_dir, model.state_dict(), trainer.opt_state(), epoch,
                        best_mrr, filename=filename, **kw)

    # SIGTERM: finish the epoch, write latest.pkl, stop (resume with --resume)
    stop_signal = {"flag": False}

    def _on_term(signum, frame):
        stop_signal["flag"] = True
        logging.info("signal %d received: will checkpoint latest state and "
                     "stop at the epoch boundary", signum)

    on_main = threading.current_thread() is threading.main_thread()
    old_handler = signal.signal(signal.SIGTERM, _on_term) if on_main else None
    history = []
    try:
        logging.info("\t Start training")
        epoch = start_epoch - 1
        for epoch in range(start_epoch, args.max_epochs + 1):
            t0 = time.perf_counter()
            rng = np.random.default_rng([args.seed, epoch])
            batches, weights, lab_b = epoch_batches(train_examples, args.batch_size, rng,
                                                    labels)
            train_loss = trainer.run_epoch(batches, weights,
                                           epoch_generator(args.seed, 2 * epoch, dev), lab_b)
            dt = time.perf_counter() - t0
            logging.info("\t Epoch %d | average train loss: %.4f | %.0f triples/s",
                         epoch, train_loss, len(train_examples) / dt)
            valid_loss = trainer.valid_loss(vb, vw,
                                            epoch_generator(args.seed, 2 * epoch + 1, dev), vlab)
            logging.info("\t Epoch %d | average valid loss: %.4f", epoch, valid_loss)
            history.append({"epoch": epoch, "train_loss": train_loss,
                            "valid_loss": valid_loss, "seconds": dt,
                            "steps": len(batches),
                            "triples_per_s": len(train_examples) / dt})

            stopped_early = False
            if epoch % args.valid == 0:
                valid_metrics = avg_both(compute_metrics(
                    model, dataset, "valid", args.eval_batch_size, rank_fn=rank_fn))
                logging.info(format_metrics(valid_metrics, split="valid"))
                valid_mrr = valid_metrics["MRR"]
                if best_mrr is None or valid_mrr > best_mrr:
                    best_mrr, counter, best_epoch = valid_mrr, 0, epoch
                    logging.info("\t Saving model at epoch %d in %s", epoch, save_dir)
                    save(config={"args": vars(args)})
                else:
                    counter += 1
                    if counter >= args.patience:
                        logging.info("\t Early stopping")
                        stopped_early = True
                # after the best-checkpoint update, so a resumed run restores
                # the post-validation best_mrr and counter
                save("latest.pkl", extra={"counter": counter, "best_epoch": best_epoch})
            if stopped_early:
                break
            # after the epoch's validation, so a resumed run repeats it exactly
            if stop_signal["flag"]:
                save("latest.pkl", extra={"counter": counter, "best_epoch": best_epoch})
                logging.info("\t Stopped by signal at epoch %d; latest state "
                             "saved — resume with --resume", epoch)
                break
    finally:
        if old_handler is not None:
            signal.signal(signal.SIGTERM, old_handler)

    logging.info("\t Optimization finished")
    if best_mrr is not None:
        logging.info("\t Loading best model saved at epoch %s", best_epoch)
        load_into(model, save_dir)
    else:
        # the last completed epoch, which --resume continues from
        save(config={"args": vars(args)})

    valid_metrics = avg_both(compute_metrics(
        model, dataset, "valid", args.eval_batch_size, rank_fn=rank_fn))
    logging.info(format_metrics(valid_metrics, split="valid"))
    test_metrics = avg_both(compute_metrics(
        model, dataset, "test", args.eval_batch_size, rank_fn=rank_fn))
    logging.info(format_metrics(test_metrics, split="test"))
    for i in range(dataset.n_predicates // 2):
        rel_metrics = compute_metrics(model, dataset, "test", args.eval_batch_size,
                                      rel_idx=i, rank_fn=rank_fn)
        logging.info("\t Results for relation %d", i)
        logging.info(format_metrics(avg_both(rel_metrics), split="test"))
    return {"valid": valid_metrics, "test": test_metrics, "history": history}


def main():
    train(build_parser().parse_args())


if __name__ == "__main__":
    main()
