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
--edge_dropout, --dropout, --opn (mult, add, corr), --interaction
(distmult, transe, conve), --basis and --gnn_agg_method, and --k_w, --k_h,
--num_filt, --ker_sz for CompGCN's conve decoder (a 2 k_w x k_h image of
the head and relation rows, so --hidden_dim must be k_w * k_h; its batch
norms' running statistics ride in the checkpoints beside the params).
With --subgraph a GNN trains on sampled subgraphs
instead (train/subgraph.py: batches of --batch_size seed edges, CE or BCE
over each subgraph's nodes, --neg_sample_size 0); the validation loss and
validation stay on the full graph.  It composes with --mesh and
--distributed below: every rank samples each step's subgraph, each data
row trains on its slice of the seed queries, and the entity tables stay
row-sharded, a step gathering only its subgraph's rows.  --profile_dir
writes a torch.profiler trace of the second epoch's training (the first's
when it is the only one); without --subgraph it holds a range
kge.train.step for every step, with its phases kge.train.loss,
kge.train.backward and kge.train.optimizer inside
(utils/profiling.py::span).  --debug_nans checks every training step and
raises FloatingPointError at the first non-finite loss or NaN gradient
(utils/profiling.py).  Runs on the card unless --device cpu.

--mesh DxM trains on D x M ranks, one process each (parallel/mesh.py):
rank r at (d, m) = (r // M, r % M).  Each data row trains on its slice of
every batch (the gradients summed over the data rows); with M > 1 the
entity tables are row-sharded over the model group and validation and
the final test rank through the entity-sharded rankers
(parallel/ranking.py::make_best_sharded_ranker), the fused kernels on each
rank's slice.  Results equal the one-process run's up to the order in
which the ranks' gradients add.  Without --distributed, D x M > 1 starts
the ranks here (torch.multiprocessing, a localhost TCP store):

    python -m complexhyperbolickge_torch.cli.run ... --mesh 2x2

--distributed joins a process group instead: --coordinator host:port,
--num_processes and --process_id, or torchrun's environment (env://)
when they are absent; D x M must equal the world size (the default mesh
is world x 1):

    torchrun --nproc_per_node 4 -m complexhyperbolickge_torch.cli.run ... \
        --distributed --mesh 2x2

Each rank takes cuda:(local rank % device count) unless --device cpu; the
backend is NCCL when every rank of a node has a card of its own, gloo when
ranks share a card or run on the CPU.  Rank 0 alone writes config.json,
train.log and the checkpoints, which stay canonical (unpadded, gathered
from the model group), so a mesh run resumes under any other mesh or none.
--subgraph composes with both; a --batch_size that the data axis does not
divide raises before any rank starts:

    python -m complexhyperbolickge_torch.cli.run --model CompGCN --subgraph \
        --neg_sample_size 0 --loss crossentropy --batch_size 500 ... --mesh 2x1
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import socket
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from complexhyperbolickge_torch.data.dataset import KGData, epoch_batches, synthetic_kg
from complexhyperbolickge_torch.kernels._ranker import BACKENDS
from complexhyperbolickge_torch.models import GNN_MODELS, ModelConfig, get_model
from complexhyperbolickge_torch.parallel.mesh import (
    gather_entity_tree,
    make_mesh,
    parse_shape,
    shard_entity_tree,
)
from complexhyperbolickge_torch.parallel.ranking import make_best_sharded_ranker
from complexhyperbolickge_torch.train.checkpoint import (
    PickledStub,
    load_buffers,
    load_checkpoint,
    opt_state_from_jax,
    params_from_jax,
    save_checkpoint,
    state_buffers,
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
from complexhyperbolickge_torch.utils.profiling import trace

DATASETS = ["FB15K", "WN", "WN18RR", "FB237", "YAGO3-10", "synthetic"]
# the GNN flags and their defaults; k_w, k_h, num_filt and ker_sz shape
# CompGCN's conve decoder (CompGCN's published values)
_GNN_DEFAULTS = {"hidden_dim": 200, "edge_dropout": 0.3, "layers": 2,
                 "opn": "mult", "interaction": "distmult", "basis": 0,
                 "gnn_agg_method": 1, "k_w": 10, "k_h": 20, "num_filt": 200, "ker_sz": 7}

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
                   choices=BACKENDS,
                   help="auto/pallas = masked fused CUDA ranker (K1 FFT, K5 "
                        "Poincare and Lorentz, K7 AttRH), pallas_maskless = "
                        "maskless fused rankers (K2, K6, K8), dense = "
                        "materialized (B, N) scores")
    p.add_argument("--eval_precision", default="highest",
                   choices=["highest", "default"])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    for flag in ("mesh", "coordinator"):
        p.add_argument(f"--{flag}", default=None)
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of epoch 2 (or 1 when it is the "
                        "only one) into this directory; each training step is a range "
                        "kge.train.step holding kge.train.loss, kge.train.backward and "
                        "kge.train.optimizer")
    p.add_argument("--num_processes", default=None, type=int)
    p.add_argument("--process_id", default=None, type=int)
    for flag in ("distributed", "debug_nans", "subgraph"):
        p.add_argument(f"--{flag}", action="store_true")
    for flag, default in _GNN_DEFAULTS.items():
        p.add_argument(f"--{flag}", default=default, type=type(default))
    return p


def epoch_generator(seed: int, stream: int, device) -> torch.Generator:
    """The torch.Generator of one (seed, stream) pair on `device`, as the
    JAX package folds `stream` into PRNGKey(seed): stream 2 * epoch draws
    the epoch's training negatives, 2 * epoch + 1 its validation ones."""
    state = np.random.SeedSequence([seed, stream]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def _canonical(model, trainer) -> dict:
    """The model's state_dict at canonical shapes (meta tensors for the
    row-sharded tables): what a checkpoint is checked against."""
    n = model.cfg.n_entities
    return {k: torch.empty((n,) + tuple(v.shape[1:]), dtype=v.dtype, device="meta")
            if k in trainer.sharded else v for k, v in model.state_dict().items()}


def _load_params(model, trainer, params, mesh):
    """Canonical checkpoint params into the model (load_state_dict casts
    to its dtypes): padded by name and cut to this rank's rows for a
    row-sharded model."""
    params = params_from_jax(params, next(model.parameters()).device)
    if trainer.sharded:
        params = shard_entity_tree(params, model.cfg.n_entities, mesh.m, mesh.n_model)
    model.load_state_dict(params)


def _resume(save_dir, model, trainer, mesh=None):
    """Load the newer of latest.pkl and state.pkl (latest.pkl on a tie: it
    carries counter and best_epoch) into model and trainer; returns the
    checkpoint, or None when there is none.  On a mesh every rank loads the
    canonical file and keeps its rows of the entity tables and moments."""
    found = [load_checkpoint(save_dir, expect_params=_canonical(model, trainer), filename=fn,
                             n_entities=model.cfg.n_entities)
             for fn in ("latest.pkl", "state.pkl")
             if os.path.exists(os.path.join(save_dir, fn))]
    if not found:
        return None
    st = max(found, key=lambda s: s["epoch"])
    _load_params(model, trainer, st["params"], mesh)
    load_buffers(model, st)
    opt_state = st["opt_state"]
    if opt_state is None:
        logging.info("Checkpoint has no optimizer state: warm-starting from "
                     "its params with a fresh optimizer")
    else:
        if isinstance(opt_state, PickledStub):  # written by the JAX package
            opt_state = opt_state_from_jax(opt_state)
        if trainer.sharded:
            opt_state = shard_entity_tree(opt_state, model.cfg.n_entities, mesh.m, mesh.n_model)
        trainer.load_opt_state(opt_state)
    logging.info("Resumed from epoch %d", st["epoch"])
    return st


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (for a rendezvous on this host)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def train(args) -> dict:
    """Train per the run config `args` (build_parser's namespace); returns
    the final valid and test metrics and the per-epoch history (rank 0's,
    which every rank shares, on a mesh).

    --distributed joins the process group the flags or torchrun's
    environment describe; --mesh DxM alone, with D x M > 1, starts the
    D x M ranks here (one process each, a localhost TCP store) and returns
    rank 0's result; one process otherwise."""
    shape = parse_shape(args.mesh) if args.mesh else None
    if args.distributed:
        if args.coordinator:
            if args.num_processes is None or args.process_id is None:
                raise ValueError("--coordinator needs --num_processes and --process_id")
            world, rank = args.num_processes, args.process_id
            init, local = args.coordinator, None
        else:  # torchrun's environment
            world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
            init = "env://"
            local = (int(os.environ.get("LOCAL_RANK", rank)),
                     int(os.environ.get("LOCAL_WORLD_SIZE", world)))
        shape = shape or (world, 1)
        _check_subgraph_batch(args, shape)
        return run_rank(args, shape, world, rank, init, local)
    if shape is not None:
        _check_subgraph_batch(args, shape)
    if shape is not None and shape[0] * shape[1] > 1:
        world = shape[0] * shape[1]
        results = torch.multiprocessing.get_context("spawn").SimpleQueue()
        ranks = torch.multiprocessing.start_processes(
            _spawned, args=(args, shape, f"127.0.0.1:{free_port()}", results),
            nprocs=world, join=False, start_method="spawn")
        out = None
        # read rank 0's result while joining (a result larger than the
        # pipe's buffer blocks its writer until read); join re-raises a
        # rank's exception
        while not ranks.join(timeout=1.0):
            if out is None and not results.empty():
                out = results.get()
        return results.get() if out is None else out
    return _train(args, None)


def _check_subgraph_batch(args, shape):
    """--subgraph splits each step's seed queries over the data axis, which
    must divide --batch_size (SubgraphTrainer raises alike on every rank)."""
    if args.subgraph and args.batch_size % shape[0]:
        raise ValueError(f"--subgraph --batch_size {args.batch_size} must divide by the mesh's "
                         f"'data' axis {shape[0]}")


def _spawned(rank, args, shape, init, results):
    """One rank of a mesh that train() started on this host."""
    world = shape[0] * shape[1]
    out = run_rank(args, shape, world, rank, init, (rank, world))
    if rank == 0:
        results.put(out)


def process_device(device: str, local_rank: int, local_world: int):
    """(device, backend) of a rank: cuda:(local_rank % device_count) under
    NCCL when every rank of the node has a card of its own, under gloo when
    ranks share a card (NCCL refuses two ranks on one device) or run on the
    CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev, "gloo"
    count = torch.cuda.device_count()
    dev = torch.device("cuda", local_rank % count)
    return dev, ("nccl" if local_world <= count else "gloo")


def node_layout(store, world: int, rank: int):
    """(local rank, ranks on this node) of `rank`, from every rank's host
    name set in the rendezvous store."""
    store.set(f"host/{rank}", socket.gethostname())
    hosts = [store.get(f"host/{r}").decode() for r in range(world)]
    return hosts[:rank].count(hosts[rank]), hosts.count(hosts[rank])


def run_rank(args, shape, world: int, rank: int, init: str, local=None) -> dict:
    """Join the process group as `rank` of `world`, train on the (D, M)
    mesh `shape`, and leave the group.  init: "env://" (torchrun's
    environment) or the host:port of the TCP store that rank 0 hosts.
    local: (local rank, ranks on this node); None learns it from the
    ranks' host names through the store (node_layout), so ranks of several
    hosts launched with --coordinator pick their card and backend right.
    An NCCL failure raises; nothing falls back to gloo."""
    kw = {"init_method": init}
    if init != "env://":
        host, port = init.rsplit(":", 1)
        kw = {"store": dist.TCPStore(host, int(port), world, is_master=rank == 0)}
        local = local or node_layout(kw["store"], world, rank)
    local_rank, local_world = local
    dev, backend = process_device(getattr(args, "device", "cuda"), local_rank, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, world_size=world, rank=rank, **kw)
    try:
        mesh = make_mesh(shape, dev, local_size=local_world)
        return _train(args, mesh, backend)
    finally:
        dist.destroy_process_group()


def _train(args, mesh, backend: str | None = None) -> dict:
    """The training protocol of one process, or of one rank of `mesh`:
    rank 0 alone writes config.json, the log and the checkpoints, and the
    other ranks log warnings to stderr."""
    lead = mesh is None or mesh.rank == 0
    dev = resolve_device(getattr(args, "device", "cuda")) if mesh is None else mesh.device
    save_dir = args.save_dir
    if lead:
        os.makedirs(save_dir, exist_ok=True)
        setup_logging(save_dir)
        logging.info("Saving logs in: %s", save_dir)
    else:
        logging.basicConfig(format="%(asctime)s rank " + str(mesh.rank) + " %(levelname)-8s "
                            "%(message)s", level=logging.WARNING, stream=sys.stderr, force=True)
    if mesh is not None:
        logging.info("Mesh: data=%d model=%d over %d ranks, %s backend, rank 0 on %s",
                     mesh.n_data, mesh.n_model, mesh.size, backend, dev)
    apply_dtype_policy(args)

    dataset = load_dataset(args)
    sizes = dataset.get_shape()
    logging.info("\t %s", str(sizes))
    if lead:
        with open(os.path.join(save_dir, "config.json"), "w") as f:
            json.dump(vars(args), f, indent=2)

    model = build_model(args, dataset, dev,
                        generator=torch.Generator().manual_seed(args.seed))
    logging.info("Total number of parameters %d", count_params(model))
    tcfg = TrainConfig(
        regularizer=args.regularizer, reg=args.reg, optimizer=args.optimizer,
        learning_rate=args.learning_rate, batch_size=args.batch_size,
        update_steps=args.update_steps, neg_sample_size=args.neg_sample_size,
        neg_mode=args.neg_mode, neg_pool_size=args.neg_pool_size,
        loss=args.loss, smoothing=args.smoothing, double_neg=args.double_neg,
    )
    trainer = Trainer(model, tcfg, sizes[0], sizes[1], mesh=mesh)
    trainer.debug_nans = args.debug_nans
    sub_trainer = None
    if args.subgraph:
        from complexhyperbolickge_torch.train.subgraph import SubgraphTrainer

        # one optimizer: the checkpoint and --resume code read trainer's
        sub_trainer = SubgraphTrainer(model, tcfg, dataset, mesh=mesh,
                                      optimizer=trainer.optimizer)
        sub_trainer.debug_nans = args.debug_nans
        logging.info("Subgraph training: %s sampler, %d steps an epoch",
                     sub_trainer.sampler.backend, sub_trainer.steps(args.batch_size))

    train_examples = dataset.get_examples("train")
    labels, valid_labels = None, None
    if tcfg.neg_sample_size <= 0 and tcfg.loss == "binarycrossentropy":
        # BCE labels: train facts for train, train + valid facts for valid
        _, labels = dataset.label_pack("train")
        _, valid_labels = dataset.label_pack("valid")
    start_epoch, best_mrr, best_epoch, counter = 1, None, None, 0
    if args.resume:
        st = _resume(save_dir, model, trainer, mesh)
        if st is not None:
            start_epoch = st["epoch"] + 1
            best_mrr = st["best_mrr"]
            counter = st.get("counter", 0)
            best_epoch = st.get("best_epoch", None)

    if trainer.sharded:
        rank_fn = make_best_sharded_ranker(model, mesh, sizes[0], args.eval_backend,
                                           precision=args.eval_precision)
    else:
        rank_fn = make_best_ranker(model, args.eval_batch_size, args.eval_backend,
                                   precision=args.eval_precision)
    vb, vw, vlab = epoch_batches(dataset.get_examples("valid"), args.batch_size, None,
                                 valid_labels)

    def save(filename="state.pkl", **kw):
        # every rank joins the gathers of the row-sharded leaves
        params, opt_state = model.state_dict(), trainer.opt_state()
        if trainer.sharded:
            params = gather_entity_tree(params, sizes[0], mesh)
            opt_state = gather_entity_tree(opt_state, sizes[0], mesh)
        if lead:
            save_checkpoint(save_dir, params, opt_state, epoch, best_mrr,
                            filename=filename, buffers=state_buffers(model), **kw)

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
        # the second epoch is traced (the first pays the warm-up), or the
        # first when it is the only one
        profile_epoch = start_epoch + 1 if args.max_epochs > start_epoch else start_epoch
        for epoch in range(start_epoch, args.max_epochs + 1):
            t0 = time.perf_counter()
            rng = np.random.default_rng([args.seed, epoch])
            gen = epoch_generator(args.seed, 2 * epoch, dev)
            with trace(args.profile_dir if epoch == profile_epoch and lead else None):
                if sub_trainer is not None:
                    steps = sub_trainer.steps(args.batch_size)
                    train_loss = sub_trainer.run_epoch(args.batch_size, rng, gen,
                                                       epoch_id=epoch)
                else:
                    # every rank builds the whole epoch; the trainer keeps
                    # its slice of each batch
                    batches, weights, lab_b = epoch_batches(train_examples, args.batch_size,
                                                            rng, labels)
                    steps = len(batches)
                    train_loss = trainer.run_epoch(batches, weights, gen, lab_b,
                                                   epoch_id=epoch)
            dt = time.perf_counter() - t0
            logging.info("\t Epoch %d | average train loss: %.4f | %.0f triples/s",
                         epoch, train_loss, len(train_examples) / dt)
            valid_loss = trainer.valid_loss(vb, vw,
                                            epoch_generator(args.seed, 2 * epoch + 1, dev), vlab)
            logging.info("\t Epoch %d | average valid loss: %.4f", epoch, valid_loss)
            history.append({"epoch": epoch, "train_loss": train_loss,
                            "valid_loss": valid_loss, "seconds": dt,
                            "steps": steps,
                            "triples_per_s": len(train_examples) / dt})

            stopped_early = False
            if epoch % args.valid == 0:
                valid_metrics = avg_both(compute_metrics(
                    model, dataset, "valid", args.eval_batch_size, rank_fn=rank_fn))
                logging.info(format_metrics(valid_metrics, split="valid"))
                # rank 0's value: every rank takes the same branch below
                valid_mrr = (valid_metrics["MRR"] if mesh is None
                             else mesh.broadcast_float(valid_metrics["MRR"]))
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
            # after the epoch's validation, so a resumed run repeats it
            # exactly; a signal on any rank stops every rank
            stop = stop_signal["flag"] if mesh is None else mesh.any(stop_signal["flag"])
            if stop:
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
        if mesh is not None:
            mesh.barrier()  # rank 0's last write is complete
        st = load_checkpoint(save_dir, expect_params=_canonical(model, trainer),
                             cast_to_expected=True)
        _load_params(model, trainer, st["params"], mesh)
        load_buffers(model, st)
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
