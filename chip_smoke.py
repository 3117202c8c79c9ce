#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (complexhyperbolickge_torch) on one
NVIDIA GPU, at the width of the paper's model: FFTRotH, rank 33 (a 40,943 x
66 f32 entity table), bias=learn, multi_c, batch 500, on a synthetic KG
with WN18RR's shapes (40,943 entities, 11 relations, 86,835 / 3,034 / 3,134
train / valid / test triples).  Weights and data are drawn from --seed.

    python3 chip_smoke.py [--seed 0]

The real-hyperbolic family runs at the width of KGEmb's (HazyResearch, the
upstream of the reference) RotH WN18RR example, examples/
train_RotH_WN18RR_32.sh: rank 32 (a 40,943 x 32 f32 table), multi_c,
bias=learn, float32, eval batch 500; training with Adam lr 5e-4, N3 reg 0,
batch 500, 50 negatives, double_neg.  These values are recalled from that
script and were not checked against a copy of the file (this repo has
none).  RotLH (the Lorentz epilogue) and AttRH (the two-half ranker) run at
the same width in the kernel and kge-test phases.

The paths of the port are driven each with the kernels' launch counts
set to 0 just before it and read just after: FFT serving and evaluation
(kge-test, predict, HTTP), FFT training (cli.run.train at the published
WN18RR config: Adam lr 3e-4, N3 reg 0, 100 per-query negatives, 2 epochs),
FFT training at that config with each other loss, negative mode and
optimizer (the all-entity cross-entropy, BCE with label smoothing 0.1
through the label packs, shared negatives, a pool of 512, SparseAdam),
the real-hyperbolic path (kge-test of RotH, RotLH and AttRH, RotH
serving, 2 epochs of RotH training), and the GNN path at the JAX package's
full-graph CompGCN configuration (benchmarks/gnn_train_bench.py): rank 32,
hidden 200, 2 layers, opn mult, distmult, Adam lr 1e-3, batch 1000, 50
negatives, edge dropout 0.3, the encoder re-run over all 173,670 edges
every step (2 epochs of CompGCN training, 20 PoincareGCN steps, kge-test of
CompGCN, PoincareGCN, LorentzGCN and PoincareGAT, CompGCN serving).
Phases, one JSON line each; any failure exits non-zero without the final
line:
  1 device    the card (torch.cuda), then nvidia-smi's name and power limit
  2 build     nvcc builds every kernel from csrc/ (one nvcc per source, all
              started together)
  3 kernels   each CUDA kernel against its plain PyTorch version at the main
              paths' shapes: the rankers K1/K2 on an eval batch (the maskless
              count must equal the masked), the train distance K3/K4 in
              the clamped-at-init and 0.4 regimes: the gathered (identity)
              form at (500, 100, 66), and the id form of the training step,
              500 x (1 + 100) sampler-drawn ids over a 40,943 x 66 table
  4 train-step parity  3 Adam steps through K3/K4 (one launch of each a
              step) and through the plain version from the same params and
              negatives: params agree
  5 hyp-run   run dirs of RotH, RotLH and AttRH with planted test answers
              (write_run, plant): how many folds could be inverted
  6 hyp-kernels  K5 (Poincare on RotH, Lorentz on RotLH), K6, K7 and K8
              (AttRH) and the sweeps' radius tables against their plain
              versions on an eval batch (B 500, Np 40,960, D 32); the
              sweeps' curvature cvals[cid] is get_queries'; maskless ==
              masked exactly
  7 kge-test  cli.test.test() with the auto (masked kernel), pallas_maskless
              and dense rankers: MRR equal within 1e-4, fused ranks identical;
              plus whole-split ranking throughput per ranker
  8 serve     PredictService top-k (filtered and unfiltered) against the
              argmax of the dense score_all, and one POST /predict over HTTP
  9 train     cli.run.train(): the loss finite and falling from epoch 1 to 2,
              final test metrics through K1; triples/s and ms/step per epoch
  9a ce-train, bce-train, neg-modes-train-shared, neg-modes-train-pool,
              sparse-adam-train  phase 9 with --neg_sample_size 0 and
              --loss crossentropy; --loss binarycrossentropy --smoothing 0.1;
              --neg_mode shared; --neg_mode pool --neg_pool_size 512;
              --optimizer SparseAdam.  loss-launches: K1 in each, K3/K4
              and chyp_train_lists at least once a SparseAdam step
  9b ce-step parity  one CE and one BCE loss and gradient on the card in
              float32 against the CPU in float64 (CE_PARITY_TOL)
  9c euc-train-RotE, euc-train-ComplEx, euc-kge-test  RotE and ComplEx
              through cli.run.train at the RotH config, 2 epochs; kge-test
              of planted run dirs of the nine Euclidean and complex models
              through the dense ranker (MRR >= 0.25)
 10 hyp-kge-test, hyp-serve, hyp-train  phases 7-9 on the real-hyperbolic
              path: kge-test per model, RotH serving, RotH training (eager
              autograd, no kernel in the step; validation and the final test
              through K5)
 11 launches  each path's kernel launches; a kernel of a path that never
              launched there fails the run, K3/K4 (and chyp_train_lists,
              K4's index preparation) must launch at least once
              per training step, and each of RotH, RotLH and AttRH must
              launch its family's three kernels and the radius launcher
 12 gnn-kernels  K9 against index_add_ (rtol 1e-5, atol 1e-6) and K10 against
              x[ids] (bitwise) on one sorted half of the graph (E 86,835, N
              40,943) at H = 1, 32, 200, forward and backward, in float32
              and in bfloat16 (K9 within one bfloat16 ulp, K10 bitwise)
 13 gnn-encode parity  each GNN model's encode through K9/K10 and through
              their plain versions (rtol 1e-4, atol 1e-5)
 14 gnn-train-step parity  3 Adam steps of CompGCN, kernels against plain
              (float64 held to PARITY_TOL; float32 reported); gnn-bf16-train:
              12 Adam steps of a bfloat16 CompGCN through K9/K10's bfloat16
              instances, the loss finite and falling, float32 optimizer
              state
 15 gnn-train, gnn-step-window, gnn-kge-test, gnn-serve  the GNN path:
              2 epochs of CompGCN through cli.run.train, 20 PoincareGCN
              steps, kge-test of the four models (dense ranker over the
              cached encoding), CompGCN serving; gnn-launches: K9/K10 at
              least once per training step and in every kge-test
 16 profile   torch.profiler over one whole-split ranking per ranker (FFTRotH
              and RotH) and over 20 training steps of each, of CompGCN and
              of FFTRotH's CE and BCE steps: wall time, device busy time and
              idle share, kernels a step, top kernels and host ops
 17 the kernels line: launches, and the times of kernel, plain version and
              library call beside the kernel's bound (and the rankers' busy
              time per call and the training step's device time; the sweeps'
              registers, blocks per SM, shared and local bytes; K9/K10's
              bfloat16 instances under "bfloat16")
 18 {"ok": true, "device": {...}}
Needs no network; the HTTP server listens on 127.0.0.1 and is shut down.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
import traceback
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
DEVICE = "cuda"  # of the phases that build their own tensors

WN18RR = dict(synthetic_entities=40943, synthetic_relations=11,
              synthetic_train=86835, synthetic_valid=3034, synthetic_test=3134)
RANK, BATCH, NEG = 33, 500, 100
REPS = 5  # timed repetitions of a whole-split ranking
EPOCHS = 2  # training epochs of the train phase
PROFILE_STEPS = 20  # training steps in the profiled window
# the paper's published WN18RR training config (README.md)
TRAIN_FLAGS = ["--model", "FFTRotH", "--regularizer", "N3", "--reg", "0.0",
               "--optimizer", "Adam", "--rank", str(RANK), "--batch_size", str(BATCH),
               "--neg_sample_size", str(NEG), "--learning_rate", "3e-4", "--multi_c",
               "--bias", "learn", "--dtype", "float32"]
# K3/K4 against their plain version: the JAX kernel test's tolerances
TRAIN_FWD_TOL = dict(rtol=1e-5, atol=0.0)
TRAIN_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARITY_TOL = dict(rtol=1e-5, atol=1e-7)

# peak rates by card, from NVIDIA's data sheets (dense, no sparsity): fp32
# outside the tensor cores (the kernels are exact fp32), memory bandwidth,
# and fp64 outside the tensor cores (K3/K4 accumulate their dots in fp64)
PEAKS = {"H100 PCIe": (51.2e12, 2.0e12, 25.6e12), "H100 NVL": (60.0e12, 3.9e12, 30.0e12),
         "H100": (67.0e12, 3.35e12, 34.0e12), "H200": (67.0e12, 4.8e12, 34.0e12)}

KERNEL_META = {
    "chyp_rank_sweep_masked": "complexhyperbolickge_tpu/kernels/chyp_rank.py:147",
    "chyp_rank_sweep_nomask": "complexhyperbolickge_tpu/kernels/chyp_rank.py:213",
    "chyp_rank_filtered_sub": "complexhyperbolickge_tpu/kernels/chyp_rank.py:230",
    "chyp_train_fwd": "complexhyperbolickge_tpu/kernels/chyp_train.py:89",
    "chyp_train_bwd": "complexhyperbolickge_tpu/kernels/chyp_train.py:117",
    "hyp_rank_sweep_masked": "complexhyperbolickge_tpu/kernels/hyp_rank.py:502",
    "hyp_rank_sweep_nomask": "complexhyperbolickge_tpu/kernels/hyp_rank.py:545",
    "hyp_rank_filtered_sub": "complexhyperbolickge_tpu/kernels/hyp_rank.py:563",
    "attrh_rank_sweep_masked": "complexhyperbolickge_tpu/kernels/hyp_rank.py:253",
    "attrh_rank_sweep_nomask": "complexhyperbolickge_tpu/kernels/hyp_rank.py:294",
    "attrh_rank_filtered_sub": "complexhyperbolickge_tpu/kernels/hyp_rank.py:312",
    "sorted_segment_sum": "complexhyperbolickge_tpu/kernels/segsum.py:98",
    "row_gather": "complexhyperbolickge_tpu/kernels/gather.py:94",
}
SOURCES = {"chyp_rank": "complexhyperbolickge_torch/kernels/csrc/chyp_rank.cu",
           "chyp_train": "complexhyperbolickge_torch/kernels/csrc/chyp_train.cu",
           "hyp_rank": "complexhyperbolickge_torch/kernels/csrc/hyp_rank.cu",
           "sorted_segment_sum": "complexhyperbolickge_torch/kernels/csrc/segsum.cu",
           "row_gather": "complexhyperbolickge_torch/kernels/csrc/gather.cu"}
RANK_KERNELS = ("chyp_rank_sweep_masked", "chyp_rank_sweep_nomask",
                "chyp_rank_filtered_sub")
TRAIN_KERNELS = ("chyp_train_fwd", "chyp_train_bwd")

# the real-hyperbolic path (KGEmb's RotH WN18RR 32-dim example, see above)
HYP_RANK, HYP_NEG = 32, 50
HYP_MODELS = {"RotH": "poincare", "RotLH": "lorentz", "AttRH": "attrh"}
HYP_TRAIN_FLAGS = ["--model", "RotH", "--regularizer", "N3", "--reg", "0.0",
                   "--optimizer", "Adam", "--rank", str(HYP_RANK), "--batch_size", str(BATCH),
                   "--neg_sample_size", str(HYP_NEG), "--double_neg", "--learning_rate", "5e-4",
                   "--multi_c", "--bias", "learn", "--dtype", "float32"]
TRAIN_CONFIGS = {"FFTRotH": dict(optimizer="Adam", learning_rate=3e-4, neg_sample_size=NEG),
                 "RotH": dict(optimizer="Adam", learning_rate=5e-4, neg_sample_size=HYP_NEG,
                              double_neg=True)}
# the FFT training phases of the all-entity losses, the negative modes and
# SparseAdam: TRAIN_FLAGS with the later flags overriding (argparse keeps
# the last occurrence)
LOSS_TRAIN_FLAGS = {
    "ce-train": [*TRAIN_FLAGS, "--neg_sample_size", "0", "--loss", "crossentropy"],
    "bce-train": [*TRAIN_FLAGS, "--neg_sample_size", "0", "--loss", "binarycrossentropy",
                  "--smoothing", "0.1"],
    "neg-modes-train-shared": [*TRAIN_FLAGS, "--neg_mode", "shared"],
    "neg-modes-train-pool": [*TRAIN_FLAGS, "--neg_mode", "pool", "--neg_pool_size", "512"],
    "sparse-adam-train": [*TRAIN_FLAGS, "--optimizer", "SparseAdam"],
}
TRAIN_CONFIGS.update({
    "FFTRotH CE": dict(optimizer="Adam", learning_rate=3e-4, neg_sample_size=0,
                       loss="crossentropy"),
    "FFTRotH BCE": dict(optimizer="Adam", learning_rate=3e-4, neg_sample_size=0,
                        loss="binarycrossentropy", smoothing=0.1)})
# the all-entity step on the card in float32 against the CPU in float64, at
# params well inside the ball (entity ~ N(0, 0.05): the f32 and f64 ball
# clamps differ, 4e-3 against 1e-5): loss relative error, and each gradient's
# max error over its largest entry (floored at 1e-2 of the largest entry of
# all gradients: CE's bh gradient is zero in exact arithmetic, so its own
# scale is float32 noise).  Exact fp32 gives ~1e-6 (a CPU probe at 6,000
# entities); a TF32 contraction ~1e-3
CE_PARITY_TOL = {"loss_rel": 1e-5, "grad_rel": 1e-4}
# the Euclidean and complex families: RotE and ComplEx train at the RotH
# phase's config (HYP_TRAIN_FLAGS); all nine rank densely from planted run
# dirs.  The dot-product scorers' planted rows are their query points scaled
# to norm DOT_PLANT_NORM, which dominates every other row's inner product
EUC_MODELS = ("TransE", "CP", "MurE", "RotE", "RefE", "AttE", "ComplEx", "RotatE", "Fourier")
DOT_MODELS = ("CP", "ComplEx", "RotatE", "Fourier")
EUC_TRAIN = ("RotE", "ComplEx")
DOT_PLANT_NORM = 10.0
HYP_RANK_KERNELS = ("hyp_rank_sweep_masked", "hyp_rank_sweep_nomask", "hyp_rank_filtered_sub")
ATTRH_KERNELS = ("attrh_rank_sweep_masked", "attrh_rank_sweep_nomask",
                 "attrh_rank_filtered_sub")
# the kernels' inputs in wrapper order (kernels/hyp_rank.py): the filtered
# subtractions' leading inputs (each query's curvature c), and the sweeps'
# (curvature ids into the ranker's cvals, and its radius table), followed
# by the mask (K5, K7) or the gold (K6, K8)
HYP_ARGS = {"hyp": ("lhs", "x2", "c", "t2", "rhs", "un", "bt"),
            "attrh": ("lhs", "x2r", "x2f", "c", "w0", "w1", "t2", "rhs", "un_rot", "un_ref",
                      "bt")}
HYP_SWEEP_ARGS = {"hyp": ("lhs", "x2", "cid", "cvals", "t2", "rhs", "un", "bt", "radii"),
                  "attrh": ("lhs", "x2r", "x2f", "cid", "cvals", "w0", "w1", "t2", "rhs",
                            "un_rot", "un_ref", "bt", "radii")}
# the radius table against its plain version: libdevice's tanhf / sinhf and
# torch's may round apart
RADII_MAX_ULP = 2
# the GNN path: the JAX package's full-graph CompGCN configuration
# (benchmarks/gnn_train_bench.py:27-51, the README's full-graph CompGCN row)
# at the CLI's default edge dropout 0.3: rank 32, hidden 200, 2 layers,
# opn mult, distmult, basis 0, Adam lr 1e-3, batch 1000, 50 per-query
# negatives, N3 reg 0, multi_c, bias learn, float32; 173,670 edges with
# inverses re-encoded every step
GNN_RANK, GNN_BATCH, GNN_NEG = 32, 1000, 50
GNN_MODELS = ("CompGCN", "PoincareGCN", "LorentzGCN", "PoincareGAT")
GNN_ARGS = dict(hidden_dim=200, layers=2, edge_dropout=0.3, dropout=0.0, opn="mult",
                interaction="distmult", basis=0, gnn_agg_method=1)
GNN_TRAIN_FLAGS = ["--model", "CompGCN", "--regularizer", "N3", "--reg", "0.0",
                   "--optimizer", "Adam", "--rank", str(GNN_RANK), "--batch_size", str(GNN_BATCH),
                   "--neg_sample_size", str(GNN_NEG), "--learning_rate", "1e-3", "--multi_c",
                   "--bias", "learn", "--dtype", "float32",
                   *[str(x) for k, v in GNN_ARGS.items() for x in (f"--{k}", v)]]
GNN_TRAIN_CONFIG = dict(optimizer="Adam", learning_rate=1e-3, neg_sample_size=GNN_NEG)
GNN_KERNELS = ("sorted_segment_sum", "row_gather")
GNN_WIDTHS = (1, 32, 200)  # K9 / K10 widths on the encoder: edge weights, rank, hidden
GNN_KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)  # K9 against index_add_: another order
# a whole 2-layer encode, kernels vs plain: float32 (the hyperbolic maps
# amplify summation-order noise near the ball's edge) and float64
GNN_ENCODE_TOL = dict(rtol=1e-4, atol=1e-4)
GNN_ENCODE_TOL_F64 = dict(rtol=1e-9, atol=1e-9)
PROFILE_GNN_STEPS = 20
# K9/K10's bfloat16 instances against their plain versions: both sum in
# float32 (in other orders) and round once, so one bfloat16 ulp (2^-7
# relative) where the float32 sums straddle a rounding boundary
GNN_BF16_TOL = dict(rtol=2 ** -7, atol=1e-5)
BF16_STEPS = 12  # Adam steps of the bfloat16 CompGCN phase
# fp32 operations of one pair's epilogue after the contraction, counted in
# csrc/hyp_rank.cu (pair_score) with every +, -, *, /, sqrt, clamp and
# transcendental call as one: a floor, since a tanhf or log1pf is ~20
# instructions
EPILOGUE_OPS = {"poincare": 54, "lorentz": 23, "attrh": 93}


def emit(obj):
    print(json.dumps(obj), flush=True)


def peak_rates(name: str):
    for key in ("H100 PCIe", "H100 NVL", "H200", "H100"):
        if key.replace(" ", "").lower() in name.replace(" ", "").lower():
            return PEAKS[key]
    return PEAKS["H100"]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `reps` back-to-back calls (CUDA events).
    The stream first sleeps ~0.1 s on the card while the host enqueues all
    calls, so the host's launch overhead does not open gaps between them."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    return name, smi


def phase_build():
    from complexhyperbolickge_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for log in _build.build_logs.values()
             for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": secs, "sources": list(_build.SOURCES),
          "ptxas": ptxas})


def plant(name: str, pack):
    """Entity rows that put each query's gold tail at distance ~0 from its
    query point, and which rows could be made so.  FFTRotH scores the raw
    row: the query point itself.  The real-hyperbolic models map a tail row
    v through folds of its radius |v|, keeping its direction; inverting the
    folds in float64, with x the query point (per half for AttRH):
      RotH:  the point has radius tanh(sqrt_c m) / sqrt_c with m = tanh(
             sqrt_c |v|) / sqrt_c, so m = artanh(sqrt_c |x|) / sqrt_c and
             |v| = artanh(sqrt_c m) / sqrt_c; no row exists once sqrt_c m
             reaches project()'s clip 1 - 4e-3 (the row is then left drawn);
      RotLH: radius sinh(sqrt_c |v|) / sqrt_c, so |v| = asinh(sqrt_c |x|) /
             sqrt_c, always;
      AttRH: one tanh a half, |v_h| = artanh(sqrt_c |x_h|) / sqrt_c, below
             the distance's artanh clamp 1 - 1e-5.
    The Euclidean distance models (TransE ... AttE) score the raw row: the
    query point; the dot-product ones (CP and the complex family) take the
    query's direction at norm DOT_PLANT_NORM."""
    import torch

    from complexhyperbolickge_torch.kernels.hyp_rank import ONE_MINUS_EPS

    x = pack[0].double()
    ok = torch.ones(len(x), dtype=torch.bool)
    if name in DOT_MODELS:
        return (x / x.norm(dim=-1, keepdim=True) * DOT_PLANT_NORM).float(), ok
    if name not in HYP_MODELS:
        return pack[0], ok
    sc = pack[1].double().expand(len(x), 1).sqrt()
    rows = []
    for h in (x.chunk(2, dim=-1) if name == "AttRH" else (x,)):
        g = h.norm(dim=-1, keepdim=True)
        if name == "RotLH":
            r = torch.asinh(sc * g) / sc
        else:
            m = torch.atanh(sc * g) / sc if name == "RotH" else g
            lim = ONE_MINUS_EPS if name == "RotH" else 1.0 - 1e-5
            ok &= (sc * m < lim)[:, 0]  # False on NaN too
            r = torch.atanh(sc * m) / sc
        rows.append(h / g * r)
    return torch.cat(rows, dim=-1).float(), ok


def write_run(seed: int, name: str = "FFTRotH"):
    """A run dir as the trainer writes it: config.json and state.pkl with
    `name`'s weights drawn from `seed` (entity ~ N(0, 0.1) keeps the points
    well inside the ball and the scores distinct; the real-hyperbolic
    models take N(0, 0.05), so that their query folds stay invertible, and
    bt ~ N(0, 0.01), below their smaller distances; the Euclidean and
    complex models bt ~ N(0, 0.01) as well, below the nearest unplanted
    row's distance or inner-product gap).  Random
    weights rank the gold near N/2, so the test answers are planted: each
    test tail's row is set so that the gold lies at distance ~0 from its
    (head, rel) query point (plant), wherever the head's own row was not
    overwritten after.  Tail prediction then finds most golds at rank 1,
    and MRR says whether ranking works.  Returns the dir and the number of
    test tails whose folds could not be inverted."""
    import numpy as np
    import torch

    from complexhyperbolickge_torch.cli.run import build_model, load_dataset
    from complexhyperbolickge_torch.train.checkpoint import save_checkpoint

    hyp = name in HYP_MODELS
    args = dict(dataset="synthetic", synthetic_seed=seed, data_path="data",
                debug=False, model=name, rank=RANK if name == "FFTRotH" else HYP_RANK,
                init_size=1e-3,
                bias="learn", gamma=0.0, multi_c=True, dtype="float32",
                dropout=0.0, eval_batch_size=BATCH, eval_backend="auto",
                eval_precision="highest", **WN18RR)
    ns = argparse.Namespace(**args)
    dataset = load_dataset(ns)
    model = build_model(ns, dataset, "cpu")
    rng = np.random.default_rng(seed)
    spread = {"entity": 0.1, "rel": 0.1, "bh": 0.1, "bt": 0.1, "c": 0.05, "weights": 0.1,
              "context_vec": 0.1}
    if hyp:
        spread.update(entity=0.05, rel=0.05, bt=0.01)
    elif name in EUC_MODELS:
        spread.update(bt=0.01)
    params = {}
    for k, v in model.state_dict().items():
        if k in ("rel_diag", "ref", "rot"):
            x = rng.uniform(-1.0, 1.0, v.shape)
        else:
            x = rng.normal(0.0, spread[k], v.shape) + (1.0 if k == "c" else 0.0)
        params[k] = torch.as_tensor(x, dtype=torch.float32)
    model.load_state_dict(params)
    test = dataset.get_examples("test").astype(np.int64)
    # a tail shared by several test triples takes its last triple's point
    # (chosen here: index_put with repeated indices picks no fixed winner)
    first_from_end = np.unique(test[::-1, 2], return_index=True)[1]
    test = torch.as_tensor(test[len(test) - 1 - first_from_end])
    with torch.no_grad():
        rows, ok = plant(name, model.get_queries(test[:, :2])[0])
    params["entity"][test[ok, 2]] = rows[ok]
    work = WORK if name == "FFTRotH" else WORK / name
    work.mkdir(parents=True, exist_ok=True)
    save_checkpoint(str(work), params, config={"args": args})
    return str(work), int((~ok).sum())


def near_threshold(scores, t2):
    """Per query: entities whose plain score is within 1e-5 (1 + |t2|) of t2."""
    return ((scores - t2[:, None]).abs() <= (1e-5 * (1 + t2.abs()))[:, None]).sum(1)


def phase_kernels(model, dataset):
    """Each kernel against its plain version on one main-path batch."""
    import torch

    from complexhyperbolickge_torch.kernels import chyp_rank as K

    dev = next(model.parameters()).device
    pack = dataset.eval_pack("test", "rhs")
    q = torch.as_tensor(pack.queries[:BATCH], dtype=torch.int64, device=dev)
    f = torch.as_tensor(pack.filter_idx[:BATCH], dtype=torch.int64, device=dev)
    ranker = K.ChypRanker(model)
    xm = ranker.kernel_inputs(q, f, masked=True)
    xn = ranker.kernel_inputs(q, f, masked=False)
    base = [xm[k] for k in ("lhs2", "zn", "t2", "rhs", "wn", "bt")]
    scores = K.chyp_scores_plain(*base[:2], *base[3:])
    near = near_threshold(scores, xm["t2"])
    pairs = {
        "chyp_rank_sweep_masked": (K.chyp_rank_counts, K.chyp_rank_counts_plain,
                                   [xm["mask"]]),
        "chyp_rank_sweep_nomask": (K.chyp_rank_sweep_nomask,
                                   K.chyp_rank_sweep_nomask_plain, [xn["gold"]]),
        "chyp_rank_filtered_sub": (K.chyp_rank_filtered_sub,
                                   K.chyp_rank_filtered_sub_plain,
                                   [xn["fidx"], xn["gold"]]),
    }
    result = {"phase": "kernels", "batch": BATCH, "Np": int(xm["rhs"].shape[0]),
              "D": int(xm["lhs2"].shape[1]), "ld": int(xm["rhs"].shape[1]),
              "L": int(xn["fidx"].shape[1]),
              "max_near_threshold": int(near.max()), "kernels": {}}
    errors = {}
    for name, (kernel, plain, extra) in pairs.items():
        got = kernel(*base, *extra)
        want = plain(*base, *extra)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        errors[name] = int(diff.max())
        result["kernels"][name] = {"max_abs_err": errors[name],
                                   "queries_differing": int((diff > 0).sum()),
                                   "within_tolerance": bool((diff <= near).all())}
        if not (diff <= near).all():
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"beyond the near-threshold count: {result}")
    k1 = K.chyp_rank_counts(*base, xm["mask"])
    k2 = K.chyp_rank_counts_nomask(*base, xn["fidx"], xn["gold"])
    result["maskless_equals_masked"] = bool(torch.equal(k1, k2))
    emit(result)
    if not result["maskless_equals_masked"]:
        raise AssertionError("K2 (sweep - subtraction) != K1 on a batch whose "
                             "golds are all filtered")
    return (q, f, xm, xn), errors


def hyp_family(family: str):
    """A real-hyperbolic family's kernels: (the subtractions' leading input
    names, plain all-entity scores of an input dict, kernel name ->
    (wrapper, plain version, input names in wrapper order), the maskless
    count of an input dict, the radius table of an input dict through the
    kernel and the plain version)."""
    from functools import partial

    from complexhyperbolickge_torch.kernels import hyp_rank as H

    g = "attrh" if family == "attrh" else "hyp"
    names, sweep = HYP_ARGS[g], HYP_SWEEP_ARGS[g]
    un = ("un_rot", "un_ref") if g == "attrh" else ("un",)

    def radii(x, fn):
        return fn(x["cvals"], x[un[0]], family, *(x[k] for k in un[1:]))

    tables = (partial(radii, fn=H.hyp_rank_radii), partial(radii, fn=H.hyp_rank_radii_plain))
    fam = {} if g == "attrh" else dict(family=family)
    counts_nomask = H.attrh_rank_counts_nomask if g == "attrh" else H.hyp_rank_counts_nomask

    def maskless(x):
        return counts_nomask(*(x[k] for k in sweep), x["fidx"], x["gold"], **fam)

    if g == "attrh":
        return names, lambda x: H.attrh_scores_plain(*(x[k] for k in names if k != "t2")), {
            "attrh_rank_sweep_masked": (H.attrh_rank_counts, H.attrh_rank_counts_plain,
                                        (*sweep, "mask")),
            "attrh_rank_sweep_nomask": (H.attrh_rank_sweep_nomask,
                                        H.attrh_rank_sweep_nomask_plain, (*sweep, "gold")),
            "attrh_rank_filtered_sub": (H.attrh_rank_filtered_sub,
                                        H.attrh_rank_filtered_sub_plain,
                                        (*names, "fidx", "gold")),
        }, maskless, tables
    return names, lambda x: H.hyp_scores_plain(*(x[k] for k in names if k != "t2"), **fam), {
        "hyp_rank_sweep_masked": (partial(H.hyp_rank_counts, **fam),
                                  partial(H.hyp_rank_counts_plain, **fam), (*sweep, "mask")),
        "hyp_rank_sweep_nomask": (partial(H.hyp_rank_sweep_nomask, **fam),
                                  partial(H.hyp_rank_sweep_nomask_plain, **fam),
                                  (*sweep, "gold")),
        "hyp_rank_filtered_sub": (partial(H.hyp_rank_filtered_sub, **fam),
                                  partial(H.hyp_rank_filtered_sub_plain, **fam),
                                  (*names, "fidx", "gold")),
    }, maskless, tables


def ulps_apart(a, b) -> int:
    """The largest distance in float32 units in the last place between two
    tensors of one sign pattern (a larger sentinel where signs differ)."""
    import torch

    if not torch.equal(torch.sign(a), torch.sign(b)):
        return 1 << 30
    return int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())


def phase_hyp_kernels(hyp: dict):
    """K5-K8 and the radius launcher against their plain versions on one
    test batch of each model (hyp: name -> (model, dataset)); the masked
    sweeps' curvature cvals[cid] is the one get_queries took, bit for bit;
    maskless == masked exactly.  Returns each model's batch (q, f, kernel
    inputs) and the errors keyed by (kernel, family)."""
    import torch

    from complexhyperbolickge_torch.kernels.hyp_rank import AttRHRanker, HypRanker

    out = {"phase": "hyp-kernels", "models": {}}
    batches, errors, failed = {}, {}, []
    for name, (model, dataset) in hyp.items():
        family = HYP_MODELS[name]
        names, scores, fns, maskless, tables = hyp_family(family)
        dev = next(model.parameters()).device
        pack = dataset.eval_pack("test", "rhs")
        q = torch.as_tensor(pack.queries[:BATCH], dtype=torch.int64, device=dev)
        f = torch.as_tensor(pack.filter_idx[:BATCH], dtype=torch.int64, device=dev)
        ranker = (AttRHRanker if family == "attrh" else HypRanker)(model)
        x = {**ranker.kernel_inputs(q, f, masked=False), **ranker.kernel_inputs(q, f)}
        near = near_threshold(scores(x), x["t2"])
        c_queries = model.get_queries(q[:, :2])[0][1].to(torch.float32).expand(len(q), 1)[:, 0]
        res = {"family": family, "batch": BATCH, "Np": int(x["rhs"].shape[0]),
               "D": int(x["rhs"].shape[1]), "L": int(x["fidx"].shape[1]),
               "n_curvatures": int(x["cvals"].shape[0]),
               "max_near_threshold": int(near.max()),
               "c_equals_cvals_cid": bool(torch.equal(x["c"], x["cvals"][x["cid"].long()])),
               "c_equals_get_queries": bool(torch.equal(x["c"], c_queries)), "kernels": {}}
        if not (res["c_equals_cvals_cid"] and res["c_equals_get_queries"]):
            failed.append(f"{name}: the kernels' curvature cvals[cid] is not get_queries'")
        radii, radii_plain = tables[0](x), tables[1](x)
        torch.cuda.synchronize()
        res["radii_max_ulp"] = errors[("hyp_rank_radii", family)] = ulps_apart(
            radii.cpu(), radii_plain.cpu())
        if res["radii_max_ulp"] > RADII_MAX_ULP or not torch.equal(radii, x["radii"]):
            failed.append(f"{name}: the radius table is {res['radii_max_ulp']} ulp from its "
                          f"plain version (or not the ranker's)")
        for kname, (kernel, plain, args) in fns.items():
            got = kernel(*[x[k] for k in args])
            want = plain(*[x[k] for k in args])
            torch.cuda.synchronize()
            diff = (got - want).abs()
            errors[(kname, family)] = int(diff.max())
            ok = bool((diff <= near).all())
            res["kernels"][kname] = {"max_abs_err": int(diff.max()),
                                     "queries_differing": int((diff > 0).sum()),
                                     "within_tolerance": ok}
            if not ok:
                failed.append(f"{name} {kname} disagrees with its plain version")
        kernel, _, args = fns[next(iter(fns))]
        res["maskless_equals_masked"] = bool(torch.equal(kernel(*[x[k] for k in args]),
                                                         maskless(x)))
        if not res["maskless_equals_masked"]:
            failed.append(f"{name}: maskless != masked on a batch whose golds are filtered")
        out["models"][name] = res
        batches[name] = (q, f, x)
    emit(out)
    if failed:
        raise AssertionError("; ".join(failed))
    return batches, errors


def train_pair(scale: float, seed: int):
    """A train-distance input at the main path's shape, lhs (B, D) and rhs
    (B, K, D) ~ N(0, scale), with a cotangent g (B, K), on the card."""
    import numpy as np
    import torch

    r = np.random.default_rng(seed)
    d = 2 * RANK
    return [torch.tensor(r.normal(0.0, s, shape), dtype=torch.float32, device=DEVICE)
            for s, shape in ((scale, (BATCH, d)), (scale, (BATCH, NEG, d)), (1.0, (BATCH, NEG)))]


def train_ids(scale: float, seed: int):
    """The id form's input at the training step's shape: lhs (B, D) and a
    WN18RR-sized table (N, D) ~ N(0, scale), ids (B, 1 + NEG) of a random
    batch's tails and the sampler's negatives, and a cotangent g, on the
    card."""
    import numpy as np
    import torch

    from complexhyperbolickge_torch.train.losses import sample_negatives

    r = np.random.default_rng(seed)
    n, d = WN18RR["synthetic_entities"], 2 * RANK
    batch = torch.as_tensor(r.integers(0, n, (BATCH, 3)), device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    ids = torch.cat([batch[:, 2:3], sample_negatives(gen, batch, n, NEG)], dim=1)
    lhs, table, g = [torch.tensor(r.normal(0.0, s, shape), dtype=torch.float32, device=DEVICE)
                     for s, shape in ((scale, (BATCH, d)), (scale, (n, d)),
                                      (1.0, (BATCH, 1 + NEG)))]
    return lhs, table, ids, g


def phase_train_kernels(seed: int):
    """K3/K4 against their plain version (forward and both gradients), in
    the clamped-at-init (1e-3) and the 0.4 regime: the gathered form
    (chyp_train_distance, the identity form) at (500, 100, 66), and the id
    form (chyp_train_distance_ids) at the training step's ids over the
    WN18RR table."""
    import torch

    from complexhyperbolickge_torch.kernels import chyp_train as CT

    def value_and_grads(fn, lhs, rhs, g, *ids):
        l, r = lhs.clone().requires_grad_(), rhs.clone().requires_grad_()
        d = fn(l, r, *ids)
        (d * g).sum().backward()
        return d.detach(), l.grad, r.grad

    out = {"phase": "train-kernels", "B": BATCH, "K": NEG, "D": 2 * RANK,
           "N": WN18RR["synthetic_entities"], "regimes": {}}
    errors = dict.fromkeys(TRAIN_KERNELS, 0.0)
    for form in ("gathered", "ids"):
        for scale in (1e-3, 0.4):
            if form == "ids":
                lhs, rhs, ids, g = train_ids(scale, seed)
                pair = (CT.chyp_train_distance_ids, CT.chyp_train_distance_ids_plain)
                args = (lhs, rhs, g, ids)
            else:
                pair = (CT.chyp_train_distance, CT.chyp_train_distance_plain)
                args = train_pair(scale, seed)
            got = value_and_grads(pair[0], *args)
            want = value_and_grads(pair[1], *args)
            torch.cuda.synchronize()
            tols = (TRAIN_FWD_TOL, TRAIN_GRAD_TOL, TRAIN_GRAD_TOL)
            ok = [bool(torch.allclose(a, b, **t)) for a, b, t in zip(got, want, tols)]
            diff = [float((a - b).abs().max()) for a, b in zip(got, want)]
            regime = {"d_max_abs_err": diff[0], "d_lhs_max_abs_err": diff[1],
                      "d_rhs_max_abs_err" if form == "gathered" else "d_table_max_abs_err":
                      diff[2], "within_tolerance": ok,
                      "finite": all(bool(torch.isfinite(t).all()) for t in got)}
            if form == "ids":
                # K4's index preparation against its plain version: exactly
                flat, n = args[3].reshape(-1), rhs.shape[0]
                _, res = CT.chyp_train_ids_forward(lhs, rhs, args[3])
                got_l = CT.chyp_train_lists(g, flat, *res, n)
                want_l = CT.chyp_train_lists_plain(g, flat, *res, n)
                regime["distinct_rows"] = int(flat.unique().numel())
                regime["lists_equal"] = bool(
                    torch.equal(got_l[0], want_l[0])
                    and torch.equal(got_l[1].view(torch.int32), want_l[1].view(torch.int32)))
                ok.append(regime["lists_equal"])
            out["regimes"][f"{form} {scale}"] = regime
            errors["chyp_train_fwd"] = max(errors["chyp_train_fwd"], diff[0])
            errors["chyp_train_bwd"] = max(errors["chyp_train_bwd"], diff[1], diff[2])
    emit(out)
    if not all(all(v["within_tolerance"]) and v["finite"] for v in out["regimes"].values()):
        raise AssertionError(f"K3/K4 disagree with their plain version: {out}")
    return errors


def wn18rr_model(seed: int, name: str = "FFTRotH"):
    """A fresh `name` at the smoke's width on the card, drawn from `seed`."""
    import torch

    from complexhyperbolickge_torch.models import ModelConfig, get_model

    cfg = ModelConfig(n_entities=WN18RR["synthetic_entities"],
                      n_relations=2 * WN18RR["synthetic_relations"],
                      rank=HYP_RANK if name in HYP_MODELS else RANK,
                      bias="learn", multi_c=True, dtype="float32")
    return get_model(name)(cfg, device=DEVICE, generator=torch.Generator().manual_seed(seed))


def phase_train_step_parity(seed: int):
    """3 Adam steps (lr 3e-4) from the same params with the same negatives,
    once through K3/K4 and once with the plain version in their place."""
    import numpy as np
    import torch

    import complexhyperbolickge_torch.kernels as KS
    from complexhyperbolickge_torch.kernels import chyp_train as CT
    from complexhyperbolickge_torch.train.losses import sample_negatives
    from complexhyperbolickge_torch.train.trainer import TrainConfig, Trainer

    init = wn18rr_model(seed).state_dict()
    n_ent, n_rel = init["entity"].shape[0], init["rel"].shape[0]
    rng = np.random.default_rng(seed)
    batches = np.stack([rng.integers(0, n_ent, (3, BATCH)), rng.integers(0, n_rel, (3, BATCH)),
                        rng.integers(0, n_ent, (3, BATCH))], axis=-1).astype(np.int32)
    weights = np.ones((3, BATCH), np.float32)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    negs = [sample_negatives(gen, torch.as_tensor(b, dtype=torch.int64, device=DEVICE),
                             n_ent, NEG) for b in batches]

    def three_steps():
        model = wn18rr_model(seed)
        model.load_state_dict(init)
        it = iter(negs)
        trainer = Trainer(model, TrainConfig(**TRAIN_CONFIGS["FFTRotH"]), n_ent, n_rel,
                          sampler=lambda *a: next(it))
        KS.reset_launches()
        trainer.run_epoch(batches, weights, None)
        torch.cuda.synchronize()
        counts = {k: KS.launches()[k] for k in (*TRAIN_KERNELS, "chyp_train_lists")}
        return {k: v.detach().clone() for k, v in model.state_dict().items()}, counts

    kernel, kernel_launches = three_steps()
    real, CT.chyp_train_distance_ids = (CT.chyp_train_distance_ids,
                                        CT.chyp_train_distance_ids_plain)
    try:
        plain, plain_launches = three_steps()
    finally:
        CT.chyp_train_distance_ids = real
    out = {"phase": "train-step parity", "steps": 3, "tolerance": PARITY_TOL,
           "kernel_launches": kernel_launches, "plain_launches": plain_launches,
           "max_moved": {k: float((kernel[k] - init[k]).abs().max()) for k in init},
           "max_abs_diff": {k: float((kernel[k] - plain[k]).abs().max()) for k in init},
           "within_tolerance": {k: bool(torch.allclose(kernel[k], plain[k], **PARITY_TOL))
                                for k in init}}
    emit(out)
    # a step scores the positive and the negatives as one (B, 1 + NEG) id
    # block: one launch of each kernel and of K4's pair lists
    if (not all(out["within_tolerance"].values()) or set(plain_launches.values()) != {0}
            or set(kernel_launches.values()) != {3}):
        raise AssertionError(f"kernel and plain training steps disagree: {out}")


def phase_kge_test(model_dir, model, dataset, label="kge-test"):
    """kge-test end to end with each ranker, then whole-split throughput."""
    import numpy as np
    import torch

    from complexhyperbolickge_torch.cli.test import test
    from complexhyperbolickge_torch.train.evaluate import get_ranking, make_best_ranker

    out = {"phase": label, "model": type(model).__name__, "split": "test", "batch": BATCH,
           "backends": {}}
    for backend in ("auto", "pallas_maskless", "dense"):
        t0 = time.perf_counter()
        m = test(model_dir, device="cuda", eval_backend=backend)
        out["backends"][backend] = {"MRR": m["MRR"], "MR": m["MR"],
                                    "hits@[1,3,10]": m["hits@[1,3,10]"],
                                    "cli_seconds": time.perf_counter() - t0}
    mrrs = [v["MRR"] for v in out["backends"].values()]
    if not all(np.isfinite(mrrs)) or not 0.0 < min(mrrs) <= 1.0:
        raise AssertionError(f"bad MRR values: {out}")
    # tail prediction finds most planted golds at rank 1 (write_run); head
    # prediction stays near chance, so the mean of both is ~0.45
    if min(mrrs) < 0.25:
        raise AssertionError(f"the planted test answers were not found: {out}")
    if max(mrrs) - min(mrrs) > 1e-4:
        raise AssertionError(f"rankers disagree on MRR beyond 1e-4: {out}")

    # whole-split ranking throughput (both directions; median of REPS runs,
    # host clocks on a shared host vary), and rank identity of the two
    # fused rankers
    packs = [dataset.eval_pack("test", d) for d in ("rhs", "lhs")]
    n_q = sum(len(p.queries) for p in packs)
    n_b = sum(-(-len(p.queries) // BATCH) for p in packs)
    ranks = {}
    for backend in ("auto", "pallas_maskless", "dense"):
        rank_fn = make_best_ranker(model, BATCH, backend)
        get_ranking(model, packs[0], BATCH, rank_fn=rank_fn)  # warm-up
        secs = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ranks[backend] = [get_ranking(model, p, BATCH, rank_fn=rank_fn) for p in packs]
            secs.append(time.perf_counter() - t0)
        secs.sort()
        out["backends"][backend].update(
            {"queries_per_s": n_q / secs[REPS // 2],
             "ms_per_batch": 1e3 * secs[REPS // 2] / n_b,
             "ms_per_batch_min_max": [1e3 * secs[0] / n_b, 1e3 * secs[-1] / n_b]})
    out["queries"] = n_q
    out["fused_ranks_identical"] = all(
        np.array_equal(a, b) for a, b in zip(ranks["auto"], ranks["pallas_maskless"]))
    out["fused_vs_dense_rank_mismatches"] = int(sum(
        (a != b).sum() for a, b in zip(ranks["auto"], ranks["dense"])))
    emit(out)
    if not out["fused_ranks_identical"]:
        raise AssertionError("masked and maskless fused rankers gave different ranks")


def phase_serve(model_dir, label="serve"):
    import numpy as np
    import torch

    from complexhyperbolickge_torch.cli.predict import known_tail_filters
    from complexhyperbolickge_torch.cli.serve import PredictService, make_server

    svc = PredictService(model_dir, k=10, batch=32, device="cuda")
    rng = np.random.default_rng(1)
    ds = svc.dataset
    q = [[int(h), int(r)] for h, r in zip(rng.integers(0, ds.n_entities, 12),
                                           rng.integers(0, ds.n_predicates, 12))]
    qt = torch.as_tensor(q, device=svc.device)
    with torch.no_grad():
        dense = svc.model.score_all(qt)
    filtered = dense.clone()
    for i, row in enumerate(known_tail_filters(ds, q).tolist()):
        filtered[i, [t for t in row if t < ds.n_entities]] = -torch.inf
    checks = {}
    for filter_known, ref in ((False, dense), (True, filtered)):
        got = svc.predict(q, filter_known=filter_known)
        top1 = [g["tails"][0] for g in got]
        checks[f"top1_matches_dense_argmax_filter_{filter_known}"] = (
            top1 == ref.argmax(1).tolist())
    lat = []
    for i in range(20):
        t0 = time.perf_counter()
        svc.predict([q[i % len(q)]])
        lat.append(1e3 * (time.perf_counter() - t0))

    srv = make_server(svc, "127.0.0.1", 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        body = json.dumps({"queries": q[:4], "k": 5, "filter_known": True}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/predict", data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            http_status, http_out = r.status, json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    checks["http_matches_service"] = (
        http_status == 200 and http_out == svc.predict(q[:4], k=5, filter_known=True))
    lat.sort()
    emit({"phase": label, "model": type(svc.model).__name__,
          "requests": len(q) * 2 + 20 + 1, **checks,
          "single_query_latency_ms_p50": lat[len(lat) // 2],
          "single_query_latency_ms_max": lat[-1]})
    if not all(checks.values()):
        raise AssertionError(f"serving checks failed: {checks}")


def phase_train(seed: int, flags=TRAIN_FLAGS, label="train"):
    """cli.run.train() on the card with `flags` for EPOCHS epochs,
    validating every epoch; returns the per-epoch history."""
    import numpy as np

    from complexhyperbolickge_torch.cli.run import build_parser, train

    argv = ["--dataset", "synthetic",
            *[str(x) for k, v in WN18RR.items() for x in (f"--{k}", v)], *flags,
            "--max_epochs", str(EPOCHS), "--valid", "1", "--eval_batch_size", str(BATCH),
            "--device", DEVICE, "--seed", str(seed), "--save_dir", str(WORK / label)]
    t0 = time.perf_counter()
    res = train(build_parser().parse_args(argv))
    secs = time.perf_counter() - t0
    epochs = [dict(h, ms_per_step=1e3 * h["seconds"] / h["steps"]) for h in res["history"]]
    later = epochs[1:]
    out = {"phase": label, "argv": argv, "epochs": epochs, "cli_seconds": secs,
           "median_after_first": {
               k: float(np.median([e[k] for e in later])) for k in ("triples_per_s", "ms_per_step")},
           "valid": res["valid"], "test": res["test"]}
    emit(out)
    losses = [e["train_loss"] for e in epochs]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the training loss is not finite and falling: {losses}")
    metrics = [res["test"]["MRR"], res["test"]["MR"], *res["test"]["hits@[1,3,10]"]]
    if not (np.isfinite(metrics).all() and 0.0 < res["test"]["MRR"] <= 1.0):
        raise AssertionError(f"bad final test metrics: {res['test']}")
    return res["history"]


def phase_loss_training(seed: int) -> dict:
    """The FFT training phases of LOSS_TRAIN_FLAGS (ce-train, bce-train,
    neg-modes-train shared and pool, sparse-adam-train), each through
    cli.run.train with the kernels' launch counts set to 0 just before it
    and read just after.  K1 must launch in each (validation and the final
    test); K3, K4 and chyp_train_lists at least once a step of the
    per-query SparseAdam training.  Returns each phase's steps and
    launches."""
    import complexhyperbolickge_torch.kernels as KS

    out = {}
    for label, flags in LOSS_TRAIN_FLAGS.items():
        KS.reset_launches()
        history = phase_train(seed, flags, label=label)
        launches = {k: v for k, v in KS.launches().items() if v}
        out[label] = {"steps": sum(h["steps"] for h in history), "launches": launches}
    emit({"phase": "loss-launches", **out})
    no_k1 = [k for k, v in out.items() if not v["launches"].get("chyp_rank_sweep_masked")]
    sa = out["sparse-adam-train"]
    if no_k1 or min(sa["launches"].get(k, 0)
                    for k in (*TRAIN_KERNELS, "chyp_train_lists")) < sa["steps"]:
        raise AssertionError(f"K1 never launched in {no_k1}, or K3/K4 (or K4's lists) "
                             f"launched fewer times than the SparseAdam steps: {out}")
    return out


def phase_ce_step_parity(dataset, seed: int):
    """One cross-entropy and one BCE (smoothing 0.1, the train label pack)
    loss and gradient of a WN18RR-width FFTRotH on a batch of BATCH train
    rows: on the card in float32 against the same params and batch on the
    CPU in float64, held to CE_PARITY_TOL (a TF32 contraction or a lost
    mask shows here)."""
    import dataclasses

    import numpy as np
    import torch

    from complexhyperbolickge_torch.train import losses as L

    card = wn18rr_model(seed)
    rng = np.random.default_rng(seed)
    spread = {"entity": 0.05, "rel": 0.05, "bh": 0.1, "bt": 0.1, "c": 0.05}
    card.load_state_dict({
        k: torch.as_tensor(rng.uniform(-1.0, 1.0, v.shape) if k == "rel_diag"
                           else rng.normal(0.0, spread[k], v.shape) + (1.0 if k == "c" else 0.0))
        for k, v in card.state_dict().items()})
    cpu = type(card)(dataclasses.replace(card.cfg, dtype="float64"))
    cpu.load_state_dict({k: v.double().cpu() for k, v in card.state_dict().items()})
    rows, labels = dataset.label_pack("train")
    idx = rng.choice(len(rows), BATCH, replace=False)
    n = dataset.n_entities
    fns = {"ce": lambda m, b, w, lab: L.cross_entropy_loss(m, b, w, None, n),
           "bce": lambda m, b, w, lab: L.bce_loss(m, b, w, lab, n, 0.1)}
    out = {"phase": "ce-step parity", "batch": BATCH, "entities": n,
           "tolerance": CE_PARITY_TOL, "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    for name, fn in fns.items():
        res = {}
        for m in (card, cpu):
            p0 = next(m.parameters())
            m.zero_grad(set_to_none=True)
            loss = fn(m, torch.as_tensor(rows[idx], dtype=torch.int64, device=p0.device),
                      torch.ones(BATCH, dtype=p0.dtype, device=p0.device),
                      torch.as_tensor(labels[idx], dtype=torch.int64, device=p0.device))[0]
            loss.backward()
            res[p0.dtype] = (loss.item(), {k: p.grad.double().cpu()
                                           for k, p in m.named_parameters()})
        (l32, g32), (l64, g64) = res[torch.float32], res[torch.float64]
        floor = 1e-2 * max(float(g.abs().max()) for g in g64.values())
        grad_rel = {k: float((g32[k] - g).abs().max()) / max(float(g.abs().max()), floor)
                    for k, g in g64.items()}
        loss_rel = abs(l32 - l64) / abs(l64)
        out[name] = {"loss_f32_card": l32, "loss_f64_cpu": l64, "loss_rel_err": loss_rel,
                     "grad_rel_err": grad_rel, "max_grad_rel_err": max(grad_rel.values())}
    emit(out)
    tol = CE_PARITY_TOL
    if out["allow_tf32"] or not all(
            np.isfinite(out[k]["loss_f32_card"]) and out[k]["loss_rel_err"] <= tol["loss_rel"]
            and out[k]["max_grad_rel_err"] <= tol["grad_rel"] for k in fns):
        raise AssertionError(f"the card's all-entity step disagrees with float64: {out}")


def phase_euc(seed: int) -> dict:
    """The Euclidean and complex families.  euc-train: RotE and ComplEx
    through cli.run.train at the RotH phase's config (HYP_TRAIN_FLAGS, the
    model overridden), 2 epochs each, dense validation.  euc-kge-test:
    kge-test of a planted run dir (write_run) of each of the nine models
    through the dense ranker; tail prediction finds the planted golds, so
    the MRR of both directions must reach 0.25 (chance is ~2e-4).  Returns
    the kge-test metrics by model."""
    import numpy as np

    from complexhyperbolickge_torch.cli.test import test

    for m in EUC_TRAIN:
        phase_train(seed, [*HYP_TRAIN_FLAGS, "--model", m], label=f"euc-train-{m}")
    out = {}
    for m in EUC_MODELS:
        d, _ = write_run(seed, m)
        t0 = time.perf_counter()
        res = test(d, device="cuda", eval_backend="auto")
        out[m] = {"MRR": res["MRR"], "MR": res["MR"], "hits@[1,3,10]": res["hits@[1,3,10]"],
                  "cli_seconds": time.perf_counter() - t0}
    emit({"phase": "euc-kge-test", "ranker": "dense", "split": "test", "models": out})
    bad = {m: v["MRR"] for m, v in out.items()
           if not (np.isfinite(v["MRR"]) and 0.25 <= v["MRR"] <= 1.0)}
    if bad:
        raise AssertionError(f"the planted test answers were not found: {bad}")
    return out


def train_window(dataset, seed: int, name: str = "FFTRotH", config: str | None = None):
    """A trainer at the training config TRAIN_CONFIGS[config or name] on a
    fresh WN18RR-width `name`, with one epoch's batches (and, for BCE, its
    label batches): what the training profile and the step time run.
    Returns (trainer, batches, weights, generator, label batches or None)."""
    import numpy as np
    import torch

    from complexhyperbolickge_torch.data.dataset import epoch_batches
    from complexhyperbolickge_torch.train.trainer import TrainConfig, Trainer

    cfg = TrainConfig(**TRAIN_CONFIGS[config or name])
    model = wn18rr_model(seed, name)
    trainer = Trainer(model, cfg, model.cfg.n_entities, model.cfg.n_relations)
    labels = None
    if cfg.neg_sample_size <= 0 and cfg.loss == "binarycrossentropy":
        _, labels = dataset.label_pack("train")
    b, w, lab = epoch_batches(dataset.get_examples("train"), BATCH,
                              np.random.default_rng(seed), labels)
    return trainer, b, w, torch.Generator(device=DEVICE).manual_seed(seed), lab


def profile_window(fn, shapes: bool = False) -> dict:
    """torch.profiler over fn(): wall time, device busy time (the union of
    the CUDA kernels' intervals; annotation spans such as Optimizer.step's
    cover gaps and are left out) and idle share, top kernels and host ops;
    with `shapes`, also the ops whose own kernels take the most device time,
    by input shapes (which tensors the top kernels work on)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=shapes) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kern = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: e.time_range.start)
    busy, end, by_name = 0.0, float("-inf"), {}
    for e in kern:
        s, f = e.time_range.start, e.time_range.end
        busy += max(0.0, f - max(s, end))
        end = max(end, f)
        by_name[e.name] = by_name.get(e.name, 0.0) + (f - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {}
    if shapes:
        by_shape = sorted(prof.key_averages(group_by_input_shape=True),
                          key=lambda e: -e.self_device_time_total)[:8]
        out["top_device_ops_by_shape_ms"] = {
            f"{e.key} {e.input_shapes}"[:160]: e.self_device_time_total / 1e3
            for e in by_shape}
    return {
        **out,
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3 if kern else "not measured",
        "device_idle_share": 1.0 - busy / wall_us if kern else "not measured",
        "device_kernels": len(kern),
        "top_kernels_ms": {n[:80]: t / 1e3 for n, t in top},
        "top_host_ops_self_ms": {
            e.key[:60]: e.self_cpu_time_total / 1e3
            for e in sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:8]},
    }


def busy_ms(fn, calls: int = 5) -> float:
    """The card's busy time per call of fn, from profile_window over
    `calls` calls after one warm-up: a ranker call launches hundreds of
    kernels, so CUDA events around back-to-back calls would time the host."""
    fn()
    busy = profile_window(lambda: [fn() for _ in range(calls)])["device_busy_ms"]
    if not isinstance(busy, float):
        raise AssertionError("torch.profiler saw no device time")
    return busy / calls


def profile_rankers(model, dataset) -> dict:
    """One whole-split ranking of the test split (both directions) per
    ranker, profiled."""
    from complexhyperbolickge_torch.train.evaluate import get_ranking, make_best_ranker

    packs = [dataset.eval_pack("test", d) for d in ("rhs", "lhs")]
    out = {}
    for backend in ("auto", "pallas_maskless", "dense"):
        rank_fn = make_best_ranker(model, BATCH, backend)
        for p in packs:  # warm-up
            get_ranking(model, p, BATCH, rank_fn=rank_fn)
        out[backend] = profile_window(
            lambda: [get_ranking(model, p, BATCH, rank_fn=rank_fn) for p in packs])
    return out


def profile_steps(window, shapes: bool = False) -> dict:
    """PROFILE_STEPS training steps of a train_window, profiled."""
    trainer, b, w, gen, lab = window
    trainer.run_epoch(b[:3], w[:3], gen, None if lab is None else lab[:3])  # warm-up
    steps = slice(3, 3 + PROFILE_STEPS)
    prof = profile_window(lambda: trainer.run_epoch(
        b[steps], w[steps], gen, None if lab is None else lab[steps]), shapes)
    busy = prof["device_busy_ms"]
    prof["device_busy_ms_per_step"] = (busy / PROFILE_STEPS if isinstance(busy, float)
                                       else "not measured")
    prof["wall_ms_per_step"] = prof["wall_ms"] / PROFILE_STEPS
    prof["device_kernels_per_step"] = prof["device_kernels"] / PROFILE_STEPS
    return {"steps": PROFILE_STEPS, **prof}


def phase_profile(fft, roth, gnn_window, loss_windows: dict):
    """Where the time goes: one whole-split ranking per ranker and
    PROFILE_STEPS training steps, of FFTRotH and of RotH (each a (model,
    dataset, train_window) triple), PROFILE_STEPS CompGCN training steps
    (gnn_window) with their K9/K10 launches, and PROFILE_STEPS steps of each
    of loss_windows (label -> train_window: the FFT CE and BCE steps).
    Returns the FFT training step's device time (busy ms per step)."""
    import complexhyperbolickge_torch.kernels as KS

    before = KS.launches()
    gnn = profile_steps(gnn_window, shapes=True)
    gnn["kernel_launches_per_step"] = {
        k: (KS.launches()[k] - before[k]) / (PROFILE_STEPS + 3) for k in GNN_KERNELS}
    out = {"phase": "profile", "split": "test", "batch": BATCH,
           "rankers": profile_rankers(*fft[:2]), "train": profile_steps(fft[2]),
           "hyp_rankers": profile_rankers(*roth[:2]), "hyp_train": profile_steps(roth[2]),
           "gnn_train": gnn, **{k: profile_steps(w) for k, w in loss_windows.items()}}
    emit(out)
    return out["train"]["device_busy_ms_per_step"]


def phase_kernel_line(model, batch, launches, errors, smi, name, seed, step_ms):
    """Times of each kernel and its plain version on the main paths'
    shapes, beside the kernel's bound.  Rankers: dense_ms is the dense
    ranker's device time per batch and ranker_ms that of the fused ranker
    that launches the kernel, both with the query prep, as the card's busy
    time per call (busy_ms).  Train distance: step_ms is one whole training
    step's device time (phase_profile)."""
    import numpy as np
    import torch

    from complexhyperbolickge_torch.kernels import chyp_rank as K
    from complexhyperbolickge_torch.kernels import chyp_train as CT
    from complexhyperbolickge_torch.train.evaluate import make_ranker

    q, f, xm, xn = batch
    base = [xm[k] for k in ("lhs2", "zn", "t2", "rhs", "wn", "bt")]
    b, d = base[0].shape[0] // 2, base[0].shape[1]
    np_, ld = base[3].shape  # the table's rows padded to ld >= d floats
    l = xn["fidx"].shape[1]
    f32_peak, bw_peak, f64_peak = peak_rates(name)
    # whole rankers per batch, query prep included (~200 launches a call)
    dense = make_ranker(model)
    dense_ms = busy_ms(lambda: dense(q, f))
    ranker_ms = {}
    for masked in (True, False):
        ranker = K.ChypRanker(model, masked=masked)
        ranker_ms[masked] = busy_ms(lambda: ranker(q, f))
    n_rows = int(np.unique(xn["fidx"].cpu().numpy()).size)
    vec = 4 * (2 * b * d + 2 * b + 2 * np_ + np_ * ld)  # lhs2, zn, t2, wn, bt, rhs
    # name -> (kernel, plain, args, fp32 ops, fp64 ops, bytes)
    work = {
        "chyp_rank_sweep_masked": (K.chyp_rank_counts, K.chyp_rank_counts_plain,
                                   [*base, xm["mask"]], 4 * b * np_ * d, 0,
                                   vec + b * np_ + 4 * b),
        "chyp_rank_sweep_nomask": (K.chyp_rank_sweep_nomask,
                                   K.chyp_rank_sweep_nomask_plain, [*base, xn["gold"]],
                                   4 * b * np_ * d, 0, vec + 4 * b + 4 * b),
        "chyp_rank_filtered_sub": (K.chyp_rank_filtered_sub,
                                   K.chyp_rank_filtered_sub_plain,
                                   [*base, xn["fidx"], xn["gold"]], 4 * b * l * d, 0,
                                   4 * (2 * b * d + 2 * b + n_rows * (d + 2))
                                   + 4 * b * l + 8 * b),
    }
    # the train distance in the id form of the training step, at the
    # published init scale: B x (1 + NEG) ids over the N x D table.  K3:
    # per pair three fp64 dots of D FMAs and ~16 fp32 epilogue operations;
    # reads lhs, the ids and each distinct row once, writes d, sr, si, wn,
    # x, zn.  K4: per pair ~20 fp32 operations for the coefficients and 5
    # per column of its table term, per column two fp64 FMAs for m_a, m_b
    # and one fp64 add into its row; reads g, the residuals, lhs, the ids
    # and the distinct rows, writes d_lhs and the dense (N, D) gradient.
    # K4's time includes its index preparation chyp_train_lists (the ids'
    # counting sort with each pair's table-side coefficients; lists_ms
    # alone).  identity_ms: the gathered form at (500, 100, 66).
    lhs, table, ids, g = train_ids(1e-3, seed)
    _, res = CT.chyp_train_ids_forward(lhs, table, ids)
    tb, tp, td = BATCH, ids.numel(), 2 * RANK
    tn, distinct = table.shape[0], int(ids.unique().numel())
    work["chyp_train_fwd"] = (CT.chyp_train_ids_forward, CT.chyp_train_ids_forward_plain,
                              [lhs, table, ids], 16 * tp, 6 * tp * td,
                              4 * (tb * td + distinct * td + 5 * tp + tb) + 8 * tp)
    work["chyp_train_bwd"] = (CT.chyp_train_ids_backward, CT.chyp_train_ids_backward_plain,
                              [g, lhs, table, ids, *res], 20 * tp + 5 * tp * td,
                              5 * tp * td,
                              4 * (5 * tp + tb + 2 * tb * td + distinct * td + tn * td)
                              + 8 * tp)
    gl, gr, gg = train_pair(1e-3, seed)
    gt = gr.reshape(-1, td)
    _, gres = CT.chyp_train_ids_forward(gl, gt, None)
    identity = {"chyp_train_fwd": lambda: CT.chyp_train_ids_forward(gl, gt, None),
                "chyp_train_bwd": lambda: CT.chyp_train_ids_backward(gg, gl, gt, None, *gres)}
    lists_ms = cuda_ms(lambda: CT.chyp_train_lists(g, ids.reshape(-1), *res, tn), reps=50)
    rows = []
    for kname, (kernel, plain, args, f32_ops, f64_ops, nbytes) in work.items():
        t_ops = (f32_ops / f32_peak + f64_ops / f64_peak) * 1e3
        t_bytes = nbytes / bw_peak * 1e3
        row = {
            "name": kname, "route": "cuda",
            "source": SOURCES["chyp_train" if kname in TRAIN_KERNELS else "chyp_rank"],
            "replaces": KERNEL_META[kname], "launches": launches[kname],
            "max_abs_err": errors[kname],
            "ms": cuda_ms(lambda: kernel(*args), reps=50),
            "plain_ms": cuda_ms(lambda: plain(*args)),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "card": smi,
        }
        if kname in TRAIN_KERNELS:
            row.update(step_ms=step_ms, shape={"B": tb, "K": ids.shape[1], "N": tn, "D": td,
                                               "distinct_rows": distinct},
                       identity_ms=cuda_ms(identity[kname], reps=50),
                       identity_shape={"B": BATCH, "K": NEG, "D": td})
            if kname == "chyp_train_bwd":
                row.update(lists_ms=lists_ms, lists_launches=launches["chyp_train_lists"])
        else:
            row.update(dense_ms=dense_ms, ranker_ms=ranker_ms[kname == "chyp_rank_sweep_masked"],
                       shape={"B": b, "Np": np_, "D": d, "ld": ld, "L": l})
            if kname != "chyp_rank_filtered_sub":
                row.update(K.sweep_info(base[0].device, d,
                                        masked=kname == "chyp_rank_sweep_masked"))
        rows.append(row)
    return rows


def hyp_kernel_rows(hyp, batches, launches, errors, smi, name):
    """The kernels line's K5-K8 rows, timed on each model's test batch
    (phase_hyp_kernels): the hyp_rank rows on RotH (Poincare) with the
    RotLH (Lorentz) instantiation beside them, the attrh rows on AttRH.
    Bound: per pair the 2 D operations of the contraction plus the family's
    EPILOGUE_OPS (counted on the inline epilogue: the sweeps' radius table
    holds part of them, precomputed once per params version), so the bound
    measures the function's work whatever the kernel hoists; bytes each
    input once (the curvature ids, cvals and the radius table, the int8
    mask (masked) or the gold (maskless)) and the counts once; a filtered
    subtraction scores only this batch's kept filter ids (in range, not the
    gold) and reads their distinct rows.  The sweep rows add the radius
    launcher's time and launches and the sweep's registers and resident
    blocks; ranker_ms and dense_ms are busy times per call (busy_ms)."""
    import torch

    from complexhyperbolickge_torch.kernels.hyp_rank import AttRHRanker, HypRanker, sweep_info
    from complexhyperbolickge_torch.train.evaluate import make_ranker

    f32_peak, bw_peak, _ = peak_rates(name)
    timed = {}
    for mname, (model, _) in hyp.items():
        family = HYP_MODELS[mname]
        names, _, fns, _, tables = hyp_family(family)
        q, f, x = batches[mname]
        (b, d), np_, l = x["lhs"].shape, x["rhs"].shape[0], x["fidx"].shape[1]
        n_pq = names.index("rhs") - 1  # per-query vectors
        n_pr = len(names) - names.index("rhs") - 1  # per-row vectors
        vec = 4 * (b * d + np_ * d + b * n_pq + np_ * n_pr)
        pair_ops = 2 * d + EPILOGUE_OPS[family]
        fidx, gold = x["fidx"].long(), x["gold"].long()
        kept = (fidx >= 0) & (fidx < np_) & (fidx != gold[:, None])
        n_rows = int(torch.unique(fidx[kept]).numel())
        table_bytes = 4 * (x["radii"].numel() + x["cvals"].numel())
        work = {  # kernel name -> (fp32 operations, bytes)
            fns_name: w for fns_name, w in zip(fns, (
                (b * np_ * pair_ops, vec + b * np_ + table_bytes + 4 * b),
                (b * np_ * pair_ops, vec + table_bytes + 4 * b + 4 * b),
                (int(kept.sum()) * pair_ops,
                 4 * (b * d + b * n_pq + n_rows * (d + n_pr)) + 4 * b * l + 8 * b)))}
        dense = make_ranker(model)
        dense_ms = busy_ms(lambda: dense(q, f))
        ranker_ms = {}
        for masked in (True, False):
            ranker = (AttRHRanker if family == "attrh" else HypRanker)(model, masked=masked)
            ranker_ms[masked] = busy_ms(lambda: ranker(q, f))
        for kname, (kernel, plain, argnames) in fns.items():
            args = [x[k] for k in argnames]
            ops, nbytes = work[kname]
            t_ops, t_bytes = ops / f32_peak * 1e3, nbytes / bw_peak * 1e3
            timed[(kname, family)] = {
                "model": mname, "family": family, "max_abs_err": errors[(kname, family)],
                "ms": cuda_ms(lambda: kernel(*args), reps=50),
                "plain_ms": cuda_ms(lambda: plain(*args)),
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "dense_ms": dense_ms, "ranker_ms": ranker_ms[kname.endswith("_masked")],
                "shape": {"B": b, "Np": np_, "D": d, "L": l}}
            if "_sweep_" in kname:
                timed[(kname, family)].update(
                    radii_ms=cuda_ms(lambda: tables[0](x), reps=50),
                    radii_launches=launches["hyp_rank_radii"],
                    radii_max_ulp=errors[("hyp_rank_radii", family)],
                    n_curvatures=int(x["cvals"].shape[0]),
                    **sweep_info(family, x["lhs"].device, d,
                                 masked=kname.endswith("_masked")))
    rows = []
    for kname in HYP_RANK_KERNELS + ATTRH_KERNELS:
        family = "attrh" if kname in ATTRH_KERNELS else "poincare"
        row = {"name": kname, "route": "cuda", "source": SOURCES["hyp_rank"],
               "replaces": KERNEL_META[kname], "launches": launches[kname],
               "library_ms": None, "card": smi, **timed[(kname, family)]}
        if family == "poincare":
            row["lorentz"] = timed[(kname, "lorentz")]
        rows.append(row)
    return rows


# ------------------------------- the GNN path ----------------------------------


def gnn_args(seed: int, name: str) -> dict:
    """The run config of `name` at the GNN path's width, as cli.run saves it."""
    return dict(dataset="synthetic", synthetic_seed=seed, data_path="data", debug=False,
                model=name, rank=GNN_RANK, init_size=1e-3, bias="learn", gamma=0.0,
                multi_c=True, dtype="float32", eval_batch_size=GNN_BATCH,
                eval_backend="auto", eval_precision="highest", **GNN_ARGS, **WN18RR)


def gnn_model(seed: int, name: str, dataset, **over):
    """A fresh `name` on the card at the GNN path's width, drawn from `seed`."""
    import torch

    from complexhyperbolickge_torch.cli.run import build_model

    ns = argparse.Namespace(**{**gnn_args(seed, name), **over})
    return build_model(ns, dataset, DEVICE, generator=torch.Generator().manual_seed(seed))


def gnn_kernel_inputs(model, h: int, seed: int):
    """K9 and K10 inputs at the encoder's shapes: the first sorted half of
    the graph (its K9 closure over the receiving nodes and K10 closure over
    the tails), messages (E, h) and a node table (N, h) on the card."""
    import numpy as np
    import torch

    g = model.graph
    seg, gth = g.heads.halves[0], g.tail_gathers[0]
    r = np.random.default_rng(seed)
    msgs = torch.tensor(r.normal(size=(seg.num_edges, h)), dtype=torch.float32, device=DEVICE)
    x = torch.tensor(r.normal(size=(seg.num_segments, h)), dtype=torch.float32, device=DEVICE)
    return seg, gth, msgs, x


def phase_gnn_kernels(model, seed: int):
    """K9 against index_add_ and K10 against x[ids] on one sorted half of
    the WN18RR-shape graph (E = 86,835 into N = 40,943) at H = 1, 32, 200,
    forward and backward (against autograd of the plain versions), in
    float32 and in bfloat16 (gnn_bf16_checks); then the times of kernel,
    plain version and library call.  Returns the rows' measurements by
    (kernel, H) and (kernel, H, "bfloat16")."""
    import torch

    from complexhyperbolickge_torch.kernels import gather as G
    from complexhyperbolickge_torch.kernels import segsum as S

    out = {"phase": "gnn-kernels", "E": None, "N": None, "widths": {}}
    meas, failed = {}, []
    for h in GNN_WIDTHS:
        seg, gth, msgs, x = gnn_kernel_inputs(model, h, seed + h)
        out["E"], out["N"] = seg.num_edges, seg.num_segments
        gm = torch.randn((seg.num_segments, h), device=DEVICE, generator=torch.Generator(
            device=DEVICE).manual_seed(seed))
        gx = torch.randn((seg.num_edges, h), device=DEVICE, generator=torch.Generator(
            device=DEVICE).manual_seed(seed + 1))
        m1, m2 = msgs.clone().requires_grad_(), msgs.clone().requires_grad_()
        s_k = seg(m1)
        s_p = S.sorted_segment_sum_plain(m2, seg)
        (s_k * gm).sum().backward()
        (s_p * gm).sum().backward()
        x1, x2 = x.clone().requires_grad_(), x.clone().requires_grad_()
        g_k = gth(x1)
        g_p = G.row_gather_plain(x2, gth.ids)
        (g_k * gx).sum().backward()
        (g_p * gx).sum().backward()
        lengths = seg.row_ptr.diff().long()
        lib = torch.segment_reduce(msgs, "sum", lengths=lengths)
        torch.cuda.synchronize()
        s_k, s_p, g_k, g_p = s_k.detach(), s_p.detach(), g_k.detach(), g_p.detach()
        res = {
            "segsum_max_abs_err": float((s_k - s_p).abs().max()),
            "segsum_within_tolerance": bool(torch.allclose(s_k, s_p, **GNN_KERNEL_TOL)),
            "segsum_grad_equal": bool(torch.equal(m1.grad, m2.grad)),
            "segment_reduce_max_abs_err": float((lib - s_p).abs().max()),
            "gather_bitwise_equal": bool(torch.equal(g_k, g_p)),
            "gather_grad_max_abs_err": float((x1.grad - x2.grad).abs().max()),
            "gather_grad_within_tolerance": bool(torch.allclose(x1.grad, x2.grad,
                                                                **GNN_KERNEL_TOL)),
        }
        out["widths"][h] = res
        if not (res["segsum_within_tolerance"] and res["segsum_grad_equal"]
                and res["gather_bitwise_equal"] and res["gather_grad_within_tolerance"]):
            failed.append(f"H={h}: {res}")
        ids64 = gth.ids.long()
        n_read = int(gth.ids.unique().numel())  # the table rows the gather reads
        res["bfloat16"] = bf16 = gnn_bf16_checks(seg, gth, msgs, x, gm, gx)
        if not all(v for k, v in bf16.items() if isinstance(v, bool)):
            failed.append(f"H={h} bfloat16: {bf16}")
        mb, xb = msgs.to(torch.bfloat16), x.to(torch.bfloat16)
        meas[("sorted_segment_sum", h, "bfloat16")] = dict(
            max_abs_err=bf16["segsum_max_abs_err"],
            ms=cuda_ms(lambda: S.sorted_segment_sum(mb, seg), reps=50),
            plain_ms=cuda_ms(lambda: S.sorted_segment_sum_plain(mb, seg)),
            library_ms=cuda_ms(lambda: torch.segment_reduce(mb, "sum", lengths=lengths)),
            nbytes=2 * (seg.num_edges * h + seg.num_segments * h) + 4 * (seg.num_segments + 1),
            ops=seg.num_edges * h)
        meas[("row_gather", h, "bfloat16")] = dict(
            max_abs_err=0.0 if bf16["gather_bitwise_equal"] else None,
            ms=cuda_ms(lambda: G.row_gather(xb, gth.ids), reps=50),
            plain_ms=cuda_ms(lambda: G.row_gather_plain(xb, gth.ids)),
            library_ms=cuda_ms(lambda: torch.index_select(xb, 0, ids64)),
            nbytes=2 * (n_read * h + seg.num_edges * h) + 4 * seg.num_edges, ops=0)
        meas[("sorted_segment_sum", h)] = dict(
            max_abs_err=res["segsum_max_abs_err"],
            ms=cuda_ms(lambda: S.sorted_segment_sum(msgs, seg), reps=50),
            plain_ms=cuda_ms(lambda: S.sorted_segment_sum_plain(msgs, seg)),
            library_ms=cuda_ms(lambda: torch.segment_reduce(msgs, "sum", lengths=lengths)),
            nbytes=4 * (seg.num_edges * h + seg.num_segments + 1 + seg.num_segments * h),
            ops=seg.num_edges * h,
            shape={"E": seg.num_edges, "N": seg.num_segments, "H": h})
        meas[("row_gather", h)] = dict(
            max_abs_err=0.0 if res["gather_bitwise_equal"] else float((g_k - g_p).abs().max()),
            ms=cuda_ms(lambda: G.row_gather(x, gth.ids), reps=50),
            plain_ms=cuda_ms(lambda: G.row_gather_plain(x, gth.ids)),
            library_ms=cuda_ms(lambda: torch.index_select(x, 0, ids64)),
            nbytes=4 * (n_read * h + seg.num_edges + seg.num_edges * h), ops=0,
            shape={"E": seg.num_edges, "N": seg.num_segments, "H": h, "rows_read": n_read})
    emit(out)
    if failed:
        raise AssertionError("K9/K10 disagree with their plain versions: " + "; ".join(failed))
    return meas


def gnn_bf16_checks(seg, gth, msgs, x, gm, gx) -> dict:
    """K9's and K10's bfloat16 instances against their plain versions on
    the bfloat16-rounded inputs, forward and backward: K9 within
    GNN_BF16_TOL of its plain version (float32 sums rounded once), its
    backward (K10) bitwise; K10 bitwise, its backward (K9 over the sorted
    ids) within GNN_BF16_TOL of the float32 plain gradient rounded once."""
    import torch

    from complexhyperbolickge_torch.kernels import gather as G
    from complexhyperbolickge_torch.kernels import segsum as S

    bf = torch.bfloat16
    gm_b, gx_b = gm.to(bf), gx.to(bf)
    m1, m2 = msgs.to(bf).requires_grad_(), msgs.to(bf).requires_grad_()
    s_k, s_p = seg(m1), S.sorted_segment_sum_plain(m2, seg)
    (s_k * gm_b).sum().backward()
    (s_p * gm_b).sum().backward()
    x1 = x.to(bf).requires_grad_()
    x2 = x.to(bf).float().requires_grad_()
    g_k, g_p = gth(x1), G.row_gather_plain(x2, gth.ids)
    (g_k * gx_b).sum().backward()
    (g_p * gx_b.float()).sum().backward()
    torch.cuda.synchronize()
    s_k, s_p, g_k = s_k.detach(), s_p.detach(), g_k.detach()
    want_grad = x2.grad.to(bf)
    return {
        "dtypes": [str(t.dtype) for t in (s_k, g_k, m1.grad, x1.grad)],
        "segsum_max_abs_err": float((s_k.float() - s_p.float()).abs().max()),
        "segsum_within_tolerance": bool(torch.allclose(s_k.float(), s_p.float(),
                                                       **GNN_BF16_TOL)),
        "segsum_grad_equal": bool(torch.equal(m1.grad, m2.grad)),
        "gather_bitwise_equal": bool(torch.equal(g_k, g_p.detach().to(bf))),
        "gather_grad_max_abs_err": float((x1.grad.float() - want_grad.float()).abs().max()),
        "gather_grad_within_tolerance": bool(torch.allclose(
            x1.grad.float(), want_grad.float(), **GNN_BF16_TOL)),
        "all_bfloat16": all(t.dtype == bf for t in (s_k, g_k, m1.grad, x1.grad)),
    }


def phase_gnn_bf16_train(dataset, seed: int):
    """BF16_STEPS Adam steps of a bfloat16 CompGCN (the GNN path's width,
    dtype bfloat16) on one training batch with the same negatives and
    dropout every step, so every sum and gather of its encoder runs K9's
    and K10's bfloat16 instances: the loss finite and falling, K9/K10
    launched every step, the optimizer's state float32 (as the JAX trainer
    keeps it for bfloat16 params)."""
    import numpy as np
    import torch

    import complexhyperbolickge_torch.kernels as KS
    from complexhyperbolickge_torch.data.dataset import epoch_batches
    from complexhyperbolickge_torch.train.trainer import TrainConfig, Trainer

    model = gnn_model(seed, "CompGCN", dataset, dtype="bfloat16")
    trainer = Trainer(model, TrainConfig(**GNN_TRAIN_CONFIG), model.cfg.n_entities,
                      model.cfg.n_relations)
    b, w, _ = epoch_batches(dataset.get_examples("train"), GNN_BATCH, np.random.default_rng(seed))
    b, w, _ = trainer._upload(b[:1], w[:1])
    losses = []
    KS.reset_launches()  # the bfloat16 GNN path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(BF16_STEPS):
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        losses.append(trainer.train_step(b[0], w[0], gen))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: KS.launches()[k] for k in GNN_KERNELS}  # ... and ends here
    losses = [float(v) for v in losses]
    state = trainer.optimizer.state_dict()["state"]
    state_dtypes = sorted({str(v.dtype) for st in state.values() for v in st.values()})
    out = {"phase": "gnn-bf16-train", "model": "CompGCN", "dtype": "bfloat16",
           "steps": BF16_STEPS, "losses": losses, "ms_per_step": 1e3 * secs / BF16_STEPS,
           "param_dtypes": sorted({str(p.dtype) for p in model.parameters()}),
           "optimizer_state_dtypes": state_dtypes, "launches": launches}
    emit(out)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the bfloat16 CompGCN loss is not finite and falling: {losses}")
    if min(launches.values()) < BF16_STEPS or state_dtypes != ["torch.float32"]:
        raise AssertionError(f"bfloat16 CompGCN: K9/K10 launched fewer times than its steps, "
                             f"or its optimizer state is not float32: {out}")


def tensor_leaves(tree) -> list:
    """The tensors of a nested tuple (a GNN encoding: x and its relation pack)."""
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in tensor_leaves(v)]
    return [tree]


def swap_plain_gnn():
    """Swap K9's and K10's plain versions in for the kernels; returns the
    function that swaps the kernels back."""
    from complexhyperbolickge_torch.kernels import gather as G
    from complexhyperbolickge_torch.kernels import segsum as S

    real = (S.sorted_segment_sum, G.row_gather)
    S.sorted_segment_sum, G.row_gather = S.sorted_segment_sum_plain, G.row_gather_plain

    def restore():
        S.sorted_segment_sum, G.row_gather = real

    return restore


def encode_kernel_and_plain(model, plain_runs: int = 1):
    """The eval-mode encoding's tensors through K9/K10, then `plain_runs`
    times with their plain versions swapped in, with each run's launches."""
    import torch

    import complexhyperbolickge_torch.kernels as KS

    runs = []
    with torch.no_grad():
        for plain in [False] + [True] * plain_runs:
            KS.reset_launches()
            restore = swap_plain_gnn() if plain else (lambda: None)
            try:
                enc = tensor_leaves(model.encode())
                torch.cuda.synchronize()
            finally:
                restore()
            runs.append((enc, {k: KS.launches()[k] for k in GNN_KERNELS}))
    return runs


def max_diff(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def phase_gnn_encode_parity(models: dict, dataset, seed: int):
    """Each GNN model's eval-mode encode (rank 32, hidden 200, 2 layers,
    multi_c, weights from the seed) once through K9/K10 and once with their
    plain versions swapped in.  float64 (the kernels' double instances) is
    held to GNN_ENCODE_TOL_F64.  In float32 both sum in other orders
    (index_add_'s atomics), and the hyperbolic maps amplify that near the
    ball's edge (artanh'), so the float32 encodings are held to
    GNN_ENCODE_TOL, beside the plain version's own run-to-run spread.  Each
    kernel run launches the kernels its encoder runs (K10 everywhere, K9
    on the sorted-halves sums, which PoincareGAT does not have); the plain
    runs launch nothing."""
    import torch

    out = {"phase": "gnn-encode parity", "tolerance": GNN_ENCODE_TOL,
           "tolerance_float64": GNN_ENCODE_TOL_F64, "models": {}}
    failed = []
    for name, model in models.items():
        (kern, k_launch), (plain, p_launch), (again, _) = encode_kernel_and_plain(model, 2)
        k64, p64 = encode_kernel_and_plain(gnn_model(seed, name, dataset, dtype="float64"))
        res = {"max_abs_err": max_diff(kern, plain),
               "plain_vs_plain_max_abs_diff": max_diff(plain, again),
               "max_abs_value": max(float(a.abs().max()) for a in kern),
               "within_tolerance": all(bool(torch.allclose(a, b, **GNN_ENCODE_TOL))
                                       for a, b in zip(kern, plain)),
               "float64_max_abs_err": max_diff(k64[0], p64[0]),
               "float64_within_tolerance": all(bool(torch.allclose(a, b, **GNN_ENCODE_TOL_F64))
                                               for a, b in zip(k64[0], p64[0])),
               "finite": all(bool(torch.isfinite(a).all()) for a in kern + k64[0]),
               "kernel_launches": k_launch, "plain_launches": p_launch}
        out["models"][name] = res
        need = GNN_KERNELS[1:] if name == "PoincareGAT" else GNN_KERNELS
        if (not (res["within_tolerance"] and res["float64_within_tolerance"] and res["finite"])
                or not all(k_launch[k] and k64[1][k] for k in need)
                or any(p_launch.values()) or any(p64[1].values())):
            failed.append(f"{name}: {res}")
    emit(out)
    if failed:
        raise AssertionError("GNN encodes through the kernels and the plain versions "
                             "disagree: " + "; ".join(failed))


def phase_gnn_train_step_parity(dataset, seed: int):
    """3 Adam steps of CompGCN (edge dropout 0) from the same params with the
    same negatives, once through K9/K10 and once with the plain versions.
    Held to PARITY_TOL in float64 (both kernels have a float64 instance).
    In float32 the step reorders f32 sums (K9's edge order against
    index_add_'s atomics), and Adam turns that noise in near-zero gradient
    components into visible steps, as it does between two runs of the plain
    version alone: the float32 differences are reported beside the plain
    version's own run-to-run spread."""
    import numpy as np
    import torch

    import complexhyperbolickge_torch.kernels as KS
    from complexhyperbolickge_torch.train.losses import sample_negatives
    from complexhyperbolickge_torch.train.trainer import TrainConfig, Trainer

    out = {"phase": "gnn-train-step parity", "model": "CompGCN", "steps": 3,
           "tolerance_float64": PARITY_TOL, "dtypes": {}}
    failed = []
    for dtype in ("float64", "float32"):
        model = gnn_model(seed, "CompGCN", dataset, edge_dropout=0.0, dtype=dtype)
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}
        n_ent, n_rel = model.cfg.n_entities, model.cfg.n_relations
        rng = np.random.default_rng(seed)
        batches = np.stack([rng.integers(0, n_ent, (3, GNN_BATCH)),
                            rng.integers(0, n_rel, (3, GNN_BATCH)),
                            rng.integers(0, n_ent, (3, GNN_BATCH))], axis=-1).astype(np.int32)
        weights = np.ones((3, GNN_BATCH), np.float32)
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        negs = [sample_negatives(gen, torch.as_tensor(b, dtype=torch.int64, device=DEVICE),
                                 n_ent, GNN_NEG) for b in batches]

        def three_steps(plain: bool):
            model.load_state_dict(init)
            it = iter(negs)
            trainer = Trainer(model, TrainConfig(**GNN_TRAIN_CONFIG), n_ent, n_rel,
                              sampler=lambda *a: next(it))
            KS.reset_launches()
            restore = swap_plain_gnn() if plain else (lambda: None)
            try:
                trainer.run_epoch(batches, weights, None)
                torch.cuda.synchronize()
            finally:
                restore()
            counts = {k: KS.launches()[k] for k in GNN_KERNELS}
            return {k: v.detach().clone() for k, v in model.state_dict().items()}, counts

        kernel, kernel_launches = three_steps(False)
        plain, plain_launches = three_steps(True)
        res = {"kernel_launches": kernel_launches, "plain_launches": plain_launches,
               "max_moved": max(float((kernel[k] - init[k]).abs().max()) for k in init),
               "max_abs_diff": {k: float((kernel[k] - plain[k]).abs().max()) for k in init},
               "not_within_parity_tol": [k for k in init if not torch.allclose(
                   kernel[k], plain[k], **PARITY_TOL)]}
        if dtype == "float32":
            again, _ = three_steps(True)
            res["plain_vs_plain_max_abs_diff"] = max(
                float((again[k] - plain[k]).abs().max()) for k in init)
        elif res["not_within_parity_tol"]:
            failed.append(f"float64 params beyond PARITY_TOL: {res['not_within_parity_tol']}")
        if set(plain_launches.values()) != {0} or min(kernel_launches.values()) < 3:
            failed.append(f"{dtype} launches: kernel {kernel_launches}, plain {plain_launches}")
        out["dtypes"][dtype] = res
        del model
    emit(out)
    if failed:
        raise AssertionError(f"kernel and plain GNN training steps disagree: {failed}")


def write_gnn_run(seed: int, model) -> str:
    """A run dir of `model` (weights as drawn) as the trainer writes it."""
    from complexhyperbolickge_torch.train.checkpoint import save_checkpoint

    name = type(model).__name__
    work = WORK / "gnn" / name
    save_checkpoint(str(work), model.state_dict(), config={"args": gnn_args(seed, name)})
    return str(work)


def phase_gnn_kge_test(dirs: dict):
    """kge-test of each GNN run dir (auto = the dense ranker over the cached
    encoding): finite metrics, and K9/K10 launched in each (K10 alone for
    PoincareGAT, whose encoder sums over the unsorted [edges; loops] index).
    The weights are untrained, so MRR is near chance."""
    import numpy as np

    import complexhyperbolickge_torch.kernels as KS
    from complexhyperbolickge_torch.cli.test import test

    out = {"phase": "gnn-kge-test", "split": "test", "models": {}}
    by_model = {}
    for name, d in dirs.items():
        before = KS.launches()
        t0 = time.perf_counter()
        m = test(d, device="cuda")
        by_model[name] = {k: KS.launches()[k] - before[k] for k in GNN_KERNELS}
        out["models"][name] = {"MRR": m["MRR"], "MR": m["MR"], "hits@[1,3,10]": m["hits@[1,3,10]"],
                               "cli_seconds": time.perf_counter() - t0,
                               "launches": by_model[name]}
    emit(out)
    # K10 in every encoder, K9 wherever it sums over the sorted halves
    # (PoincareGAT's sums run over the unsorted [edges; loops] index)
    bad = {n: v for n, v in out["models"].items()
           if not (np.isfinite([v["MRR"], v["MR"]]).all() and 0.0 < v["MRR"] <= 1.0)
           or not all(v["launches"][k] for k in (
               GNN_KERNELS[1:] if n == "PoincareGAT" else GNN_KERNELS))}
    if bad:
        raise AssertionError(f"GNN kge-test failed or launched no K9/K10: {bad}")
    return by_model


def gnn_train_window(dataset, seed: int, name: str = "CompGCN"):
    """A trainer at the GNN training config on a fresh `name`, with one
    epoch's batches: what the GNN profile and step windows run (the
    train_window tuple, no labels)."""
    import numpy as np
    import torch

    from complexhyperbolickge_torch.data.dataset import epoch_batches
    from complexhyperbolickge_torch.train.trainer import TrainConfig, Trainer

    model = gnn_model(seed, name, dataset)
    trainer = Trainer(model, TrainConfig(**GNN_TRAIN_CONFIG),
                      model.cfg.n_entities, model.cfg.n_relations)
    b, w, lab = epoch_batches(dataset.get_examples("train"), GNN_BATCH,
                              np.random.default_rng(seed))
    return trainer, b, w, torch.Generator(device=DEVICE).manual_seed(seed), lab


def phase_gnn_step_window(dataset, seed: int, name: str = "PoincareGCN"):
    """PROFILE_GNN_STEPS training steps of `name` through Trainer.run_epoch,
    so the hyperbolic convs' backward runs K9/K10 on the card: loss finite,
    ms per step, launches per step."""
    import numpy as np
    import torch

    import complexhyperbolickge_torch.kernels as KS

    trainer, b, w, gen, _ = gnn_train_window(dataset, seed, name)
    trainer.run_epoch(b[:2], w[:2], gen)  # warm-up
    before = KS.launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = trainer.run_epoch(b[2:2 + PROFILE_GNN_STEPS], w[2:2 + PROFILE_GNN_STEPS], gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: KS.launches()[k] - before[k] for k in GNN_KERNELS}
    out = {"phase": "gnn-step-window", "model": name, "steps": PROFILE_GNN_STEPS,
           "loss": loss, "ms_per_step": 1e3 * secs / PROFILE_GNN_STEPS,
           "triples_per_s": PROFILE_GNN_STEPS * GNN_BATCH / secs,
           "launches_per_step": {k: v / PROFILE_GNN_STEPS for k, v in launches.items()},
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    if not np.isfinite(loss) or min(launches.values()) < PROFILE_GNN_STEPS:
        raise AssertionError(f"{name} training window failed: {out}")


def gnn_kernel_rows(meas, launches, smi, name):
    """The kernels line's K9 and K10 rows at the encoder's hidden width (H =
    200), with the H = 1 and H = 32 measurements beside them.  Bound: bytes,
    each input read once (msgs, row_ptr; the table, ids) and the output
    written once, K10's table as the distinct rows its ids fetch; K9's E H
    fp32 additions as operations."""
    f32_peak, bw_peak, _ = peak_rates(name)
    rows = []
    for kname in GNN_KERNELS:
        by_h = {}
        for h in GNN_WIDTHS:
            m = dict(meas[(kname, h)])
            t_ops, t_bytes = m.pop("ops") / f32_peak * 1e3, m.pop("nbytes") / bw_peak * 1e3
            by_h[h] = {**m, "bound_ms": max(t_ops, t_bytes),
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        bf16 = {}
        for h in GNN_WIDTHS:
            m = dict(meas[(kname, h, "bfloat16")])
            t_ops, t_bytes = m.pop("ops") / f32_peak * 1e3, m.pop("nbytes") / bw_peak * 1e3
            bf16[h] = {**m, "bound_ms": max(t_ops, t_bytes),
                       "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        main = by_h[GNN_WIDTHS[-1]]
        rows.append({"name": kname, "route": "cuda", "source": SOURCES[kname],
                     "replaces": KERNEL_META[kname], "launches": launches[kname], **main,
                     "library": ("torch.segment_reduce" if kname == "sorted_segment_sum"
                                 else "torch.index_select"),
                     "card": smi, "other_widths": {h: by_h[h] for h in GNN_WIDTHS[:-1]},
                     "bfloat16": bf16})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    try:
        import complexhyperbolickge_torch  # noqa: F401  the port beside this script

        name, smi = phase_device()
        phase_build()

        import torch

        import complexhyperbolickge_torch.kernels as KS
        from complexhyperbolickge_torch.cli.predict import load_serving_state

        model_dir, _ = write_run(a.seed)
        model, dataset = load_serving_state(model_dir, "cuda")
        batch, errors = phase_kernels(model, dataset)
        errors.update(phase_train_kernels(a.seed))
        phase_train_step_parity(a.seed)

        hyp_dirs, not_inverted = {}, {}
        for m in HYP_MODELS:
            hyp_dirs[m], not_inverted[m] = write_run(a.seed, m)
        emit({"phase": "hyp-run", "dirs": hyp_dirs, "rank": HYP_RANK,
              "test_tails_not_invertible": not_inverted})
        hyp = {m: load_serving_state(d, "cuda") for m, d in hyp_dirs.items()}
        hyp_batches, hyp_errors = phase_hyp_kernels(hyp)

        KS.reset_launches()  # the FFT serving and evaluation path starts here
        phase_kge_test(model_dir, model, dataset)
        phase_serve(model_dir)
        serve_launches = KS.launches()  # ... and ends here
        KS.reset_launches()  # the FFT training path starts here
        history = phase_train(a.seed)
        train_launches = KS.launches()  # ... and ends here
        # the all-entity losses, the negative modes, SparseAdam (each phase
        # resets and reads the counts itself), then the Euclidean and
        # complex families
        phase_loss_training(a.seed)
        phase_ce_step_parity(dataset, a.seed)
        phase_euc(a.seed)
        KS.reset_launches()  # the real-hyperbolic path starts here
        by_model = {}
        for m, d in hyp_dirs.items():
            before = KS.launches()
            phase_kge_test(d, *hyp[m], label="hyp-kge-test")
            by_model[m] = {k: v - before[k] for k, v in KS.launches().items() if v > before[k]}
        phase_serve(hyp_dirs["RotH"], label="hyp-serve")
        before = KS.launches()
        phase_train(a.seed, HYP_TRAIN_FLAGS, label="hyp-train")
        by_model["RotH training"] = {k: v - before[k] for k, v in KS.launches().items()
                                     if v > before[k]}
        hyp_launches = KS.launches()  # ... and ends here
        emit({"phase": "launches", "serve_eval": serve_launches, "train": train_launches,
              "hyp": hyp_launches, "hyp_by_model": by_model})
        if not all(serve_launches[k] for k in RANK_KERNELS):
            raise AssertionError(f"a ranking kernel never launched: {serve_launches}")
        steps = sum(h["steps"] for h in history)
        if (min(train_launches[k] for k in (*TRAIN_KERNELS, "chyp_train_lists")) < steps
                or not train_launches["chyp_rank_sweep_masked"]):
            raise AssertionError(f"K3/K4 (or K4's lists) launched fewer times than the "
                                 f"{steps} training steps, or K1 never: {train_launches}")
        want = {"RotH": (*HYP_RANK_KERNELS, "hyp_rank_radii"),
                "RotLH": (*HYP_RANK_KERNELS, "hyp_rank_radii"),
                "AttRH": (*ATTRH_KERNELS, "hyp_rank_radii"),
                "RotH training": ("hyp_rank_sweep_masked", "hyp_rank_radii")}
        missing = {m: [k for k in ks if k not in by_model[m]] for m, ks in want.items()}
        if any(missing.values()):
            raise AssertionError(f"real-hyperbolic kernels that never launched: {missing}")
        launches = {**{k: serve_launches[k] for k in RANK_KERNELS},
                    **{k: train_launches[k] for k in (*TRAIN_KERNELS, "chyp_train_lists")}}

        # the GNN path: kernels and parity first, at full width
        gnn_models = {m: gnn_model(a.seed, m, dataset) for m in GNN_MODELS}
        gnn_meas = phase_gnn_kernels(gnn_models["CompGCN"], a.seed)
        phase_gnn_encode_parity(gnn_models, dataset, a.seed)
        phase_gnn_train_step_parity(dataset, a.seed)
        phase_gnn_bf16_train(dataset, a.seed)
        gnn_dirs = {m: write_gnn_run(a.seed, g) for m, g in gnn_models.items()}
        del gnn_models
        KS.reset_launches()  # the GNN path starts here
        gnn_history = phase_train(a.seed, GNN_TRAIN_FLAGS, label="gnn-train")
        gnn_train_launches = KS.launches()
        phase_gnn_step_window(dataset, a.seed)
        gnn_by_model = phase_gnn_kge_test(gnn_dirs)
        phase_serve(gnn_dirs["CompGCN"], label="gnn-serve")
        gnn_launches = KS.launches()  # ... and ends here
        gnn_steps = sum(h["steps"] for h in gnn_history)
        emit({"phase": "gnn-launches", "train": {k: gnn_train_launches[k] for k in GNN_KERNELS},
              "train_steps": gnn_steps, "kge_test_by_model": gnn_by_model,
              "path": {k: gnn_launches[k] for k in GNN_KERNELS}})
        if min(gnn_train_launches[k] for k in GNN_KERNELS) < gnn_steps:
            raise AssertionError(f"K9/K10 launched fewer times than the {gnn_steps} CompGCN "
                                 f"training steps: {gnn_train_launches}")

        step_ms = phase_profile(
            (model, dataset, train_window(dataset, a.seed)),
            (*hyp["RotH"], train_window(hyp["RotH"][1], a.seed, "RotH")),
            gnn_train_window(dataset, a.seed),
            {"ce_train": train_window(dataset, a.seed, config="FFTRotH CE"),
             "bce_train": train_window(dataset, a.seed, config="FFTRotH BCE")})
        rows = phase_kernel_line(model, batch, launches, errors, smi, name, a.seed, step_ms)
        rows += hyp_kernel_rows(hyp, hyp_batches, hyp_launches, hyp_errors, smi, name)
        rows += gnn_kernel_rows(gnn_meas, gnn_launches, smi, name)
        emit({"kernels": rows})
        torch.cuda.synchronize()
    except (Exception, SystemExit):  # report, then fail without the ok line
        traceback.print_exc()
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
