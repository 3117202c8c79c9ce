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
CompGCN, PoincareGCN, LorentzGCN and PoincareGAT, CompGCN serving), and the
subgraph path at the JAX package's subgraph configuration
(benchmarks/subgraph_bench.py:17-45): CompGCN at that width with edge
dropout 0.1 and dropout 0.1, trained on subgraphs sampled around batches of
500 seed edges by the C++ sampler (fanouts 20/20, at most 4,096 nodes and
32,768 edges), the all-node cross-entropy, 348 steps an epoch.
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
              500 x (1 + 100) sampler-drawn ids over a 40,943 x 66 table;
              FFTRotH's fused query chain (forward, and the backward's two
              launches) on 500 queries at the init, 0.1 and 0.5 scales;
              RotH's ranker query prep (one launch) on 500 queries at the
              init, 0.05 and 3 (project clips) scales
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
              through the dense ranker (MRR >= 0.25); profile-dir: the
              ComplEx run with --profile_dir writes one trace (epoch 2)
 10 hyp-kge-test, hyp-serve, hyp-train  phases 7-9 on the real-hyperbolic
              path: kge-test per model, RotH serving, RotH training (eager
              autograd, no kernel in the step; validation and the final test
              through K5)
 10a bf16-kernels  --eval_precision default: the bf16 tensor-core
              instances of K1, K2's sweep and subtraction (FFTRotH, D 66 in
              bf16 rows of 80) and of K5-K8's sweeps and subtractions (RotH,
              RotLH, AttRH, D 32) against their plain default versions on
              each model's first test batch (inputs from the default
              rankers' kernel_inputs); maskless == masked exactly
 10b bf16-bits  the bits of the bf16 sweeps' branch-free epilogue: its
              square root against __fsqrt_rn over every non-negative finite
              float32, its division against __fdiv_rn over 2^32 drawn pairs,
              and the K1/K2 (FFTRotH), K5/K6 (RotH, RotLH) and K7/K8 (AttRH)
              bf16 sweeps' scores against chyp_score()'s / score_from_radii's
              for every pair of each model's first test batch; mismatch
              counts per family (and FFTRotH's pairs the fast path
              flagged), any > 0 fails
 11 launches  each path's kernel launches; a kernel of a path that never
              launched there fails the run, K3/K4 (and chyp_train_lists,
              K4's index preparation) must launch at least once
              per training step, and each of RotH, RotLH and AttRH must
              launch its family's three kernels and the radius launcher
 12 gnn-kernels  K9 against index_add_ (rtol 1e-5, atol 1e-6) and K10 against
              x[ids] (bitwise) on one sorted half of the graph (E 86,835, N
              40,943) at H = 1, 32, 100, 200, forward and backward, in float32
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
 15' default-kge-test  the --eval_precision default path: kge-test of the
              FFTRotH, RotH, RotLH and AttRH runs with the masked and the
              maskless fused rankers and of the CompGCN run (dense), beside
              the same at highest (MRR delta within 1e-3), each default
              fused ranker's whole-split queries/s, every bf16 instance
              launched on this path, and one batch of CompGCN's dense
              default scores against their rounded-operand definition
 15a subgraph-train  the subgraph path: cli.run.train --subgraph at the
              JAX package's subgraph configuration (benchmarks/
              subgraph_bench.py:17-45; below), 2 epochs of 348 steps: the C++
              sampler, the loss finite and falling, triples/s and ms a step,
              peak device memory, and a 20-step profiler window (busy ms,
              idle share, launches a step); subgraph-launches: K9/K10 in
              its full-graph validation
 15b subgraph-bce  40 steps of that model with BCE, smoothing 0.1 and
              update_steps 2: the loss finite and falling
 15c subgraph-step parity  one subgraph step of CompGCN and of PoincareGCN
              (dropout 0) on the card in float32 against the CPU in float64
              (CE_PARITY_TOL)
 15d export-import  cli.export of the FFT run dir equals its checkpoint; a
              reference-style config.json + model.pt of its weights through
              cli.import_ref; kge-test of the import gives the same metrics
 15e mesh-rank, mesh-train, mesh-1x2-train  the parallel/ path: two
              ranks spawned on the one card under gloo (NCCL refuses two
              ranks on a device), each counting its kernels' launches in its
              own process: cli.run.run_rank --mesh 2x1 for 2 epochs at the
              FFT config (K3/K4 at least once a step on each rank, the loss
              falling), then on a 1x2 mesh the sharded rankers (K1/K2,
              K5/K6 on RotH, K7/K8 on AttRH, K1/K2 bf16) over the planted
              test splits, equal to this process's fused ranks, and 3 Adam
              steps on 2x1 and on 1x2 against one process's (PARITY_TOL);
              the gloo all_reduce of a step's flat gradient, ms.  Correctness
              and overhead, not a multi-GPU number
 15e' mesh-subgraph-parity, mesh-subgraph-train  the same two ranks:
              3 SGD steps of the subgraph path's CompGCN (dropouts on) on
              2x1 and on 1x2 against one process's (PARITY_TOL), then 20
              timed steps (ms, the collectives' calls and bytes, peak
              memory, beside one process's); then cli.run.run_rank for one
              epoch of `--subgraph --mesh 2x1` at the subgraph config (the
              C++ sampler, 348 steps, a finite loss, K9/K10 in each rank's
              full-graph validation and test)
 15f nccl-world1  an NCCL group of one in this process (cli.run's device
              and backend choice): 3 data-parallel steps and a sharded rank
              call whose collectives all run through NCCL, equal to one
              process's
 16 profile   torch.profiler over one whole-split ranking per ranker (FFTRotH
              and RotH) and over 20 training steps of each, of CompGCN and
              of FFTRotH's CE and BCE steps: wall time, device busy time and
              idle share, kernels a step, top kernels and host ops
 17 the kernels line: launches, and the times of kernel, plain version and
              library call beside the kernel's bound (and the rankers' busy
              time per call and the training step's device time; the sweeps'
              registers, blocks per SM, shared and local bytes; K9/K10's
              bfloat16 instances under "bfloat16"; the rows of the rankers'
              bf16 instances, `<name>_bf16`, with their exact instance's
              time (exact_ms), the contraction's torch.mm time as
              library_ms, the bound's winning term (bound_term: the
              epilogue on the fp32 cores, the tensor cores or the bytes),
              and the Lorentz K5/K6 instantiation under
              "lorentz"; each rank's launches on the mesh paths,
              mesh_rank_launches_per_rank, mesh_train_launches_per_rank and
              mesh_subgraph_launches_per_rank)
 18 {"ok": true, "device": {...}}
Needs no network; the HTTP server listens on 127.0.0.1 and is shut down.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import threading
import time
import traceback
import urllib.request
from functools import partial
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
# outside the tensor cores (the exact kernels), memory bandwidth, fp64
# outside the tensor cores (K3/K4 accumulate their dots in fp64), and bf16
# on the tensor cores (the bf16 instances of --eval_precision default)
PEAKS = {"H100 PCIe": (51.2e12, 2.0e12, 25.6e12, 756e12),
         "H100 NVL": (60.0e12, 3.9e12, 30.0e12, 835e12),
         "H100": (67.0e12, 3.35e12, 34.0e12, 989e12), "H200": (67.0e12, 4.8e12, 34.0e12, 989e12)}

KERNEL_META = {
    "chyp_rank_sweep_masked": "complexhyperbolickge_tpu/kernels/chyp_rank.py:147",
    "chyp_rank_sweep_nomask": "complexhyperbolickge_tpu/kernels/chyp_rank.py:213",
    "chyp_rank_filtered_sub": "complexhyperbolickge_tpu/kernels/chyp_rank.py:230",
    "chyp_train_fwd": "complexhyperbolickge_tpu/kernels/chyp_train.py:89",
    "chyp_train_bwd": "complexhyperbolickge_tpu/kernels/chyp_train.py:117",
    # no pallas_call: the JAX model runs the chain in XLA
    "fftroth_queries_fwd": "complexhyperbolickge_tpu/models/chyperbolic.py FFTRotH.get_queries",
    "fftroth_queries_bwd": "its autograd backward",
    # no pallas_call: XLA runs the JAX ranker's query prep
    "roth_rank_queries": "complexhyperbolickge_tpu/kernels/hyp_rank.py:659 "
                         "PallasHypRanker._queries_core (RotH)",
    "hyp_rank_sweep_masked": "complexhyperbolickge_tpu/kernels/hyp_rank.py:502",
    "hyp_rank_sweep_nomask": "complexhyperbolickge_tpu/kernels/hyp_rank.py:545",
    "hyp_rank_filtered_sub": "complexhyperbolickge_tpu/kernels/hyp_rank.py:563",
    "attrh_rank_sweep_masked": "complexhyperbolickge_tpu/kernels/hyp_rank.py:253",
    "attrh_rank_sweep_nomask": "complexhyperbolickge_tpu/kernels/hyp_rank.py:294",
    "attrh_rank_filtered_sub": "complexhyperbolickge_tpu/kernels/hyp_rank.py:312",
    "sorted_segment_sum": "complexhyperbolickge_tpu/kernels/segsum.py:98",
    "row_gather": "complexhyperbolickge_tpu/kernels/gather.py:94",
    # no pallas_call: XLA's scatter-add, the backward of rel[etype]
    "relation_grad": "complexhyperbolickge_tpu/models/gnn/convs.py:119 rel[etype]'s backward",
}
SOURCES = {"chyp_rank": "complexhyperbolickge_torch/kernels/csrc/chyp_rank.cu",
           "chyp_train": "complexhyperbolickge_torch/kernels/csrc/chyp_train.cu",
           "chyp_queries": "complexhyperbolickge_torch/kernels/csrc/chyp_queries.cu",
           "hyp_rank": "complexhyperbolickge_torch/kernels/csrc/hyp_rank.cu",
           "hyp_queries": "complexhyperbolickge_torch/kernels/csrc/hyp_queries.cu",
           "sorted_segment_sum": "complexhyperbolickge_torch/kernels/csrc/segsum.cu",
           "row_gather": "complexhyperbolickge_torch/kernels/csrc/gather.cu",
           "relation_grad": "complexhyperbolickge_torch/kernels/csrc/relgrad.cu"}
RANK_KERNELS = ("chyp_rank_sweep_masked", "chyp_rank_sweep_nomask",
                "chyp_rank_filtered_sub")
TRAIN_KERNELS = ("chyp_train_fwd", "chyp_train_bwd")
CHAIN_KERNELS = ("fftroth_queries_fwd", "fftroth_queries_bwd")
# the fused chain against its plain version on the card: the forward
# within 4 float32 ulps of the output's largest entry, the gradients 1e-5
# of each table's (tests/test_torch_chyp_queries.py)
CHAIN_FWD_ULPS, CHAIN_GRAD_REL = 4, 1e-5

# RotH's ranker query prep against its plain version on the card: lhs, x2
# and t2 within 4 float32 ulps of each output's largest entry, cid and c
# equal (tests/test_torch_kernels_cuda.py)
ROTH_QUERIES_ULPS = 4

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
GNN_WIDTHS = (1, 32, 100, 200)  # K9 / K10: edge weights, rank 32, rank 100, hidden
GNN_KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)  # K9 against index_add_: another order
# the relation table's gradient (kernels/relgrad.py): CompGCN's rank at
# WN18RR's published widths, and the hidden width
RELGRAD_WIDTHS = (100, 200)
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
# the subgraph path: the JAX package's published subgraph configuration
# (benchmarks/subgraph_bench.py:17-45): CompGCN, rank 32, hidden 200, 2
# layers, opn mult, distmult, edge dropout 0.1, dropout 0.1, Adam lr 1e-3,
# batches of 500 seed edges, the all-node cross-entropy, float32; the
# sampler at SubgraphTrainer's defaults (fanouts 20/20, max_nodes 4,096,
# max_edges 32,768).  Every directed train edge seeds once an epoch:
# 173,670 / 500 -> 348 steps, the last one padded
SUBGRAPH_ARGS = dict(GNN_ARGS, edge_dropout=0.1, dropout=0.1)
SUBGRAPH_TRAIN_FLAGS = ["--model", "CompGCN", "--regularizer", "N3", "--reg", "0.0",
                        "--optimizer", "Adam", "--rank", str(GNN_RANK), "--batch_size",
                        str(BATCH), "--neg_sample_size", "0", "--loss", "crossentropy",
                        "--learning_rate", "1e-3", "--multi_c", "--bias", "learn",
                        "--dtype", "float32", "--subgraph",
                        *[str(x) for k, v in SUBGRAPH_ARGS.items() for x in (f"--{k}", v)]]
SUBGRAPH_CONFIG = dict(optimizer="Adam", learning_rate=1e-3, batch_size=BATCH,
                       neg_sample_size=0, loss="crossentropy")
SUBGRAPH_STEPS = 348
SUBGRAPH_BCE_WINDOW = 20  # subgraph-bce: two windows of 20 steps (update_steps 2)
# the bf16 tensor-core instances (--eval_precision default)
BF16_KERNELS = tuple(f"{k}_bf16" for k in (*RANK_KERNELS, *HYP_RANK_KERNELS, *ATTRH_KERNELS))
# an epilogue's transcendental calls, IEEE divisions and square roots a pair
# after the contraction, with the radius tables' part precomputed
# (csrc/chyp_rank.cu chyp_score, csrc/hyp_rank.cu score_from_radii)
SFU_PER_PAIR = {"chyp": 3, "poincare": 7, "lorentz": 4, "attrh": 14}
# fp32 operations of one pair's epilogue after the contraction, counted in
# csrc/hyp_rank.cu (pair_score) and csrc/epilogue.cuh (chyp_score) with
# every +, -, *, /, sqrt, clamp and transcendental call as one: a floor,
# since a tanhf, log1pf or logf is ~20 instructions
EPILOGUE_OPS = {"poincare": 54, "lorentz": 23, "attrh": 93, "chyp": 16}
# bf16-bits: the drawn pairs of the division's proof (2^32)
BITS_QUOT_PAIRS = 1 << 32


def bound_ms(peaks, nbytes, f32_ops=0, f64_ops=0, tc_ops=0):
    """The least time (ms) a card of `peaks` (a PEAKS entry) takes for a
    kernel's work: the largest of its fp32 and fp64 operations over those
    rates (one term: both issue on the SMs' cores), its tensor-core
    operations over the bf16 tensor-core rate (a separate unit), and its
    bytes over the memory rate.  Returns (ms, "operations" or "bytes", the
    term that wins: "cores", "tensor_cores" or "bytes")."""
    f32_peak, bw_peak, f64_peak, bf16_peak = peaks
    terms = {"cores": (f32_ops / f32_peak + f64_ops / f64_peak) * 1e3,
             "tensor_cores": tc_ops / bf16_peak * 1e3, "bytes": nbytes / bw_peak * 1e3}
    term = max(terms, key=terms.get)
    return terms[term], ("bytes" if term == "bytes" else "operations"), term


def chyp_row_work(kname, b, n, d, kept=0, n_rows=0, l=0):
    """(fp32 operations, bytes) of the exact K1 / K2 instance `kname` at the
    model's N entities and D features, for B queries: per pair the
    contraction's 2 (2D) operations (re and im) and chyp_score's
    EPILOGUE_OPS; a subtraction only its `kept` filter ids, of `n_rows`
    distinct rows, L a query.  Bytes each input once: lhs2, zn, t2, the
    table's real rows, wn, bt, the int8 mask (masked) or the gold, the
    counts."""
    pair_ops = 2 * (2 * d) + EPILOGUE_OPS["chyp"]
    vec = 4 * (2 * b * d + 2 * b + 2 * n + n * d)  # lhs2, zn, t2, wn, bt, rhs
    if kname == "chyp_rank_sweep_masked":
        return b * n * pair_ops, vec + b * n + 4 * b
    if kname == "chyp_rank_sweep_nomask":
        return b * n * pair_ops, vec + 4 * b + 4 * b
    return kept * pair_ops, 4 * (2 * b * d + 2 * b + n_rows * (d + 2)) + 4 * b * l + 8 * b


def bf16_row_work(kname, family, b, n, d, kept=0, n_rows=0, l=0, n_c=0, table_width=0):
    """(tensor-core operations, fp32 operations, bytes) of a bf16 instance
    `kname` (`<kernel>_bf16`) of `family` ("chyp", "poincare", "lorentz" or
    "attrh") at the model's N entities and D features, for B queries: the
    contraction's 2 M N D on the tensor cores (M = 2B query rows for the FFT
    family, B otherwise; a subtraction only its `kept` filter ids, of
    `n_rows` distinct rows, L a query); the family's EPILOGUE_OPS a pair in
    fp32, as the exact rows count them; bytes
    each input once: bf16 operands, f32 per-query and per-row vectors, the
    int8 mask or the gold, the radius table's real rows of its n_c
    curvatures (table_width floats an entry) and cvals, the counts."""
    chyp = family == "chyp"
    m_rows = 2 * b if chyp else b
    names = HYP_ARGS["attrh" if family == "attrh" else "hyp"]
    n_pq = 2 if chyp else names.index("rhs") - 1  # per-query vectors
    n_pr = 2 if chyp else len(names) - names.index("rhs") - 1  # per-row vectors
    epi = EPILOGUE_OPS[family]
    if "_sweep_" in kname:
        nbytes = (2 * (m_rows + n) * d + 4 * (b * n_pq + n * n_pr) + 4 * b
                  + (b * n if kname.endswith("masked_bf16") else 4 * b))
        if not chyp:
            nbytes += 4 * (n_c * table_width * n + n_c + b)
        return 2 * m_rows * n * d, b * n * epi, nbytes
    nbytes = 2 * (m_rows + n_rows) * d + 4 * (b * n_pq + n_rows * n_pr) + 4 * b * l + 8 * b
    return 2 * (2 if chyp else 1) * kept * d, kept * epi, nbytes


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


def hyp_family(family: str, precision: str = "highest"):
    """A real-hyperbolic family's kernels at `precision`: (the subtractions'
    leading input names, plain all-entity scores of an input dict, kernel
    name -> (wrapper, plain version, input names in wrapper order), the
    maskless count of an input dict, the radius table of an input dict
    through the kernel and the plain version)."""
    from functools import partial

    from complexhyperbolickge_torch.kernels import hyp_rank as H

    g = "attrh" if family == "attrh" else "hyp"
    names, sweep = HYP_ARGS[g], HYP_SWEEP_ARGS[g]
    un = ("un_rot", "un_ref") if g == "attrh" else ("un",)

    def radii(x, fn):
        return fn(x["cvals"], x[un[0]], family, *(x[k] for k in un[1:]))

    tables = (partial(radii, fn=H.hyp_rank_radii), partial(radii, fn=H.hyp_rank_radii_plain))
    fam = dict(precision=precision) if g == "attrh" else dict(family=family,
                                                              precision=precision)
    counts_nomask = H.attrh_rank_counts_nomask if g == "attrh" else H.hyp_rank_counts_nomask

    def maskless(x):
        return counts_nomask(*(x[k] for k in sweep), x["fidx"], x["gold"], **fam)

    if g == "attrh":
        return names, lambda x: H.attrh_scores_plain(*(x[k] for k in names if k != "t2"),
                                                     **fam), {
            "attrh_rank_sweep_masked": (partial(H.attrh_rank_counts, **fam),
                                        partial(H.attrh_rank_counts_plain, **fam),
                                        (*sweep, "mask")),
            "attrh_rank_sweep_nomask": (partial(H.attrh_rank_sweep_nomask, **fam),
                                        partial(H.attrh_rank_sweep_nomask_plain, **fam),
                                        (*sweep, "gold")),
            "attrh_rank_filtered_sub": (partial(H.attrh_rank_filtered_sub, **fam),
                                        partial(H.attrh_rank_filtered_sub_plain, **fam),
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


def chain_inputs(scale: float, seed: int):
    """FFTRotH's tables at the smoke's width (the published init, or rows
    drawn at `scale`, where 0.5 clips in project) and BATCH queries [h, r]
    with repeated ids: (tables, queries, g_res, g_bias)."""
    import torch

    model = wn18rr_model(seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        if scale:
            for k in ("entity", "rel", "bh"):
                p = getattr(model, k)
                p.copy_(torch.randn(p.shape, generator=g) * scale)
            model.c.copy_(1.0 + 0.05 * torch.randn(model.c.shape, generator=g))
    n, nr = model.entity.shape[0], model.rel.shape[0]
    q = torch.stack([torch.randint(0, n, (BATCH,), generator=g),
                     torch.randint(0, nr, (BATCH,), generator=g)], 1)
    q[7], q[9, 0] = q[3], q[3, 0]
    tables = [getattr(model, k).detach() for k in ("entity", "rel", "rel_diag", "c", "bh")]
    g_res = torch.randn((BATCH, 2 * RANK), generator=g)
    g_bias = torch.randn((BATCH, 1), generator=g)
    return tables, q.to(DEVICE), g_res.to(DEVICE), g_bias.to(DEVICE)


def chain_work(kname: str, b: int, n_rows: int, d: int, n_rel: int):
    """(fp32 operations, fp64 operations, bytes) of FFTRotH's fused chain
    for b queries: fp64, the DFTs' 2 D n FMA operations each (the forward
    two, the backward three: the recomputed irfft and the two transposed
    products) and the row sums' 2 n a sum (13 forward, 16 more backward);
    fp32, ~25 a coordinate forward and ~60 more backward (n = D - 2).
    Bytes: each query's rows of the five tables, its ids and its outputs;
    the backward also g_res, its scratch written and read, the row slots
    (N) and the dense gradients (N x (D + 1), the relation tables)."""
    n = d - 2
    dft, sums = 2 * d * n, 2 * n
    row_in = 4 * (d + 2 * n + n + 2) + 16
    if kname == "fftroth_queries_fwd":
        return b * 25 * n, b * (2 * dft + 13 * sums), b * (row_in + 4 * (d + 1)) + 16 * d * n
    scratch = 4 * (d + 3 * n + 1)
    return (b * 85 * n, b * (3 * dft + 29 * sums),
            b * (row_in + 4 * d + 2 * scratch) + 4 * (n_rows * (d + 2) + n_rel * 3 * n)
            + 24 * d * n)


def phase_chain_kernels(seed: int):
    """FFTRotH's fused query chain against its plain version on the card:
    the forward and the backward (both launches), at the published init
    and at row scales 0.1 and 0.5, with and without multi_c."""
    import torch

    from complexhyperbolickge_torch.kernels import chyp_queries as CQ

    out = {"phase": "chain-kernels", "B": BATCH, "D": 2 * RANK, "regimes": {}}
    errors = dict.fromkeys(CHAIN_KERNELS, 0.0)
    for scale in (0.0, 0.1, 0.5):
        tables, q, g_res, g_bias = chain_inputs(scale, seed)
        res, bias = CQ.fftroth_queries_forward(*tables, q, True)
        want, want_b = CQ.fftroth_queries_forward_plain(*tables, q, True)
        grads = CQ.fftroth_queries_backward(g_res, g_bias, *tables[:4], q, True)
        again = CQ.fftroth_queries_backward(g_res, g_bias, *tables[:4], q, True)
        want_g = CQ.fftroth_queries_backward_plain(g_res, g_bias, *tables[:4], q, True)
        torch.cuda.synchronize()
        fwd_err = float((res - want).abs().max())
        rel = [float((a - e).abs().max()) / max(float(e.abs().max()), 1e-30)
               for a, e in zip(grads, want_g)]
        out["regimes"][str(scale)] = {
            "res_max_abs_err": fwd_err, "bias_equal": bool(torch.equal(bias, want_b)),
            "grad_rel_err": rel, "same_bits_twice": all(
                torch.equal(a, b) for a, b in zip(grads, again)),
            "ok": (fwd_err <= CHAIN_FWD_ULPS * 2**-23 * float(want.abs().max())
                   and max(rel) <= CHAIN_GRAD_REL and bool(torch.equal(bias, want_b)))}
        errors["fftroth_queries_fwd"] = max(errors["fftroth_queries_fwd"], fwd_err)
        errors["fftroth_queries_bwd"] = max(errors["fftroth_queries_bwd"], *[
            float((a - e).abs().max()) for a, e in zip(grads, want_g)])
    emit(out)
    if not all(v["ok"] and v["same_bits_twice"] for v in out["regimes"].values()):
        raise AssertionError(f"the fused chain disagrees with its plain version: {out}")
    return errors


def roth_queries_inputs(scale: float, seed: int):
    """RotH at the smoke's width (rank 32, multi_c, bias learn) with entity
    and relation rows drawn at `scale` (0: the published init; 3: heads and
    relation halves that project clips), its curvature table cvals as
    HypRanker builds it, and BATCH queries [h, r, gold]."""
    import torch

    from complexhyperbolickge_torch.kernels.hyp_rank import _curvatures

    model = wn18rr_model(seed, "RotH")
    g = torch.Generator().manual_seed(seed + 17)
    if scale:
        with torch.no_grad():
            for k in ("entity", "rel"):
                p = getattr(model, k)
                p.copy_(torch.randn(p.shape, generator=g) * scale)
            model.bt.copy_(torch.randn(model.bt.shape, generator=g) * 0.01)
            model.c.copy_(1.0 + 0.05 * torch.randn(model.c.shape, generator=g))
    n, nr = model.cfg.n_entities, model.cfg.n_relations
    q = torch.stack([torch.randint(0, n, (BATCH,), generator=g),
                     torch.randint(0, nr, (BATCH,), generator=g),
                     torch.randint(0, n, (BATCH,), generator=g)], 1)
    q[7, :2] = q[3, :2]
    tables = [getattr(model, k).detach() for k in ("entity", "rel", "rel_diag", "bt")]
    return tables + [_curvatures(model, DEVICE)], q.to(DEVICE)


def phase_roth_queries(seed: int, name: str, smi: str):
    """RotH's ranker query prep (kernels/hyp_queries.py) against its plain
    version on the card at the published init and at row scales 0.05 (the
    benchmark's trained spread) and 3 (project clips); then its kernels
    line row at scale 0.05: the kernel's and the plain version's ms at B
    500, D 32, and the bound of its work (per row the chain's ~40 fp32
    operations a coordinate and 18 fp64 sums of 2 D operations; bytes: the
    head, gold, relation and rel_diag rows, the ids, bt, the curvature and
    the outputs)."""
    import torch

    from complexhyperbolickge_torch.kernels import hyp_queries as HQ

    out = {"phase": "roth-queries", "B": BATCH, "D": HYP_RANK, "regimes": {}}
    err = 0.0
    for scale in (0.0, 0.05, 3.0):
        tables, q = roth_queries_inputs(scale, seed)
        got = HQ.roth_rank_queries(*tables, q, True, True)
        want = HQ.roth_rank_queries_plain(*tables, q, True, True)
        torch.cuda.synchronize()
        errs = {k: float((a - e).abs().max()) for k, a, e in
                zip(("lhs", "x2", "t2"), (got[0], got[1], got[4]), (want[0], want[1], want[4]))}
        ok = (torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
              and all(errs[k] <= ROTH_QUERIES_ULPS * 2**-23 * float(e.abs().max())
                      for k, e in zip(errs, (want[0], want[1], want[4])))
              and all(bool(torch.isfinite(t).all()) for t in got))
        out["regimes"][str(scale)] = {"max_abs_err": errs, "ok": ok}
        err = max(err, *errs.values())
    emit(out)
    if not all(v["ok"] for v in out["regimes"].values()):
        raise AssertionError(f"RotH's query kernel disagrees with its plain version: {out}")
    tables, q = roth_queries_inputs(0.05, seed)
    d = HYP_RANK
    f32_ops, f64_ops = BATCH * 40 * d, BATCH * 18 * 2 * d
    nbytes = BATCH * (4 * (2 * d + 2 * d + d + 1 + 1) + 24 + 4 * (d + 3) + 4)
    bound, bound_by, _ = bound_ms(peak_rates(name), nbytes, f32_ops, f64_ops)
    args = [*tables, q, True, True]
    return {"name": "roth_rank_queries", "route": "cuda", "source": SOURCES["hyp_queries"],
            "replaces": KERNEL_META["roth_rank_queries"], "max_abs_err": err,
            "ms": cuda_ms(lambda: HQ.roth_rank_queries(*args), reps=50),
            "plain_ms": cuda_ms(lambda: HQ.roth_rank_queries_plain(*args)),
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None, "card": smi,
            "shape": {"B": BATCH, "N": tables[0].shape[0], "D": d, "nR": tables[1].shape[0]}}


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
        # --profile_dir on the ComplEx run: epoch 2 is traced
        prof = WORK / f"profile-{m}"
        shutil.rmtree(prof, ignore_errors=True)  # a trace of an earlier run
        flags = ["--profile_dir", str(prof)] if m == "ComplEx" else []
        phase_train(seed, [*HYP_TRAIN_FLAGS, "--model", m, *flags], label=f"euc-train-{m}")
        if flags:
            traces = sorted(prof.glob("*.pt.trace.json"))
            emit({"phase": "profile-dir", "run": f"euc-train-{m}", "traced_epoch": 2,
                  "traces": [t.name for t in traces],
                  "bytes": [t.stat().st_size for t in traces]})
            if len(traces) != 1 or not traces[0].stat().st_size:
                raise AssertionError(f"--profile_dir wrote no single trace into {prof}")
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
    import torch

    from complexhyperbolickge_torch.kernels import chyp_rank as K
    from complexhyperbolickge_torch.kernels import chyp_train as CT
    from complexhyperbolickge_torch.train.evaluate import make_ranker

    q, f, xm, xn = batch
    base = [xm[k] for k in ("lhs2", "zn", "t2", "rhs", "wn", "bt")]
    b, d = base[0].shape[0] // 2, base[0].shape[1]
    np_, ld = base[3].shape  # the table's rows padded to ld >= d floats
    l = xn["fidx"].shape[1]
    # whole rankers per batch, query prep included (~200 launches a call)
    dense = make_ranker(model)
    dense_ms = busy_ms(lambda: dense(q, f))
    ranker_ms = {}
    for masked in (True, False):
        ranker = K.ChypRanker(model, masked=masked)
        ranker_ms[masked] = busy_ms(lambda: ranker(q, f))
    # the function's work at the model's N entities, not the table's Np
    # padded rows (nor the ld - d pad floats of a row)
    n = model.cfg.n_entities
    fidx, gold = xn["fidx"].long(), xn["gold"].long()
    kept = (fidx >= 0) & (fidx < n) & (fidx != gold[:, None])
    n_rows = int(torch.unique(fidx[kept]).numel())
    # name -> (kernel, plain, args)
    calls = {
        "chyp_rank_sweep_masked": (K.chyp_rank_counts, K.chyp_rank_counts_plain,
                                   [*base, xm["mask"]]),
        "chyp_rank_sweep_nomask": (K.chyp_rank_sweep_nomask,
                                   K.chyp_rank_sweep_nomask_plain, [*base, xn["gold"]]),
        "chyp_rank_filtered_sub": (K.chyp_rank_filtered_sub,
                                   K.chyp_rank_filtered_sub_plain,
                                   [*base, xn["fidx"], xn["gold"]]),
    }
    work = {}  # name -> (kernel, plain, args, fp32 ops, fp64 ops, bytes)
    for kname, call in calls.items():
        f32_ops, nbytes = chyp_row_work(kname, b, n, d, int(kept.sum()), n_rows, l)
        work[kname] = (*call, f32_ops, 0, nbytes)
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
    # FFTRotH's fused query chain at BATCH queries: the forward, and the
    # backward's two launches (bwd, then sum), counted as one row
    from complexhyperbolickge_torch.kernels import chyp_queries as CQ

    tables, cq, g_res, g_bias = chain_inputs(0.1, seed)
    for kname, (kernel, plain, args) in {
            "fftroth_queries_fwd": (CQ.fftroth_queries_forward, CQ.fftroth_queries_forward_plain,
                                    [*tables, cq, True]),
            "fftroth_queries_bwd": (CQ.fftroth_queries_backward,
                                    CQ.fftroth_queries_backward_plain,
                                    [g_res, g_bias, *tables[:4], cq, True])}.items():
        f32_ops, f64_ops, nbytes = chain_work(kname, BATCH, tables[0].shape[0], 2 * RANK,
                                              tables[1].shape[0])
        work[kname] = (kernel, plain, args, f32_ops, f64_ops, nbytes)
    rows = []
    for kname, (kernel, plain, args, f32_ops, f64_ops, nbytes) in work.items():
        bound, bound_by, _ = bound_ms(peak_rates(name), nbytes, f32_ops, f64_ops)
        lib = ("chyp_train" if kname in TRAIN_KERNELS else
               "chyp_queries" if kname in CHAIN_KERNELS else "chyp_rank")
        row = {
            "name": kname, "route": "cuda", "source": SOURCES[lib],
            "replaces": KERNEL_META[kname], "launches": launches[kname],
            "max_abs_err": errors[kname],
            "ms": cuda_ms(lambda: kernel(*args), reps=50),
            "plain_ms": cuda_ms(lambda: plain(*args)),
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None, "card": smi,
        }
        if kname in TRAIN_KERNELS:
            row.update(step_ms=step_ms, shape={"B": tb, "K": ids.shape[1], "N": tn, "D": td,
                                               "distinct_rows": distinct},
                       identity_ms=cuda_ms(identity[kname], reps=50),
                       identity_shape={"B": BATCH, "K": NEG, "D": td})
            if kname == "chyp_train_bwd":
                row.update(lists_ms=lists_ms, lists_launches=launches["chyp_train_lists"])
        elif kname in CHAIN_KERNELS:
            row.update(step_ms=step_ms, shape={"B": BATCH, "N": tables[0].shape[0],
                                               "D": 2 * RANK, "nR": tables[1].shape[0]})
            if kname == "fftroth_queries_bwd":
                row["sum_launches"] = launches["fftroth_queries_sum"]
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

    timed = {}
    for mname, (model, _) in hyp.items():
        family = HYP_MODELS[mname]
        names, _, fns, _, tables = hyp_family(family)
        q, f, x = batches[mname]
        (b, d), np_, l = x["lhs"].shape, x["rhs"].shape[0], x["fidx"].shape[1]
        n = model.cfg.n_entities  # the function's rows, not the Np padded ones
        n_pq = names.index("rhs") - 1  # per-query vectors
        n_pr = len(names) - names.index("rhs") - 1  # per-row vectors
        vec = 4 * (b * d + n * d + b * n_pq + n * n_pr)
        pair_ops = 2 * d + EPILOGUE_OPS[family]
        fidx, gold = x["fidx"].long(), x["gold"].long()
        kept = (fidx >= 0) & (fidx < n) & (fidx != gold[:, None])
        n_rows = int(torch.unique(fidx[kept]).numel())
        table_bytes = 4 * (x["radii"].numel() // np_ * n + x["cvals"].numel())
        work = {  # kernel name -> (fp32 operations, bytes)
            fns_name: w for fns_name, w in zip(fns, (
                (b * n * pair_ops, vec + b * n + table_bytes + 4 * b),
                (b * n * pair_ops, vec + table_bytes + 4 * b + 4 * b),
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
            bound, bound_by, _ = bound_ms(peak_rates(name), nbytes, ops)
            timed[(kname, family)] = {
                "model": mname, "family": family, "max_abs_err": errors[(kname, family)],
                "ms": cuda_ms(lambda: kernel(*args), reps=50),
                "plain_ms": cuda_ms(lambda: plain(*args)),
                "bound_ms": bound, "bound_by": bound_by,
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


# ------------------- --eval_precision default: the bf16 instances -------------------


def phase_bf16_kernels(model, dataset, hyp: dict):
    """The bf16 tensor-core instances (precision "default") against their
    plain default versions on each model's first test batch at full width
    (FFTRotH: D 66 in bf16 rows of 80; RotH, RotLH, AttRH: D 32), inputs
    from each default ranker's kernel_inputs: within the entities whose
    score interval (the contraction moved by TC_REL sum_k |q_k w_k|) holds
    t2; masked == maskless - subtraction exactly.  Returns (name, family)
    -> (the bf16 call, its plain call, the exact instance's call on the
    exact inputs, the inputs, the ranker's busy ms, the model's entities
    and features) for the kernels line, and the errors."""
    import torch

    from complexhyperbolickge_torch.kernels import chyp_rank as K
    from complexhyperbolickge_torch.kernels._ranker import TC_REL, near_threshold, score_interval
    from complexhyperbolickge_torch.kernels.hyp_rank import AttRHRanker, HypRanker

    out = {"phase": "bf16-kernels", "models": {}}
    work, errors, failed = {}, {}, []
    base = ("lhs2", "zn", "t2", "rhs", "wn", "bt")
    families = {"FFTRotH": ("chyp", model, dataset),
                **{m: (HYP_MODELS[m], *md) for m, md in hyp.items()}}
    for mname, (family, m, data) in families.items():
        dev = next(m.parameters()).device
        pack = data.eval_pack("test", "rhs")
        q = torch.as_tensor(pack.queries[:BATCH], dtype=torch.int64, device=dev)
        f = torch.as_tensor(pack.filter_idx[:BATCH], dtype=torch.int64, device=dev)
        xs, fns, ranker_ms = {}, {}, {}
        for prec in ("highest", "default"):
            r = (K.ChypRanker if family == "chyp" else
                 AttRHRanker if family == "attrh" else HypRanker)(m, precision=prec)
            xs[prec] = {**r.kernel_inputs(q, f, masked=False), **r.kernel_inputs(q, f)}
            if prec == "default":  # the default rankers' busy time a call
                for masked in (True, False):
                    rk = type(r)(m, masked=masked, precision=prec)
                    ranker_ms[masked] = busy_ms(lambda: rk(q, f))
            if family == "chyp":
                fns[prec] = {
                    "chyp_rank_sweep_masked": (partial(K.chyp_rank_counts, precision=prec),
                                               partial(K.chyp_rank_counts_plain, precision=prec),
                                               (*base, "mask")),
                    "chyp_rank_sweep_nomask": (partial(K.chyp_rank_sweep_nomask, precision=prec),
                                               partial(K.chyp_rank_sweep_nomask_plain,
                                                       precision=prec), (*base, "gold")),
                    "chyp_rank_filtered_sub": (partial(K.chyp_rank_filtered_sub, precision=prec),
                                               partial(K.chyp_rank_filtered_sub_plain,
                                                       precision=prec), (*base, "fidx", "gold"))}
            else:
                fns[prec] = hyp_family(family, prec)[2]
        x = xs["default"]
        if family == "chyp":
            maskless = K.chyp_rank_counts_nomask(*(x[k] for k in base), x["fidx"], x["gold"],
                                                 precision="default")
        else:
            maskless = hyp_family(family, "default")[3](x)
        near = near_threshold(*score_interval(family, x, TC_REL), x["t2"])
        res = {"family": family, "batch": BATCH, "Np": int(x["rhs"].shape[0]),
               "Dp": int(x["rhs"].shape[1]), "operands": str(x["rhs"].dtype),
               "max_near_threshold": int(near.max()), "kernels": {}}
        first = None
        for kname, (kernel, plain, args) in fns["default"].items():
            a = [x[k] for k in args]
            got, want = kernel(*a), plain(*a)
            torch.cuda.synchronize()
            first = got if first is None else first
            diff = (got - want).abs()
            name = f"{kname}_bf16"
            errors[(name, family)] = int(diff.max())
            ok = bool((diff <= near).all())
            res["kernels"][name] = {"max_abs_err": int(diff.max()),
                                    "queries_differing": int((diff > 0).sum()),
                                    "within_tolerance": ok}
            if not ok:
                failed.append(f"{mname} {name} disagrees with its plain default version")
            ek, _, eargs = fns["highest"][kname]
            ea = [xs["highest"][k] for k in eargs]
            work[(name, family)] = (partial(kernel, *a), partial(plain, *a), partial(ek, *ea), x,
                                    ranker_ms[kname.endswith("_masked")], m.cfg.n_entities,
                                    m.entity.shape[1])
        res["maskless_equals_masked"] = bool(torch.equal(first, maskless))
        if not res["maskless_equals_masked"]:
            failed.append(f"{mname}: bf16 maskless != masked on a batch whose golds are filtered")
        out["models"][mname] = res
    emit(out)
    if failed:
        raise AssertionError("; ".join(failed))
    return work, errors


def phase_bf16_bits(model, dataset, hyp: dict, seed: int):
    """The bits of the bf16 sweeps' epilogue (K1/K2 and K5-K8 bf16,
    branch-free with a range flag a pair) on the card: (i) its square root
    against __fsqrt_rn over every non-negative finite float32, (ii) its
    division against __fdiv_rn over BITS_QUOT_PAIRS pairs drawn across the
    epilogue's operand ranges and the edge cases
    (hyp_rank.fast_arith_sweep), (iii) each sweep's scores through the
    batched epilogue against score_from_radii's / chyp_score()'s for every
    pair of the FFTRotH (`model`), RotH, RotLH and AttRH runs' first test
    batch (B 500 x Np 40,960, every curvature of the run; chyp_scores_bf16,
    which also counts the pairs the fast path flagged, hyp_scores_bf16,
    attrh_scores_bf16).  Any differing bit fails the run."""
    import torch

    from complexhyperbolickge_torch.kernels import chyp_rank as K
    from complexhyperbolickge_torch.kernels import hyp_rank as H

    t0 = time.perf_counter()
    out = {"phase": "bf16-bits", **H.fast_arith_sweep(DEVICE, BITS_QUOT_PAIRS, seed)}
    out["arith_seconds"] = time.perf_counter() - t0
    out["families"] = {}
    for mname, family in {"FFTRotH": "chyp", **HYP_MODELS}.items():
        m, data = (model, dataset) if family == "chyp" else hyp[mname]
        pack = data.eval_pack("test", "rhs")
        q = torch.as_tensor(pack.queries[:BATCH], dtype=torch.int64, device=DEVICE)
        f = torch.as_tensor(pack.filter_idx[:BATCH], dtype=torch.int64, device=DEVICE)
        cls = {"chyp": K.ChypRanker, "attrh": H.AttRHRanker}.get(family, H.HypRanker)
        x = cls(m, masked=False, precision="default").kernel_inputs(q, f)
        res = {"model": mname}
        if family == "chyp":
            args = [x[k] for k in ("lhs2", "zn", "rhs", "wn", "bt")]
            (fast, res["flagged_pairs"]), (ieee, _) = (K.chyp_scores_bf16(*args),
                                                       K.chyp_scores_bf16(*args, ieee=True))
        else:
            args = [x[k] for k in HYP_SWEEP_ARGS["attrh" if family == "attrh" else "hyp"]
                    if k != "t2"]
            fn = (H.attrh_scores_bf16 if family == "attrh"
                  else partial(H.hyp_scores_bf16, family=family))
            fast, ieee = fn(*args), fn(*args, ieee=True)
            res["n_curvatures"] = int(x["cvals"].numel())
        torch.cuda.synchronize()
        out["families"][family] = {
            **res, "score_pairs": fast.numel(),
            "score_mismatches": int((fast.view(torch.int32) != ieee.view(torch.int32)).sum()),
            "scores_finite": bool(torch.isfinite(fast[:, :m.cfg.n_entities]).all())}
    emit(out)
    bad = {k: out[k] for k in ("sqrt_mismatches", "quot_mismatches") if out[k]}
    bad.update({f: r for f, r in out["families"].items()
                if r["score_mismatches"] or not r["scores_finite"]})
    if bad:
        raise AssertionError(f"the bf16 sweeps' epilogue bits differ from IEEE's: {bad}")


def dense_default_scores(gnn_dir: str, dataset) -> dict:
    """The dense default path's score region on one card batch: the
    CompGCN run's score_all inside eval_matmul_precision("default") is not
    highest's, and equals its definition (the distmult contraction of the
    bf16-rounded queries and encoded entities summed in float64, then the
    biases) within the float32 sum of D exact products and the float32
    bias adds."""
    import torch

    from complexhyperbolickge_torch.cli.run import build_model
    from complexhyperbolickge_torch.ops.math import eval_matmul_precision, round_bf16
    from complexhyperbolickge_torch.train.checkpoint import load_config, load_into

    model = build_model(argparse.Namespace(**load_config(gnn_dir)["args"]), dataset, DEVICE)
    load_into(model, gnn_dir)
    pack = dataset.eval_pack("test", "rhs")
    q = torch.as_tensor(pack.queries[:BATCH], dtype=torch.int64, device=DEVICE)
    with torch.no_grad():
        cache = model.cached_encode()
        highest = model.score_all(q, cache)
        with eval_matmul_precision("default"):
            got = model.score_all(q, cache)
        (lhs,), lhs_b = model.get_queries(q, cache)
        a, w = round_bf16(lhs).double(), round_bf16(cache[0]).double()
        bt = model.bt.double()
        want = model._apply_bias(a @ w.T, lhs_b.double(), bt, all_pairs=True)
        slack = ((a.abs() @ w.abs().T) * (a.shape[1] * 2.0 ** -24)
                 + 2.0 ** -22 * (lhs_b.double().abs() + bt[None, :, 0].abs() + want.abs()))
        err = (got.double() - want).abs()
    out = {"shape": list(got.shape), "max_abs_diff_vs_highest": float((got - highest).abs().max()),
           "max_abs_err_vs_definition": float(err.max()),
           "max_err_over_slack": float((err / slack).max())}
    out["ok"] = bool(not torch.equal(got, highest) and (err <= slack).all())
    return out


def phase_default_kge_test(runs: dict, gnn_dir: str, dataset):
    """kge-test with --eval_precision default (runs: name -> (dir, model,
    dataset)): each run with the masked fused ranker (auto) and the maskless
    one, and the dense CompGCN run, beside the same runs at highest: MRR
    (delta within 1e-3), whole-split queries/s of each default ranker
    (median of 3), and the default fused forms' ranks identical; and the
    dense CompGCN score region on one batch (dense_default_scores).
    Returns the path's launches, read before the highest runs."""
    import numpy as np
    import torch

    import complexhyperbolickge_torch.kernels as KS
    from complexhyperbolickge_torch.cli.test import test
    from complexhyperbolickge_torch.train.evaluate import get_ranking, make_best_ranker

    KS.reset_launches()  # the default path starts here
    out = {"phase": "default-kge-test", "runs": {}}
    dirs = {**{m: r[0] for m, r in runs.items()}, "CompGCN": gnn_dir}
    for name, d in dirs.items():
        for backend in ("auto", "pallas_maskless") if name in runs else ("dense",):
            t0 = time.perf_counter()
            m = test(d, device="cuda", eval_backend=backend, eval_precision="default")
            out["runs"][f"{name} {backend}"] = {"MRR": m["MRR"], "MR": m["MR"],
                                                "cli_seconds": time.perf_counter() - t0}
    launches = KS.launches()  # ... and ends here
    for name, d in dirs.items():
        for backend in ("auto", "pallas_maskless") if name in runs else ("dense",):
            r = out["runs"][f"{name} {backend}"]
            r["MRR_highest"] = test(d, device="cuda", eval_backend=backend)["MRR"]
            r["MRR_delta"] = r["MRR"] - r["MRR_highest"]
    for name, (_, model, dataset) in runs.items():
        packs = [dataset.eval_pack("test", d) for d in ("rhs", "lhs")]
        n_q = sum(len(p.queries) for p in packs)
        ranks = {}
        for backend in ("auto", "pallas_maskless"):
            rank_fn = make_best_ranker(model, BATCH, backend, precision="default")
            get_ranking(model, packs[0], BATCH, rank_fn=rank_fn)  # warm-up
            secs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ranks[backend] = [get_ranking(model, p, BATCH, rank_fn=rank_fn) for p in packs]
                secs.append(time.perf_counter() - t0)
            out["runs"][f"{name} {backend}"]["queries_per_s"] = n_q / sorted(secs)[1]
        out["runs"][f"{name} auto"]["fused_ranks_identical"] = all(
            np.array_equal(a, b) for a, b in zip(ranks["auto"], ranks["pallas_maskless"]))
    out["launches"] = {k: v for k, v in launches.items() if v}
    out["dense_scores"] = dense_default_scores(gnn_dir, dataset)
    emit(out)
    bad = {k: v for k, v in out["runs"].items()
           if not (np.isfinite(v["MRR"]) and 0.0 < v["MRR"] <= 1.0 and abs(v["MRR_delta"]) <= 1e-3
                   and v.get("fused_ranks_identical", True))}
    if bad:
        raise AssertionError(f"default-mode kge-test failed: {bad}")
    if not out["dense_scores"]["ok"]:
        raise AssertionError(f"the dense default scores are highest's or not the rounded-operand "
                             f"definition: {out['dense_scores']}")
    missing = [k for k in BF16_KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"bf16 instances that never launched on the default path: {missing}")
    return launches


def bf16_kernel_rows(work, launches, errors, smi, name):
    """The kernels line's rows of the bf16 instances, timed on the batches
    of phase_bf16_kernels beside their exact instances (exact_ms, same
    call).  Bound (bound_ms on bf16_row_work), at the model's own width
    and entity count (D features, N entities: the zero features padding a
    row to the mma k-step and the pad rows of the table are the kernel's,
    not the function's): the largest of the contraction on the tensor
    cores, the epilogue's EPILOGUE_OPS a pair on the fp32 cores (the exact
    rows' epilogue term; the radius tables hold part of it) and the bytes
    each input once; bound_term names the winner.  The epilogue's
    transcendental calls, divisions and square roots a pair beside it
    (SFU_PER_PAIR).  library_ms: torch.mm of the bf16 operands with a
    float32 output for the same (M x Dp) x (Dp x Np) contraction of the
    kernel's padded inputs, the contraction alone (no PyTorch call
    computes the count)."""
    import torch

    from complexhyperbolickge_torch.kernels import chyp_rank as K
    from complexhyperbolickge_torch.kernels import hyp_rank as H

    rows = []
    for (kname, family), (kernel, plain, exact, x, ranker_ms, n, d) in work.items():
        chyp = family == "chyp"
        lhs = x["lhs2"] if chyp else x["lhs"]
        m_rows, dp = lhs.shape
        np_ = x["rhs"].shape[0]
        b = m_rows // 2 if chyp else m_rows
        fidx, gold = x["fidx"].long(), x["gold"].long()
        kept = (fidx >= 0) & (fidx < n) & (fidx != gold[:, None])
        n_c = 0 if chyp else int(x["cvals"].numel())
        tc_ops, f32_ops, nbytes = bf16_row_work(
            kname, family, b, n, d, kept=int(kept.sum()),
            n_rows=int(torch.unique(fidx[kept]).numel()), l=int(fidx.shape[1]), n_c=n_c,
            table_width=0 if chyp else x["radii"].shape[-1])
        bound, bound_by, bound_term = bound_ms(peak_rates(name), nbytes, f32_ops,
                                               tc_ops=tc_ops)
        row = {"name": kname, "route": "cuda", "source": SOURCES["chyp_rank" if chyp else "hyp_rank"],
               "replaces": KERNEL_META[kname.removesuffix("_bf16")] + ' (precision="default")',
               "launches": launches[kname], "max_abs_err": errors[(kname, family)],
               "ms": cuda_ms(kernel, reps=50), "plain_ms": cuda_ms(plain),
               "bound_ms": bound, "bound_by": bound_by, "bound_term": bound_term,
               "library_ms": None, "card": smi, "family": family,
               "exact_ms": cuda_ms(exact, reps=50), "ranker_ms": ranker_ms,
               "epilogue_sfu_per_pair": SFU_PER_PAIR[family],
               "shape": {"M": m_rows, "N": n, "D": d, "Np": np_, "Dp": dp,
                         "L": int(fidx.shape[1])}}
        if "_sweep_" in kname:
            rhs_t = x["rhs"].T
            row["library_ms"] = cuda_ms(lambda: torch.mm(lhs, rhs_t, out_dtype=torch.float32),
                                        reps=50)
            row["library_call"] = "torch.mm(bf16, bf16, out_dtype=float32), contraction alone"
            info = (K.sweep_info(lhs.device, dp, masked=kname.endswith("masked_bf16"),
                                 precision="default") if chyp else
                    H.sweep_info(family, lhs.device, dp, masked=kname.endswith("masked_bf16"),
                                 precision="default"))
            row.update(info)
        rows.append(row)
    # the Lorentz instantiation of K5/K6's rows beside the Poincare one, as
    # in the exact rows
    lorentz = {r["name"]: r for r in rows if r["family"] == "lorentz"}
    rows = [r for r in rows if r["family"] != "lorentz"]
    for r in rows:
        if r["name"] in lorentz:
            r["lorentz"] = lorentz[r["name"]]
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
    the WN18RR-shape graph (E = 86,835 into N = 40,943) at H = 1, 32, 100, 200,
    forward and backward (against autograd of the plain versions), in
    float32 and in bfloat16 (gnn_bf16_checks); then the times of kernel,
    plain version and library call; then the relation table's gradient
    (relgrad_checks).  Returns the rows' measurements by (kernel, H) and
    (kernel, H, "bfloat16")."""
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
    out["relation_grad"] = relgrad_checks(model, seed, meas, failed)
    emit(out)
    if failed:
        raise AssertionError("K9/K10 or the relation gradient disagree with their plain "
                             "versions: " + "; ".join(failed))
    return meas


def relgrad_checks(model, seed: int, meas: dict, failed: list) -> dict:
    """The relation table's gradient (kernels/relgrad.py) over the first
    sorted half's etype (E = 86,835 into the 22 relation rows, the half's
    11 ids) at RELGRAD_WIDTHS in float32: against a float64 index_add_
    within the sum's rounding (each chunk's at most C rows in float32, at
    most C 2^-24 of their magnitudes' sum; one rounding, 2^-23 of the value
    taken), two calls bit for bit, the rows without ids 0; then the times of
    the kernels, the plain version and autograd's accumulate at the same
    shape (the library row).  Adds the measurements by ("relation_grad",
    W) to `meas` and what failed to `failed`; returns the checks."""
    import torch

    from complexhyperbolickge_torch.kernels import relgrad as R

    g = model.graph
    lay, ids, n_rel = g.rel_layouts[0], g.etype[:g.half], model.cfg.n_relations
    n_chunks = lay.chunks.shape[0]
    out = {"E": lay.num_rows, "rows": n_rel, "chunks": n_chunks, "chunk_rows": lay.chunk_rows,
           "widths": {}}
    for w in RELGRAD_WIDTHS:
        gr = torch.randn((lay.num_rows, w), device=DEVICE,
                         generator=torch.Generator(device=DEVICE).manual_seed(seed + w))
        got, again = R.relation_grad(gr, lay, n_rel), R.relation_grad(gr, lay, n_rel)
        want = torch.zeros((n_rel, w), dtype=torch.float64, device=DEVICE).index_add_(
            0, ids, gr.double())
        mags = torch.zeros_like(want).index_add_(0, ids, gr.double().abs())
        err = (got.double() - want).abs()
        res = {"max_abs_err_vs_float64": float(err.max()),
               "within_rounding": bool((err <= lay.chunk_rows * 2.0**-24 * mags
                                        + 2.0**-23 * want.abs()).all()),
               "bitwise_repeatable": bool(torch.equal(got, again)),
               "rows_without_ids_zero": not bool(got[lay.num_ids:].any())}
        out["widths"][w] = res
        if not all(v for v in res.values() if isinstance(v, bool)):
            failed.append(f"relation_grad W={w}: {res}")
        meas[("relation_grad", w)] = dict(
            max_abs_err=res["max_abs_err_vs_float64"],
            ms=cuda_ms(lambda: R.relation_grad(gr, lay, n_rel), reps=50),
            plain_ms=cuda_ms(lambda: R.relation_grad_plain(gr, lay, n_rel)),
            library_ms=cuda_ms(lambda: R.relation_grad_accumulate(gr, ids, (n_rel, w))),
            nbytes=4 * (lay.num_rows * (w + 1) + 3 * n_chunks + lay.num_ids + 1 + n_rel * w),
            ops=lay.num_rows * w,
            shape={"E": lay.num_rows, "rows": n_rel, "W": w, "chunks": n_chunks})
    return out


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
    """Swap K9's and K10's plain versions in for the kernels, and autograd's
    accumulate in for the relation gradient's kernels; returns the function
    that swaps the kernels back."""
    from complexhyperbolickge_torch.kernels import gather as G
    from complexhyperbolickge_torch.kernels import relgrad as R
    from complexhyperbolickge_torch.kernels import segsum as S

    real = (S.sorted_segment_sum, G.row_gather, R.use_kernel)
    S.sorted_segment_sum, G.row_gather = S.sorted_segment_sum_plain, G.row_gather_plain
    R.use_kernel = lambda table, layout: False

    def restore():
        S.sorted_segment_sum, G.row_gather, R.use_kernel = real

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
    same negatives, once through K9/K10 and the relation gradient's kernels
    and once with the plain versions and autograd's accumulate.
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
            counts = {k: KS.launches()[k] for k in (*GNN_KERNELS, "relation_grad")}
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


# ----------------------------- the subgraph path --------------------------------


def subgraph_trainer(seed: int, dataset, name: str = "CompGCN", config=None, **over):
    """A SubgraphTrainer at the subgraph path's width on a fresh `name` on
    the card (config: SUBGRAPH_CONFIG's overrides; over: the model's)."""
    from complexhyperbolickge_torch.train.subgraph import SubgraphTrainer
    from complexhyperbolickge_torch.train.trainer import TrainConfig

    model = gnn_model(seed, name, dataset, **{**SUBGRAPH_ARGS, **over})
    return SubgraphTrainer(model, TrainConfig(**{**SUBGRAPH_CONFIG, **(config or {})}),
                           dataset)


def phase_subgraph_train(seed: int, dataset):
    """subgraph-train: cli.run.train --subgraph at the published subgraph
    configuration, 2 epochs (validation and the final test on the full
    graph, through K9/K10 and the dense ranker): the sampler backend must be
    the C++ one, an epoch 348 steps, the loss finite and falling.  Then a
    PROFILE_STEPS window of the same trainer (3 warm-up steps first):
    device busy ms, idle share and launches a step, and the peak device
    memory of subgraph training alone.  Returns the phase's line."""
    import numpy as np
    import torch

    import complexhyperbolickge_torch.kernels as KS

    torch.cuda.reset_peak_memory_stats()
    history = phase_train(seed, SUBGRAPH_TRAIN_FLAGS, label="subgraph-train")
    run_peak = torch.cuda.max_memory_allocated()
    trainer = subgraph_trainer(seed, dataset)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    trainer.run_epoch(BATCH, np.random.default_rng(seed), gen, max_steps=3)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = KS.launches()
    prof = profile_window(lambda: trainer.run_epoch(
        BATCH, np.random.default_rng(seed + 1), gen, epoch_id=1, max_steps=PROFILE_STEPS))
    busy = prof["device_busy_ms"]
    e2 = dict(history[1], ms_per_step=1e3 * history[1]["seconds"] / history[1]["steps"])
    out = {"phase": "subgraph-train-window", "sampler_backend": trainer.sampler.backend,
           "steps_per_epoch": [h["steps"] for h in history],
           "train_loss": [h["train_loss"] for h in history],
           "epoch2_triples_per_s": e2["triples_per_s"], "epoch2_ms_per_step": e2["ms_per_step"],
           "peak_memory_gb_run": run_peak / 1e9,
           "peak_memory_gb_window": torch.cuda.max_memory_allocated() / 1e9,
           "window_steps": PROFILE_STEPS,
           "window_wall_ms_per_step": prof["wall_ms"] / PROFILE_STEPS,
           "window_device_busy_ms_per_step": (busy / PROFILE_STEPS if isinstance(busy, float)
                                              else busy),
           "window_device_idle_share": prof["device_idle_share"],
           "window_kernels_per_step": prof["device_kernels"] / PROFILE_STEPS,
           "window_k9_k10_launches": {k: KS.launches()[k] - before[k] for k in GNN_KERNELS},
           "window_top_kernels_ms": prof["top_kernels_ms"],
           "window_top_host_ops_self_ms": prof["top_host_ops_self_ms"]}
    emit(out)
    if (out["sampler_backend"] != "cpp" or out["steps_per_epoch"] != [SUBGRAPH_STEPS] * 2
            or not isinstance(busy, float)):
        raise AssertionError(f"subgraph training did not run as configured: {out}")
    return out


def phase_subgraph_bce(seed: int, dataset):
    """subgraph-bce: 2 x SUBGRAPH_BCE_WINDOW steps of the subgraph path's
    model through SubgraphTrainer with BCE, label smoothing 0.1 and
    update_steps 2: each window's mean loss finite, the second below the
    first."""
    import numpy as np
    import torch

    trainer = subgraph_trainer(seed, dataset, config=dict(
        loss="binarycrossentropy", smoothing=0.1, update_steps=2))
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    t0 = time.perf_counter()
    losses = [trainer.run_epoch(BATCH, np.random.default_rng([seed, e]), gen, epoch_id=e,
                                max_steps=SUBGRAPH_BCE_WINDOW) for e in (0, 1)]
    out = {"phase": "subgraph-bce", "steps": 2 * SUBGRAPH_BCE_WINDOW, "update_steps": 2,
           "window_mean_loss": losses, "seconds": time.perf_counter() - t0}
    emit(out)
    if not (np.isfinite(losses).all() and losses[1] < losses[0]):
        raise AssertionError(f"the subgraph BCE loss is not finite and falling: {out}")


def subgraph_step_errors(card, cpu, prepped, params: dict) -> dict:
    """One subgraph step (loss and gradients) of the same batch from the
    same params (float64 tensors by name) on the card in float32 and on the
    CPU in float64: the loss's relative error and each gradient's max
    error over its largest entry (floored at 1e-2 of the largest entry of
    all gradients, as phase_ce_step_parity)."""
    import torch

    res = {}
    for t in (card, cpu):
        p0 = next(t.model.parameters())
        t.model.load_state_dict({k: v.to(p0.device, p0.dtype) for k, v in params.items()})
        t.model.zero_grad(set_to_none=True)
        loss = t._loss(*t._to_device(t._host_tensors(prepped)))
        loss.backward()
        res[t is card] = (loss.item(), {k: torch.zeros(p.shape, dtype=torch.float64)
                                        if p.grad is None else p.grad.double().cpu()
                                        for k, p in t.model.named_parameters()})
    (l32, g32), (l64, g64) = res[True], res[False]
    floor = 1e-2 * max(float(g.abs().max()) for g in g64.values())
    grad_rel = {k: float((g32[k] - g).abs().max()) / max(float(g.abs().max()), floor)
                for k, g in g64.items()}
    return {"loss_f32_card": l32, "loss_f64_cpu": l64, "loss_rel_err": abs(l32 - l64) / abs(l64),
            "max_grad_rel_err": max(grad_rel.values()),
            "worst_grads": dict(sorted(grad_rel.items(), key=lambda kv: -kv[1])[:4])}


def phase_subgraph_step_parity(seed: int, dataset):
    """subgraph-step-parity: one subgraph step (the CE loss and its
    gradients) of CompGCN and of PoincareGCN (method 1) at the subgraph
    path's width, dropout 0, on one sampled subgraph: on the card in
    float32 against the same params and batch on the CPU in float64, held
    to CE_PARITY_TOL.  CompGCN is held at its init.  PoincareGCN's init puts
    its relation stream at the edge of the ball (the layers' w_rel map the
    relation tables to points whose expmap0 is within ~1e-5 of the
    boundary, where float32 keeps ~2 of its digits: a CPU probe gave loss
    1e-5 and gradients 8e-4 at hidden 32), so it is held with the layers'
    w_rel scaled by 0.1, well inside the ball; its errors at init are
    reported beside them, as phase_ce_step_parity holds FFTRotH inside the
    ball."""
    import numpy as np
    import torch

    from complexhyperbolickge_torch.cli.run import build_model

    out = {"phase": "subgraph-step parity", "batch": BATCH, "tolerance": CE_PARITY_TOL,
           "allow_tf32": torch.backends.cuda.matmul.allow_tf32, "models": {}}
    failed = []
    for name in ("CompGCN", "PoincareGCN"):
        card = subgraph_trainer(seed, dataset, name, edge_dropout=0.0, dropout=0.0)
        ns = argparse.Namespace(**{**gnn_args(seed, name), **SUBGRAPH_ARGS, "edge_dropout": 0.0,
                                   "dropout": 0.0, "dtype": "float64"})
        cpu = type(card)(build_model(ns, dataset, "cpu"), card.cfg, dataset)
        sub = next(card.sampler.epoch(BATCH, np.random.default_rng(seed), seed_base=0))
        prepped = card._prep_host(sub)
        init = {k: v.double().cpu() for k, v in card.model.state_dict().items()}
        held = init
        r = {"n_nodes": sub.n_nodes, "n_edges": sub.n_edges, "overflow": sub.overflow}
        if name == "PoincareGCN":
            r["at_init_not_held"] = subgraph_step_errors(card, cpu, prepped, init)
            held = {k: v * 0.1 if ".w_rel." in k else v for k, v in init.items()}
            r["held_at"] = "the layers' w_rel scaled by 0.1"
        r.update(subgraph_step_errors(card, cpu, prepped, held))
        out["models"][name] = r
        if not (np.isfinite(r["loss_f32_card"]) and r["loss_rel_err"] <= CE_PARITY_TOL["loss_rel"]
                and r["max_grad_rel_err"] <= CE_PARITY_TOL["grad_rel"]):
            failed.append(name)
        del card, cpu
    emit(out)
    if failed or out["allow_tf32"]:
        raise AssertionError(f"the card's subgraph step disagrees with float64: {failed}")


def phase_export_import(model_dir: str, dataset):
    """export-import: cli.export of the FFT run dir (every array equal to
    the checkpoint's, the config embedded); a reference-style run dir
    (config.json with `sizes`, model.pt of <param>.weight tables) made of
    that run's weights through cli.import_ref; kge-test of the imported dir
    gives the source dir's MRR."""
    import json

    import numpy as np
    import torch

    from complexhyperbolickge_torch.cli.export import export
    from complexhyperbolickge_torch.cli.import_ref import import_reference
    from complexhyperbolickge_torch.cli.test import test
    from complexhyperbolickge_torch.train.checkpoint import flatten, load_checkpoint

    st = load_checkpoint(model_dir)
    params = flatten(st["params"])
    path = export(model_dir, str(WORK / "export" / "embeddings"))
    with np.load(path) as z:
        exported_equal = (sorted(z.keys()) == sorted([*params, "__config__"])
                          and all(np.array_equal(z[k], v) and z[k].dtype == v.dtype
                                  for k, v in params.items())
                          and json.loads(z["__config__"].tobytes()) == st["config"]["args"])
    ref = WORK / "reference-run"
    ref.mkdir(parents=True, exist_ok=True)
    torch.save({f"{k}.weight": torch.from_numpy(np.array(v)) for k, v in params.items()},
               ref / "model.pt")
    (ref / "config.json").write_text(json.dumps(
        {**st["config"]["args"], "sizes": list(dataset.get_shape())}))
    imported = WORK / "imported"
    import_reference(str(ref), str(imported))
    src, dst = test(model_dir, device="cuda"), test(str(imported), device="cuda")
    out = {"phase": "export-import", "npz": path, "arrays": len(params),
           "exported_equal_checkpoint": exported_equal, "source_mrr": src["MRR"],
           "imported_mrr": dst["MRR"], "imported_metrics_equal": src == dst}
    emit(out)
    if not (exported_equal and src == dst and 0.0 < src["MRR"] <= 1.0):
        raise AssertionError(f"export or import changed the model: {out}")


def gnn_kernel_rows(meas, launches, smi, name):
    """The kernels line's K9 and K10 rows at the encoder's hidden width (H =
    200), with the H = 1 and H = 32 measurements beside them, and the
    relation gradient's row at W = 100 with W = 200 beside it.  Bound:
    bytes, each input read once (msgs, row_ptr; the table, ids; g, perm, the
    chunk table and chunk_ptr) and the output written once, K10's table as
    the distinct rows its ids fetch; K9's E H and the relation gradient's E
    W fp32 additions as operations."""
    def bounded(m):
        m = dict(m)
        bound, bound_by, _ = bound_ms(peak_rates(name), m.pop("nbytes"), m.pop("ops"))
        return {**m, "bound_ms": bound, "bound_by": bound_by}

    rows = []
    for kname in GNN_KERNELS:
        by_h = {h: bounded(meas[(kname, h)]) for h in GNN_WIDTHS}
        bf16 = {h: bounded(meas[(kname, h, "bfloat16")]) for h in GNN_WIDTHS}
        main = by_h[GNN_WIDTHS[-1]]
        rows.append({"name": kname, "route": "cuda", "source": SOURCES[kname],
                     "replaces": KERNEL_META[kname], "launches": launches[kname], **main,
                     "library": ("torch.segment_reduce" if kname == "sorted_segment_sum"
                                 else "torch.index_select"),
                     "card": smi, "other_widths": {h: by_h[h] for h in GNN_WIDTHS[:-1]},
                     "bfloat16": bf16})
    by_w = {w: bounded(meas[("relation_grad", w)]) for w in RELGRAD_WIDTHS}
    rows.append({"name": "relation_grad", "route": "cuda", "source": SOURCES["relation_grad"],
                 "replaces": KERNEL_META["relation_grad"], "launches": launches["relation_grad"],
                 **by_w[RELGRAD_WIDTHS[0]],
                 "library": "autograd's accumulate (_index_put_impl_)",
                 "card": smi, "other_widths": {w: by_w[w] for w in RELGRAD_WIDTHS[1:]}})
    return rows


# the parallel/ path: two ranks on the one card (gloo: NCCL refuses two
# ranks on one device), a model axis of 2 for ranking and 1x2 training, a
# data axis of 2 for the CLI run and the 2x1 steps
MESH_RANK_CASES = (("FFTRotH", "auto", "highest"), ("FFTRotH", "pallas_maskless", "highest"),
                   ("FFTRotH", "auto", "default"), ("FFTRotH", "pallas_maskless", "default"),
                   ("RotH", "auto", "highest"),
                   ("RotH", "pallas_maskless", "highest"), ("AttRH", "auto", "highest"),
                   ("AttRH", "pallas_maskless", "highest"))
# the kernels each rank must launch in mesh-rank (every K1/K2, K5/K6, K7/K8
# wrapper and K1/K2's bf16 instances) and in the data-parallel steps (K3/K4)
MESH_RANK_KERNELS = (*RANK_KERNELS, *HYP_RANK_KERNELS, *ATTRH_KERNELS,
                     *(f"{k}_bf16" for k in RANK_KERNELS))
MESH_TRAIN_KERNELS = (*TRAIN_KERNELS, "chyp_train_lists")
MESH_STEPS = 3  # the mesh parity windows, as train-step parity's
MESH_TIMEOUT = 600  # seconds for the two ranks' whole run
ALLREDUCE_REPS = 20
# mesh-subgraph-parity: SGD, as the JAX package's mesh subgraph tests: the
# CE loss does not move with a query's bh, so bh's gradient is rounding
# noise, which Adam turns into lr-sized steps that differ between any two
# runs; then a timed window of steps (ms, collective bytes, peak memory)
MESH_SUBGRAPH_OPT = dict(optimizer="SGD", learning_rate=0.1)
MESH_SUBGRAPH_WINDOW = 20


def mesh_steps(seed: int, mesh=None):
    """MESH_STEPS Adam steps of FFTRotH at the paper config (lr 3e-4, 100
    negatives drawn by the trainer from one seeded generator) on
    MESH_STEPS random batches of BATCH, on `mesh` or in one process: the
    params after them (canonical, numpy), the mean loss and the launches."""
    import numpy as np
    import torch

    import complexhyperbolickge_torch.kernels as KS
    from complexhyperbolickge_torch.parallel import gather_entity_tree
    from complexhyperbolickge_torch.train.trainer import TrainConfig, Trainer

    model = wn18rr_model(seed)
    n_ent, n_rel = model.cfg.n_entities, model.cfg.n_relations
    rng = np.random.default_rng(seed)
    shape = (MESH_STEPS, BATCH)
    batches = np.stack([rng.integers(0, n_ent, shape), rng.integers(0, n_rel, shape),
                        rng.integers(0, n_ent, shape)], axis=-1).astype(np.int32)
    trainer = Trainer(model, TrainConfig(**TRAIN_CONFIGS["FFTRotH"]), n_ent, n_rel, mesh=mesh)
    KS.reset_launches()
    loss = trainer.run_epoch(batches, np.ones(shape, np.float32),
                             torch.Generator(device=DEVICE).manual_seed(seed))
    torch.cuda.synchronize()
    launches = {k: KS.launches()[k] for k in MESH_TRAIN_KERNELS}
    params = model.state_dict()
    if trainer.sharded:
        params = gather_entity_tree(params, n_ent, mesh)
    return {k: v.detach().cpu().numpy() for k, v in params.items()}, loss, launches


class CollectiveBytes:
    """While active: the calls to torch.distributed's all_reduce, all_gather
    and broadcast, and the bytes of the tensors handed to them."""

    NAMES = ("all_reduce", "all_gather", "broadcast")

    def __enter__(self):
        import torch.distributed as dist

        self.calls, self.bytes, self._saved = 0, 0, {}
        for name in self.NAMES:
            f = self._saved[name] = getattr(dist, name)

            def wrapped(*args, _f=f, **kw):
                self.calls += 1
                self.bytes += sum(t.numel() * t.element_size() for a in args
                                  for t in (a if isinstance(a, (list, tuple)) else [a])
                                  if hasattr(t, "element_size"))
                return _f(*args, **kw)

            setattr(dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, f in self._saved.items():
            setattr(dist, name, f)


def mesh_subgraph_steps(seed: int, mesh=None):
    """The subgraph path's CompGCN (dropouts 0.1 on) through SubgraphTrainer
    on `mesh` or in one process: MESH_STEPS steps with MESH_SUBGRAPH_OPT
    from the seed's init, then a timed window of MESH_SUBGRAPH_WINDOW
    steps.  Returns the params after the first steps (canonical, numpy),
    their mean loss, and the window's wall ms a step, collective calls and
    bytes a step, and peak device memory (absolute and above its start)."""
    import numpy as np
    import torch

    from complexhyperbolickge_torch.cli.run import load_dataset
    from complexhyperbolickge_torch.parallel import gather_entity_tree
    from complexhyperbolickge_torch.train.subgraph import SubgraphTrainer
    from complexhyperbolickge_torch.train.trainer import TrainConfig

    dataset = load_dataset(argparse.Namespace(**gnn_args(seed, "CompGCN")))
    model = gnn_model(seed, "CompGCN", dataset, **SUBGRAPH_ARGS)
    trainer = SubgraphTrainer(model, TrainConfig(**{**SUBGRAPH_CONFIG, **MESH_SUBGRAPH_OPT}),
                              dataset, mesh=mesh)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    loss = trainer.run_epoch(BATCH, np.random.default_rng(seed), gen, max_steps=MESH_STEPS)
    params = model.state_dict()
    if mesh is not None and mesh.n_model > 1:
        params = gather_entity_tree(params, model.cfg.n_entities, mesh)
    params = {k: v.detach().cpu().numpy().copy() for k, v in params.items()}
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with CollectiveBytes() as coll:
        trainer.run_epoch(BATCH, np.random.default_rng(seed + 1), gen, epoch_id=1,
                          max_steps=MESH_SUBGRAPH_WINDOW)
        torch.cuda.synchronize()
    window = {"steps": MESH_SUBGRAPH_WINDOW,
              "wall_ms_per_step": 1e3 * (time.perf_counter() - t0) / MESH_SUBGRAPH_WINDOW,
              "collective_calls_per_step": coll.calls / MESH_SUBGRAPH_WINDOW,
              "collective_bytes_per_step": coll.bytes / MESH_SUBGRAPH_WINDOW,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "peak_memory_gb_above_start": (torch.cuda.max_memory_allocated() - start) / 1e9,
              "rows_a_rank": int(model.entity.shape[0])}
    return params, loss, window


def mesh_rank_job(mesh, dirs: dict) -> dict:
    """Each MESH_RANK_CASES ranker of this rank's shard over the whole test
    split (both directions): ranks, launches and seconds."""
    import torch

    import complexhyperbolickge_torch.kernels as KS
    from complexhyperbolickge_torch.cli.predict import load_serving_state
    from complexhyperbolickge_torch.parallel import make_best_sharded_ranker, shard_model_
    from complexhyperbolickge_torch.train.evaluate import get_ranking

    out, loaded = {}, {}
    for name, backend, precision in MESH_RANK_CASES:
        if name not in loaded:
            model, dataset = load_serving_state(dirs[name], "cuda")
            shard_model_(model, mesh.m, mesh.n_model)
            loaded[name] = model, dataset
        model, dataset = loaded[name]
        ranker = make_best_sharded_ranker(model, mesh, model.cfg.n_entities, backend, precision)
        packs = [dataset.eval_pack("test", d) for d in ("rhs", "lhs")]
        get_ranking(model, packs[0], BATCH, ranker)  # warm-up
        KS.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ranks = [get_ranking(model, p, BATCH, ranker) for p in packs]
        secs = time.perf_counter() - t0
        out[f"{name} {backend} {precision}"] = {
            "ranks": ranks, "seconds": secs, "rows": int(model.entity.shape[0]),
            "launches": {k: v for k, v in KS.launches().items() if v}}
    return out


def allreduce_ms(mesh, numel: int) -> dict:
    """The data group's all_reduce of a float32 CUDA tensor of `numel`
    (a 2x1 step's flat gradient), staged through the host by gloo: median
    and min-max ms of ALLREDUCE_REPS host-timed calls; and whether gloo
    takes reduce_scatter on CUDA tensors (the port's gathers do not need
    it)."""
    import torch
    import torch.distributed as dist

    t = torch.ones(numel, device=DEVICE)
    mesh.sum_data(t)
    ms = []
    for _ in range(ALLREDUCE_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh.sum_data(t)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    ms.sort()
    probe = torch.empty(4, device=DEVICE)
    try:
        dist.reduce_scatter(probe, [torch.ones(4, device=DEVICE)] * 2, group=mesh.data_group)
        reduce_scatter = True
    except (RuntimeError, ValueError) as e:  # a report, not a phase failure
        reduce_scatter = f"{type(e).__name__}: {str(e)[:160]}"
    return {"bytes": 4 * numel, "ms_median": ms[len(ms) // 2], "ms_min_max": [ms[0], ms[-1]],
            "gloo_reduce_scatter_cuda": reduce_scatter}


def _mesh_worker(rank: int, seed: int, ports, dirs: dict, out_dir: str):
    """One of the two ranks on the card: the CLI's rank entry point
    (cli.run.run_rank, as `kge-train --mesh 2x1` starts it) for EPOCHS
    epochs at the paper config; then, in a second gloo group, mesh-rank
    (a 1x2 mesh), the 2x1 and 1x2 parity steps, the all_reduce's time and
    the subgraph steps on 2x1 and 1x2; then the rank entry point again for
    one epoch of `kge-train --subgraph --mesh 2x1` at the subgraph config.
    Writes its results to out_dir/rank<r>.pkl."""
    import pickle

    import torch
    import torch.distributed as dist

    import complexhyperbolickge_torch.kernels as KS
    from complexhyperbolickge_torch.cli import run as R
    from complexhyperbolickge_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    out = {}
    argv = ["--dataset", "synthetic",
            *[str(x) for k, v in WN18RR.items() for x in (f"--{k}", v)], *TRAIN_FLAGS,
            "--max_epochs", str(EPOCHS), "--valid", "1", "--eval_batch_size", str(BATCH),
            "--device", "cuda", "--seed", str(seed), "--save_dir", str(WORK / "mesh-train"),
            "--mesh", "2x1"]
    KS.reset_launches()  # the data-parallel training path starts here
    t0 = time.perf_counter()
    res = R.run_rank(R.build_parser().parse_args(argv), (2, 1), 2, rank,
                     f"127.0.0.1:{ports[0]}", (rank, 2))
    out["cli"] = {"argv": argv, "seconds": time.perf_counter() - t0, "history": res["history"],
                  "test": res["test"], "valid": res["valid"],
                  "launches": {k: v for k, v in KS.launches().items() if v}}  # ... ends here
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{ports[1]}", world_size=2,
                            rank=rank)
    try:
        dev = torch.device("cuda", 0)
        mesh12, mesh21 = make_mesh((1, 2), dev), make_mesh((2, 1), dev)
        out["rank"] = mesh_rank_job(mesh12, dirs)  # resets and reads the counts per case
        out["steps_2x1"] = mesh_steps(seed, mesh21)
        out["steps_1x2"] = mesh_steps(seed, mesh12)
        numel = sum(p.numel() for p in wn18rr_model(seed).parameters())
        out["allreduce"] = allreduce_ms(mesh21, numel)
        out["subgraph_2x1"] = mesh_subgraph_steps(seed, mesh21)
        out["subgraph_1x2"] = mesh_subgraph_steps(seed, mesh12)
    finally:
        dist.destroy_process_group()
    argv = ["--dataset", "synthetic",
            *[str(x) for k, v in WN18RR.items() for x in (f"--{k}", v)], *SUBGRAPH_TRAIN_FLAGS,
            "--max_epochs", "1", "--valid", "1", "--eval_batch_size", str(BATCH),
            "--device", "cuda", "--seed", str(seed), "--save_dir",
            str(WORK / "mesh-subgraph-train"), "--mesh", "2x1"]
    KS.reset_launches()  # the mesh subgraph path starts here
    t0 = time.perf_counter()
    res = R.run_rank(R.build_parser().parse_args(argv), (2, 1), 2, rank,
                     f"127.0.0.1:{ports[2]}", (rank, 2))
    out["subgraph_cli"] = {"argv": argv, "seconds": time.perf_counter() - t0,
                           "history": res["history"], "test": res["test"],
                           "launches": {k: v for k, v in KS.launches().items() if v}}  # ... ends
    (Path(out_dir) / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))


def _params_close(got: dict, want: dict) -> dict:
    import numpy as np

    return {k: {"max_abs_diff": float(np.abs(got[k] - v).max()),
                "within_tolerance": bool(np.allclose(got[k], v, **PARITY_TOL))}
            for k, v in want.items()}


def phase_mesh(seed: int, dirs: dict, loaded: dict) -> dict:
    """mesh-rank, mesh-train and mesh-1x2-train: two ranks spawned on the
    card (_mesh_worker), held against this process: the sharded rankers'
    ranks against the single-device fused rankers' (equal), the ranks'
    params after MESH_STEPS steps against one process's (PARITY_TOL: the
    all_reduce adds K4's two entity-gradient halves in another order).
    Then mesh-subgraph-parity and mesh-subgraph-train (the subgraph steps
    on 2x1 and 1x2 against one process's, PARITY_TOL; one epoch of
    `kge-train --subgraph --mesh 2x1`: K9/K10 in each rank's full-graph
    validation and test, the C++ sampler, a finite loss).  Returns each
    rank's launches on the mesh paths, by kernel."""
    import pickle

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from complexhyperbolickge_torch.cli.run import free_port
    from complexhyperbolickge_torch.train.evaluate import get_ranking, make_best_ranker

    ref = {}
    for name, backend, precision in MESH_RANK_CASES:
        model, dataset = loaded[name]
        ranker = make_best_ranker(model, BATCH, backend, precision=precision)
        ref[f"{name} {backend} {precision}"] = [
            get_ranking(model, dataset.eval_pack("test", d), BATCH, ranker) for d in ("rhs", "lhs")]
    ref_steps = mesh_steps(seed)
    ref_subgraph = mesh_subgraph_steps(seed)

    out_dir = WORK / "mesh"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    ctx = mp.start_processes(_mesh_worker, args=(seed, (free_port(), free_port(), free_port()),
                                                 dirs, str(out_dir)),
                             nprocs=2, join=False, start_method="spawn")
    while not ctx.join(timeout=1.0):
        if time.perf_counter() - t0 > MESH_TIMEOUT:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"the two mesh ranks did not finish in {MESH_TIMEOUT} s")
    secs = time.perf_counter() - t0
    res = [pickle.loads((out_dir / f"rank{r}.pkl").read_bytes()) for r in range(2)]

    # mesh-rank
    cases, launches = {}, [{}, {}]
    for key, want in ref.items():
        diff = max(float(np.abs(g - w).max()) for r in res
                   for g, w in zip(r["rank"][key]["ranks"], want))
        cases[key] = {"max_abs_rank_diff_vs_single_process": diff,
                      "rows_per_shard": [r["rank"][key]["rows"] for r in res],
                      "seconds_per_rank": [r["rank"][key]["seconds"] for r in res],
                      "launches_per_rank": [r["rank"][key]["launches"] for r in res]}
        for i, r in enumerate(res):
            for k, v in r["rank"][key]["launches"].items():
                launches[i][k] = launches[i].get(k, 0) + v
    n_q = sum(len(x) for x in next(iter(ref.values())))
    emit({"phase": "mesh-rank", "mesh": "1x2", "backend": "gloo, two ranks on one card",
          "queries": n_q, "cases": cases,
          "launches_per_rank": [{k: v[k] for k in MESH_RANK_KERNELS if k in v} for v in launches]})
    bad = {k: c["max_abs_rank_diff_vs_single_process"] for k, c in cases.items()
           if c["max_abs_rank_diff_vs_single_process"] != 0.0}
    idle = [(i, k) for i, v in enumerate(launches) for k in MESH_RANK_KERNELS if not v.get(k)]
    if bad or idle:
        raise AssertionError(f"sharded ranks differ from one process's {bad}, or kernels a rank "
                             f"never launched {idle}")

    # mesh-train: the CLI run, the 2x1 steps, the all_reduce
    cli = [r["cli"] for r in res]
    steps = sum(h["steps"] for h in cli[0]["history"])
    epochs = [dict(h, ms_per_step=1e3 * h["seconds"] / h["steps"]) for h in cli[0]["history"]]
    p21, loss21, l21 = res[0]["steps_2x1"]
    close21 = _params_close(p21, ref_steps[0])
    train_launches = [{k: c["launches"].get(k, 0) for k in (*MESH_TRAIN_KERNELS,
                                                            "chyp_rank_sweep_masked")}
                      for c in cli]
    out = {"phase": "mesh-train", "mesh": "2x1", "backend": "gloo, two ranks on one card "
           "(correctness and overhead, not a multi-GPU number)", "argv": cli[0]["argv"],
           "epochs": epochs, "train_steps": steps, "seconds_per_rank": [c["seconds"] for c in cli],
           "test": cli[0]["test"], "launches_per_rank": train_launches,
           "parity": {"steps": MESH_STEPS, "tolerance": PARITY_TOL, "loss": [loss21, ref_steps[1]],
                      "launches_per_rank": [r["steps_2x1"][2] for r in res], "params": close21},
           "allreduce_per_step": res[0]["allreduce"], "spawned_seconds": secs}
    emit(out)
    losses = [h["train_loss"] for h in cli[0]["history"]]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the 2x1 training loss is not finite and falling: {losses}")
    if any(min(v[k] for k in MESH_TRAIN_KERNELS) < steps or not v["chyp_rank_sweep_masked"]
           for v in train_launches):
        raise AssertionError(f"K3/K4 launched fewer times than the {steps} steps on a rank, "
                             f"or K1 never: {train_launches}")
    if not all(c["within_tolerance"] for c in close21.values()) or any(
            min(r["steps_2x1"][2].values()) < MESH_STEPS for r in res):
        raise AssertionError(f"2x1 steps disagree with one process: {out['parity']}")

    # mesh-1x2-train
    p12, loss12, _ = res[0]["steps_1x2"]
    close12 = _params_close(p12, ref_steps[0])
    same = all(np.array_equal(res[1]["steps_1x2"][0][k], v) for k, v in p12.items())
    emit({"phase": "mesh-1x2-train", "mesh": "1x2", "steps": MESH_STEPS,
          "tolerance": PARITY_TOL, "loss": [loss12, ref_steps[1]],
          "launches_per_rank": [r["steps_1x2"][2] for r in res], "params": close12,
          "ranks_hold_one_model": same})
    if not (same and all(c["within_tolerance"] for c in close12.values())) or any(
            min(r["steps_1x2"][2].values()) < MESH_STEPS for r in res):
        raise AssertionError("1x2 steps disagree with one process")

    # mesh-subgraph-parity: the subgraph steps on 2x1 and 1x2
    sub = {"phase": "mesh-subgraph-parity", "steps": MESH_STEPS, "optimizer": MESH_SUBGRAPH_OPT,
           "tolerance": PARITY_TOL, "one_process": {"loss": ref_subgraph[1],
                                                    "window": ref_subgraph[2]}}
    bad = []
    for shape in ("2x1", "1x2"):
        close = _params_close(res[0][f"subgraph_{shape}"][0], ref_subgraph[0])
        same = all(np.array_equal(res[1][f"subgraph_{shape}"][0][k], v)
                   for k, v in res[0][f"subgraph_{shape}"][0].items())
        sub[shape] = {"loss": [r[f"subgraph_{shape}"][1] for r in res],
                      "max_abs_diff": max(c["max_abs_diff"] for c in close.values()),
                      "worst": dict(sorted(((k, c["max_abs_diff"]) for k, c in close.items()),
                                           key=lambda kv: -kv[1])[:3]),
                      "ranks_hold_one_model": same,
                      "window_per_rank": [r[f"subgraph_{shape}"][2] for r in res]}
        if not (same and all(c["within_tolerance"] for c in close.values())):
            bad.append(shape)
    emit(sub)
    if bad:
        raise AssertionError(f"mesh subgraph steps disagree with one process: {bad}")

    # mesh-subgraph-train: kge-train --subgraph --mesh 2x1, one epoch
    cli = [r["subgraph_cli"] for r in res]
    hist = cli[0]["history"][0]
    log = (WORK / "mesh-subgraph-train" / "train.log").read_text()
    sub_launches = [{k: c["launches"].get(k, 0) for k in GNN_KERNELS} for c in cli]
    out = {"phase": "mesh-subgraph-train", "mesh": "2x1", "backend": "gloo, two ranks on one "
           "card (correctness and overhead, not a multi-GPU number)", "argv": cli[0]["argv"],
           "steps": hist["steps"], "train_loss": hist["train_loss"],
           "ms_per_step": 1e3 * hist["seconds"] / hist["steps"],
           "triples_per_s": hist["triples_per_s"], "seconds_per_rank": [c["seconds"] for c in cli],
           "cpp_sampler": f"Subgraph training: cpp sampler, {SUBGRAPH_STEPS} steps an epoch" in log,
           "test": cli[0]["test"], "launches_per_rank": sub_launches}
    emit(out)
    if not (out["cpp_sampler"] and hist["steps"] == SUBGRAPH_STEPS
            and np.isfinite(hist["train_loss"]) and all(min(v.values()) for v in sub_launches)):
        raise AssertionError(f"the mesh subgraph run did not run as configured, or a rank "
                             f"launched no K9/K10: {out}")
    return {"rank": [{k: v.get(k, 0) for k in MESH_RANK_KERNELS} for v in launches],
            "train": train_launches, "subgraph": sub_launches}


def phase_nccl_world1(seed: int, model, dataset):
    """An NCCL group of world size 1 through the CLI's device and backend
    choice (cli.run.process_device) and init: a 1x1 mesh whose data and
    model groups are that group, so every collective of MESH_STEPS
    data-parallel steps (the normalizers, the gradient all_reduce, the
    loss sums) and of one sharded rank call (the query rows, the counts)
    runs through NCCL; params and ranks against one process's."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from complexhyperbolickge_torch.cli.run import free_port, process_device
    from complexhyperbolickge_torch.parallel import Mesh, make_best_sharded_ranker
    from complexhyperbolickge_torch.train.evaluate import get_ranking, make_best_ranker

    ref_steps = mesh_steps(seed)
    pack = dataset.eval_pack("test", "rhs")
    want = get_ranking(model, pack, BATCH, make_best_ranker(model, BATCH, "auto"))
    dev, backend = process_device("cuda", 0, 1)
    if backend != "nccl":
        raise AssertionError(f"one rank with a card of its own chose {backend}, not nccl")
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        world = dist.group.WORLD
        mesh = Mesh((1, 1), 0, dev, data_group=world, model_group=world)
        params, loss, launches = mesh_steps(seed, mesh)
        ranker = make_best_sharded_ranker(model, mesh, model.cfg.n_entities, "auto")
        got = get_ranking(model, pack, BATCH, ranker)
    finally:
        dist.destroy_process_group()
    close = _params_close(params, ref_steps[0])
    out = {"phase": "nccl-world1", "backend": backend, "device": str(dev),
           "steps": MESH_STEPS, "loss": [loss, ref_steps[1]], "launches": launches,
           "params": close, "ranker": type(ranker).__name__,
           "max_abs_rank_diff_vs_single_process": float(np.abs(got - want).max())}
    emit(out)
    if (not all(c["within_tolerance"] for c in close.values())
            or out["max_abs_rank_diff_vs_single_process"] != 0.0
            or min(launches.values()) < MESH_STEPS):
        raise AssertionError(f"the NCCL world-1 mesh disagrees with one process: {out}")


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
        errors.update(phase_chain_kernels(a.seed))
        roth_queries_row = phase_roth_queries(a.seed, name, smi)
        phase_train_step_parity(a.seed)

        hyp_dirs, not_inverted = {}, {}
        for m in HYP_MODELS:
            hyp_dirs[m], not_inverted[m] = write_run(a.seed, m)
        emit({"phase": "hyp-run", "dirs": hyp_dirs, "rank": HYP_RANK,
              "test_tails_not_invertible": not_inverted})
        hyp = {m: load_serving_state(d, "cuda") for m, d in hyp_dirs.items()}
        hyp_batches, hyp_errors = phase_hyp_kernels(hyp)
        bf16_work, bf16_errors = phase_bf16_kernels(model, dataset, hyp)
        phase_bf16_bits(model, dataset, hyp, a.seed)

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
        if (min(train_launches[k] for k in (*TRAIN_KERNELS, "chyp_train_lists",
                                            *CHAIN_KERNELS, "fftroth_queries_sum")) < steps
                or not train_launches["chyp_rank_sweep_masked"]):
            raise AssertionError(f"K3/K4 (or K4's lists, or the fused chain) launched fewer "
                                 f"times than the {steps} training steps, or K1 never: "
                                 f"{train_launches}")
        want = {"RotH": (*HYP_RANK_KERNELS, "hyp_rank_radii", "roth_rank_queries"),
                "RotLH": (*HYP_RANK_KERNELS, "hyp_rank_radii"),
                "AttRH": (*ATTRH_KERNELS, "hyp_rank_radii"),
                "RotH training": ("hyp_rank_sweep_masked", "hyp_rank_radii")}
        missing = {m: [k for k in ks if k not in by_model[m]] for m, ks in want.items()}
        if any(missing.values()):
            raise AssertionError(f"real-hyperbolic kernels that never launched: {missing}")
        launches = {**{k: serve_launches[k] for k in RANK_KERNELS},
                    **{k: train_launches[k] for k in (*TRAIN_KERNELS, "chyp_train_lists",
                                                      *CHAIN_KERNELS, "fftroth_queries_sum")}}

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
        relgrad_keys = ("relation_grad", "relation_grad_accumulate")
        emit({"phase": "gnn-launches",
              "train": {k: gnn_train_launches[k] for k in (*GNN_KERNELS, *relgrad_keys)},
              "train_steps": gnn_steps, "kge_test_by_model": gnn_by_model,
              "path": {k: gnn_launches[k] for k in GNN_KERNELS}})
        if min(gnn_train_launches[k] for k in GNN_KERNELS) < gnn_steps:
            raise AssertionError(f"K9/K10 launched fewer times than the {gnn_steps} CompGCN "
                                 f"training steps: {gnn_train_launches}")
        if (gnn_train_launches["relation_grad"] < 2 * gnn_steps
                or gnn_train_launches["relation_grad_accumulate"]):
            raise AssertionError(f"CompGCN's full-graph steps did not take the relation "
                                 f"gradient's kernels in both directions: {gnn_train_launches}")

        # --eval_precision default: kge-test through the bf16 instances
        # (phase_default_kge_test resets and reads the counts itself)
        default_launches = phase_default_kge_test(
            {"FFTRotH": (model_dir, model, dataset),
             **{m: (d, *hyp[m]) for m, d in hyp_dirs.items()}}, gnn_dirs["CompGCN"], dataset)

        # the subgraph path: its steps encode with the unsorted sums and
        # gathers of the masked convs; its validation and test encode the
        # full graph through K9/K10
        KS.reset_launches()  # the subgraph path starts here
        phase_subgraph_train(a.seed, dataset)
        sub_launches = KS.launches()  # ... and ends here
        emit({"phase": "subgraph-launches", "path": {k: v for k, v in sub_launches.items() if v}})
        if not all(sub_launches[k] for k in GNN_KERNELS):
            raise AssertionError(f"the subgraph path's full-graph validation launched no "
                                 f"K9/K10: {sub_launches}")
        phase_subgraph_bce(a.seed, dataset)
        phase_subgraph_step_parity(a.seed, dataset)
        phase_export_import(model_dir, dataset)

        # the parallel/ path: two ranks on the card (each rank's kernels
        # counted in its own process, reset just before each of its paths
        # and read just after), then an NCCL group of one
        mesh_launches = phase_mesh(a.seed, {"FFTRotH": model_dir, **hyp_dirs},
                                   {"FFTRotH": (model, dataset), **hyp})
        phase_nccl_world1(a.seed, model, dataset)

        step_ms = phase_profile(
            (model, dataset, train_window(dataset, a.seed)),
            (*hyp["RotH"], train_window(hyp["RotH"][1], a.seed, "RotH")),
            gnn_train_window(dataset, a.seed),
            {"ce_train": train_window(dataset, a.seed, config="FFTRotH CE"),
             "bce_train": train_window(dataset, a.seed, config="FFTRotH BCE")})
        rows = phase_kernel_line(model, batch, launches, errors, smi, name, a.seed, step_ms)
        rows += hyp_kernel_rows(hyp, hyp_batches, hyp_launches, hyp_errors, smi, name)
        rows.append({**roth_queries_row, "launches": hyp_launches["roth_rank_queries"],
                     "launches_by_model": {m: v.get("roth_rank_queries", 0)
                                           for m, v in by_model.items()}})
        rows += gnn_kernel_rows(gnn_meas, gnn_launches, smi, name)
        rows += bf16_kernel_rows(bf16_work, default_launches, bf16_errors, smi, name)
        for row in rows:  # each rank's launches on the mesh paths
            for path in ("rank", "train", "subgraph"):
                if any(row["name"] in v for v in mesh_launches[path]):
                    row[f"mesh_{path}_launches_per_rank"] = [v[row["name"]]
                                                             for v in mesh_launches[path]]
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
