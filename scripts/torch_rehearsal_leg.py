"""The PyTorch port's leg of the MRR-gate rehearsal.

Writes the rehearsal's generated raw KG (permutation relations over 800
entities, 20 relations; with --noisy, the skewed window noise whose
Bayes-optimal filtered MRR is ~0.64), preprocesses it with the port
(data/preprocess.py), then trains FFTRotH through the port's cli.run.train
with the gate's protocol: rank 33, batch 500, 100 per-query negatives,
Adam lr 3e-4, N3 reg 0, multi_c, bias learn, init 0.001, validation every
5 epochs, patience 30.  Prints the test MRR as `... ours MRR=...`, the
line format of scripts/rehearsal_ours_leg.py (the JAX package's leg).

    python scripts/torch_rehearsal_leg.py --seed 7 --noisy --device cpu
    python scripts/torch_rehearsal_leg.py --seed 7 --noisy --device cuda --dtype float32

Imports torch and numpy only: the generator below is a copy of the
rehearsal test's write_raw_dataset (tests/test_mrr_gate_rehearsal.py),
whose module imports the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# the rehearsal KG: N_REL permutation relations over N_ENT entities, and
# the noisy variant's window-offset distribution
N_ENT, N_REL = 800, 20
NOISE_P = (0.4, 0.3, 0.2, 0.1)
# the gate's protocol (tests/test_realdata_gate.py)
PATIENCE, VALID_EVERY = 30, 5
RANK, BATCH, NEG, LR = 33, 500, 100, 3e-4


def write_raw_dataset(root: str, noisy: bool = False, data_seed: int = 7) -> None:
    """Raw files {train,valid,test} of tab-separated string triples under
    <root>/WN18RR: tail = head + offset_r (+ a noise draw u from NOISE_P
    when noisy), each (h, r) once; shuffled, 1/12 valid, 1/12 test."""
    rng = np.random.default_rng(data_seed)
    k_noise = len(NOISE_P) if noisy else 1
    offsets = rng.choice(np.arange(1, N_ENT - k_noise), size=N_REL, replace=False)
    if noisy:
        u = rng.choice(k_noise, p=NOISE_P, size=(N_REL, N_ENT))
    else:
        u = np.zeros((N_REL, N_ENT), dtype=np.int64)
    triples = [(i, k, (i + int(off) + int(u[k, i])) % N_ENT)
               for k, off in enumerate(offsets) for i in range(N_ENT)]
    triples = np.asarray(triples, dtype=np.int64)
    triples = triples[rng.permutation(len(triples))]
    n_eval = len(triples) // 12
    splits = {"valid": triples[:n_eval], "test": triples[n_eval: 2 * n_eval],
              "train": triples[2 * n_eval:]}
    ds = os.path.join(root, "WN18RR")
    os.makedirs(ds, exist_ok=True)
    for name, arr in splits.items():
        with open(os.path.join(ds, name), "w") as f:
            for h, r, t in arr:
                f.write(f"/c/en/ent_{h:05d}\t_rel_{r}\t/c/en/ent_{t:05d}\n")


def gate_argv(data_path: str, save_dir: str, epochs: int, train_seed: int,
              device: str, dtype: str) -> list:
    """cli.run's flags for the gate's FFTRotH protocol."""
    return ["--dataset", "WN18RR", "--data_path", data_path,
            "--model", "FFTRotH", "--rank", str(RANK),
            "--batch_size", str(BATCH), "--neg_sample_size", str(NEG),
            "--optimizer", "Adam", "--learning_rate", str(LR),
            "--regularizer", "N3", "--reg", "0.0", "--multi_c",
            "--bias", "learn", "--init_size", "0.001", "--gamma", "0.0",
            "--dtype", dtype, "--loss", "crossentropy",
            "--max_epochs", str(epochs), "--patience", str(PATIENCE),
            "--valid", str(VALID_EVERY), "--seed", str(train_seed),
            "--device", device, "--save_dir", save_dir]


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7, help="data seed of the generated KG")
    ap.add_argument("--noisy", action="store_true",
                    help="the non-saturating skewed-window-noise KG")
    ap.add_argument("--epochs", type=int, default=400,
                    help="epoch horizon (patience stops the run well before)")
    ap.add_argument("--train_seed", type=int, default=0, help="the training seed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None,
                    help="model dtype (default float64 on the CPU, float32 on the card)")
    args = ap.parse_args(argv)
    dtype = args.dtype or ("float64" if args.device == "cpu" else "float32")

    from complexhyperbolickge_torch.cli.run import build_parser, train
    from complexhyperbolickge_torch.data.preprocess import process_dataset

    with tempfile.TemporaryDirectory() as tmp:
        data_path = os.path.join(tmp, "data")
        write_raw_dataset(data_path, noisy=args.noisy, data_seed=args.seed)
        process_dataset(os.path.join(data_path, "WN18RR"))
        t0 = time.time()
        res = train(build_parser().parse_args(gate_argv(
            data_path, os.path.join(tmp, "ours"), args.epochs, args.train_seed,
            args.device, dtype)))
        dt = time.time() - t0
    mrr = res["test"]["MRR"]
    print(f"\n[torch_rehearsal_leg] seed={args.seed} noisy={args.noisy} "
          f"train_seed={args.train_seed} device={args.device} dtype={dtype} "
          f"epochs_run={len(res['history'])} wall_s={dt:.1f}")
    print(f"WN18RR FFTRotH ours: MRR={mrr:.4f}")
    return mrr


if __name__ == "__main__":
    main()
