"""cli.run.train on the CPU with each loss, negative mode and optimizer
beside per-query Adam, and with the Euclidean and complex families: the
all-entity cross-entropy (with and without label smoothing), BCE through
the train and valid label packs (the CLI always builds them, so the
signed-logsigmoid CE is tested through the Trainer), shared and pooled
negatives, SparseAdam.
Each run trains 2 epochs on a tiny synthetic KG: the loss is finite and
falls, the final metrics are valid, and kge-test of the run dir repeats
them."""

import numpy as np
import pytest

from complexhyperbolickge_torch.cli import run as R
from complexhyperbolickge_torch.cli.test import test as torch_test

TINY = ["--dataset", "synthetic", "--synthetic_entities", "60", "--synthetic_relations", "3",
        "--rank", "5", "--batch_size", "256", "--eval_batch_size", "128",
        "--optimizer", "Adam", "--learning_rate", "0.01", "--bias", "learn", "--multi_c",
        "--dtype", "float64", "--valid", "1", "--device", "cpu", "--seed", "3",
        "--max_epochs", "2"]

CASES = {
    "ce": ["--model", "FFTRotH", "--neg_sample_size", "0", "--loss", "crossentropy"],
    "ce_smoothed": ["--model", "FFTRotH", "--neg_sample_size", "0", "--loss", "crossentropy",
                    "--smoothing", "0.1"],
    "bce": ["--model", "FFTRotH", "--neg_sample_size", "0", "--loss", "binarycrossentropy",
            "--smoothing", "0.1"],
    "shared": ["--model", "FFTRotH", "--neg_sample_size", "8", "--neg_mode", "shared",
               "--double_neg"],
    "pool": ["--model", "FFTRotH", "--neg_sample_size", "8", "--neg_mode", "pool",
             "--neg_pool_size", "32"],
    "sparse_adam": ["--model", "FFTRotH", "--neg_sample_size", "8", "--optimizer",
                    "SparseAdam"],
    "rote": ["--model", "RotE", "--rank", "8", "--neg_sample_size", "8"],
    "complex_ce": ["--model", "ComplEx", "--rank", "8", "--neg_sample_size", "0"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_trains_with_each_new_loss(case, tmp_path, monkeypatch):
    seen = []
    real = R.Trainer.run_epoch

    def spy(self, batches, weights, generator, labels=None, **kw):
        seen.append(labels)
        return real(self, batches, weights, generator, labels, **kw)

    monkeypatch.setattr(R.Trainer, "run_epoch", spy)
    out = R.train(R.build_parser().parse_args(TINY + CASES[case] + ["--save_dir",
                                                                    str(tmp_path)]))
    losses = [h["train_loss"] for h in out["history"]]
    assert np.isfinite(losses).all() and losses[1] < losses[0], losses
    assert np.isfinite([h["valid_loss"] for h in out["history"]]).all()
    assert 0.0 < out["test"]["MRR"] <= 1.0
    # BCE batches carry label rows (the train pack, permuted with the triples)
    assert all((lab is not None) == (case == "bce") for lab in seen)
    if case == "bce":
        assert seen[0].ndim == 3 and seen[0].shape[1] == 256
        assert (seen[0] == seen[0].max()).any()  # pads
    assert torch_test(str(tmp_path), device="cpu") == out["test"]
