"""Traffic `rank_split`: a closed loop of whole-split filtered evaluation
passes, as `kge-test` and model selection run them: each pass is one
train/evaluate.py::compute_metrics call over `split` (both directions, in
batches of the configuration's eval batch size) through the ranker that
make_best_ranker picks for the configuration's eval backend and
precision, built once in set-up with the graph's eval packs.

Weights are drawn from the seed by the workload's `weights`
distributions (a trained model's spread: points well inside the ball,
distinct scores), so that ranks fall across the whole candidate range.
Set-up runs `warmup_passes` passes (every batch shape of the split).

End to end: rank_queries_per_s, every filtered query ranked in the
window's passes over the window's wall time (each pass ends in the
ranks' copy to the host).  With a profiled sub-window (`trace_at` of the
way in, `trace_passes` passes), the info the per-layer readers get counts
it apart.

The check: the ranks of pass 0, of `sample_passes` passes drawn from the
seed among the first `sample_range`, and of the last pass, against the
plain reference's float64 scores (kgbench/reference/protocol.py::
rank_gaps): the widest score gap by which a rank lies off the
reference's.  `numbers` also reads the widest gap of a returned metric
against the reference ranks' (MR over the entity count), for calibration.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from kgbench.inputs import draw_weights, make_graph, seed_words
from kgbench.reference import protocol
from kgbench.trace import Profiled

SAMPLE_STREAM = 3


class _Recorder:
    """The ranker, called inside a span `ranker`; keeps each call's ranks
    (device tensors) in `out`.  Anything else is the ranker's."""

    def __init__(self, inner, spans):
        self.inner, self.spans, self.out = inner, spans, []

    def __call__(self, q, fidx):
        with self.spans.span("ranker", queries=int(q.shape[0])):
            r = self.inner(q, fidx)
        self.out.append(r)
        return r

    def __getattr__(self, name):
        return getattr(self.inner, name)


def build_ranker(cell, device, weights: dict):
    """The graph, the program's dataset (its filters and eval packs), the
    model with `weights`, and its ranker for the cell's configuration."""
    from complexhyperbolickge_torch.data.dataset import KGData
    from complexhyperbolickge_torch.models import ModelConfig, get_model
    from complexhyperbolickge_torch.train.evaluate import make_best_ranker

    cfg = cell.config
    graph = make_graph(cell.seed, cfg["entities"], cfg["relations"], cfg["train_triples"],
                       cfg["valid_triples"], cfg["test_triples"])
    data = KGData(splits=graph)
    n_ent, n_rel, _ = data.get_shape()
    if (n_ent, n_rel) != (cfg["n_entities"], cfg["n_relations"]):
        raise ValueError(f"graph shape {(n_ent, n_rel)} is not the configuration's")
    model = get_model(cfg["model"])(ModelConfig(
        n_entities=n_ent, n_relations=n_rel, rank=cfg["rank"], init_size=cfg["init_size"],
        bias=cfg["bias"], multi_c=cfg["multi_c"], dtype=cfg["dtype"]), device=device)
    model.load_state_dict(weights)
    ranker = make_best_ranker(model, cfg["eval_batch_size"], cfg["eval_backend"],
                              cfg["eval_precision"])
    return graph, data, model, ranker


class Session:
    def __init__(self, cell, spans):
        from complexhyperbolickge_torch.train.evaluate import compute_metrics

        self.cell, self.spans = cell, spans
        self.p = p = cell.params
        self.device = torch.device(cell.device)
        self.cuda = self.device.type == "cuda"
        self._compute_metrics = compute_metrics
        ref, cfg = cell.reference, cell.config
        with spans.span("setup.model"):
            w = draw_weights(ref.PARAMS(cfg), p["weights"], cell.seed, self.device,
                             torch.float32)
            self.graph, self.data, self.model, ranker = build_ranker(cell, self.device, w)
            del w
        self.rank_fn = _Recorder(ranker, spans)
        self.n_queries = 2 * len(self.graph[p["split"]])
        with spans.span("setup.warmup"):
            for _ in range(p["warmup_passes"]):
                self._pass()
        rng = np.random.default_rng([seed_words(cell.seed), SAMPLE_STREAM])
        self.sample = {0, *(int(i) for i in rng.choice(
            np.arange(1, p["sample_range"]), size=p["sample_passes"], replace=False))}
        self.kept = {}

    def _pass(self) -> dict:
        """One compute_metrics pass; its ranks stay in rank_fn.out (rhs then
        lhs, in batch order)."""
        self.rank_fn.out = []
        with self.spans.span("pass", queries=self.n_queries):
            return self._compute_metrics(self.model, self.data, self.p["split"],
                                         self.cell.config["eval_batch_size"],
                                         rank_fn=self.rank_fn)

    def window(self, seconds: float, profile: bool = False) -> dict:
        p = self.p
        prof = Profiled(self.spans, self.cuda) if profile else None
        passes, prof_passes, prof_s, last = 0, 0, 0.0, None
        t0 = time.perf_counter()
        while True:
            if (prof is not None and not prof_passes
                    and time.perf_counter() - t0 >= p["trace_at"] * seconds):
                t1 = time.perf_counter()
                prof.run(lambda: [self._pass() for _ in range(p["trace_passes"])])
                prof_s += time.perf_counter() - t1
                prof_passes = p["trace_passes"]
                continue
            metrics = self._pass()
            last = (passes, self.rank_fn.out, metrics)
            if passes in self.sample:
                self.kept[passes] = last[1:]
            passes += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if self.cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - prof_s
        self.kept[last[0]] = last[1:]
        info = {"kind": "rank", "window_start": t0, "passes": passes,
                "queries": passes * self.n_queries, "wall_s": wall,
                "profiled_passes": prof_passes, "n_queries": self.n_queries}
        return {"end_to_end": {"rank_queries_per_s": passes * self.n_queries / wall},
                "attempted": passes * self.n_queries, "failed": 0, "info": info,
                "trace": prof.read() if prof is not None and prof.prof is not None else None}

    def free(self):
        self.model = self.data = self.rank_fn = None

    def reference_scores(self, ar):
        """Yield (direction, rows slice, gold, fidx, scores (B, N)) over the
        split in blocks, scored by the plain reference in precision ar."""
        ref, cfg, p = self.cell.reference, self.cell.config, self.p
        n, n_rel2 = cfg["n_entities"], cfg["n_relations"]
        w = draw_weights(ref.PARAMS(cfg), p["weights"], self.cell.seed, self.device,
                         torch.float32)
        P = {k: v.to(ar.dtype) for k, v in w.items()}
        split = self.graph[p["split"]]
        bsz = p["reference_block"]
        with torch.no_grad():
            for direction in ("rhs", "lhs"):
                q = protocol.eval_queries(split, n_rel2, direction)
                f = protocol.filter_lists(self.graph, q, n_rel2, n)
                for i in range(0, len(q), bsz):
                    qb = torch.as_tensor(q[i:i + bsz], device=self.device)
                    fb = torch.as_tensor(f[i:i + bsz], device=self.device)
                    lhs, _ = ref.queries(P, qb[:, 0], qb[:, 1], cfg, ar)
                    yield direction, slice(i, i + len(qb)), qb[:, 2], fb, \
                        ref.score_all(P, lhs, cfg, ar)

    def numbers(self, passes: list) -> dict:
        """The compared numbers of `passes`, a list of (ranks (n_queries,),
        metrics dict or None) against the float64 reference."""
        n = self.cell.config["n_entities"]
        half = self.n_queries // 2
        ports = torch.stack([r.to(self.device, torch.float64) for r, _ in passes])
        gap, ref_ranks = 0.0, {"rhs": [], "lhs": []}
        for direction, rows, gold, fidx, scores in self.reference_scores(
                protocol.Arith("float64")):
            off = 0 if direction == "rhs" else half
            r, g = protocol.rank_gaps(scores, gold, fidx,
                                      ports[:, off + rows.start: off + rows.stop])
            ref_ranks[direction].append(r)
            gap = max(gap, float(g.max()))
        out = {"rank_score_gap": gap}
        ref_m = {d: protocol.direction_metrics(torch.cat(v).cpu().numpy())
                 for d, v in ref_ranks.items()}
        mgap = 0.0
        for _, metrics in passes:
            if metrics is None:
                continue
            for d, want in ref_m.items():
                got = metrics[d]
                mgap = max(mgap, abs(got["MR"] - want["MR"]) / n, abs(got["MRR"] - want["MRR"]),
                           *(abs(a - b) for a, b in zip(got["hits@[1,3,10]"],
                                                         want["hits@[1,3,10]"])))
        if any(m is not None for _, m in passes):
            out["metrics_gap"] = mgap
        return out

    def control_ranks(self, ar) -> torch.Tensor:
        """The filtered ranks that the reference computed in precision ar
        gives in the program's place, (n_queries,) in pass order."""
        out = {"rhs": [], "lhs": []}
        for direction, _, gold, fidx, scores in self.reference_scores(ar):
            out[direction].append(protocol.filtered_ranks(scores, gold, fidx))
        return torch.cat(out["rhs"] + out["lhs"]).to(torch.float64)

    def check(self) -> dict:
        """The compared number: rank_score_gap.  metrics_gap is a reading
        only (kgbench/calibrate.py): a metric averages a lower precision's
        rank flips away, so it cannot tell one from float32 rounding."""
        kept = [(torch.cat(r), m) for r, m in self.kept.values()]
        return {"rank_score_gap": self.numbers(kept)["rank_score_gap"]}
