"""Frozen work counts of the full-graph GNN cells: the yardstick of
k9k10.roofline_share and gnn.mfu, beside roofline.py, whose peaks,
bound_ms, distinct_expected and adam_work they use (roofline.py is not
changed).

A step of the full-graph encoder runs over E directed edges (the train
triples and their inverses: E / 2 a direction, each direction sorted by
its receiving node) into N nodes, through layers of widths
widths[0] (the entity table) -> widths[1] -> ...; R relation rows; B
queries scored against the N entities.  Each count is the work that these
inputs need, whatever implements it; bytes count each input once and each
output once, and a gather reads the distinct rows its ids name, counted
as the expected distinct rows of E / 2 uniform draws
(roofline.distinct_expected): a floor, since one side of each direction
names every entity.
"""

from __future__ import annotations

from kgbench import roofline

# fp32 operations an entry of the (B, N) scores takes in the smoothed BCE:
# the smoothed label, the log-sigmoid, both floored log terms and their
# weighted sum forward; the sigmoid and the label's difference backward
BCE_OPS_FWD, BCE_OPS_BWD = 10, 5
# fp32 operations a node's output feature takes in the mix of the in, out
# and loop terms and batch norm with batch statistics (mean, variance,
# normalize, scale and shift)
BN_OPS = 10


def k9_bytes(e: int, n: int, h: int) -> int:
    """Bytes of one sorted segment sum (K9) of e messages of width h into
    n rows: the messages and the n + 1 CSR offsets read, the rows written."""
    return 4 * (e * h + n + 1 + n * h)


def k10_bytes(e: int, rows: float, h: int) -> float:
    """Bytes of one row gather (K10) of e rows of width h: the distinct
    `rows` read, the e int32 ids read, the e rows written."""
    return 4 * (rows * h + e + e * h)


def k9k10_launches(e: int, n: int, widths) -> list:
    """(kernel, bytes) of every K9 and K10 launch of one training step of
    the full-graph encoder.  Per layer of input width d and per direction:
    forward, the degree sum (K9, width 1), the tail gather (K10) and the
    message sum (K9); backward, the message sum's (K10 at the receiving
    nodes) and the tail gather's (K10 through the ids' sorting
    permutation, then K9 over the sorted ids)."""
    half = e // 2
    rows = roofline.distinct_expected(n, half)
    out = []
    for d in widths[:-1]:
        for _ in range(2):
            out += [("K9", k9_bytes(half, n, 1)), ("K10", k10_bytes(half, rows, d)),
                    ("K9", k9_bytes(half, n, d)), ("K10", k10_bytes(half, rows, d)),
                    ("K10", k10_bytes(half, half, d)), ("K9", k9_bytes(half, n, d))]
    return out


def compgcn_step_work(e: int, n: int, r: int, widths, b: int, n_params: int):
    """(fp32 operations, bytes) of one CompGCN training step with the
    DistMult score and the smoothed BCE over every entity.  Per layer of
    widths d -> h, forward: each edge's composition, norm and sum (3 E d),
    the in, out and loop projections of the N sums and the self loop's
    composition (6 N d h + N d), the mix and batch norm (BN_OPS N h), the
    relations' projection (2 R d h); backward twice each contraction and
    once each elementwise pass.  The decoder: the query rows (B h), every
    (query, entity) pair's dot and biases (2 B N h + 2 B N), twice the
    contraction backward, and the BCE's passes over the (B, N) scores.
    Then the dense Adam update of every parameter.  Bytes: per layer, the
    input table and the edges' three int32 indices read and the output
    written, forward and backward; the encoded table read and the scores
    written, forward and backward; Adam's passes."""
    f32 = nbytes = 0.0
    for d, h in zip(widths[:-1], widths[1:]):
        mm = 6 * n * d * h + 2 * r * d * h
        elementwise = 3 * e * d + n * d + BN_OPS * n * h
        f32 += 3 * mm + 2 * elementwise
        nbytes += 2 * 4 * (n * d + 3 * e + n * h)
    h = widths[-1]
    f32 += b * h + 3 * (2 * b * n * h) + 2 * b * n + (BCE_OPS_FWD + BCE_OPS_BWD) * b * n
    nbytes += 2 * 4 * (n * h + b * n)
    a_ops, a_bytes = roofline.adam_work(n_params)
    return f32 + a_ops, nbytes + a_bytes


def widths(cfg) -> list:
    """The layer stack's widths of a GNN configuration."""
    return [cfg["rank"]] + [cfg["hidden_dim"]] * cfg["layers"]
