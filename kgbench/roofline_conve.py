"""Frozen work counts of a full-graph CompGCN step with the circular-
correlation composition (corr) and the ConvE decoder: the yardstick of
gnn_conve.mfu, beside roofline.py and roofline_gnn.py, whose peaks,
adam_work, BN_OPS and BCE_OPS_* it uses (neither is changed).

Each count is the least work that these inputs need, whatever implements
it.  A corr of length d takes, at its least, two real FFTs and one inverse
(REAL_FFT_OPS each: 2.5 d log2 d, half a complex FFT's 5 d log2 d) and the
d/2 + 1 complex products of the conjugate (6 operations each); its
backward, a corr for each input, twice that.  Bytes count each input once
and each output once, as roofline_gnn.compgcn_step_work does.
"""

from __future__ import annotations

import math

from kgbench import roofline
from kgbench.roofline_gnn import BCE_OPS_BWD, BCE_OPS_FWD, BN_OPS


def real_fft_ops(d: int) -> float:
    """fp32 operations of one real FFT (or its inverse) of length d."""
    return 2.5 * d * math.log2(d)


def corr_ops(d: int) -> float:
    """fp32 operations of one corr of length d, forward: two real FFTs, the
    d/2 + 1 conjugate products, one inverse."""
    return 3 * real_fft_ops(d) + 6 * (d // 2 + 1)


def conve_shape(k_w: int, k_h: int, num_filt: int, ker_sz: int) -> tuple:
    """(output rows, output columns, flat width) of ConvE's convolution."""
    oh, ow = 2 * k_w - ker_sz + 1, k_h - ker_sz + 1
    return oh, ow, num_filt * oh * ow


def conve_step_work(e: int, n: int, r: int, widths, b: int, n_params: int,
                    k_w: int, k_h: int, num_filt: int, ker_sz: int):
    """(fp32 operations, bytes) of one CompGCN training step with corr, the
    ConvE decoder and the smoothed BCE over every entity, on E directed
    edges into N nodes, R relation rows, layers of `widths`, B queries.
    Per layer of widths d -> h: the in, out and loop projections of the N
    sums (6 N d h) and the relations' projection (2 R d h), three times
    for the backward; each edge's norm and sum (2 E d), the mix and batch
    norm (BN_OPS N h), forward and backward; each edge's and node's corr,
    three times (forward, and a corr for each input backward).  The
    decoder: the convolution (2 B F oh ow k^2) and fc (2 B flat h), three
    times; the three batch norms with their ReLUs (BN_OPS a value of the
    image, the filters' output and the h rows), forward and backward; the
    scores' products (2 B N h, three times), their biases and the BCE's
    passes.  Then the dense Adam update of every parameter.  Bytes: per
    layer, the input table and the edges' three int32 indices read and the
    output written, forward and backward; the decoder's fc weight, its
    input and output, forward and backward; the encoded table read and the
    scores written, forward and backward; Adam's passes."""
    f32 = nbytes = 0.0
    for d, h in zip(widths[:-1], widths[1:]):
        mm = 6 * n * d * h + 2 * r * d * h
        elementwise = 2 * e * d + BN_OPS * n * h
        f32 += 3 * mm + 2 * elementwise + 3 * (e + n) * corr_ops(d)
        nbytes += 2 * 4 * (n * d + 3 * e + n * h)
    h = widths[-1]
    oh, ow, flat = conve_shape(k_w, k_h, num_filt, ker_sz)
    f32 += 3 * (2 * b * num_filt * oh * ow * ker_sz * ker_sz + 2 * b * flat * h)
    f32 += 2 * BN_OPS * b * (2 * h + flat + h)
    nbytes += 2 * 4 * (flat * h + b * flat + b * h)
    f32 += 3 * (2 * b * n * h) + 2 * b * n + (BCE_OPS_FWD + BCE_OPS_BWD) * b * n
    nbytes += 2 * 4 * (n * h + b * n)
    a_ops, a_bytes = roofline.adam_work(n_params)
    return f32 + a_ops, nbytes + a_bytes

