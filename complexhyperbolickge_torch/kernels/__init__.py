"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

chyp_rank.py ports complexhyperbolickge_tpu/kernels/chyp_rank.py (K1, K2).
The other Pallas kernels of the JAX package (chyp_train, hyp_rank, segsum,
gather) are queued in ROADMAP.md Queue 2.  Sources live in csrc/ and are
compiled at first use (_build.py); importing this package builds nothing.
"""
