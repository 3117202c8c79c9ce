"""PyTorch + CUDA port of complexhyperbolickge_tpu for one NVIDIA H100.

The module tree mirrors complexhyperbolickge_tpu file for file; each module
names its JAX counterpart.  This package imports torch and numpy only —
never jax, optax or complexhyperbolickge_tpu.

Exact fp32 is the JAX default for every score contraction (its
precision="highest" pins), so TF32 is switched off at import: a TF32 matmul
keeps ~10 mantissa bits and would shift filtered ranks.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
