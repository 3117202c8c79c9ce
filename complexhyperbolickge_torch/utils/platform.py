"""Device selection (counterpart of complexhyperbolickge_tpu/utils/platform.py).

Entry points run on the card unless the caller asks for the CPU; a request
for the card on a machine without one raises instead of falling back.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU"
        )
    return dev
