"""Model registry (counterpart of complexhyperbolickge_tpu/models/__init__.py).

This slice ports the four CHYP names.  The other 21 registered JAX models
are queued in ROADMAP.md Queue 1 (item 11: Euclidean / hyperbolic / complex
families; item 13: GNN encoders).
"""

from __future__ import annotations

from complexhyperbolickge_torch.models.base import KGModel, ModelConfig  # noqa: F401
from complexhyperbolickge_torch.models.chyperbolic import (  # noqa: F401
    CHYP_MODELS,
    FFTAttH,
    FFTIsoH,
    FFTRefH,
    FFTRotH,
    FFTUnitBall,
)

all_models = list(CHYP_MODELS)

_REGISTRY = {
    "FFTRotH": FFTRotH,
    "FFTRefH": FFTRefH,
    "FFTAttH": FFTAttH,
    "FFTIsoH": FFTIsoH,
}


def get_model(name: str):
    """Resolve a model class by registry name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet (ROADMAP.md Queue 1, "
            f"items 11 and 13); ported: {sorted(_REGISTRY)}"
        ) from None
