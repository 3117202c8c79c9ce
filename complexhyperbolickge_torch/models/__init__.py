"""Model registry (counterpart of complexhyperbolickge_tpu/models/__init__.py).

Ported: the four CHYP (FFT) names, the eight real-hyperbolic ones
(Poincare ball and Lorentz) and the four GNN encoders.  The other 9
registered JAX models (Euclidean and complex families) are queued in
ROADMAP.md Queue 1 item 11b.  A GNN class takes (cfg, args, dataset): its
graph is the dataset's train split.
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
from complexhyperbolickge_torch.models.gnn import (  # noqa: F401
    GNN_MODELS,
    CompGCN,
    LorentzGCN,
    PoincareGAT,
    PoincareGCN,
)
from complexhyperbolickge_torch.models.hyperbolic import (  # noqa: F401
    HYP_MODELS,
    AttH,
    AttRH,
    BaseH,
    BaseLorentz,
    HyboNet,
    IFFTH,
    IsoH,
    RefH,
    RotH,
    RotLH,
)

all_models = CHYP_MODELS + HYP_MODELS + GNN_MODELS

_REGISTRY = {
    "FFTRotH": FFTRotH,
    "FFTRefH": FFTRefH,
    "FFTAttH": FFTAttH,
    "FFTIsoH": FFTIsoH,
    "RotH": RotH,
    "RefH": RefH,
    "AttH": AttH,
    "AttRH": AttRH,
    "IFFTH": IFFTH,
    "IsoH": IsoH,
    "RotLH": RotLH,
    "HyboNet": HyboNet,
    "CompGCN": CompGCN,
    "PoincareGCN": PoincareGCN,
    "PoincareGAT": PoincareGAT,
    "LorentzGCN": LorentzGCN,
}


def get_model(name: str):
    """Resolve a model class by registry name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet (ROADMAP.md Queue 1, "
            f"item 11b); ported: {sorted(_REGISTRY)}"
        ) from None
