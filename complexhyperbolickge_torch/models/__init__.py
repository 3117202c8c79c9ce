"""Model registry (counterpart of complexhyperbolickge_tpu/models/__init__.py).

All 25 JAX models: the Euclidean family, the eight real-hyperbolic ones
(Poincare ball and Lorentz), the complex family, the four CHYP (FFT) names
and the four GNN encoders.  A GNN class takes (cfg, args, dataset): its
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
from complexhyperbolickge_torch.models.complexm import (  # noqa: F401
    COMPLEX_MODELS,
    BaseC,
    ComplEx,
    Fourier,
    RotatE,
)
from complexhyperbolickge_torch.models.euclidean import (  # noqa: F401
    EUC_MODELS,
    CP,
    AttE,
    BaseE,
    MurE,
    RefE,
    RotE,
    TransE,
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

all_models = EUC_MODELS + HYP_MODELS + COMPLEX_MODELS + CHYP_MODELS + GNN_MODELS

_REGISTRY = {name: globals()[name] for name in all_models}


def get_model(name: str):
    """Resolve a model class by registry name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; available: {sorted(all_models)}") from None
