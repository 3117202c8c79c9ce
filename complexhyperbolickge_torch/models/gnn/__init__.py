from complexhyperbolickge_torch.models.gnn.models import (  # noqa: F401
    GNN_MODELS,
    BoundGNN,
    CompGCN,
    GNNModel,
    LorentzGCN,
    PoincareGAT,
    PoincareGCN,
)
