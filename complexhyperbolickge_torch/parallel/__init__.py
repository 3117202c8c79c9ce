"""Multi-process runs on torch.distributed: the (data, model) process mesh,
row-sharded entity tables and entity-sharded ranking.  Port of
complexhyperbolickge_tpu/parallel/."""

from complexhyperbolickge_torch.parallel.mesh import (  # noqa: F401
    ENTITY_PARAMS,
    Mesh,
    gather_entity_tree,
    gather_rows,
    make_mesh,
    pad_entity_tree,
    padded_rows,
    shard_entity_tree,
    shard_epoch_arrays,
    shard_model_,
    sum_grads,
    unpad_entity_tree,
)
from complexhyperbolickge_torch.parallel.ranking import (  # noqa: F401
    make_best_sharded_ranker,
    run_shards,
)
