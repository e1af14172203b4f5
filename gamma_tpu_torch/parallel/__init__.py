from gamma_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardedDense,
    ShardedIVFPQ,
    ShardedIVFSQ,
    build_mesh,
    shard_dense,
    shard_ivfpq,
    shard_ivfsq,
    sharded_dense_search_fn,
    sharded_flat_search_fn,
    sharded_ivfpq_search_fn,
    sharded_ivfsq_search_fn,
    sharded_kmeans_fit,
)
