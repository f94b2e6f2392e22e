from porqua_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    pad_batch_to_mesh,
    shard_qp_batch,
    solve_qp_sharded,
)

__all__ = [
    "batch_sharding",
    "make_mesh",
    "pad_batch_to_mesh",
    "shard_qp_batch",
    "solve_qp_sharded",
]
