"""Data, tensor and spatial parallelism over ``torch.distributed`` (port
of ``hmvit_tpu/parallel``; see :mod:`.mesh`)."""
from .mesh import (  # noqa: F401
    audit_tp_sharding,
    gather_batch,
    init_from_env,
    make_hybrid_mesh,
    make_mesh,
    make_sharded_eval,
    make_spatial_eval,
    replicate_state,
    shard_batch,
    shard_state_tp,
    tp_shard_tree,
    tp_spec_for_path,
)
