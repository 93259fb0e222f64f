"""Meshes, sharding rules and the parallel layers of the port (data,
tensor, pipeline and expert parallelism over ``torch.distributed``): the
counterpart of ``fp8tpu.parallel``, whose names it all exports.  Each
collective that GSPMD inserts in the JAX package is issued here by hand,
so that a sharded run computes the global program."""

from .data import Block, BatchShard, TensorShard, seq_chunk  # noqa: F401
from .grad_comm import (  # noqa: F401
    wire_all_reduce,
    wire_all_reduce_tree,
    wire_bytes_per_element,
)
from .mesh import (  # noqa: F401
    Mesh,
    gather_last,
    init_world,
    make_mesh,
    make_pp_mesh,
)
from .moe import (  # noqa: F401
    moe_ffn,
    quantize_expert_weights,
    top_k_routing,
)
from .pipeline import (  # noqa: F401
    pipeline_apply,
    stack_stage_params,
    stage_param_sharding,
)
from .sharding import (  # noqa: F401
    DECODER_PARAM_RULES,
    MOE_PARAM_RULES,
    KV_CACHE_SPEC,
    KV_SCALE_SPEC,
    SERVE_PARAM_RULES,
    NamedSharding,
    PartitionSpec,
    batch_sharding,
    local_shards,
    replicated,
    shard_params,
    shard_tree,
    split_dim,
)
from .tp_matmul import (  # noqa: F401
    chunk_columns,
    column_parallel_qmatmul,
    row_parallel_qmatmul,
    tp_mlp_block,
)
