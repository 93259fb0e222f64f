"""Parallel layers of the port.  Only the mixture-of-experts FFN is here so
far, without a mesh: expert parallelism over NCCL, and the rest of
``fp8tpu.parallel`` (sharding rules, tensor- and pipeline-parallel
matmuls, the fp8 gradient all-reduce), come with slice 4."""

from .moe import (  # noqa: F401
    moe_ffn,
    quantize_expert_weights,
    top_k_routing,
)
