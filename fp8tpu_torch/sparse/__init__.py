"""Sparsity: top-k / stochastic pruning transforms and adaptive sparse
layers (the JAX package's ``sparse/``)."""

from .adaptive import SparseConv, SparseLinear, weight_mask_step  # noqa: F401
from .prune import (  # noqa: F401
    SparseConfig,
    SparseState,
    sparsify_outgrad,
    sparsify_weight,
    sparsity_of,
    stochastic_prune,
    stochastic_prune_threshold,
    topk_prune,
    topk_threshold_sampled,
)
