"""FP8 serving: fp8-weight decoder (dense or mixture-of-experts),
quantized KV cache (ring, with optional batched ring writes, or paged pool
with a prefix cache), continuous batching, draft-and-verify speculation
(single-sequence on the ring, batched under continuous batching on the
paged pool)."""

from .engine import Request, ServingEngine  # noqa: F401
from .server import EngineServer  # noqa: F401
from .kv_cache import (  # noqa: F401
    KVCache,
    PagedKVCache,
    RingKVCache,
    quantize_kv,
)
from .speculative import (  # noqa: F401
    SpecStats,
    draft_chunk,
    greedy_verify,
    sample_verify,
    score_tokens,
    speculative_decode,
)
from .model import (  # noqa: F401
    ServeConfig,
    convert_decoder_params,
    decode_chunk,
    decode_chunk_paged,
    decode_step,
    decode_step_paged,
    decode_steps,
    decode_steps_paged,
    fp8_linear,
    full_logits,
    int4_linear,
    paged_from_jax,
    prefill,
    prefill_batch,
    prefill_batch_paged,
    prefill_paged,
    random_serve_params,
    ring_from_jax,
    serve_params_from_jax,
    shard_serve_params,
)
