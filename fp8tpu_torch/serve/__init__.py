"""FP8 serving: fp8-weight decoder, quantized ring KV cache, continuous
batching.  The paged pool and speculation are not ported yet."""

from .engine import Request, ServingEngine  # noqa: F401
from .server import EngineServer  # noqa: F401
from .kv_cache import KVCache, RingKVCache, quantize_kv  # noqa: F401
from .model import (  # noqa: F401
    ServeConfig,
    convert_decoder_params,
    decode_chunk,
    decode_step,
    decode_steps,
    fp8_linear,
    full_logits,
    int4_linear,
    prefill,
    prefill_batch,
    random_serve_params,
    ring_from_jax,
    serve_params_from_jax,
)
