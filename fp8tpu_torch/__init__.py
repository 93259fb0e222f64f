"""fp8tpu_torch: the PyTorch and CUDA port of fp8tpu.

Bit-exact FP8 / FP4 / bf16 / fp16 fake-quant casts over the mode-string
ABI, post-training quantization through ``quantize_model``, and the
fp8-weight / quantized-KV serving decoder with its continuous-batching
engine (``fp8tpu_torch.serve``), on an NVIDIA H100 with hand-written
kernels (``fp8tpu_torch/kernels/csrc``), or on the CPU through their plain
torch versions when the caller asks for ``device="cpu"``.
"""

from fp8tpu_torch.api import QuantizedModel, quantize_model
from fp8tpu_torch.numerics import (
    FORMATS,
    RoundMode,
    qdq,
    qdq_blocked,
    qdq_mode_string,
)
from fp8tpu_torch.quant import (
    ModuleQuantConfig,
    QuantPolicy,
    TensorQuantConfig,
    fake_quant,
    get_policy,
)

__all__ = [
    "FORMATS", "ModuleQuantConfig", "QuantPolicy", "QuantizedModel",
    "RoundMode", "TensorQuantConfig", "fake_quant", "get_policy", "qdq",
    "qdq_blocked", "qdq_mode_string", "quantize_model",
]
