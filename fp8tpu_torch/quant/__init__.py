"""Quantization policy, fake-quant, interception, calibration, the
hw-patched engine routing and AWQ equalization for serving artifacts."""

from .awq import awq_calibrate_decoder, awq_equalize, collect_awq_stats
from .config import ROLES, ModuleQuantConfig, TensorQuantConfig
from .fakequant import fake_quant, fake_quant_with_scale, quantize_grad
from .policy import LayerKind, QuantPolicy, get_policy

__all__ = [
    "awq_calibrate_decoder", "awq_equalize", "collect_awq_stats",
    "LayerKind", "ModuleQuantConfig", "QuantPolicy", "ROLES",
    "TensorQuantConfig",
    "fake_quant", "fake_quant_with_scale", "get_policy", "quantize_grad",
]
