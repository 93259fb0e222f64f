"""Quantization policy, fake-quant, interception, calibration and the
hw-patched engine routing."""

from .config import ROLES, ModuleQuantConfig, TensorQuantConfig
from .fakequant import fake_quant, fake_quant_with_scale, quantize_grad
from .policy import LayerKind, QuantPolicy, get_policy

__all__ = [
    "LayerKind", "ModuleQuantConfig", "QuantPolicy", "ROLES",
    "TensorQuantConfig",
    "fake_quant", "fake_quant_with_scale", "get_policy", "quantize_grad",
]
