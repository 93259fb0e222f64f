"""Models of the port: the PTQ workloads (ResNet, MLP) and the decoder
that the serving stack converts."""

from .mlp import MLP, mlp
from .resnet import (
    RESNET_EXEMPT,
    RESNET_OUTPUT_FUSED,
    BasicBlock,
    Bottleneck,
    ResNet,
    ResNetConfig,
    resnet18,
    resnet50,
    tiny_resnet,
    variables_from_flax,
)

from .transformer import (
    Attention,
    Decoder,
    DecoderConfig,
    DecoderLayer,
    RMSNorm,
    apply_rope,
    decoder,
    rope_freqs,
    tiny_config,
)

__all__ = [
    "Attention", "Decoder", "DecoderConfig", "DecoderLayer", "RMSNorm",
    "apply_rope", "decoder", "rope_freqs", "tiny_config",
    "MLP", "RESNET_EXEMPT", "RESNET_OUTPUT_FUSED", "BasicBlock",
    "Bottleneck", "ResNet", "ResNetConfig", "mlp", "resnet18", "resnet50",
    "tiny_resnet", "variables_from_flax",
]
