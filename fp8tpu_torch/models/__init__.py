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
    resnext50_32x4d,
    tiny_resnet,
    tiny_resnext,
    variables_from_flax,
    variables_to_flax,
    wide_resnet50_2,
)

from .transformer import (
    Attention,
    Decoder,
    DecoderConfig,
    DecoderLayer,
    MoEMLP,
    RMSNorm,
    apply_rope,
    decoder,
    moe_aux_loss,
    rope_freqs,
    tiny_config,
)

__all__ = [
    "Attention", "Decoder", "DecoderConfig", "DecoderLayer", "MoEMLP",
    "RMSNorm", "apply_rope", "decoder", "moe_aux_loss", "rope_freqs",
    "tiny_config",
    "MLP", "RESNET_EXEMPT", "RESNET_OUTPUT_FUSED", "BasicBlock",
    "Bottleneck", "ResNet", "ResNetConfig", "mlp", "resnet18", "resnet50",
    "resnext50_32x4d", "tiny_resnet", "tiny_resnext", "variables_from_flax",
    "variables_to_flax", "wide_resnet50_2",
]
