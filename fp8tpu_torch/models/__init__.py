"""Models of the PTQ slice."""

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

__all__ = [
    "MLP", "RESNET_EXEMPT", "RESNET_OUTPUT_FUSED", "BasicBlock",
    "Bottleneck", "ResNet", "ResNetConfig", "mlp", "resnet18", "resnet50",
    "tiny_resnet", "variables_from_flax",
]
