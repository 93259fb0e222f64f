"""Quantizable op wrappers and BatchNorm folding."""

from .scale_shift import ScaleShift, SwitchableNorm, fold_batchnorm, fold_bn_stats
from .wrappers import (
    AddMatmul,
    BatchMatmul,
    EltwiseAdd,
    EltwiseDiv,
    EltwiseMul,
    Matmul,
    Mean,
    Norm,
)

__all__ = [
    "AddMatmul", "BatchMatmul", "EltwiseAdd", "EltwiseDiv", "EltwiseMul",
    "Matmul", "Mean", "Norm", "ScaleShift", "SwitchableNorm",
    "fold_batchnorm", "fold_bn_stats",
]
