"""ResNet (torchvision-style v1 with BatchNorm), the PTQ workload.

Submodule names give the JAX package's Flax paths (``stage0_block0/conv1``,
``stage0_block0/norm1/ss``), so policies, the module table and SR stream
ids resolve identically.  Layouts are PyTorch's: NCHW inputs, OIHW
weights; :func:`variables_from_flax` carries Flax variables across.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from fp8tpu_torch._device import resolve_device
from fp8tpu_torch.linen import Conv, Dense, Module, init_params
from fp8tpu_torch.ops.scale_shift import SwitchableNorm
from fp8tpu_torch.ops.wrappers import EltwiseAdd


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Sequence[int] = (2, 2, 2, 2)   # resnet18
    num_classes: int = 1000
    width: int = 64
    bottleneck: bool = False
    norm_mode: str = "bn"          # 'bn' | 'scale_shift'
    small_images: bool = False     # CIFAR-style 3x3 stem
    groups: int = 1
    base_width: int = 64


class BasicBlock(Module):
    def __init__(self, in_features: int, features: int, strides: int,
                 norm_mode: str):
        super().__init__()
        # explicit pad 1 (not SAME), as torchvision pads stride-2 3x3 convs
        self.conv1 = Conv(in_features, features, (3, 3), strides,
                          padding=[(1, 1), (1, 1)], use_bias=False)
        self.norm1 = SwitchableNorm(features, norm_mode)
        self.conv2 = Conv(features, features, (3, 3),
                          padding=[(1, 1), (1, 1)], use_bias=False)
        self.norm2 = SwitchableNorm(features, norm_mode)
        if in_features != features or strides != 1:
            self.downsample_conv = Conv(in_features, features, (1, 1),
                                        strides, use_bias=False)
            self.downsample_norm = SwitchableNorm(features, norm_mode)
        self.residual_add = EltwiseAdd()

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        res = x
        if hasattr(self, "downsample_conv"):
            res = self.downsample_norm(self.downsample_conv(x))
        return F.relu(self.residual_add(y, res))


class Bottleneck(Module):
    def __init__(self, in_features: int, features: int, strides: int,
                 norm_mode: str, groups: int = 1, base_width: int = 64):
        super().__init__()
        inner = int(features * base_width / 64.0) * groups
        self.conv1 = Conv(in_features, inner, (1, 1), use_bias=False)
        self.norm1 = SwitchableNorm(inner, norm_mode)
        self.conv2 = Conv(inner, inner, (3, 3), strides,
                          padding=[(1, 1), (1, 1)], use_bias=False,
                          feature_group_count=groups)
        self.norm2 = SwitchableNorm(inner, norm_mode)
        self.conv3 = Conv(inner, features * 4, (1, 1), use_bias=False)
        self.norm3 = SwitchableNorm(features * 4, norm_mode)
        if in_features != features * 4 or strides != 1:
            self.downsample_conv = Conv(in_features, features * 4, (1, 1),
                                        strides, use_bias=False)
            self.downsample_norm = SwitchableNorm(features * 4, norm_mode)
        self.residual_add = EltwiseAdd()

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        res = x
        if hasattr(self, "downsample_conv"):
            res = self.downsample_norm(self.downsample_conv(x))
        return F.relu(self.residual_add(y, res))


class ResNet(Module):
    """``forward(x)`` on NCHW images; BatchNorm uses batch statistics in
    ``train()`` mode and running statistics in ``eval()`` mode."""

    def __init__(self, cfg: ResNetConfig, in_channels: int = 3):
        super().__init__()
        self.cfg = cfg
        if cfg.small_images:
            self.conv1 = Conv(in_channels, cfg.width, (3, 3), use_bias=False)
        else:
            self.conv1 = Conv(in_channels, cfg.width, (7, 7), (2, 2),
                              padding=[(3, 3), (3, 3)], use_bias=False)
        self.norm1 = SwitchableNorm(cfg.width, cfg.norm_mode)
        feats, in_f = cfg.width, cfg.width
        self.block_names = []
        for stage, n_blocks in enumerate(cfg.stage_sizes):
            for b in range(n_blocks):
                strides = 2 if (stage > 0 and b == 0) else 1
                if cfg.bottleneck:
                    block = Bottleneck(in_f, feats, strides, cfg.norm_mode,
                                       cfg.groups, cfg.base_width)
                    in_f = feats * 4
                else:
                    block = BasicBlock(in_f, feats, strides, cfg.norm_mode)
                    in_f = feats
                name = f"stage{stage}_block{b}"
                self.add_module(name, block)
                self.block_names.append(name)
            feats *= 2
        self.fc = Dense(in_f, cfg.num_classes)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        if not self.cfg.small_images:
            x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.fc(x.mean(dim=(2, 3)))


def _build(cfg: ResNetConfig, device, generator: Optional[torch.Generator]):
    dev = resolve_device(device)
    model = ResNet(cfg)
    if generator is not None:
        init_params(model, generator)
    return model.to(dev)


def resnet18(num_classes: int = 1000, device="cuda",
             generator: Optional[torch.Generator] = None, **kw) -> ResNet:
    return _build(ResNetConfig(stage_sizes=(2, 2, 2, 2),
                               num_classes=num_classes, **kw),
                  device, generator)


def resnet50(num_classes: int = 1000, device="cuda",
             generator: Optional[torch.Generator] = None, **kw) -> ResNet:
    return _build(ResNetConfig(stage_sizes=(3, 4, 6, 3), bottleneck=True,
                               num_classes=num_classes, **kw),
                  device, generator)


def tiny_resnet(num_classes: int = 10, device="cuda",
                generator: Optional[torch.Generator] = None, **kw) -> ResNet:
    """CIFAR-scale model for tests and examples."""
    return _build(ResNetConfig(stage_sizes=(1, 1), width=16,
                               num_classes=num_classes, small_images=True,
                               **kw),
                  device, generator)


# First conv and classifier head stay unquantized.
RESNET_EXEMPT = ("conv1", "fc")
RESNET_OUTPUT_FUSED = ("*conv*",)


_LEAF_NAMES = {("bn", "scale"): "weight", ("bn", "mean"): "running_mean",
               ("bn", "var"): "running_var"}


def variables_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """A state_dict from Flax variables of the same model (nested dicts of
    arrays, ``{"params": ..., "batch_stats": ...}``): HWIO conv kernels
    become OIHW weights, Dense (in, out) kernels (out, in) weights, and
    BatchNorm leaves take torch's names."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for name, sub in tree.items():
            if isinstance(sub, dict):
                walk(sub, path + (name,))
                continue
            t = torch.from_numpy(np.array(sub, dtype=np.float32))
            leaf = name
            if name == "kernel":
                leaf = "weight"
                t = t.permute(3, 2, 0, 1) if t.ndim == 4 else t.t()
            elif path and (path[-1], name) in _LEAF_NAMES:
                leaf = _LEAF_NAMES[(path[-1], name)]
            out[".".join(path + (leaf,))] = t.contiguous()

    for collection in ("params", "batch_stats"):
        walk(variables.get(collection, {}), ())
    return out
