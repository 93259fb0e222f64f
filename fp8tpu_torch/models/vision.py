"""The vision families of the reference's sweep beyond ResNet, and ViT.

The reference's launch.py iterates 12 torchvision architectures
(examples/inference/classifier/launch.py:14-80); the structurally distinct
ones beyond ResNets are here: the plain-conv VGG stack, the depthwise-
separable MobileNet, the branchy Inception and dense-concat DenseNet, the
split-and-shuffle ShuffleNet, the norm-free SqueezeNet, the inverted-
residual MBConv stack (mobilenet_v2 / mobilenet_v3 / efficientnet_b0) and a
ViT-B/16-class encoder.  Each uses :class:`SwitchableNorm`, so the PTQ
recipe's BN -> ScaleShift fold applies, and exempts its first conv and its
classifier.

Submodule names give the JAX package's Flax paths (``features_0``,
``b3_se_reduce``, ``blk0_fc1``), so policies, exempt lists, the module table
and SR stream ids resolve as there; ``models.variables_from_flax`` carries
Flax variables across.  Layouts are PyTorch's (NCHW, OIHW) and every
operation is the JAX package's: convs pad ``"SAME"`` as Flax does (a
stride-2 3x3 conv on an even input pads (0, 1), not torchvision's (1, 1)),
pools are ``VALID`` (floor mode) except Inception's branch pool (``SAME``,
padded with -inf), and the activations are ``jax.nn``'s op for op.

Depthwise and grouped convs (MobileNet, ShuffleNet, MBConv) are outside the
fused engine's geometry: under hw patching ``quant.hw_patch.conv_patchable``
sends them to ``F.conv2d``, as the reference's C-model falls back for
groups != 1 (cmodel/simple.py:98-103).  They, the exempt convs and ViT's
attention products run in IEEE f32 (``full_fp32``), not TF32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fp8tpu_torch._device import full_fp32, resolve_device
from fp8tpu_torch.linen import Conv, Dense, LayerNorm, Module, init_params
from fp8tpu_torch.ops.scale_shift import SwitchableNorm

# The reference exempts the first conv + classifier for every
# architecture (imagenet_test.py:24-71).
VGG_EXEMPT: Tuple[str, ...] = ("features_0", "classifier")
MOBILENET_EXEMPT: Tuple[str, ...] = ("conv_stem", "classifier")
INCEPTION_EXEMPT: Tuple[str, ...] = ("conv_stem", "classifier")
DENSENET_EXEMPT: Tuple[str, ...] = ("conv_stem", "classifier")
SHUFFLENET_EXEMPT: Tuple[str, ...] = ("conv_stem", "classifier")
SQUEEZENET_EXEMPT: Tuple[str, ...] = ("conv_stem", "classifier")
MBCONV_EXEMPT: Tuple[str, ...] = ("conv_stem", "classifier")
# the patch-embed conv is the "first conv"
VIT_EXEMPT: Tuple[str, ...] = ("patch_embed", "classifier")


# -- jax.nn's activations, op for op --------------------------------------------

def _const(x: torch.Tensor, v: float) -> torch.Tensor:
    """``v`` rounded once to x's dtype, as a 0-d tensor on x's device (the
    constant XLA folds into the op)."""
    return torch.full((), v, dtype=x.dtype, device=x.device)


def relu6(x):
    """``jnp.minimum(jnp.maximum(x, 0), 6.)``."""
    return torch.clamp_max(torch.clamp_min(x, 0.0), 6.0)


def hard_swish(x):
    """``x * (relu6(x + 3.) / 6.)`` as ``jax.nn.hard_swish`` computes it:
    the function is jitted, and XLA multiplies by f32(1/6) for the divide
    (tests/test_torch_vision.py holds both forms against it)."""
    return x * (relu6(x + 3.0) * _const(x, 1.0 / 6.0))


def silu(x):
    """``x * sigmoid(x)`` (``jax.nn.silu``)."""
    return x * torch.sigmoid(x)


def gelu_exact(x):
    """``0.5 * x * erfc(-x * sqrt(0.5))`` in x's dtype: ``jax.nn.gelu`` with
    ``approximate=False`` (not ``F.gelu``, whose form is another)."""
    sqrt_half = _const(x, math.sqrt(0.5))
    return 0.5 * x * torch.special.erfc(-x * sqrt_half)


_ACTS = {"relu6": relu6, "hardswish": hard_swish, "silu": silu}


def _cbr(owner: nn.Module, name: str, cin: int, ch: int, k: int,
         norm_mode: str, stride: int = 1, groups: int = 1):
    """The Flax families' ``cbr``: a conv (no bias, SAME) named ``name``
    and its SwitchableNorm ``{name}_norm``, registered on ``owner``;
    :func:`_apply_cbr` runs them and the relu."""
    owner.add_module(name, Conv(cin, ch, (k, k), stride, use_bias=False,
                                feature_group_count=groups))
    owner.add_module(f"{name}_norm", SwitchableNorm(ch, norm_mode))


def _apply_cbr(owner: nn.Module, name: str, x):
    x = getattr(owner, name)(x)
    return F.relu(getattr(owner, f"{name}_norm")(x))


# -- VGG ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VGGConfig:
    # channels per stage; 0 marks a pooling boundary
    plan: Tuple[int, ...] = (64, 0, 128, 0, 256, 256, 0, 512, 512, 0)
    num_classes: int = 1000
    norm_mode: str = "bn"
    width_mult: float = 1.0


class VGG(Module):
    """VGG-style plain conv stack (conv-norm-relu, maxpool boundaries)."""

    def __init__(self, cfg: VGGConfig, in_channels: int = 3):
        super().__init__()
        self.cfg = cfg
        cin, idx = in_channels, 0
        for c in cfg.plan:
            if c == 0:
                continue
            ch = max(int(c * cfg.width_mult), 8)
            self.add_module(f"features_{idx}",
                            Conv(cin, ch, (3, 3), use_bias=False))
            self.add_module(f"norm_{idx}", SwitchableNorm(ch, cfg.norm_mode))
            cin, idx = ch, idx + 1
        self.classifier = Dense(cin, cfg.num_classes)

    def forward(self, x):
        idx = 0
        for c in self.cfg.plan:
            if c == 0:
                x = F.max_pool2d(x, 2, 2)
                continue
            x = getattr(self, f"features_{idx}")(x)
            x = F.relu(getattr(self, f"norm_{idx}")(x))
            idx += 1
        return self.classifier(x.mean(dim=(2, 3)))


# -- MobileNet ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MobileNetConfig:
    # (channels, stride) per depthwise-separable block
    plan: Tuple[Tuple[int, int], ...] = (
        (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
        (512, 1), (512, 1), (1024, 2), (1024, 1))
    stem_width: int = 32
    num_classes: int = 1000
    norm_mode: str = "bn"


class MobileNet(Module):
    """MobileNetV1-style depthwise-separable stack."""

    def __init__(self, cfg: MobileNetConfig, in_channels: int = 3):
        super().__init__()
        self.cfg = cfg
        nm = cfg.norm_mode
        self.conv_stem = Conv(in_channels, cfg.stem_width, (3, 3), 2,
                              use_bias=False)
        self.norm_stem = SwitchableNorm(cfg.stem_width, nm)
        cin = cfg.stem_width
        for i, (ch, stride) in enumerate(cfg.plan):
            # depthwise: one filter per input channel (groups == channels)
            self.add_module(f"dw_{i}", Conv(cin, cin, (3, 3), stride,
                                            use_bias=False,
                                            feature_group_count=cin))
            self.add_module(f"dw_norm_{i}", SwitchableNorm(cin, nm))
            self.add_module(f"pw_{i}", Conv(cin, ch, (1, 1), use_bias=False))
            self.add_module(f"pw_norm_{i}", SwitchableNorm(ch, nm))
            cin = ch
        self.classifier = Dense(cin, cfg.num_classes)

    def forward(self, x):
        x = F.relu(self.norm_stem(self.conv_stem(x)))
        for i in range(len(self.cfg.plan)):
            x = F.relu(getattr(self, f"dw_norm_{i}")(
                getattr(self, f"dw_{i}")(x)))
            x = F.relu(getattr(self, f"pw_norm_{i}")(
                getattr(self, f"pw_{i}")(x)))
        return self.classifier(x.mean(dim=(2, 3)))


# -- Inception / DenseNet (branchy and dense-concat graphs) --------------------

@dataclasses.dataclass(frozen=True)
class InceptionConfig:
    # per inception block: (b1x1, b3x3_reduce, b3x3, b5x5_reduce, b5x5,
    # pool_proj); 0-tuple marks a pool boundary
    plan: Tuple[Tuple[int, ...], ...] = (
        (64, 96, 128, 16, 32, 32), (128, 128, 192, 32, 96, 64), (),
        (192, 96, 208, 16, 48, 64), (160, 112, 224, 24, 64, 64), (),
    )
    stem_width: int = 64
    num_classes: int = 1000
    norm_mode: str = "bn"


class Inception(Module):
    """GoogLeNet-style multi-branch blocks: four parallel conv paths whose
    outputs concatenate on the channel axis."""

    def __init__(self, cfg: InceptionConfig, in_channels: int = 3):
        super().__init__()
        self.cfg = cfg
        nm = cfg.norm_mode
        self.conv_stem = Conv(in_channels, cfg.stem_width, (3, 3), 2,
                              use_bias=False)
        self.norm_stem = SwitchableNorm(cfg.stem_width, nm)
        cin, bi = cfg.stem_width, 0
        for plan in cfg.plan:
            if not plan:
                continue
            c1, r3, c3, r5, c5, cp = plan
            _cbr(self, f"i{bi}_b1", cin, c1, 1, nm)
            _cbr(self, f"i{bi}_b3r", cin, r3, 1, nm)
            _cbr(self, f"i{bi}_b3", r3, c3, 3, nm)
            _cbr(self, f"i{bi}_b5r", cin, r5, 1, nm)
            _cbr(self, f"i{bi}_b5", r5, c5, 3, nm)
            _cbr(self, f"i{bi}_bp", cin, cp, 1, nm)
            cin, bi = c1 + c3 + c5 + cp, bi + 1
        self.classifier = Dense(cin, cfg.num_classes)

    def forward(self, x):
        x = F.relu(self.norm_stem(self.conv_stem(x)))
        bi = 0
        for plan in self.cfg.plan:
            if not plan:
                x = F.max_pool2d(x, 2, 2)
                continue
            b1 = _apply_cbr(self, f"i{bi}_b1", x)
            b3 = _apply_cbr(self, f"i{bi}_b3",
                            _apply_cbr(self, f"i{bi}_b3r", x))
            b5 = _apply_cbr(self, f"i{bi}_b5",
                            _apply_cbr(self, f"i{bi}_b5r", x))
            # SAME max pool: torch pads a max pool with -inf, as Flax does
            bp = _apply_cbr(self, f"i{bi}_bp", F.max_pool2d(x, 3, 1, 1))
            x = torch.cat([b1, b3, b5, bp], dim=1)
            bi += 1
        return self.classifier(x.mean(dim=(2, 3)))


@dataclasses.dataclass(frozen=True)
class DenseNetConfig:
    # layers per dense block; growth channels appended per layer
    blocks: Tuple[int, ...] = (6, 12, 24, 16)
    growth: int = 32
    stem_width: int = 64
    num_classes: int = 1000
    norm_mode: str = "bn"


class DenseNet(Module):
    """DenseNet-style dense-concat blocks: every layer consumes the
    concatenation of all previous features in its block, with 1x1
    transition convs + 2x2 average pooling between blocks."""

    def __init__(self, cfg: DenseNetConfig, in_channels: int = 3):
        super().__init__()
        self.cfg = cfg
        nm = cfg.norm_mode
        self.conv_stem = Conv(in_channels, cfg.stem_width, (3, 3), 2,
                              use_bias=False)
        self.norm_stem = SwitchableNorm(cfg.stem_width, nm)
        ch = cfg.stem_width
        for b, n_layers in enumerate(cfg.blocks):
            for i in range(n_layers):
                _cbr(self, f"d{b}_l{i}", ch + i * cfg.growth, cfg.growth, 3,
                     nm)
            cin = ch + n_layers * cfg.growth
            ch = cin
            if b != len(cfg.blocks) - 1:
                ch = ch // 2
                _cbr(self, f"trans_{b}", cin, ch, 1, nm)
        self.classifier = Dense(ch, cfg.num_classes)

    def forward(self, x):
        cfg = self.cfg
        x = F.relu(self.norm_stem(self.conv_stem(x)))
        for b, n_layers in enumerate(cfg.blocks):
            feats = [x]
            for i in range(n_layers):
                feats.append(_apply_cbr(self, f"d{b}_l{i}",
                                        torch.cat(feats, dim=1)))
            x = torch.cat(feats, dim=1)
            if b != len(cfg.blocks) - 1:
                x = F.avg_pool2d(_apply_cbr(self, f"trans_{b}", x), 2, 2)
        return self.classifier(x.mean(dim=(2, 3)))


# -- ShuffleNet ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShuffleNetConfig:
    # (out_channels, stride) per unit; channels must be even (the split)
    plan: Tuple[Tuple[int, int], ...] = (
        (116, 2), (116, 1), (116, 1), (232, 2), (232, 1), (464, 2))
    stem_width: int = 24
    num_classes: int = 1000
    norm_mode: str = "bn"


def channel_shuffle(x, groups: int = 2):
    """The NHWC ``reshape(B, H, W, g, C/g).swapaxes(3, 4)`` on the channel
    axis of NCHW: channel j * g + i takes channel i * C/g + j."""
    b, c, h, w = x.shape
    return (x.reshape(b, groups, c // groups, h, w).transpose(1, 2)
            .reshape(b, c, h, w))


class ShuffleNet(Module):
    """ShuffleNetV2-style units: channel split -> (identity | 1x1-dw-1x1
    branch) -> concat -> channel shuffle; downsampling units transform
    both branches."""

    def __init__(self, cfg: ShuffleNetConfig, in_channels: int = 3):
        super().__init__()
        self.cfg = cfg
        nm = cfg.norm_mode
        _cbr(self, "conv_stem", in_channels, cfg.stem_width, 3, nm, stride=2)
        cin = cfg.stem_width
        for i, (ch, stride) in enumerate(cfg.plan):
            half = ch // 2
            if stride == 1 and cin == ch:
                _cbr(self, f"u{i}_pw1", half, half, 1, nm)
            else:
                _cbr(self, f"u{i}_adw", cin, cin, 3, nm, stride, groups=cin)
                _cbr(self, f"u{i}_apw", cin, half, 1, nm)
                _cbr(self, f"u{i}_pw1", cin, half, 1, nm)
            _cbr(self, f"u{i}_dw", half, half, 3, nm, stride, groups=half)
            _cbr(self, f"u{i}_pw2", half, half, 1, nm)
            cin = ch
        self.classifier = Dense(cin, cfg.num_classes)

    def forward(self, x):
        x = _apply_cbr(self, "conv_stem", x)
        cin = self.cfg.stem_width
        for i, (ch, stride) in enumerate(self.cfg.plan):
            if stride == 1 and cin == ch:
                a, b = torch.chunk(x, 2, dim=1)
            else:
                a = _apply_cbr(self, f"u{i}_apw",
                               _apply_cbr(self, f"u{i}_adw", x))
                b = x
            b = _apply_cbr(self, f"u{i}_pw1", b)
            b = _apply_cbr(self, f"u{i}_dw", b)
            b = _apply_cbr(self, f"u{i}_pw2", b)
            x = channel_shuffle(torch.cat([a, b], dim=1))
            cin = ch
        return self.classifier(x.mean(dim=(2, 3)))


# -- SqueezeNet / MBConv --------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SqueezeNetConfig:
    # per fire module: (squeeze, expand); 0-tuple marks a pool boundary
    plan: Tuple[Tuple[int, ...], ...] = (
        (16, 64), (16, 64), (), (32, 128), (32, 128), (),
        (48, 192), (48, 192), (64, 256), (64, 256))
    stem_width: int = 64
    num_classes: int = 1000


class SqueezeNet(Module):
    """SqueezeNet1.1-style fire modules: squeeze 1x1 -> (expand 1x1 |
    expand 3x3) concat.  Norm-free like the torchvision original: its
    convs carry bias and feed no BatchNorm, so PTQ runs without the
    BN fold.  Its max pools are 3x3 / 2 ``VALID`` (floor mode; torchvision
    uses ceil mode)."""

    def __init__(self, cfg: SqueezeNetConfig, in_channels: int = 3):
        super().__init__()
        self.cfg = cfg
        self.conv_stem = Conv(in_channels, cfg.stem_width, (3, 3), 2)
        cin = cfg.stem_width
        for i, plan in enumerate(cfg.plan):
            if not plan:
                continue
            s, e = plan
            self.add_module(f"f{i}_squeeze", Conv(cin, s, (1, 1)))
            self.add_module(f"f{i}_expand1", Conv(s, e, (1, 1)))
            self.add_module(f"f{i}_expand3", Conv(s, e, (3, 3)))
            cin = 2 * e
        # torchvision: the classifier is a 1x1 conv, then the global pool
        self.classifier = Conv(cin, cfg.num_classes, (1, 1))

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.conv_stem(x)), 3, 2)
        for i, plan in enumerate(self.cfg.plan):
            if not plan:
                x = F.max_pool2d(x, 3, 2)
                continue
            sq = F.relu(getattr(self, f"f{i}_squeeze")(x))
            e1 = F.relu(getattr(self, f"f{i}_expand1")(sq))
            e3 = F.relu(getattr(self, f"f{i}_expand3")(sq))
            x = torch.cat([e1, e3], dim=1)
        return self.classifier(x).mean(dim=(2, 3))


@dataclasses.dataclass(frozen=True)
class MBConvConfig:
    # per block: (out_channels, stride, expand_ratio, use_se)
    plan: Tuple[Tuple[int, int, int, bool], ...] = (
        (16, 1, 1, False), (24, 2, 6, False), (24, 1, 6, False),
        (40, 2, 6, True), (40, 1, 6, True), (80, 2, 6, True),
        (112, 1, 6, True), (192, 2, 6, True), (320, 1, 6, True))
    stem_width: int = 32
    num_classes: int = 1000
    norm_mode: str = "bn"
    act: str = "relu6"             # 'relu6' (v2) | 'hardswish' (v3) |
    #                                'silu' (efficientnet)
    se_ratio: float = 0.25


class MBConvNet(Module):
    """Inverted-residual (MBConv) stack: expand 1x1 -> depthwise 3x3 ->
    optional squeeze-excite (two Dense on the pooled side path, whose
    sigmoid gate multiplies the stream) -> linear project 1x1 -> residual
    add; a 1x1 head conv before the pool."""

    def __init__(self, cfg: MBConvConfig, in_channels: int = 3):
        super().__init__()
        self.cfg = cfg
        nm = cfg.norm_mode
        self.conv_stem = Conv(in_channels, cfg.stem_width, (3, 3), 2,
                              use_bias=False)
        self.norm_stem = SwitchableNorm(cfg.stem_width, nm)
        cin = cfg.stem_width
        for i, (ch, stride, t, use_se) in enumerate(cfg.plan):
            inner = cin * t
            if t != 1:
                self.add_module(f"b{i}_expand",
                                Conv(cin, inner, (1, 1), use_bias=False))
                self.add_module(f"b{i}_expand_norm",
                                SwitchableNorm(inner, nm))
            self.add_module(f"b{i}_dw", Conv(inner, inner, (3, 3), stride,
                                             use_bias=False,
                                             feature_group_count=inner))
            self.add_module(f"b{i}_dw_norm", SwitchableNorm(inner, nm))
            if use_se:
                se_ch = max(int(cin * cfg.se_ratio), 4)
                self.add_module(f"b{i}_se_reduce", Dense(inner, se_ch))
                self.add_module(f"b{i}_se_expand", Dense(se_ch, inner))
            self.add_module(f"b{i}_project",
                            Conv(inner, ch, (1, 1), use_bias=False))
            self.add_module(f"b{i}_project_norm", SwitchableNorm(ch, nm))
            cin = ch
        self.conv_head = Conv(cin, 4 * cin, (1, 1), use_bias=False)
        self.norm_head = SwitchableNorm(4 * cin, nm)
        self.classifier = Dense(4 * cin, cfg.num_classes)

    def forward(self, x):
        cfg = self.cfg
        act = _ACTS[cfg.act]
        x = act(self.norm_stem(self.conv_stem(x)))
        cin = cfg.stem_width
        for i, (ch, stride, t, use_se) in enumerate(cfg.plan):
            y = x
            if t != 1:
                y = act(getattr(self, f"b{i}_expand_norm")(
                    getattr(self, f"b{i}_expand")(y)))
            y = act(getattr(self, f"b{i}_dw_norm")(
                getattr(self, f"b{i}_dw")(y)))
            if use_se:
                s = F.relu(getattr(self, f"b{i}_se_reduce")(y.mean(dim=(2, 3))))
                s = torch.sigmoid(getattr(self, f"b{i}_se_expand")(s))
                y = y * s[:, :, None, None]
            y = getattr(self, f"b{i}_project_norm")(
                getattr(self, f"b{i}_project")(y))    # linear bottleneck
            if stride == 1 and cin == ch:
                y = y + x
            x, cin = y, ch
        x = act(self.norm_head(self.conv_head(x)))
        return self.classifier(x.mean(dim=(2, 3)))


# -- ViT ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    num_classes: int = 1000
    pool: str = "cls"               # 'cls' token | 'gap'


class ViT(Module):
    """ViT-B/16-class encoder: patch-embed conv -> [CLS] + learned
    positional embeddings -> pre-norm transformer blocks -> classifier.

    Every weight product is an interceptable ``Dense`` / ``Conv``;
    LayerNorm stays unquantized (no BN, no ScaleShift fold) and the
    attention products are plain f32 matmuls, as the JAX package's
    einsums are.  The patch grid is flattened row-major over (h, w);
    ``cls_token`` and ``pos_embed`` are top-level parameters."""

    def __init__(self, cfg: ViTConfig, in_channels: int = 3):
        super().__init__()
        self.cfg = cfg
        p, d = cfg.patch_size, cfg.d_model
        self.patch_embed = Conv(in_channels, d, (p, p), p, padding="VALID")
        n_tokens = (cfg.image_size // p) ** 2 + 1
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.randn(1, n_tokens, d) * 0.02)
        for i in range(cfg.n_layers):
            self.add_module(f"blk{i}_ln1", LayerNorm(d))
            for nm in ("q", "k", "v", "proj"):
                self.add_module(f"blk{i}_{nm}", Dense(d, d))
            self.add_module(f"blk{i}_ln2", LayerNorm(d))
            self.add_module(f"blk{i}_fc1", Dense(d, cfg.d_ff))
            self.add_module(f"blk{i}_fc2", Dense(cfg.d_ff, d))
        self.ln_f = LayerNorm(d)
        self.classifier = Dense(d, cfg.num_classes)

    def forward(self, x):
        cfg = self.cfg
        B, D = x.shape[0], cfg.d_model
        x = self.patch_embed(x).flatten(2).transpose(1, 2)  # (B, S-1, D)
        cls = self.cls_token.to(x.dtype).expand(B, 1, D)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)

        H = cfg.n_heads
        hd = D // H
        scale = hd ** -0.5
        for i in range(cfg.n_layers):
            blk = lambda nm: getattr(self, f"blk{i}_{nm}")  # noqa: E731
            y = blk("ln1")(x)
            S = y.shape[1]
            q = blk("q")(y).reshape(B, S, H, hd)
            k = blk("k")(y).reshape(B, S, H, hd)
            v = blk("v")(y).reshape(B, S, H, hd)
            with full_fp32():
                att = torch.matmul(q.permute(0, 2, 1, 3),
                                   k.permute(0, 2, 3, 1)) * scale
                att = torch.softmax(att, dim=-1)
                ctx = torch.matmul(att, v.permute(0, 2, 1, 3))
            ctx = ctx.permute(0, 2, 1, 3).reshape(B, S, -1)
            x = x + blk("proj")(ctx)
            y = gelu_exact(blk("fc1")(blk("ln2")(x)))
            x = x + blk("fc2")(y)

        x = self.ln_f(x)
        h = x[:, 0] if cfg.pool == "cls" else x[:, 1:].mean(dim=1)
        return self.classifier(h)


# -- constructors ---------------------------------------------------------------

def _build(cls, cfg, device, generator: Optional[torch.Generator]):
    """``cls(cfg)`` on ``device``; with a generator, its Dense and Conv
    weights (and ViT's positional embedding) redrawn from it, built and
    drawn where the generator lives, then moved."""
    dev = resolve_device(device)
    with torch.device(generator.device if generator is not None else dev):
        model = cls(cfg)
    if generator is not None:
        init_params(model, generator)
        if isinstance(model, ViT):
            with torch.no_grad():
                model.pos_embed.normal_(0.0, 0.02, generator=generator)
    return model.to(dev)


def vgg11(num_classes: int = 1000, device="cuda",
          generator: Optional[torch.Generator] = None, **kw) -> VGG:
    return _build(VGG, VGGConfig(plan=(64, 0, 128, 0, 256, 256, 0, 512, 512,
                                       0, 512, 512, 0),
                                 num_classes=num_classes, **kw),
                  device, generator)


def tiny_vgg(num_classes: int = 10, device="cuda",
             generator: Optional[torch.Generator] = None, **kw) -> VGG:
    return _build(VGG, VGGConfig(plan=(16, 0, 32, 0, 64, 0),
                                 num_classes=num_classes, **kw),
                  device, generator)


def mobilenet(num_classes: int = 1000, device="cuda",
              generator: Optional[torch.Generator] = None,
              **kw) -> MobileNet:
    return _build(MobileNet, MobileNetConfig(num_classes=num_classes, **kw),
                  device, generator)


def tiny_mobilenet(num_classes: int = 10, device="cuda",
                   generator: Optional[torch.Generator] = None,
                   **kw) -> MobileNet:
    return _build(MobileNet, MobileNetConfig(
        plan=((32, 1), (64, 2), (64, 1), (128, 2)), stem_width=16,
        num_classes=num_classes, **kw), device, generator)


def inception(num_classes: int = 1000, device="cuda",
              generator: Optional[torch.Generator] = None,
              **kw) -> Inception:
    return _build(Inception, InceptionConfig(num_classes=num_classes, **kw),
                  device, generator)


def tiny_inception(num_classes: int = 10, device="cuda",
                   generator: Optional[torch.Generator] = None,
                   **kw) -> Inception:
    return _build(Inception, InceptionConfig(
        plan=((16, 16, 24, 8, 8, 8), (), (32, 24, 48, 8, 16, 16)),
        stem_width=16, num_classes=num_classes, **kw), device, generator)


def densenet(num_classes: int = 1000, device="cuda",
             generator: Optional[torch.Generator] = None, **kw) -> DenseNet:
    return _build(DenseNet, DenseNetConfig(num_classes=num_classes, **kw),
                  device, generator)


def tiny_densenet(num_classes: int = 10, device="cuda",
                  generator: Optional[torch.Generator] = None,
                  **kw) -> DenseNet:
    return _build(DenseNet, DenseNetConfig(
        blocks=(3, 4), growth=12, stem_width=16, num_classes=num_classes,
        **kw), device, generator)


def shufflenet(num_classes: int = 1000, device="cuda",
               generator: Optional[torch.Generator] = None,
               **kw) -> ShuffleNet:
    return _build(ShuffleNet, ShuffleNetConfig(num_classes=num_classes,
                                               **kw), device, generator)


def tiny_shufflenet(num_classes: int = 10, device="cuda",
                    generator: Optional[torch.Generator] = None,
                    **kw) -> ShuffleNet:
    return _build(ShuffleNet, ShuffleNetConfig(
        plan=((32, 2), (32, 1), (64, 2)), stem_width=16,
        num_classes=num_classes, **kw), device, generator)


def squeezenet(num_classes: int = 1000, device="cuda",
               generator: Optional[torch.Generator] = None,
               **kw) -> SqueezeNet:
    return _build(SqueezeNet, SqueezeNetConfig(num_classes=num_classes,
                                               **kw), device, generator)


def tiny_squeezenet(num_classes: int = 10, device="cuda",
                    generator: Optional[torch.Generator] = None,
                    **kw) -> SqueezeNet:
    return _build(SqueezeNet, SqueezeNetConfig(
        plan=((8, 16), (), (16, 32)), stem_width=16,
        num_classes=num_classes, **kw), device, generator)


def mobilenet_v2(num_classes: int = 1000, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 **kw) -> MBConvNet:
    return _build(MBConvNet, MBConvConfig(num_classes=num_classes, **kw),
                  device, generator)


def mobilenet_v3(num_classes: int = 1000, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 **kw) -> MBConvNet:
    kw.setdefault("act", "hardswish")
    return _build(MBConvNet, MBConvConfig(num_classes=num_classes, **kw),
                  device, generator)


def efficientnet_b0(num_classes: int = 1000, device="cuda",
                    generator: Optional[torch.Generator] = None,
                    **kw) -> MBConvNet:
    kw.setdefault("act", "silu")
    plan = tuple((ch, st, t, True) for ch, st, t, _ in MBConvConfig().plan)
    return _build(MBConvNet, MBConvConfig(plan=plan, num_classes=num_classes,
                                          **kw), device, generator)


def tiny_mbconv(num_classes: int = 10, act: str = "relu6", device="cuda",
                generator: Optional[torch.Generator] = None,
                **kw) -> MBConvNet:
    return _build(MBConvNet, MBConvConfig(
        plan=((16, 1, 1, False), (24, 2, 4, True), (24, 1, 4, True),
              (48, 2, 4, True)),
        stem_width=16, num_classes=num_classes, act=act, **kw),
        device, generator)


def vit_b16(num_classes: int = 1000, device="cuda",
            generator: Optional[torch.Generator] = None, **kw) -> ViT:
    return _build(ViT, ViTConfig(num_classes=num_classes, **kw), device,
                  generator)


def tiny_vit(num_classes: int = 10, device="cuda",
             generator: Optional[torch.Generator] = None, **kw) -> ViT:
    return _build(ViT, ViTConfig(image_size=32, patch_size=8, d_model=64,
                                 n_layers=2, n_heads=4, d_ff=128,
                                 num_classes=num_classes, **kw),
                  device, generator)
