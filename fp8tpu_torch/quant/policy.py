"""Per-layer quantization policy.

The equivalent of the reference's emulator policy machinery: the
whitelist/blacklist + per-module qconfig dict + special-case passes of
``create_or_update_hooks`` (e5m2_emu.py:235-303, e4m3_emu.py:77-136) become
one immutable :class:`QuantPolicy` that *resolves* a module path + layer
kind to a ModuleQuantConfig.  Resolution is pure and hashable.

The resolution order mirrors the reference exactly:

  1. exempt layers (glob patterns) drop out entirely;
  2. layers whose outputs feed precision-sensitive fused ops lose
     oact/ograd quantization;
  3. kind-specific passes: embeddings quantize weights only (with the
     dedicated ``emb`` config), LayerNorm keeps activations but never
     weights, batched matmuls quantize inputs only, weightless eltwise
     ops lose weight configs;
  4. explicit per-name overrides win last.

Emulator presets (the reference's per-format emulator classes
e5m2_emu/e4m3_emu/e3m4_emu/hybrid_emu/bfloat16_emu) are factory functions
returning policies.
"""

from __future__ import annotations

import dataclasses
import enum
import fnmatch
from typing import Optional, Tuple

from .config import ModuleQuantConfig, TensorQuantConfig


class LayerKind(enum.Enum):
    """What a module is, for kind-specific policy passes (the analog of
    the reference's isinstance checks against its whitelist)."""

    DENSE = "dense"            # nn.Linear / flax Dense
    CONV = "conv"              # nn.Conv2d / flax Conv
    EMBED = "embed"            # nn.Embedding / flax Embed
    LAYERNORM = "layernorm"
    MATMUL = "matmul"          # functional a@b wrapper (module_wrappers.Matmul)
    BATCH_MATMUL = "batch_matmul"
    ELTWISE = "eltwise"        # add/mul/div wrappers
    NORM_OP = "norm_op"        # Norm/Mean aggregate wrappers
    OTHER = "other"

    @property
    def has_weight(self) -> bool:
        return self in (LayerKind.DENSE, LayerKind.CONV, LayerKind.EMBED,
                        LayerKind.LAYERNORM)


# Kinds quantized by default, per the reference whitelists
# (e5m2_emu.py:27-32, e4m3_emu.py:26-30).
DEFAULT_WHITELIST = (
    LayerKind.DENSE, LayerKind.CONV, LayerKind.EMBED, LayerKind.MATMUL,
    LayerKind.BATCH_MATMUL, LayerKind.ELTWISE,
)
TRAINING_WHITELIST = DEFAULT_WHITELIST + (LayerKind.LAYERNORM,)


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Immutable per-layer policy."""

    default: ModuleQuantConfig
    emb: Optional[TensorQuantConfig] = None
    whitelist: Tuple[LayerKind, ...] = DEFAULT_WHITELIST
    exempt_layers: Tuple[str, ...] = ()       # glob patterns on module path
    output_fused_layers: Tuple[str, ...] = ()  # ditto
    overrides: Tuple[Tuple[str, Optional[ModuleQuantConfig]], ...] = ()
    # Kinds whose ACTIVATION-GRADIENT streams (igrad/ograd) stay
    # unquantized while everything else follows the default.  The r4 role
    # ablation + budget study localized the late-phase training stall to
    # the norm/residual activation-grad casts; this field expresses the
    # direct causal test (hybrid everywhere EXCEPT those streams) without
    # changing the whitelist.
    actgrad_exempt_kinds: Tuple[LayerKind, ...] = ()
    is_training: bool = False
    name: str = "custom"

    # -- construction helpers -------------------------------------------
    def with_exempt(self, *patterns: str) -> "QuantPolicy":
        return dataclasses.replace(
            self, exempt_layers=self.exempt_layers + tuple(patterns))

    def with_output_fused(self, *patterns: str) -> "QuantPolicy":
        return dataclasses.replace(
            self,
            output_fused_layers=self.output_fused_layers + tuple(patterns))

    def with_override(self, pattern: str,
                      cfg: Optional[ModuleQuantConfig]) -> "QuantPolicy":
        return dataclasses.replace(
            self, overrides=self.overrides + ((pattern, cfg),))

    def with_hw_patching(self, enable: bool = True) -> "QuantPolicy":
        """Route matmul-kind modules through the fused fake-quant GEMM
        engine (the reference's enable_hw_patching, e4m3_emu.py:151-158 —
        there a C-model GEMM; here kernels.qmatmul)."""
        return dataclasses.replace(
            self, default=self.default.replace(patch_ops=enable))

    # -- resolution ------------------------------------------------------
    def resolve(self, path: str,
                kind: LayerKind) -> Optional[ModuleQuantConfig]:
        """Resolve the effective config for a module; None = unquantized."""
        if kind not in self.whitelist:
            cfg = None
        else:
            cfg = self.default
            if any(fnmatch.fnmatch(path, p) for p in self.exempt_layers):
                cfg = None

        if cfg is not None:
            if any(fnmatch.fnmatch(path, p)
                   for p in self.output_fused_layers):
                cfg = cfg.replace(oact=None, ograd=None)
            if kind == LayerKind.EMBED:
                cfg = cfg.replace(wt=self.emb, iact=None, oact=None,
                                  igrad=None, ograd=None)
            elif kind == LayerKind.LAYERNORM:
                cfg = cfg.replace(wt=None, wtgrad=None)
            elif kind == LayerKind.BATCH_MATMUL:
                cfg = cfg.replace(wt=None, wtgrad=None, oact=None,
                                  ograd=None)
            elif not kind.has_weight:
                cfg = cfg.replace(wt=None, wtgrad=None)
            if kind in self.actgrad_exempt_kinds:
                cfg = cfg.replace(igrad=None, ograd=None)

        for pattern, override in self.overrides:
            if fnmatch.fnmatch(path, pattern):
                cfg = override
        return cfg


# ---------------------------------------------------------------------------
# Emulator presets
# ---------------------------------------------------------------------------

def e5m2_training_policy(scaled: bool = False) -> QuantPolicy:
    """'Direct' FP8 training: everything E5M2, RNE forward / stochastic
    backward (e5m2_emu.py:56-61; Mellempudi et al., arXiv:1905.12334).
    Forward RNE casts use the hardware-convert fast path (spec-exact
    single rounding; ~30x fewer HLO ops per cast than the bit-exact
    reference pipeline — training-step compile time was pathological
    with hundreds of bit-pipeline casts in one graph).

    ``scaled=True`` adds per-tensor max scaling to every role (the
    direct-recipe ablation: centring each tensor in E5M2's range before
    the 2-mantissa-bit cast — tools/accuracy_gates.py measures its
    effect on the convergence gap)."""
    sc = "per-tensor" if scaled else "none"
    rne = TensorQuantConfig("e5m2", "rne", sc, cast_impl="hw")
    sto = TensorQuantConfig("e5m2", "stochastic", sc, cast_impl="hw")
    return QuantPolicy(
        default=ModuleQuantConfig(wt=rne, iact=rne, oact=rne,
                                  igrad=sto, ograd=sto, wtgrad=sto),
        emb=None,
        whitelist=TRAINING_WHITELIST,
        is_training=True,
        name="e5m2-scaled" if scaled else "e5m2",
    )


def hybrid_training_policy(scaled_bwd: bool = False) -> QuantPolicy:
    """Hybrid training: E4M3 per-tensor forward / E5M2 stochastic backward
    (hybrid_emu.py:56-61; Micikevicius et al., arXiv:2209.05433).

    Note the plain hybrid and direct recipes share an identical UNSCALED
    e5m2-stochastic backward stream — the 7M ablation found per-tensor
    scaling is the dominant convergence lever, which predicts the two
    recipes converge to near-identical losses whenever the backward path
    is the bottleneck.  ``scaled_bwd=True`` is the cell that tests this:
    same forward, per-tensor-scaled backward."""
    fwd = TensorQuantConfig("e4m3", "rne", "per-tensor", cast_impl="hw")
    sc = "per-tensor" if scaled_bwd else "none"
    bwd = TensorQuantConfig("e5m2", "stochastic", sc, cast_impl="hw")
    return QuantPolicy(
        default=ModuleQuantConfig(wt=fwd, iact=fwd, oact=fwd,
                                  igrad=bwd, ograd=bwd, wtgrad=bwd),
        emb=None,
        whitelist=TRAINING_WHITELIST,
        is_training=True,
        name="hybrid-scaled" if scaled_bwd else "hybrid",
    )


def gemm_only_training_policy() -> QuantPolicy:
    """GEMM-stream-only FP8 training ("hybrid-gemm"): e4m3 per-tensor on
    dense/conv weights + inputs, per-tensor-scaled e5m2-SR on their
    gradient streams — and NOTHING else quantized (no LayerNorm
    streams, no output-activation casts, no eltwise/batch-matmul).

    This is how production FP8 trainers scope quantization (only the
    matmul operands see fp8).  The r4 budget-extension study motivates
    it: with the reference's everything-on-the-whitelist scoping, EVERY
    recipe — scaled or not — stops converging around loss ~4.2 at 83M
    while bf16 trains through (ACCURACY_BUDGET.json), although a PTQ
    pass over the fully-trained bf16 model costs only +0.17 ppl: an
    optimization-under-noise ceiling, not an expressiveness limit of
    fp8 matmuls.  r5 localization note: on the llama-class decoder the
    norm/residual streams were never actually quantized by the full
    whitelist (RMSNorm is a custom module outside the LAYERNORM kind;
    residual adds are unwrapped), so what this recipe removes relative
    to "hybrid" there is the attention BATCH_MATMUL streams, the dense
    oact/igrad casts, and the embedding wtgrad — see "hybrid-no-bmm"
    for the single-factor cell."""
    fwd = TensorQuantConfig("e4m3", "rne", "per-tensor", cast_impl="hw")
    bwd = TensorQuantConfig("e5m2", "stochastic", "per-tensor",
                            cast_impl="hw")
    return QuantPolicy(
        default=ModuleQuantConfig(wt=fwd, iact=fwd, oact=None,
                                  igrad=None, ograd=bwd, wtgrad=bwd),
        emb=None,
        whitelist=(LayerKind.DENSE, LayerKind.CONV),
        is_training=True,
        name="hybrid-gemm",
    )


def e4m3_inference_policy(calibrated: bool = True) -> QuantPolicy:
    """E4M3 PTQ: per-channel weights, per-tensor activations, outputs
    unquantized (e4m3_emu.py:46-49, 175-185)."""
    scaling_w = "per-channel" if calibrated else "none"
    scaling_a = "per-tensor" if calibrated else "none"
    wt = TensorQuantConfig("e4m3", "rne", scaling_w)
    act = TensorQuantConfig("e4m3", "rne", scaling_a)
    return QuantPolicy(
        default=ModuleQuantConfig(wt=wt, iact=act, oact=None),
        emb=TensorQuantConfig("e4m3", "rne", scaling_w),
        name="e4m3",
    )


def e3m4_inference_policy(calibrated: bool = True) -> QuantPolicy:
    """E3M4 PTQ (e3m4_emu.py:45-48, 159-169)."""
    scaling_w = "per-channel" if calibrated else "per-tensor"
    wt = TensorQuantConfig("e3m4", "rne", scaling_w)
    act = TensorQuantConfig("e3m4", "rne", "per-tensor")
    return QuantPolicy(
        default=ModuleQuantConfig(wt=wt, iact=act, oact=None),
        emb=TensorQuantConfig("e3m4", "rne", scaling_w),
        name="e3m4",
    )


def hybrid_inference_policy() -> QuantPolicy:
    """Hybrid PTQ: E3M4 per-channel weights + E4M3 per-tensor activations
    (hybrid_emu.py:400-413)."""
    wt = TensorQuantConfig("e3m4", "rne", "per-channel")
    act = TensorQuantConfig("e4m3", "rne", "per-tensor")
    return QuantPolicy(
        default=ModuleQuantConfig(wt=wt, iact=act, oact=None),
        emb=TensorQuantConfig("e3m4", "rne", "per-channel"),
        name="hybrid",
    )


def bfloat16_policy() -> QuantPolicy:
    """BF16-everywhere (the reference's Bfloat16Emulator is dead code with
    missing native modules, bfloat16_emu.py:127,142 — implemented working
    here)."""
    rne = TensorQuantConfig("bfloat16", "rne")
    sto = TensorQuantConfig("bfloat16", "stochastic")
    return QuantPolicy(
        default=ModuleQuantConfig(wt=rne, iact=rne, oact=rne,
                                  igrad=sto, ograd=sto, wtgrad=sto),
        emb=rne,
        whitelist=TRAINING_WHITELIST,
        is_training=True,
        name="bfloat16",
    )


PRESETS = {
    "e5m2": e5m2_training_policy,
    "e4m3": e4m3_inference_policy,
    "e3m4": e3m4_inference_policy,
    "hybrid": hybrid_training_policy,
    "hybrid_inference": hybrid_inference_policy,
    "bfloat16": bfloat16_policy,
}


def get_policy(dtype: str, training: bool = False) -> QuantPolicy:
    """Policy factory keyed like mpt_emu's dtype/training_algo strings
    (mpt_emu.py:146-231)."""
    d = dtype.lower()
    if training:
        if d in ("e5m2", "direct"):
            return e5m2_training_policy()
        if d in ("e5m2-scaled", "direct-scaled"):
            return e5m2_training_policy(scaled=True)
        if d == "hybrid":
            return hybrid_training_policy()
        if d == "hybrid-scaled":
            return hybrid_training_policy(scaled_bwd=True)
        # Diagnostic half-recipes (role ablation, tools/accuracy_gates
        # --role_ablation): quantize only the forward or only the
        # backward streams of the hybrid recipe to localize which stream
        # carries the convergence cost at scale.
        if d == "hybrid-fwd-only":
            p = hybrid_training_policy()
            return dataclasses.replace(p, default=p.default.replace(
                igrad=None, ograd=None, wtgrad=None), name="hybrid-fwd-only")
        if d == "hybrid-bwd-only":
            p = hybrid_training_policy()
            return dataclasses.replace(p, default=p.default.replace(
                wt=None, iact=None, oact=None), name="hybrid-bwd-only")
        if d == "hybrid-no-igrad":
            # single-factor r5 mechanism cells: hybrid minus exactly one
            # stream.  hybrid-gemm differs from hybrid (on the decoder)
            # by {batch-matmul streams, dense oact, dense igrad, embed
            # wtgrad}; no-bmm stalled at 6000 steps, so the transition
            # blocker is among the dense deltas — these two separate
            # igrad (input cotangent casts) from oact (forward output
            # casts).
            p = hybrid_training_policy()
            return dataclasses.replace(p, default=p.default.replace(
                igrad=None), name="hybrid-no-igrad")
        if d == "hybrid-no-oact":
            p = hybrid_training_policy()
            return dataclasses.replace(p, default=p.default.replace(
                oact=None), name="hybrid-no-oact")
        if d == "hybrid-no-wtgrad":
            p = hybrid_training_policy()
            return dataclasses.replace(p, default=p.default.replace(
                wtgrad=None), name="hybrid-no-wtgrad")
        if d == "hybrid-no-actgrad":
            p = hybrid_training_policy()
            return dataclasses.replace(p, default=p.default.replace(
                igrad=None, ograd=None), name="hybrid-no-actgrad")
        if d == "hybrid-no-bmm":
            # Mechanism cell for the llama-class decoder (r5): the
            # decoder's RMSNorm is a custom module (LayerKind.OTHER —
            # never whitelisted) and its residual adds are bare `+`, so
            # "hybrid-no-normres" is a NO-OP there (proven: bit-identical
            # MoE result).  The real hybrid-vs-hybrid-gemm differences
            # on the decoder are (a) the attention BATCH_MATMUL streams
            # (score/context matmul iact+igrad), (b) dense oact+igrad
            # casts, (c) embed wtgrad.  This recipe drops only (a).
            p = hybrid_training_policy()
            return dataclasses.replace(
                p, whitelist=tuple(k for k in p.whitelist
                                   if k != LayerKind.BATCH_MATMUL),
                name="hybrid-no-bmm")
        if d == "hybrid-no-normres":
            # The mechanism cell (VERDICT r4 next #9): keep the reference's
            # whole-whitelist hybrid scoping on every stream EXCEPT the
            # norm/residual/aggregate activation-gradient casts.  If this
            # recipe crosses the synthetic corpus's 3000-6000 phase
            # transition like hybrid-gemm does, the role-ablation reading
            # ("quantized norm/residual grad streams block late-phase
            # optimization") is demonstrated causally, not just scoped
            # around.
            p = hybrid_training_policy()
            return dataclasses.replace(
                p, actgrad_exempt_kinds=(LayerKind.LAYERNORM,
                                         LayerKind.ELTWISE,
                                         LayerKind.NORM_OP),
                name="hybrid-no-normres")
        if d in ("hybrid-gemm", "gemm-only", "te"):
            return gemm_only_training_policy()
        if d in ("bfloat16", "bf16"):
            return bfloat16_policy()
        raise ValueError(f"unsupported training algo {dtype!r}")
    if d == "e4m3":
        return e4m3_inference_policy()
    if d == "e3m4":
        return e3m4_inference_policy()
    if d == "hybrid":
        return hybrid_inference_policy()
    if d == "e5m2":
        p = e5m2_training_policy()
        return dataclasses.replace(p, is_training=False, name="e5m2")
    if d in ("bfloat16", "bf16"):
        p = bfloat16_policy()
        return dataclasses.replace(p, is_training=False, name="bfloat16")
    raise ValueError(f"unsupported inference dtype {dtype!r}")
