"""Decoder-only transformer (the flagship model family), emulation form.

Llama-class architecture: RMSNorm, rotary position embeddings,
grouped-query attention, SwiGLU MLP.  Every contraction is an
interceptable module: projections are ``Dense`` and the attention score and
context matmuls go through ``ops.wrappers.BatchMatmul``.  Submodule names
give the JAX package's Flax paths (``layer_0/attn/q_proj``);
:func:`variables_from_flax` carries Flax variables across.

This is the emulation form (parameters in f32, computation in
``cfg.dtype``).  The serving form with real fp8 payloads and the
hand-written kernels is :mod:`fp8tpu_torch.serve`.  With ``n_experts > 0``
each layer's FFN is the mixture-of-experts :class:`MoEMLP`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fp8tpu_torch._device import full_fp32, resolve_device
from fp8tpu_torch.linen import Dense, Embed, Module, init_params, remat
from fp8tpu_torch.ops.wrappers import BatchMatmul
from fp8tpu_torch.parallel.moe import top_k_routing

from .resnet import variables_from_flax  # noqa: F401  (same leaf rules)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 32000
    d_model: int = 2048
    n_layers: int = 16
    n_heads: int = 16
    n_kv_heads: int = 16
    d_ff: int = 5504           # SwiGLU hidden
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = True
    remat: bool = False        # recompute each layer in the backward
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def tdtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.dtype]


def rope_freqs(cfg: DecoderConfig, device=None) -> torch.Tensor:
    d = cfg.head_dim
    exponent = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    theta = torch.tensor(cfg.rope_theta, dtype=torch.float32, device=device)
    return torch.ones_like(exponent) / torch.pow(theta, exponent)  # (d/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S)."""
    ang = positions[..., None].to(torch.float32) * inv_freq    # (B,S,D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class RMSNorm(Module):
    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))

    def forward(self, x):
        var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * self.scale


class Attention(Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.tdtype()
        H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.q_proj = Dense(cfg.d_model, H * D, use_bias=False, dtype=dt)
        self.k_proj = Dense(cfg.d_model, KV * D, use_bias=False, dtype=dt)
        self.v_proj = Dense(cfg.d_model, KV * D, use_bias=False, dtype=dt)
        self.attn_scores_matmul = BatchMatmul()
        self.attn_context_matmul = BatchMatmul()
        self.o_proj = Dense(H * D, cfg.d_model, use_bias=False, dtype=dt)

    def forward(self, x, positions, mask):
        cfg = self.cfg
        dt = cfg.tdtype()
        B, S, _ = x.shape
        H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = self.q_proj(x).reshape(B, S, H, D)
        k = self.k_proj(x).reshape(B, S, KV, D)
        v = self.v_proj(x).reshape(B, S, KV, D)

        inv_freq = rope_freqs(cfg, x.device)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
        if KV != H:
            k = k.repeat_interleave(H // KV, dim=2)
            v = v.repeat_interleave(H // KV, dim=2)

        qh = q.permute(0, 2, 1, 3)                # (B,H,S,D)
        kh = k.permute(0, 2, 3, 1)                # (B,H,D,S)
        scores = self.attn_scores_matmul(qh, kh).to(torch.float32)
        scores = scores / torch.full_like(scores, math.sqrt(D))
        scores = torch.where(mask, scores,
                             torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, dim=-1).to(dt)
        vh = v.permute(0, 2, 1, 3)                # (B,H,S,D)
        ctx = self.attn_context_matmul(probs, vh)
        ctx = ctx.permute(0, 2, 1, 3).reshape(B, S, H * D)
        return self.o_proj(ctx)


class MLP(Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        dt = cfg.tdtype()
        self.gate_proj = Dense(cfg.d_model, cfg.d_ff, use_bias=False, dtype=dt)
        self.up_proj = Dense(cfg.d_model, cfg.d_ff, use_bias=False, dtype=dt)
        self.down_proj = Dense(cfg.d_ff, cfg.d_model, use_bias=False, dtype=dt)

    def forward(self, x):
        gate = self.gate_proj(x)
        return self.down_proj(gate * torch.sigmoid(gate) * self.up_proj(x))


class MoEMLP(Module):
    """Mixture-of-experts FFN (GShard-style capacity-bounded top-k
    routing; ``fp8tpu_torch.parallel.moe`` holds the routing).  The expert
    contractions go through :class:`BatchMatmul` modules named
    ``experts_up`` / ``experts_down``, so the quantization interceptor
    covers them with the batchmatmul-input policy.  Each call records the
    router's aux load-balancing loss as ``aux_loss`` (the Flax module sows
    it into ``intermediates``); :func:`moe_aux_loss` collects it."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        E, Dm, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = Dense(Dm, E, use_bias=False, dtype=torch.float32)
        self.up = nn.Parameter(torch.randn(E, Dm, F_) * Dm ** -0.5)
        self.down = nn.Parameter(torch.randn(E, F_, Dm) * F_ ** -0.5)
        self.experts_up = BatchMatmul()
        self.experts_down = BatchMatmul()
        self.aux_loss: Optional[torch.Tensor] = None

    def forward(self, x):
        cfg = self.cfg
        dt = cfg.tdtype()
        B, S, Dm = x.shape
        E, k = cfg.n_experts, cfg.moe_top_k
        T = B * S
        xt = x.reshape(T, Dm)
        capacity = max(int(cfg.moe_capacity_factor * k * T / E), k)

        logits = self.router(xt.to(torch.float32))
        dispatch, combine, aux = top_k_routing(logits, k, capacity)
        self.aux_loss = aux

        with full_fp32():
            xe = torch.einsum("tec,td->ecd", dispatch,
                              xt.to(torch.float32)).to(dt)
            h = self.experts_up(xe, self.up.to(dt))
            h = F.gelu(h.to(torch.float32), approximate="tanh").to(dt)
            ye = self.experts_down(h, self.down.to(dt))
            y = torch.einsum("ecd,tec->td", ye.to(torch.float32), combine)
        return y.reshape(B, S, Dm).to(x.dtype)


class DecoderLayer(Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.norm_eps)
        self.attn = Attention(cfg)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.norm_eps)
        if cfg.n_experts > 0:
            self.moe = MoEMLP(cfg)
        else:
            self.mlp = MLP(cfg)

    def forward(self, x, positions, mask):
        h = x + self.attn(self.attn_norm(x), positions, mask)
        ffn = self.moe if hasattr(self, "moe") else self.mlp
        return h + ffn(self.mlp_norm(h))


class Decoder(Module):
    """Causal decoder LM.  ``forward`` returns logits (B, S, V) in f32."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.tdtype()
        self.embed = Embed(cfg.vocab_size, cfg.d_model, dtype=dt)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", DecoderLayer(cfg))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps)
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.d_model, cfg.vocab_size, use_bias=False,
                                 dtype=dt)

    def forward(self, tokens, positions: Optional[torch.Tensor] = None):
        cfg = self.cfg
        B, S = tokens.shape
        if positions is None:
            positions = torch.arange(S, device=tokens.device).expand(B, S)
        mask = torch.ones(S, S, dtype=torch.bool,
                          device=tokens.device).tril()[None, None]
        h = self.embed(tokens)
        for i in range(cfg.n_layers):
            layer = getattr(self, f"layer_{i}")
            if cfg.remat and torch.is_grad_enabled():
                h = remat(layer, h, positions, mask)
            else:
                h = layer(h, positions, mask)
        h = self.final_norm(h)
        if cfg.tie_embeddings:
            logits = self.embed.attend(h.to(cfg.tdtype()))
        else:
            logits = self.lm_head(h)
        return logits.to(torch.float32)


def moe_aux_loss(model: nn.Module) -> torch.Tensor:
    """Mean of the Switch load-balancing losses that the :class:`MoEMLP`
    layers of ``model`` recorded in their last call (about 1 when the
    router is perfectly balanced; 0 for a model without experts).

    Add ``aux_weight * moe_aux_loss(model)`` to the task loss after a
    forward: without it, capacity-bounded routing collapses onto a few
    experts and drops the rest's tokens."""
    leaves = [m.aux_loss.to(torch.float32) for m in model.modules()
              if isinstance(m, MoEMLP) and m.aux_loss is not None]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack(leaves).mean()


def decoder(cfg: DecoderConfig, device="cuda",
            generator: Optional[torch.Generator] = None) -> Decoder:
    """A Decoder on ``device`` (the card unless the caller asks for the
    CPU), its Dense weights (and expert stacks) redrawn from ``generator``
    when one is given.  It is built and drawn where the generator lives,
    so a generator on the card makes a full-width model without an f32
    copy on the host."""
    dev = resolve_device(device)
    with torch.device(generator.device if generator is not None else "cpu"):
        model = Decoder(cfg)
    if generator is not None:
        init_params(model, generator)
        with torch.no_grad():
            model.embed.embedding.normal_(
                0.0, 1.0 / math.sqrt(cfg.d_model), generator=generator)
            for m in model.modules():
                if isinstance(m, MoEMLP):
                    m.up.normal_(0.0, cfg.d_model ** -0.5,
                                 generator=generator)
                    m.down.normal_(0.0, cfg.d_ff ** -0.5,
                                   generator=generator)
    return model.to(dev)


def tiny_config(**kw) -> DecoderConfig:
    """Test-sized decoder."""
    base = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=4,
                n_kv_heads=2, d_ff=256, max_seq_len=128)
    base.update(kw)
    return DecoderConfig(**base)
