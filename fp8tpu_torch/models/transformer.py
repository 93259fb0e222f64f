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

``Decoder(cfg, mesh=)`` is the tensor-parallel form over the mesh's
``model`` group (the global program GSPMD runs from
``DECODER_PARAM_RULES`` in the JAX package, its collectives written
out): each rank holds its shard of every parameter the rules split
(``parallel.sharding.local_shards``), q / k / v, gate / up and an untied
``lm_head`` are column-parallel (:class:`ColumnDense`), ``o_proj`` and
``down_proj`` row-parallel (:class:`RowDense`, summed over the group),
the embedding vocabulary-sharded (:class:`VocabEmbed`).  Attention runs
on the rank's heads; where the group does not split whole KV heads, k / v
are gathered first, and where it does not split whole query heads the
attention runs whole on every rank.  A rule that ``_shrink_spec`` repairs
to replication leaves that layer whole.  With a ``seq`` axis above one
the sequence is split over the mesh's seq group as well (sequence
parallelism, ``batch_sharding(seq_parallel=True)``): each rank holds a
chunk of positions (:func:`parallel.seq_chunk`, the last chunk shorter
where the length does not divide), its positions and causal-mask rows
are the chunk's, and the attention BatchMatmuls gather k and v whole
(:class:`SeqBatchMatmul`); RMSNorm, the MLP and the projections are per
token.  Every collective carries its backward
(``parallel.collectives``), so a train step through this form is the
global step.  Modules carry the split of their operands for the
quantization interceptor: ``tp_in`` / ``tp_out``, the dimension of the
input / output split over the model group (None: replicated),
``tp_weight``, the Flax-layout dimension of the weight, and under a
sequence split ``seq_in`` / ``seq_out``, the dimension split over the
seq group (per argument for a BatchMatmul), with ``seq_split``
(:class:`SeqSplit`).
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
from fp8tpu_torch.parallel import collectives as coll
from fp8tpu_torch.parallel.data import seq_chunk
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


# -- tensor parallelism over the mesh's model group -------------------------

@dataclasses.dataclass(frozen=True)
class TPLayout:
    """Which layers of a decoder the rules split over the model group of
    ``mesh`` (from the full shapes, repaired as ``_shrink_spec`` repairs
    them), the group and this rank's place in it."""

    group: object
    size: int
    index: int
    embed: bool        # vocabulary rows
    q: bool            # q_proj's columns
    kv: bool           # k_proj's / v_proj's columns
    o: bool            # o_proj's rows
    gate_up: bool      # gate_proj's / up_proj's columns
    down: bool         # down_proj's rows
    lm_head: bool      # an untied lm_head's columns

    @classmethod
    def of(cls, cfg: "DecoderConfig", mesh) -> "TPLayout":
        from fp8tpu_torch.parallel.sharding import (DECODER_PARAM_RULES,
                                                    split_dim)
        if cfg.n_experts > 0:
            raise NotImplementedError(
                "the MoE decoder under a tensor-parallel mesh "
                "(MOE_PARAM_RULES): ROADMAP §1 item 7d")
        dm, hd, kvd = cfg.d_model, cfg.n_heads * cfg.head_dim, \
            cfg.n_kv_heads * cfg.head_dim

        def split(path, shape, dim):
            return split_dim(path, shape, mesh, DECODER_PARAM_RULES) == dim

        return cls(
            mesh.group("model"), mesh.shape["model"], mesh.index("model"),
            embed=split("embed/embedding", (cfg.vocab_size, dm), 0),
            q=split("layer_0/attn/q_proj/kernel", (dm, hd), 1),
            kv=split("layer_0/attn/k_proj/kernel", (dm, kvd), 1),
            o=split("layer_0/attn/o_proj/kernel", (hd, dm), 0),
            gate_up=split("layer_0/mlp/gate_proj/kernel", (dm, cfg.d_ff), 1),
            down=split("layer_0/mlp/down_proj/kernel", (cfg.d_ff, dm), 0),
            lm_head=split("lm_head/kernel", (dm, cfg.vocab_size), 1))

    def block(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the last dimension of a replicated ``t``
        (backward: the blocks gathered)."""
        return coll.block(t, self.group, -1)

    def sum(self, t: torch.Tensor, dtype) -> torch.Tensor:
        """The sum over the group of every rank's ``t`` in f32 (a
        row-parallel product's f32 partials, or a lookup's one nonzero
        addend), rounded once to ``dtype`` (backward: the identity)."""
        return coll.sum_f32(t, self.group, dtype)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' blocks of the last dimension put together (backward:
        the rank's block)."""
        return coll.gather(t, self.group, -1)

    def gather_parts(self, t: torch.Tensor) -> torch.Tensor:
        """:meth:`gather` for a consumer that uses another part on each
        rank (backward: the rank's block of the summed gradient)."""
        return coll.gather_parts(t, self.group, -1)

    def column_input(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (replicated over the group) as f32 for a column-parallel
        product; the backward sums the ranks' partial input gradients in
        f32 and rounds once to ``x``'s type."""
        return coll.column_input(x, self.group)


class SeqSplit:
    """The seq group of a mesh (``size`` ranks, this one ``index``) and
    the global ``length`` of the sequence that the current forward splits
    over it, which :meth:`Decoder.forward` sets: every offset, mask and
    gather takes the global length, the last chunk short where it does
    not divide."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index
        self.length: Optional[int] = None

    @classmethod
    def of(cls, mesh) -> Optional["SeqSplit"]:
        """The mesh's seq split, None when its seq axis is one rank."""
        if mesh.shape.get("seq", 1) == 1:
            return None
        return cls(mesh.group("seq"), mesh.shape["seq"], mesh.index("seq"))

    def begin(self, local: int, length: Optional[int]) -> int:
        """Set the global length (``local`` times the group's size when
        None) for a forward whose chunk holds ``local`` positions; returns
        the chunk's first global position."""
        self.length = local * self.size if length is None else length
        chunk = seq_chunk(self.length, self.size)
        start = chunk * self.index
        if local != max(0, min(chunk, self.length - start)) or local == 0:
            raise ValueError(f"a chunk of {local} positions on seq rank "
                             f"{self.index} of {self.size} over "
                             f"{self.length}")
        return start


class SeqBatchMatmul(BatchMatmul):
    """The attention's BatchMatmul under a sequence split: ``a`` is the
    rank's rows (q, or the scores' probabilities), ``b`` a sequence chunk
    (k transposed, or v) that the module gathers whole along
    ``gather_dim`` before the product (:meth:`gathered`), inside the
    interceptor's casts: the iact cast sees the chunk, and the igrad cast
    the chunk of the ranks' summed gradient.  The product is f32 (the
    gathered b is f32), rounded once to ``a``'s type, so that the ranks'
    partial gradients of b are summed before any rounding.  The decoder
    without a sequence split keeps the plain BatchMatmul."""

    def __init__(self, seq_split: SeqSplit, gather_dim: int):
        super().__init__()
        self.seq_split, self.gather_dim = seq_split, gather_dim
        self.seq_in, self.seq_out = (2, gather_dim), 2

    def gathered(self, b: torch.Tensor) -> torch.Tensor:
        sp = self.seq_split
        return coll.seq_gather(b, sp.group, self.gather_dim, sp.length)

    def forward(self, a, b):
        with full_fp32():
            return torch.matmul(a.to(torch.float32),
                                self.gathered(b)).to(a.dtype)


def _relayout(t: torch.Tensor, split: bool, want: bool,
              tp: Optional[TPLayout]) -> torch.Tensor:
    """A last dimension held split (``split``) or whole, as the consumer
    wants it (``want``)."""
    if split == want:
        return t
    return tp.gather(t) if split else tp.block(t)


class ColumnDense(Dense):
    """A column-parallel Dense: this rank's output columns, (out/T, in);
    no collective in the forward (the output stays split).  The input is
    replicated over the group, so its gradient is the sum of the ranks'
    partial products: with more than one rank the product is computed in
    f32 on the layer's-type operands, rounded once to the layer's type,
    and the partial input gradients are summed in f32 and rounded once
    (``TPLayout.column_input``), here, below the interceptor's igrad
    cast.  A group of one computes as the unsharded Dense."""

    tp_in, tp_out, tp_weight = None, -1, 1

    def __init__(self, in_features: int, features: int, tp: TPLayout,
                 use_bias: bool = True, dtype=None):
        super().__init__(in_features, features, use_bias, dtype)
        self.tp = tp

    def forward(self, x):
        if self.tp.size == 1:
            return super().forward(x)
        w, b = self.weight, self.bias
        dt = self.dtype or x.dtype
        x32 = self.tp.column_input(x.to(dt))
        w32 = w.to(dt).to(torch.float32)
        with full_fp32():
            out = F.linear(x32, w32).to(dt)
        return out if b is None else out + b.to(dt)


class RowDense(Dense):
    """A row-parallel Dense: this rank's input rows, (out, in/T); the
    partial products, each an f32 sum of exact products of the layer's
    type, are summed over the model group in f32 and rounded once to the
    layer's type (the unsharded product up to the f32 order), then the
    bias is added once.  A group of one holds the whole product, computed
    in the layer's type as the unsharded Dense computes it."""

    tp_in, tp_out, tp_weight = -1, None, 0

    def __init__(self, in_features: int, features: int, tp: TPLayout,
                 use_bias: bool = True, dtype=None):
        super().__init__(in_features, features, use_bias, dtype)
        self.tp = tp

    def forward(self, x):
        w, b = self.weight, self.bias
        dt = self.dtype or x.dtype
        x, w = x.to(dt), w.to(dt)
        if self.tp.size > 1:
            x, w = x.to(torch.float32), w.to(torch.float32)
        with full_fp32():
            part = F.linear(x, w)
        out = self.tp.sum(part, dt)
        return out if b is None else out + b.to(out.dtype)


class VocabEmbed(Embed):
    """A vocabulary-sharded embedding: rows ``index * V/T ..`` of the
    table.  A lookup takes the rank's rows (zero elsewhere) and sums over
    the model group; ``attend`` (the tied LM head) gathers the rank's
    vocabulary columns."""

    tp_in, tp_out, tp_weight = None, None, 0

    def __init__(self, num_embeddings: int, features: int, tp: TPLayout,
                 dtype=None):
        super().__init__(num_embeddings // tp.size, features, dtype)
        self.tp = tp

    def forward(self, tokens):
        n = self.embedding.shape[0]
        local = tokens - self.tp.index * n
        mine = (local >= 0) & (local < n)
        rows = self._table()[torch.where(mine, local, 0)]
        rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
        return self.tp.sum(rows, rows.dtype)

    def attend(self, query):
        if self.tp.size == 1:
            return self.tp.gather(super().attend(query))
        table = self._table()
        q32 = self.tp.column_input(query.to(table.dtype))
        with full_fp32():
            out = torch.matmul(q32, table.to(torch.float32).t())
        return self.tp.gather(out.to(table.dtype))


def _dense(tp: Optional[TPLayout], split: bool, kind: str, i: int, o: int,
           dt):
    """A Dense of (in ``i``, out ``o``), column- or row-parallel when
    ``split``."""
    if tp is None or not split:
        return Dense(i, o, use_bias=False, dtype=dt)
    if kind == "column":
        return ColumnDense(i, o // tp.size, tp, use_bias=False, dtype=dt)
    return RowDense(i // tp.size, o, tp, use_bias=False, dtype=dt)


class RMSNorm(Module):
    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))

    def forward(self, x):
        var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * self.scale


class Attention(Module):
    def __init__(self, cfg: DecoderConfig, tp: Optional[TPLayout] = None,
                 seq: Optional[SeqSplit] = None):
        super().__init__()
        self.cfg, self.tp = cfg, tp
        dt = cfg.tdtype()
        H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        T = 1 if tp is None else tp.size
        # the rank's query heads (all of them where the group does not
        # split whole query heads); their KV heads are the rank's own where
        # it splits whole KV heads, else gathered
        self.heads_local = tp is not None and tp.q and H % T == 0
        self.kv_local = self.heads_local and tp.kv and KV % T == 0
        self.q_proj = _dense(tp, tp is not None and tp.q, "column",
                             cfg.d_model, H * D, dt)
        self.k_proj = _dense(tp, tp is not None and tp.kv, "column",
                             cfg.d_model, KV * D, dt)
        self.v_proj = _dense(tp, tp is not None and tp.kv, "column",
                             cfg.d_model, KV * D, dt)
        # k arrives transposed (B, H, D, S), v as (B, H, S, D): the
        # sequence dimension each gathers under a split
        self.attn_scores_matmul = BatchMatmul() if seq is None \
            else SeqBatchMatmul(seq, gather_dim=3)
        self.attn_context_matmul = BatchMatmul() if seq is None \
            else SeqBatchMatmul(seq, gather_dim=2)
        for bmm in (self.attn_scores_matmul, self.attn_context_matmul):
            bmm.tp_in = bmm.tp_out = 1 if self.heads_local else None
        self.o_proj = _dense(tp, tp is not None and tp.o, "row",
                             H * D, cfg.d_model, dt)

    def _kv(self, t, S):
        """k or v as (B, S, heads, D) for the rank's query heads (before
        the GQA repeat where the KV heads are the rank's own)."""
        cfg, tp = self.cfg, self.tp
        B = t.shape[0]
        if tp is not None and tp.kv and not self.kv_local:
            # the rank's query heads use their part of the gathered KV
            # heads; where every rank runs every head, all of them
            t = tp.gather_parts(t) if self.heads_local else tp.gather(t)
        return t.reshape(B, S, -1, cfg.head_dim)

    def forward(self, x, positions, mask):
        cfg, tp = self.cfg, self.tp
        dt = cfg.tdtype()
        B, S, _ = x.shape
        H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = self.q_proj(x)
        if tp is not None and tp.q and not self.heads_local:
            q = tp.gather(q)
        q = q.reshape(B, S, -1, D)
        k, v = self._kv(self.k_proj(x), S), self._kv(self.v_proj(x), S)

        inv_freq = rope_freqs(cfg, x.device)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
        if KV != H:
            k = k.repeat_interleave(H // KV, dim=2)
            v = v.repeat_interleave(H // KV, dim=2)
        if self.heads_local and not self.kv_local:
            n = H // tp.size
            k = k[:, :, tp.index * n:(tp.index + 1) * n]
            v = v[:, :, tp.index * n:(tp.index + 1) * n]
        H = q.shape[2]

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
        return self.o_proj(_relayout(ctx, self.heads_local,
                                     tp is not None and tp.o, tp))


class MLP(Module):
    def __init__(self, cfg: DecoderConfig, tp: Optional[TPLayout] = None):
        super().__init__()
        dt = cfg.tdtype()
        self.tp = tp
        cols = tp is not None and tp.gate_up
        self.gate_proj = _dense(tp, cols, "column", cfg.d_model, cfg.d_ff, dt)
        self.up_proj = _dense(tp, cols, "column", cfg.d_model, cfg.d_ff, dt)
        self.down_proj = _dense(tp, tp is not None and tp.down, "row",
                                cfg.d_ff, cfg.d_model, dt)

    def forward(self, x):
        tp = self.tp
        gate = self.gate_proj(x)
        act = gate * torch.sigmoid(gate) * self.up_proj(x)
        return self.down_proj(_relayout(act, tp is not None and tp.gate_up,
                                        tp is not None and tp.down, tp))


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
    def __init__(self, cfg: DecoderConfig, tp: Optional[TPLayout] = None,
                 seq: Optional[SeqSplit] = None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.norm_eps)
        self.attn = Attention(cfg, tp, seq)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.norm_eps)
        if cfg.n_experts > 0:
            self.moe = MoEMLP(cfg)
        else:
            self.mlp = MLP(cfg, tp)

    def forward(self, x, positions, mask):
        h = x + self.attn(self.attn_norm(x), positions, mask)
        ffn = self.moe if hasattr(self, "moe") else self.mlp
        return h + ffn(self.mlp_norm(h))


class Decoder(Module):
    """Causal decoder LM.  ``forward`` returns logits (B, S, V) in f32.

    With ``mesh`` (a ``parallel.Mesh`` with its process groups) it is the
    tensor-parallel form over the mesh's model group (module docstring):
    its parameters are this rank's shards, and every rank of a model group
    returns the same whole logits of its own rows of the batch."""

    def __init__(self, cfg: DecoderConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        tp = self.tp = None if mesh is None else TPLayout.of(cfg, mesh)
        self.seq_split = None if mesh is None else SeqSplit.of(mesh)
        dt = cfg.tdtype()
        if tp is not None and tp.embed:
            self.embed = VocabEmbed(cfg.vocab_size, cfg.d_model, tp,
                                    dtype=dt)
        else:
            self.embed = Embed(cfg.vocab_size, cfg.d_model, dtype=dt)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}",
                            DecoderLayer(cfg, tp, self.seq_split))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps)
        if not cfg.tie_embeddings:
            self.lm_head = _dense(tp, tp is not None and tp.lm_head,
                                  "column", cfg.d_model, cfg.vocab_size, dt)
        if self.seq_split is not None:
            # every module below the decoder takes and gives (B, S, ...)
            # activations, split over seq along dim 1, but the attention's
            # BatchMatmuls, whose operands say their own
            for m in self.modules():
                if (m is not self and isinstance(m, Module)
                        and not isinstance(m, SeqBatchMatmul)):
                    m.seq_split = self.seq_split
                    m.seq_in = m.seq_out = 1

    def forward(self, tokens, positions: Optional[torch.Tensor] = None,
                seq_len: Optional[int] = None):
        """``tokens`` (B, S); under a sequence split the rank's chunk of a
        sequence of ``seq_len`` positions (the local length times the seq
        group's size when None), its positions from the chunk's first."""
        cfg = self.cfg
        B, S = tokens.shape
        dev = tokens.device
        rows = torch.arange(S, device=dev)
        length = S
        if self.seq_split is not None:
            rows = rows + self.seq_split.begin(S, seq_len)
            length = self.seq_split.length
        if positions is None:
            positions = rows.expand(B, S)
        mask = (rows[:, None] >= torch.arange(length, device=dev)[None, :]
                )[None, None]
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
            if self.tp is not None and self.tp.lm_head:
                logits = self.tp.gather(logits)
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
