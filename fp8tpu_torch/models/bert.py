"""BERT-style encoder with interceptable attention matmuls, and the
SQuAD span-prediction head (``BertForQA``).

The port of the JAX package's ``fp8tpu/models/bert.py``, itself the
reference's quantization-ready BERT rewrite
(examples/inference/bert/modeling_bert.py): the attention score and
context products are ``ops.wrappers.BatchMatmul`` modules
(``attn_scores_matmul``, ``attn_probs_matmul``) and the residual adds are
``EltwiseAdd`` (``attn_residual_add``, ``ffn_residual_add``), so the PTQ
policy reaches inside attention by module path, e.g. leaving every
``*attn_scores_matmul`` output uncast as run_squad.py:436-472 does.  Under
hw patching each BatchMatmul runs one K2 GEMM per (batch, head) slice.

Submodule names give the Flax paths (``bert/layer_0/attention/query``);
``models.variables_from_flax`` carries Flax variables across.  With
``dtype="bfloat16"`` the projections and both products run in bf16 and
the scores are masked and normalised in f32, as the JAX package rounds.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from fp8tpu_torch._device import resolve_device
from fp8tpu_torch.linen import Dense, Embed, LayerNorm, Module
from fp8tpu_torch.ops.wrappers import BatchMatmul, EltwiseAdd

from .vision import gelu_exact


# BERT's initializer range (HF BertConfig.initializer_range): the std of
# every weight and table of a random model.  Drawn at 1/sqrt(fan_in)
# instead, a 12-layer BERT decorrelates from its fp32 forward under
# hybrid PTQ's per-tensor casts (chip_smoke.py's bert phase prints it).
INIT_STD = 0.02


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_position: int = 512
    type_vocab: int = 2
    layer_norm_eps: float = 1e-12
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def tdtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.dtype]


class BertSelfAttention(Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        dt, d, hd = cfg.tdtype(), cfg.d_model, cfg.n_heads * cfg.head_dim
        self.query = Dense(d, hd, dtype=dt)
        self.key = Dense(d, hd, dtype=dt)
        self.value = Dense(d, hd, dtype=dt)
        self.attn_scores_matmul = BatchMatmul()
        self.attn_probs_matmul = BatchMatmul()
        self.output_dense = Dense(hd, d, dtype=dt)

    def forward(self, x, mask):
        cfg = self.cfg
        B, S, _ = x.shape
        H, D = cfg.n_heads, cfg.head_dim
        q = self.query(x).reshape(B, S, H, D)
        k = self.key(x).reshape(B, S, H, D)
        v = self.value(x).reshape(B, S, H, D)

        qh = q.permute(0, 2, 1, 3)                # (B, H, S, D)
        kh = k.permute(0, 2, 3, 1)                # (B, H, D, S)
        scores = self.attn_scores_matmul(qh, kh)
        # jnp.sqrt(D) is an f32 rounded to the scores' dtype; a tensor
        # divisor keeps the divide a divide on the card
        root = torch.tensor(math.sqrt(D), dtype=torch.float32,
                            device=scores.device).to(scores.dtype)
        scores = scores / root
        # the f32 fill promotes bf16 scores to f32, as the numpy scalar
        # jnp.finfo(float32).min does in jnp.where
        scores = torch.where(mask[:, None, None, :],
                             scores.to(torch.promote_types(scores.dtype,
                                                           torch.float32)),
                             torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, dim=-1)
        vh = v.permute(0, 2, 1, 3)                # (B, H, S, D)
        ctx = self.attn_probs_matmul(probs.to(cfg.tdtype()), vh)
        ctx = ctx.permute(0, 2, 1, 3).reshape(B, S, H * D)
        return self.output_dense(ctx)


class BertLayer(Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        dt, d = cfg.tdtype(), cfg.d_model
        self.attention = BertSelfAttention(cfg)
        self.attn_residual_add = EltwiseAdd()
        self.attn_norm = LayerNorm(d, epsilon=cfg.layer_norm_eps)
        self.intermediate = Dense(d, cfg.d_ff, dtype=dt)
        self.output = Dense(cfg.d_ff, d, dtype=dt)
        self.ffn_residual_add = EltwiseAdd()
        self.ffn_norm = LayerNorm(d, epsilon=cfg.layer_norm_eps)

    def forward(self, x, mask):
        x = self.attn_residual_add(x, self.attention(x, mask))
        x = self.attn_norm(x)
        # exact (erf) gelu: HF BERT's "gelu"
        h = self.output(gelu_exact(self.intermediate(x)))
        return self.ffn_norm(self.ffn_residual_add(x, h))


class BertEncoder(Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.word_embed = Embed(cfg.vocab_size, d)
        self.pos_embed = Embed(cfg.max_position, d)
        self.type_embed = Embed(cfg.type_vocab, d)
        self.embed_norm = LayerNorm(d, epsilon=cfg.layer_norm_eps)
        for i in range(cfg.n_layers):
            self.add_module(f"layer_{i}", BertLayer(cfg))

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        B, S = input_ids.shape
        dev = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones(B, S, dtype=torch.bool, device=dev)
        if token_type_ids is None:
            token_type_ids = torch.zeros(B, S, dtype=torch.long, device=dev)
        positions = torch.arange(S, device=dev).expand(B, S)
        x = self.embed_norm(self.word_embed(input_ids)
                            + self.pos_embed(positions)
                            + self.type_embed(token_type_ids))
        mask = attention_mask.to(torch.bool)
        for i in range(self.cfg.n_layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        return x


class BertForQA(Module):
    """Span prediction head (run_squad.py's ``qa_outputs``, exempt from
    quantization in the reference recipe, run_squad.py:436-466):
    ``forward`` returns the (start, end) logits, each (B, S)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.bert = BertEncoder(cfg)
        self.qa_outputs = Dense(cfg.d_model, 2)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        x = self.bert(input_ids, attention_mask, token_type_ids)
        logits = self.qa_outputs(x)
        return logits[..., 0], logits[..., 1]


def bert_for_qa(cfg: BertConfig, device="cuda",
                generator: Optional[torch.Generator] = None) -> BertForQA:
    """A BertForQA on ``device`` (the card unless the caller asks for the
    CPU), built where ``generator`` lives and moved.  With a generator its
    Dense weights and embedding tables are redrawn from it as BERT draws
    them (normal, std ``INIT_STD``); without one they keep the layers' own
    draws (std 1/sqrt(fan_in), Flax's defaults)."""
    dev = resolve_device(device)
    with torch.device(generator.device if generator is not None else dev):
        model = BertForQA(cfg)
    if generator is not None:
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, (Dense, Embed)):
                    w = m.weight if isinstance(m, Dense) else m.embedding
                    w.normal_(0.0, INIT_STD, generator=generator)
    return model.to(dev)


def tiny_bert(**kw) -> BertConfig:
    base = dict(vocab_size=1024, d_model=128, n_layers=2, n_heads=4,
                d_ff=256, max_position=128)
    base.update(kw)
    return BertConfig(**base)


def bert_base_config(**kw) -> BertConfig:
    """google-bert/bert-base-uncased shape (the BertConfig defaults)."""
    return BertConfig(**kw)


def bert_large_config(**kw) -> BertConfig:
    """bert-large-uncased shape, the model class the reference's SQuAD
    recipe quantizes (run_squad.py:436-489): 24 layers x d 1024 / 16
    heads."""
    base = dict(d_model=1024, n_layers=24, n_heads=16, d_ff=4096)
    base.update(kw)
    return BertConfig(**base)


# The reference's BERT PTQ recipe (run_squad.py:436-472): exempt the QA
# head and leave the attention-score matmul outputs uncast.
BERT_QA_EXEMPT = ("qa_outputs",)
BERT_OUTPUT_FUSED = ("*attn_scores_matmul",)

