"""Production serving decoder: quantized weights + quantized ring KV cache.

The real-quantization twin of :class:`fp8tpu_torch.models.Decoder`: weights
live in device memory as fp8 / int8 payloads with per-output-channel scales
(int4 nibble-packed as the capacity option), the KV cache stores fp8 / int8
with per-head-vector scales in a ring buffer (:class:`RingKVCache`), and a
decode chunk runs ``n_steps`` steps with on-device sampling and no host
synchronisation: tokens, positions, the ring head and the per-step outputs
stay on the device.

On a CUDA tensor every linear is one launch of a hand-written kernel
(:func:`fp8_linear` -> K3 ``dequant_matmul``, :func:`int4_linear` -> K5
``int4_matmul``) and a decode step's ring write is two launches of K6
``dyn_store``; on the CPU the same functions use the kernels' plain
versions.  The attention products, the tied LM head and the bf16-weight
linear of the bf16 twin are PyTorch matmuls, as they are XLA dots in the
JAX package.

Layout is the JAX package's: parameters stacked per layer, weights
``(L, K, N)``.  Where the JAX functions return a new cache, these update
``ring.kv8`` / ``ring.sc`` in place and return the same ring.

Not ported yet, each raising NotImplementedError: the paged pool and its
decode / prefill functions, MoE expert stacks, ``ring_flush > 1`` and
``matmul_impl="direct"`` (W8A8).

Design notes:

* Decode attention consumes the quantized cache: per-vector scales factor
  out of the dots, the cached prefix and the fresh token give unnormalised
  exp-sums that are combined and normalised once.  All layers of a step
  attend to the ring BEFORE the step's row is written.
* Every slot has its own position (continuous batching); masking is
  ``(head - 1 - row) mod S < min(position, S)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fp8tpu_torch._device import full_fp32, resolve_device
from fp8tpu_torch.kernels import inplace
from fp8tpu_torch.kernels import int4_matmul as int4_kernel
from fp8tpu_torch.kernels import qmatmul
from fp8tpu_torch.kernels.int4_matmul import pack_int4
from fp8tpu_torch.kernels.qmatmul import div_exact, quantize_weights
from fp8tpu_torch.models.transformer import DecoderConfig, rope_freqs
from fp8tpu_torch.numerics.formats import FORMATS

from .kv_cache import KV_DTYPES, RingKVCache, bits, quantize_kv

_FP8_DTYPES = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2,
               "int8": torch.int8}
_NEG = -1e30  # finite mask value keeps exp() NaN-free for empty slots

_LATER = {
    "paged": "the paged KV pool (PagedKVCache, the paged decode and prefill "
             "functions, the paged-attention kernel) is not ported yet; it "
             "is the next part of the serving stack to come",
    "moe": "MoE expert stacks (_moe_ffn) are not ported yet; they come with "
           "MoE serving",
    "ring_flush": "ring_flush > 1 (batched ring writes) is not ported yet",
    "direct": 'matmul_impl="direct" (W8A8 on fp8 tensor cores) is not '
              "ported yet",
}


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    model: DecoderConfig
    weight_fmt: str = "e4m3"
    kv_fmt: str = "e4m3"
    # 'convert': dequantize weights in registers (W8A16), the ported path.
    # 'direct' : fp8 operands straight to the tensor cores (W8A8); raises.
    matmul_impl: str = "convert"
    # Embedding / tied LM head storage: "bf16", or an fp8 / int8 format with
    # per-row scales.
    embed_fmt: str = "bf16"
    # K-group size for int4 weights (None: per-output-channel scales only).
    int4_group: Optional[int] = 128
    # Ring-write batching: 0 writes each step's row directly; W > 1 raises.
    # (The ring write itself is always the dyn_store kernel on a CUDA ring
    # and its plain version on the CPU: the JAX package's staging_impl has
    # no counterpart, and paged_decode_impl comes with the paged pool.)
    ring_flush: int = 0


def _check_cfg(cfg: ServeConfig, params: Optional[Dict] = None) -> None:
    if cfg.matmul_impl == "direct":
        raise NotImplementedError(_LATER["direct"])
    if cfg.matmul_impl != "convert":
        raise ValueError(f"unknown matmul_impl {cfg.matmul_impl!r}")
    if cfg.ring_flush and cfg.ring_flush > 1:
        raise NotImplementedError(_LATER["ring_flush"])
    if cfg.model.n_experts > 0 or (params is not None and "router" in params):
        raise NotImplementedError(_LATER["moe"])


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for bf16 (or f32) operands with an f32 result, accumulated
    in f32 and never rounded to bf16; ``a`` (..., M, K), ``b`` (..., K, N).
    On a CUDA tensor the bf16 operands go to the library matmul as they
    are; the CPU has no such call and contracts f32 copies."""
    if a.dtype == torch.float32:
        with full_fp32():
            return torch.matmul(a, b.to(torch.float32))
    if a.is_cuda:
        if a.ndim == 2:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def fp8_linear(x: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
               impl: str = "convert") -> torch.Tensor:
    """x @ dequant(w8) with no bf16 weight copy in device memory.

    x: (..., K) bf16; w8: (K, N) e4m3 / e5m2 / int8 (one launch of K3 on a
    CUDA tensor) or bf16 (a library matmul: the bf16 twin); scale: (1, N)
    or (N,) f32.  f32 accumulation, the scale in f32, one rounding to
    x's dtype."""
    if impl == "direct":
        raise NotImplementedError(_LATER["direct"])
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fp8_linear takes bf16 activations, got {x.dtype}")
    lead, n = x.shape[:-1], w8.shape[1]
    x2 = x.reshape(-1, x.shape[-1])
    if w8.dtype == torch.bfloat16:
        out = (_dot_f32(x2, w8) * scale.reshape(1, -1)).to(x.dtype)
    else:
        out = qmatmul.dequant_matmul(x2, w8, scale.reshape(-1), x.dtype)
    return out.reshape(*lead, n)


def quantize_weights_int4(w: torch.Tensor,
                          group_size: Optional[int] = None):
    """Symmetric int4 with nibble packing along K: two K-adjacent values
    share one byte (w[2k] in the low nibble).

    ``group_size``: None -> one scale per output channel (scales (N,));
    an int -> grouped scales, one per (K-group, output channel) (scales
    (K/group_size, N); K not divisible by group_size falls back to one
    group).  Returns (packed (K/2, N) uint8, scales f32)."""
    wf = w.to(torch.float32)
    K, N = wf.shape
    if group_size is not None:
        gs = group_size if K % group_size == 0 and K >= group_size else K
        wg = wf.reshape(K // gs, gs, N)
        amax = wg.abs().amax(dim=1)                          # (G, N)
        s = torch.where(amax > 0, div_exact(amax, 7.0), torch.ones_like(amax))
        q = torch.clip(torch.round(wg / s[:, None]), -8, 7).reshape(K, N)
    else:
        amax = wf.abs().amax(dim=0)
        s = torch.where(amax > 0, div_exact(amax, 7.0), torch.ones_like(amax))
        q = torch.clip(torch.round(wf / s), -8, 7)
    return pack_int4(q), s


def int4_linear(x: torch.Tensor, wp: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x @ dequant(int4-packed w).  ``scale`` (N,) applies per output
    channel in the epilogue; a 2-D (G, N) grouped scale multiplies the
    unpacked weights before the dot.

    On a CUDA tensor this is one launch of K5, which rounds grouped scales
    to bf16 and multiplies them in bf16 (as the JAX function does on the
    accelerator, in the activations' type).  On the CPU it computes in f32,
    as the JAX function does on the CPU."""
    if x.is_cuda:
        group = 2 * wp.shape[0] // scale.shape[0] if scale.ndim == 2 else None
        return int4_kernel.int4_matmul(x, wp, scale, group, x.dtype)
    xe = x[..., 0::2].to(torch.float32)
    xo = x[..., 1::2].to(torch.float32)
    lo, hi = (p.to(torch.float32) for p in int4_kernel.unpack_int4(wp))
    with full_fp32():
        if scale.ndim == 2:
            srow = scale.repeat_interleave(wp.shape[0] // scale.shape[0],
                                           dim=0)             # (K/2, N)
            out = torch.matmul(xe, lo * srow) + torch.matmul(xo, hi * srow)
            return out.to(x.dtype)
        out = torch.matmul(xe, lo) + torch.matmul(xo, hi)
    return (out * scale.reshape(-1)).to(x.dtype)


def _quantize_act(x: torch.Tensor, fmt: str = "e4m3"):
    """Per-row activation quantization (the W8A8 route's producer)."""
    top = FORMATS[fmt].max_normal
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax > 0, div_exact(amax, top), torch.ones_like(amax))
    q = torch.clip(xf / s, -top, top).to(_FP8_DTYPES[fmt])
    return q, s


def _embed_lookup(params, toks):
    e = params["embed"]
    rows = bits(e)[toks].view(e.dtype).to(torch.bfloat16)
    if "embed_s" in params:
        return rows * params["embed_s"][toks][..., None].to(torch.bfloat16)
    return rows


def _lm_head(params, h):
    """Tied LM head: contract on the table's feature axis directly; f32
    logits."""
    e = params["embed"]
    if e.dtype != torch.bfloat16:
        e = e.to(torch.bfloat16)
    logits = _dot_f32(h, e.t())
    if "embed_s" in params:
        logits = logits * params["embed_s"][None, :]
    return logits


def _rms(x, scale, eps):
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


_ATTN_KEYS = ("attn_norm", "q8", "qs", "k8", "ks", "v8", "vs", "o8", "os")
_DENSE_MLP_KEYS = ("mlp_norm", "gate8", "gates", "up8", "ups",
                   "down8", "downs")
_LINEARS = {"q_proj": ("q8", "qs"), "k_proj": ("k8", "ks"),
            "v_proj": ("v8", "vs"), "o_proj": ("o8", "os")}
_MLP_LINEARS = {"gate_proj": ("gate8", "gates"), "up_proj": ("up8", "ups"),
                "down_proj": ("down8", "downs")}


def convert_decoder_params(variables: Dict[str, torch.Tensor],
                           cfg: DecoderConfig, fmt: str = "e4m3",
                           embed_fmt: str = "bf16",
                           int4_group: Optional[int] = 128) -> Dict:
    """Quantize trained Decoder parameters into the serving artifact:
    stacked per-layer payloads + scales.  ``variables`` is the state_dict
    of :class:`fp8tpu_torch.models.Decoder` (Dense weights (out, in));
    the artifact's weights are (L, K, N) as in the JAX package."""
    if cfg.n_experts > 0 or any(".moe." in k for k in variables):
        raise NotImplementedError(_LATER["moe"])

    def q(w):  # (K, N)
        if fmt == "bf16":
            return (w.to(torch.bfloat16),
                    torch.ones(w.shape[-1], dtype=torch.float32,
                               device=w.device))
        if fmt == "int4":
            return quantize_weights_int4(w, group_size=int4_group)
        payload, s = quantize_weights(w, fmt, axis=-1)
        return payload, s.reshape(-1)

    layers = {k: [] for k in _ATTN_KEYS + _DENSE_MLP_KEYS}
    payload_dtype = None
    for i in range(cfg.n_layers):
        pre = f"layer_{i}."
        layers["attn_norm"].append(variables[pre + "attn_norm.scale"])
        layers["mlp_norm"].append(variables[pre + "mlp_norm.scale"])
        for block, table in (("attn", _LINEARS), ("mlp", _MLP_LINEARS)):
            for name, (tag8, tags) in table.items():
                w = variables[f"{pre}{block}.{name}.weight"].detach()
                payload, s = q(w.t())
                payload_dtype = payload.dtype
                layers[tag8].append(bits(payload))
                layers[tags].append(s)
    out = {}
    for k, v in layers.items():
        stacked = torch.stack([t.detach() for t in v])
        out[k] = stacked.view(payload_dtype) if k.endswith("8") else stacked
    emb = variables["embed.embedding"].detach()
    if embed_fmt == "bf16":
        out["embed"] = emb.to(torch.bfloat16)
    else:
        payload, es = quantize_weights(emb, embed_fmt, axis=0)
        out["embed"] = payload
        out["embed_s"] = es.reshape(-1)          # per-row (vocab) scales
    out["final_norm"] = variables["final_norm.scale"].detach()
    return out


def random_serve_params(cfg: DecoderConfig, fmt: str = "e4m3",
                        embed_fmt: str = "bf16", seed: int = 0,
                        device="cuda") -> Dict:
    """Random serving parameters built DIRECTLY in the target dtype on
    ``device``, from a generator seeded with ``seed``: for runs of models
    whose f32 form would not be worth materialising.  Weight streaming
    cost is value-independent."""
    if cfg.n_experts > 0:
        raise NotImplementedError(_LATER["moe"])
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, Dm, FF = cfg.n_layers, cfg.d_model, cfg.d_ff
    HD, KVD = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim

    def normal(shape):
        return torch.randn(shape, dtype=torch.bfloat16, device=dev,
                           generator=gen) * 0.02

    def w(k, n):
        if fmt == "int4":
            return torch.randint(0, 256, (L, k // 2, n), dtype=torch.uint8,
                                 device=dev, generator=gen)
        if fmt == "int8":
            return torch.randint(-127, 128, (L, k, n), dtype=torch.int8,
                                 device=dev, generator=gen)
        dt = torch.bfloat16 if fmt == "bf16" else _FP8_DTYPES[fmt]
        # one layer at a time: the bf16 draw is twice the payload's size
        return torch.stack([bits(normal((k, n)).to(dt))
                            for _ in range(L)]).view(dt)

    def sc(k, n):
        # int4 production scales are grouped (G, N) per layer
        if fmt == "int4":
            g = k // 128 if (k % 128 == 0 and k >= 128) else 1
            return torch.ones((L, g, n), dtype=torch.float32, device=dev)
        return torch.ones((L, n), dtype=torch.float32, device=dev)

    out = {
        "attn_norm": torch.ones((L, Dm), dtype=torch.float32, device=dev),
        "mlp_norm": torch.ones((L, Dm), dtype=torch.float32, device=dev),
        "q8": w(Dm, HD), "qs": sc(Dm, HD),
        "k8": w(Dm, KVD), "ks": sc(Dm, KVD),
        "v8": w(Dm, KVD), "vs": sc(Dm, KVD),
        "o8": w(HD, Dm), "os": sc(HD, Dm),
        "gate8": w(Dm, FF), "gates": sc(Dm, FF),
        "up8": w(Dm, FF), "ups": sc(Dm, FF),
        "down8": w(FF, Dm), "downs": sc(FF, Dm),
        "embed": normal((cfg.vocab_size, Dm)),
        "final_norm": torch.ones((Dm,), dtype=torch.float32, device=dev),
    }
    if embed_fmt != "bf16":
        if embed_fmt == "int8":
            out["embed"] = torch.randint(
                -127, 128, (cfg.vocab_size, Dm), dtype=torch.int8,
                device=dev, generator=gen)
        else:
            out["embed"] = out["embed"].to(_FP8_DTYPES[embed_fmt])
        out["embed_s"] = torch.ones((cfg.vocab_size,), dtype=torch.float32,
                                    device=dev)
    return out


_RAW = {"float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
        "float8_e5m2": (np.uint8, torch.float8_e5m2),
        "bfloat16": (np.uint16, torch.bfloat16)}


def _tensor_from_array(arr, device) -> torch.Tensor:
    """A numpy (or ml_dtypes) array as a tensor: fp8 and bf16 arrays travel
    as raw bytes, never through a float round trip."""
    arr = np.asarray(arr)
    if arr.dtype.name in _RAW:
        raw, dt = _RAW[arr.dtype.name]
        t = torch.from_numpy(np.ascontiguousarray(arr).view(raw).copy())
        if raw is np.uint16:
            t = t.view(torch.int16)
        return t.view(dt).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def serve_params_from_jax(jparams: Dict, device="cuda") -> Dict:
    """The JAX package's serving artifact (the dict its
    ``convert_decoder_params`` returns, as numpy / ml_dtypes arrays) as the
    port's tensors, leaf for leaf, in the same layout."""
    dev = resolve_device(device)
    if "router" in jparams:
        raise NotImplementedError(_LATER["moe"])
    return {k: _tensor_from_array(v, dev) for k, v in jparams.items()}


def ring_from_jax(kv8, sc, head, device="cuda") -> RingKVCache:
    """A JAX ``RingKVCache``'s arrays (numpy / ml_dtypes) as a ring."""
    dev = resolve_device(device)
    return RingKVCache(
        kv8=_tensor_from_array(kv8, dev), sc=_tensor_from_array(sc, dev),
        head=torch.as_tensor(int(np.asarray(head)), dtype=torch.int32
                             ).to(dev))


def _make_linear(cfg: ServeConfig):
    if cfg.weight_fmt == "int4":
        return lambda x, w, s: int4_linear(x, w, s)
    return lambda x, w, s: fp8_linear(x, w, s, cfg.matmul_impl)


def _layer_xs(params, li: int):
    """Layer ``li``'s parameters: views into the stacked artifact."""
    return {k: params[k][li] for k in _ATTN_KEYS + _DENSE_MLP_KEYS}


def _ffn_block(h, xs, mcfg: DecoderConfig, linear):
    """Post-attention dense SwiGLU FFN with residual."""
    x = _rms(h, xs["mlp_norm"], mcfg.norm_eps)
    act = F.silu(linear(x, xs["gate8"], xs["gates"]).to(torch.float32)
                 ).to(x.dtype) * linear(x, xs["up8"], xs["ups"])
    return h + linear(act, xs["down8"], xs["downs"])


def _rope(x, cos, sin):
    """Rotate pairs (x1, x2) of the split halves; f32 inside, x's dtype
    out.  ``cos`` / ``sin`` broadcast against x's leading dims."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def ring_valid_mask(head: torch.Tensor, lens: torch.Tensor, S: int):
    """(B, S) bool: ring row s holds a token ``(head - 1 - s) mod S`` steps
    old, valid for a slot while that age is below its ring length."""
    age = torch.remainder(
        head - 1 - torch.arange(S, device=lens.device, dtype=torch.int32), S)
    return age[None, :] < lens[:, None]


def _attend_ring(q, kq8, kqs, vq8, vqs, k8, ks, v8, vs, head, lens,
                 cfg: DecoderConfig, valid_mask=None):
    """Flash-style decode attention: ring-cached prefix + fresh token.

    q: (B,H,D) bf16 (the 1/sqrt(D) factor is applied here); fresh kq8/vq8:
    (B,KV,D) with scales kqs/vqs (B,KV); ring k8/v8: (S, B*KV, D) with
    scales ks/vs (S, B*KV); head: () int32 next write row; lens: (B,)
    valid RING lengths.  Unnormalised partials of both parts are combined
    and divided ONCE on the (B,KV,G,D) context.  The payload's upcast to
    bf16 is a copy of the layer's ring rows in device memory."""
    B, H, D = q.shape
    S, BK, _ = k8.shape
    KV = kq8.shape[1]
    G = H // KV
    qf32 = q.to(torch.float32)
    qg = (qf32 / torch.full_like(qf32, math.sqrt(D))).to(q.dtype)
    qf = qg.reshape(BK, G, D)

    scores = _dot_f32(qf, k8.to(q.dtype).permute(1, 2, 0)
                      ).reshape(B, KV, G, S) * ks.t().reshape(B, KV, 1, S)
    mask = ring_valid_mask(head, lens, S) if valid_mask is None \
        else valid_mask
    scores = torch.where(mask[:, None, None, :], scores, _NEG)

    score_self = (qg.reshape(B, KV, G, D).to(torch.float32)
                  * kq8.to(torch.float32)[:, :, None, :]
                  ).sum(-1) * kqs[:, :, None]                 # (B,KV,G)

    m = torch.maximum(scores.amax(dim=-1), score_self)
    pc = torch.exp(scores - m[..., None])
    ps = torch.exp(score_self - m)
    denom = pc.sum(-1) + ps

    pcs = (pc * vs.t().reshape(B, KV, 1, S)).to(q.dtype)
    ctx = _dot_f32(pcs.reshape(BK, G, S), v8.to(q.dtype).permute(1, 0, 2)
                   ).reshape(B, KV, G, D)
    ctx = ctx + ((ps * vqs[:, :, None])[..., None]
                 * vq8.to(torch.float32)[:, :, None, :])
    ctx = ctx / denom[..., None]
    return ctx.reshape(B, H * D).to(q.dtype)


_CANDIDATES = 64     # top-k/top-p candidate pool (k is clamped to this)


def _chosen_logprob(logits: torch.Tensor, chosen: torch.Tensor):
    """log P(chosen) under the UNSCALED model distribution: (B, V) f32
    logits + (B,) tokens -> (B,) f32."""
    lse = torch.logsumexp(logits, dim=-1)
    return logits.gather(-1, chosen[:, None].to(torch.int64))[:, 0] - lse


def _categorical(logits: torch.Tensor, generator) -> torch.Tensor:
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[:, 0]


def sample_tokens(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: torch.Tensor, top_k=None, top_p=None,
                  greedy_only: bool = False) -> torch.Tensor:
    """On-device per-slot sampling: temperature (0 -> greedy), optional
    top-k (0 disables) and nucleus top-p (>= 1 disables) filtering over a
    ``_CANDIDATES``-wide pool.  Draws come from ``generator`` (on the
    logits' device).  Filtering is strictly per slot: a slot with both
    filters disabled draws from the FULL vocabulary even when co-batched
    with filtered slots."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if greedy_only:
        return greedy
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    full = _categorical(scaled, generator).to(torch.int32)
    if top_k is None and top_p is None:
        return torch.where(temperature > 0, full, greedy)
    C = min(_CANDIDATES, logits.shape[-1])
    vals, idx = torch.topk(scaled, C, dim=-1)                 # (B, C)
    B = scaled.shape[0]
    k_off = torch.ones(B, dtype=torch.bool, device=logits.device)
    p_off = torch.ones(B, dtype=torch.bool, device=logits.device)
    rank = torch.arange(C, device=logits.device)[None]
    if top_k is not None:
        k_off = top_k <= 0
        k = torch.where(k_off | (top_k > C), C, top_k)
        vals = torch.where(rank < k[:, None], vals, _NEG)
    if top_p is not None:
        p_off = top_p >= 1
        p = torch.where((top_p <= 0) | p_off, 1.0, top_p)
        probs = torch.softmax(vals, dim=-1)
        csum = torch.cumsum(probs, dim=-1)
        # keep a token while the mass BEFORE it is < p (the argmax token
        # always survives)
        vals = torch.where((csum - probs) < p[:, None], vals, _NEG)
    choice = _categorical(vals, generator)
    pooled = idx.gather(1, choice[:, None])[:, 0].to(torch.int32)
    sampled = torch.where(k_off & p_off, full, pooled)
    return torch.where(temperature > 0, sampled, greedy)


def _ring_write_step(ring: RingKVCache, slab8: torch.Tensor,
                     slabs: torch.Tensor) -> None:
    """One decode step's cache update: the (2, L, B*KV, D) payload slab and
    the (2, L, B*KV) scale slab stored at the ring head (two launches of
    the dyn_store kernel on a CUDA ring), then ``head = (head + 1) mod S``
    as a device tensor."""
    inplace.dyn_store(ring.kv8, slab8, ring.head)
    inplace.dyn_store(ring.sc, slabs, ring.head)
    ring.head = torch.remainder(ring.head + 1, ring.max_seq)


def _steps_impl(params: Dict, ring: RingKVCache, tokens: torch.Tensor,
                positions: torch.Tensor, generator, temperature: torch.Tensor,
                n_steps: int, cfg: ServeConfig, want_logits: bool,
                top_k=None, top_p=None, greedy_only: bool = False):
    _check_cfg(cfg, params)
    mcfg = cfg.model
    H, KV, D, L = mcfg.n_heads, mcfg.n_kv_heads, mcfg.head_dim, mcfg.n_layers
    B = tokens.shape[0]
    S = ring.max_seq
    BK = B * KV
    dev = tokens.device
    linear = _make_linear(cfg)
    inv_freq = rope_freqs(mcfg, dev)
    # One step's fresh k/v of every layer; reused by every step of the
    # chunk (launches are ordered on the stream).
    slab8 = torch.empty((2, L, BK, D), dtype=ring.kv8.dtype, device=dev)
    slabs = torch.empty((2, L, BK), dtype=torch.float32, device=dev)
    slab_bits = bits(slab8)

    toks, pos = tokens.to(torch.int32), positions.to(torch.int32)
    outs = []
    for _ in range(n_steps):
        h = _embed_lookup(params, toks)
        ang = pos[:, None].to(torch.float32) * inv_freq
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        lens = torch.clamp(pos, max=S)
        mask = ring_valid_mask(ring.head, lens, S)

        for li in range(L):
            xs = _layer_xs(params, li)
            x = _rms(h, xs["attn_norm"], mcfg.norm_eps)
            q = linear(x, xs["q8"], xs["qs"]).reshape(B, H, D)
            k = linear(x, xs["k8"], xs["ks"]).reshape(B, KV, D)
            v = linear(x, xs["v8"], xs["vs"]).reshape(B, KV, D)
            q, k = _rope(q, cos, sin), _rope(k, cos, sin)

            kq8, kqs = quantize_kv(k, cfg.kv_fmt)
            vq8, vqs = quantize_kv(v, cfg.kv_fmt)

            # every layer attends to the ring as it was BEFORE this step;
            # the fresh token enters as score_self
            ctx = _attend_ring(q, kq8, kqs[..., 0], vq8, vqs[..., 0],
                               ring.kv8[:, 0, li], ring.sc[:, 0, li],
                               ring.kv8[:, 1, li], ring.sc[:, 1, li],
                               ring.head, lens, mcfg, valid_mask=mask)
            h = h + linear(ctx, xs["o8"], xs["os"])
            h = _ffn_block(h, xs, mcfg, linear)
            slab_bits[0, li] = bits(kq8).reshape(BK, D)
            slab_bits[1, li] = bits(vq8).reshape(BK, D)
            slabs[0, li] = kqs.reshape(BK)
            slabs[1, li] = vqs.reshape(BK)

        _ring_write_step(ring, slab8, slabs)

        h = _rms(h, params["final_norm"], mcfg.norm_eps)
        logits = _lm_head(params, h)
        nxt = sample_tokens(logits, generator, temperature, top_k, top_p,
                            greedy_only)
        outs.append(logits if want_logits
                    else (nxt, _chosen_logprob(logits, nxt)))
        toks, pos = nxt, pos + 1

    if want_logits:
        stacked = torch.stack(outs)
    else:
        stacked = (torch.stack([o[0] for o in outs]),
                   torch.stack([o[1] for o in outs]))
    return stacked, ring, toks, pos


@torch.no_grad()
def decode_steps(params: Dict, ring: RingKVCache, tokens: torch.Tensor,
                 positions: torch.Tensor, generator,
                 temperature: torch.Tensor, n_steps: int, cfg: ServeConfig,
                 top_k=None, top_p=None, greedy_only: bool = False
                 ) -> Tuple[torch.Tensor, RingKVCache]:
    """``n_steps`` decode steps with on-device sampling and no host
    synchronisation.  temperature: (B,) f32, 0 -> greedy.  The ring is
    updated in place.  Optional per-slot ``top_k`` (B,) int32 (0 disables)
    and nucleus ``top_p`` (B,) f32 (>= 1 disables).  Returns (sampled
    tokens (B, n_steps), ring)."""
    (toks, _), ring, _, _ = _steps_impl(
        params, ring, tokens, positions, generator, temperature, n_steps,
        cfg, want_logits=False, top_k=top_k, top_p=top_p,
        greedy_only=greedy_only)
    return toks.t(), ring


@torch.no_grad()
def decode_chunk(params: Dict, ring: RingKVCache, tokens: torch.Tensor,
                 positions: torch.Tensor, generator,
                 temperature: torch.Tensor, n_steps: int, cfg: ServeConfig,
                 top_k=None, top_p=None, greedy_only: bool = False):
    """:func:`decode_steps` plus per-token logprobs and the final device
    carry: returns (tokens (B, n_steps), logprobs (B, n_steps) f32, ring,
    last_tokens (B,), positions (B,)).  The engine chains chunks through
    the returned device carry, so a dispatch never waits for a readback
    of the previous chunk."""
    (toks, lps), ring, ftoks, fpos = _steps_impl(
        params, ring, tokens, positions, generator, temperature, n_steps,
        cfg, want_logits=False, top_k=top_k, top_p=top_p,
        greedy_only=greedy_only)
    return toks.t(), lps.t(), ring, ftoks, fpos


@torch.no_grad()
def decode_step(params: Dict, ring: RingKVCache, tokens: torch.Tensor,
                positions: torch.Tensor, cfg: ServeConfig
                ) -> Tuple[torch.Tensor, RingKVCache]:
    """One decode step for all slots; returns (logits (B, V) f32, ring).
    One step of :func:`decode_steps` (shared implementation)."""
    temperature = torch.zeros(tokens.shape, dtype=torch.float32,
                              device=tokens.device)
    logits, ring, _, _ = _steps_impl(
        params, ring, tokens, positions, None, temperature, 1, cfg,
        want_logits=True, greedy_only=True)
    return logits[0], ring


def _causal_attention(q, k, v, causal):
    """Dense causal GQA attention in f32 on (..., Sp, heads, D) operands;
    q (..., Sp, KV, G, D), k / v (..., Sp, KV, D); returns (..., Sp, KV, G,
    D) f32."""
    D = q.shape[-1]
    with full_fp32():
        scores = torch.einsum("...skgd,...tkd->...skgt", q, k)
        scores = scores / torch.full_like(scores, math.sqrt(D))
        scores = torch.where(causal[:, None, None, :], scores, _NEG)
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("...skgt,...tkd->...skgd", probs, v)


def _dense_forward(params, toks: torch.Tensor, cfg: ServeConfig):
    """Dense causal forward over (N, Sp) right-padded prompts, the shared
    prefill body.  Returns (h (N, Sp, Dm) bf16 pre-final-norm,
    pk8 (L, N, Sp, KV, D), pks (L, N, Sp, KV), pv8, pvs)."""
    _check_cfg(cfg, params)
    mcfg = cfg.model
    H, KV, D = mcfg.n_heads, mcfg.n_kv_heads, mcfg.head_dim
    N, Sp = toks.shape
    G = H // KV
    dev = toks.device
    linear = _make_linear(cfg)

    h = _embed_lookup(params, toks).to(torch.bfloat16)      # (N, Sp, Dm)
    pos = torch.arange(Sp, device=dev)
    ang = pos[:, None].to(torch.float32) * rope_freqs(mcfg, dev)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    causal = pos[None, :] <= pos[:, None]                   # (Sp, Sp)

    pk8, pks, pv8, pvs = [], [], [], []
    for li in range(mcfg.n_layers):
        xs = _layer_xs(params, li)
        x = _rms(h, xs["attn_norm"], mcfg.norm_eps)
        q = linear(x, xs["q8"], xs["qs"]).reshape(N, Sp, H, D)
        k = linear(x, xs["k8"], xs["ks"]).reshape(N, Sp, KV, D)
        v = linear(x, xs["v8"], xs["vs"]).reshape(N, Sp, KV, D)
        q, k = _rope(q, cos, sin), _rope(k, cos, sin)

        kq8, kqs = quantize_kv(k, cfg.kv_fmt)
        vq8, vqs = quantize_kv(v, cfg.kv_fmt)

        # Dense causal attention on the fresh (bf16) K/V; the cache writes
        # happen in the caller.
        ctx = _causal_attention(
            q.reshape(N, Sp, KV, G, D).to(torch.float32),
            k.to(torch.float32), v.to(torch.float32), causal)
        ctx = ctx.reshape(N, Sp, H * D).to(torch.bfloat16)
        h = h + linear(ctx, xs["o8"], xs["os"])
        h = _ffn_block(h, xs, mcfg, linear)
        pk8.append(bits(kq8))
        pks.append(kqs[..., 0])
        pv8.append(bits(vq8))
        pvs.append(vqs[..., 0])
    dt = KV_DTYPES[cfg.kv_fmt]
    return (h, torch.stack(pk8).view(dt), torch.stack(pks),
            torch.stack(pv8).view(dt), torch.stack(pvs))


def _ring_write_prompts(ring: RingKVCache, pk8, pks, pv8, pvs,
                        slots: torch.Tensor, lengths: torch.Tensor
                        ) -> RingKVCache:
    """Scatter N prompts' quantized k/v into the ring in place.  Prompt n's
    token i lands at row ``(head - lengths[n] + i) mod S`` in slot n's
    column block.  Padding rows (i >= length) and padding slots (slot >=
    n_slots) are masked out BEFORE the scatter (an out-of-range index is a
    device fault, not a dropped write); selecting the kept rows reads their
    count back, so admission synchronises here."""
    L, N, Sp, KV, D = pk8.shape
    S = ring.max_seq
    BK = ring.kv8.shape[3]
    dev = ring.kv8.device
    i = torch.arange(Sp, device=dev)
    rows = torch.remainder(ring.head - lengths[:, None] + i[None], S)
    keep = (i[None] < lengths[:, None]) & (slots[:, None] * KV < BK)
    n_idx, i_idx = keep.nonzero(as_tuple=True)              # (T,)
    r3 = rows[n_idx, i_idx].to(torch.int64)[:, None]        # (T, 1)
    c3 = (slots[n_idx].to(torch.int64) * KV)[:, None] \
        + torch.arange(KV, device=dev)[None]                # (T, KV)
    # advanced-index dims lead: values are (T, KV, 2, L, D)
    vals8 = torch.stack([bits(pk8), bits(pv8)]).permute(2, 3, 4, 0, 1, 5)
    valss = torch.stack([pks, pvs]).permute(2, 3, 4, 0, 1)
    bits(ring.kv8)[r3, :, :, c3, :] = vals8[n_idx, i_idx]
    ring.sc[r3, :, :, c3] = valss[n_idx, i_idx]
    return ring


def _first_token_logits(params, h, lengths, mcfg):
    """Logits at each prompt's last valid token: h (N, Sp, Dm) -> (N, V)."""
    idx = torch.clamp(lengths - 1, 0, h.shape[1] - 1).to(torch.int64)
    h_last = h[torch.arange(h.shape[0], device=h.device), idx]
    h_last = _rms(h_last, params["final_norm"], mcfg.norm_eps)
    return _lm_head(params, h_last)


@torch.no_grad()
def prefill(params: Dict, ring: RingKVCache, tokens: torch.Tensor,
            slot, length, cfg: ServeConfig
            ) -> Tuple[torch.Tensor, RingKVCache]:
    """Prefill one slot with a right-padded (S_p,) prompt of true length
    ``length``; returns (logits at the last valid token, ring).  The
    prompt's k/v land at ring rows ``(head - length + i) mod S``, so the
    slot's context is exactly its last ``length`` rows."""
    dev = tokens.device
    h, pk8, pks, pv8, pvs = _dense_forward(params, tokens[None], cfg)
    slots = torch.as_tensor(slot, device=dev).reshape(1).to(torch.int32)
    lengths = torch.as_tensor(length, device=dev).reshape(1).to(torch.int32)
    ring = _ring_write_prompts(ring, pk8, pks, pv8, pvs, slots, lengths)
    logits = _first_token_logits(params, h, lengths, cfg.model)
    return logits[0], ring


def _scatter_slots(carry: torch.Tensor, slots: torch.Tensor,
                   values: torch.Tensor) -> torch.Tensor:
    """``carry[slots[n]] = values[n]`` for the slots inside ``carry``;
    rows with an out-of-range slot are dropped.  No host sync."""
    hit = slots[:, None] == torch.arange(carry.shape[0],
                                         device=carry.device)[None]
    src = hit.to(torch.int32).argmax(dim=0)
    return torch.where(hit.any(dim=0), values[src].to(carry.dtype), carry)


@torch.no_grad()
def prefill_batch(params: Dict, ring: RingKVCache, prompts: torch.Tensor,
                  slots: torch.Tensor, lengths: torch.Tensor, generator,
                  temperature: torch.Tensor, top_k, top_p,
                  tokens: torch.Tensor, positions: torch.Tensor,
                  cfg: ServeConfig):
    """Admit N requests at once: dense-causal prefill of (N, Sp)
    right-padded prompts, ring writes for all N slots, per-request
    first-token sampling, and patching of the engine's device
    token/position carry.  Rows with slots[n] >= n_slots (padding of the N
    bucket) write nothing and patch nothing.

    Returns (first_tokens (N,), ring, tokens (B,), positions (B,))."""
    h, pk8, pks, pv8, pvs = _dense_forward(params, prompts, cfg)
    ring = _ring_write_prompts(ring, pk8, pks, pv8, pvs, slots, lengths)
    logits = _first_token_logits(params, h, lengths, cfg.model)
    first = sample_tokens(logits, generator, temperature, top_k, top_p)
    tokens = _scatter_slots(tokens, slots, first)
    positions = _scatter_slots(positions, slots, lengths)
    return first, ring, tokens, positions


@torch.no_grad()
def full_logits(params: Dict, tokens: torch.Tensor, cfg: ServeConfig
                ) -> torch.Tensor:
    """Teacher-forcing forward over the SERVING artifact: (S,) tokens ->
    (S, V) f32 logits with dense causal attention over the QUANTIZED k/v
    the decode cache would hold (no cache writes)."""
    _check_cfg(cfg, params)
    mcfg = cfg.model
    H, KV, D = mcfg.n_heads, mcfg.n_kv_heads, mcfg.head_dim
    Sp = tokens.shape[0]
    G = H // KV
    dev = tokens.device
    linear = _make_linear(cfg)

    h = _embed_lookup(params, tokens).to(torch.bfloat16)
    pos = torch.arange(Sp, device=dev)
    ang = pos[:, None].to(torch.float32) * rope_freqs(mcfg, dev)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    causal = pos[None, :] <= pos[:, None]

    for li in range(mcfg.n_layers):
        xs = _layer_xs(params, li)
        x = _rms(h, xs["attn_norm"], mcfg.norm_eps)
        q = linear(x, xs["q8"], xs["qs"]).reshape(Sp, H, D)
        k = linear(x, xs["k8"], xs["ks"]).reshape(Sp, KV, D)
        v = linear(x, xs["v8"], xs["vs"]).reshape(Sp, KV, D)
        q, k = _rope(q, cos, sin), _rope(k, cos, sin)

        kq8, kqs = quantize_kv(k, cfg.kv_fmt)
        vq8, vqs = quantize_kv(v, cfg.kv_fmt)
        kd = kq8.to(torch.float32) * kqs
        vd = vq8.to(torch.float32) * vqs

        ctx = _causal_attention(
            q.reshape(Sp, KV, G, D).to(torch.float32), kd, vd, causal)
        ctx = ctx.reshape(Sp, H * D).to(torch.bfloat16)
        h = h + linear(ctx, xs["o8"], xs["os"])
        h = _ffn_block(h, xs, mcfg, linear)

    h = _rms(h, params["final_norm"], mcfg.norm_eps)
    return _lm_head(params, h)


def _paged(*_args, **_kwargs):
    raise NotImplementedError(_LATER["paged"])


decode_step_paged = decode_steps_paged = decode_chunk_paged = _paged
prefill_paged = prefill_batch_paged = _paged
