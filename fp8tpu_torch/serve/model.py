"""Production serving decoder: quantized weights + quantized KV cache (ring
or paged pool).

The real-quantization twin of :class:`fp8tpu_torch.models.Decoder`: weights
live in device memory as fp8 / int8 payloads with per-output-channel scales
(int4 nibble-packed as the capacity option), the KV cache stores fp8 / int8
with per-head-vector scales in a ring buffer (:class:`RingKVCache`), and a
decode chunk runs ``n_steps`` steps with on-device sampling and no host
synchronisation: tokens, positions, the ring head and the per-step outputs
stay on the device.

On a CUDA tensor every linear is one launch of a hand-written kernel
(:func:`fp8_linear` -> K3 ``dequant_matmul``, :func:`int4_linear` -> K5
``int4_matmul``; an MoE layer's experts are one launch each per stack);
with ``matmul_impl="direct"`` (W8A8) an fp8 / int8 linear is two: P2
``quantize_rows`` quantizes its input per row to e4m3, then P1
``w8a8_matmul`` (e4m3 / e5m2 weights, fp8 tensor cores) or K3's int8
route with a row scale (int8 weights, on the codes' f16 values that P2
writes, f16 tensor cores) contracts it.  A
decode step's ring write (both slabs and the head's advance) is one launch
of K6 ``ring_store`` (with ``ring_flush = W``, one launch every W steps
that stores W rows), and paged decode with ``paged_decode_impl="kernel"``
reads the pooled prefix through one launch of K4 ``paged_decode_attention``
per layer; on the CPU the same functions use the kernels' plain versions.
The other attention products, the router, the tied LM head and the
bf16-weight linear of the bf16 twin are PyTorch matmuls, as they are XLA
dots in the JAX package.  Each linear quantizes its own input (q, k and v
each launch P2: 7 launches a dense layer, as many as its linears).

Layout is the JAX package's: parameters stacked per layer, weights
``(L, K, N)``, expert stacks ``(L, E, K, N)``.  Where the JAX functions
return a new cache, these update ``ring.kv8`` / ``ring.sc`` (``paged.pool``
/ ``paged.sc``) in place and return the same cache object.

Design notes:

* Decode attention consumes the quantized cache: per-vector scales factor
  out of the dots, the cached prefix and the fresh token give unnormalised
  exp-sums that are combined and normalised once.  All layers of a step
  attend to the ring BEFORE the step's row is written.
* Every slot has its own position (continuous batching); masking is
  ``(head - 1 - row) mod S < min(position, S)``.

Tensor parallelism (:func:`shard_serve_params`): each rank of a mesh's
model group holds its shard of the artifact under ``SERVE_PARAM_RULES``
and runs the global program that GSPMD runs in the JAX package.  q / k /
v / gate / up are column-parallel (one K3 launch on the rank's columns);
o / down row-parallel, GSPMD's order: the rank's f32 partial (a K3 launch
with f32 output and unit scales), the sum over the group, then the
column scale and one rounding to bf16.  The embedding is
vocabulary-sharded and the tied LM head's logits are gathered before
sampling, so every rank samples the same whole logits with the same
generator.  Attention runs on the rank's KV heads where the group splits
them whole (the caches hold those heads); otherwise the caches hold every
head, as ``_shrink_spec`` repairs ``KV_CACHE_SPEC``, and q / k / v are
gathered first.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from fp8tpu_torch._device import full_fp32, resolve_device
from fp8tpu_torch.kernels import inplace
from fp8tpu_torch.kernels import int4_matmul as int4_kernel
from fp8tpu_torch.kernels import paged_attention as paged_kernel
from fp8tpu_torch.kernels import qmatmul
from fp8tpu_torch.kernels.int4_matmul import pack_int4
from fp8tpu_torch.kernels.qmatmul import div_exact, quantize_weights
from fp8tpu_torch.models.transformer import DecoderConfig, rope_freqs
from fp8tpu_torch.parallel.mesh import gather_last

from .kv_cache import (KV_DTYPES, PagedKVCache, RingKVCache, bits,
                       quantize_kv)

_FP8_DTYPES = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2,
               "int8": torch.int8}
_NEG = -1e30  # finite mask value keeps exp() NaN-free for empty slots

@dataclasses.dataclass(frozen=True)
class ServeConfig:
    model: DecoderConfig
    weight_fmt: str = "e4m3"
    kv_fmt: str = "e4m3"
    # 'convert': dequantize weights in registers (W8A16).
    # 'direct' : per-row e4m3 activations, fp8 operands straight to the
    #            tensor cores (W8A8).
    matmul_impl: str = "convert"
    # Embedding / tied LM head storage: "bf16", or an fp8 / int8 format with
    # per-row scales.
    embed_fmt: str = "bf16"
    # K-group size for int4 weights (None: per-output-channel scales only).
    int4_group: Optional[int] = 128
    # Ring-write batching: 0 writes each step's row directly; W > 1 keeps
    # the chunk's fresh k/v in a W-row side buffer and flushes it into the
    # ring every W steps (decode chunks and max_seq must be multiples of
    # W).  (The ring write itself is always the ring_store kernel on a CUDA
    # ring and its plain version on the CPU: the JAX package's
    # staging_impl has no counterpart.)
    ring_flush: int = 0
    # Paged-decode chunk strategy.  "ringview" (default, as in the JAX
    # package): gather the chunk's snapshot of the mapped pages into the
    # ring layout once per chunk and run the ring attention with a position
    # mask.  "kernel": the page-walk kernel (K4) reads the pool where it
    # lies, no snapshot and no bf16 copy of it.  "side": the (B, MP, ...)
    # snapshot layout with pool writes deferred to the chunk's end;
    # "side-eager": the same with a pool write every step; "scatter": fresh
    # K/V written into the snapshot every step, no side buffer.
    paged_decode_impl: str = "ringview"


PAGED_DECODE_IMPLS = ("ringview", "kernel", "side", "side-eager", "scatter")


MATMUL_IMPLS = ("convert", "direct")


def _check_cfg(cfg: ServeConfig) -> None:
    if cfg.matmul_impl not in MATMUL_IMPLS:
        raise ValueError(f"unknown matmul_impl {cfg.matmul_impl!r}")
    if cfg.paged_decode_impl not in PAGED_DECODE_IMPLS:
        raise ValueError(f"unknown paged_decode_impl "
                         f"{cfg.paged_decode_impl!r}; one of "
                         f"{PAGED_DECODE_IMPLS}")


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
    x's dtype.

    ``impl="direct"`` (W8A8): x quantized per row to e4m3 (P2), then the
    codes contracted with f32 accumulation and scaled by ``xs * s``: P1 for
    e4m3 / e5m2 weights, K3's int8 route with a row scale for int8 (P2
    writes the codes' f16 values, exact, which K3 reads: two launches), a
    library matmul of the codes as bf16 for the bf16 twin."""
    if impl not in MATMUL_IMPLS:
        raise ValueError(f"unknown matmul_impl {impl!r}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"fp8_linear takes bf16 activations, got {x.dtype}")
    lead, n = x.shape[:-1], w8.shape[1]
    x2 = x.reshape(-1, x.shape[-1])
    if impl == "direct":
        if w8.dtype == torch.int8:
            xq, xs = _quantize_act(x2, codes_dtype=torch.float16)
            out = qmatmul.dequant_matmul(xq, w8, scale.reshape(-1), x.dtype,
                                         row_scale=xs.reshape(-1))
            return out.reshape(*lead, n)
        xq, xs = _quantize_act(x2)
        if w8.dtype == torch.bfloat16:
            out = (_dot_f32(xq.to(torch.bfloat16), w8)
                   * (xs * scale.reshape(1, -1))).to(x.dtype)
        else:
            out = qmatmul.w8a8_matmul(xq, xs.reshape(-1), w8,
                                      scale.reshape(-1), x.dtype)
        return out.reshape(*lead, n)
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
        amax = qmatmul.flush_amax(wg.abs().amax(dim=1))      # (G, N)
        s = torch.where(amax > 0, div_exact(amax, 7.0), torch.ones_like(amax))
        q = torch.clip(torch.round(wg / s[:, None]), -8, 7).reshape(K, N)
    else:
        amax = qmatmul.flush_amax(wf.abs().amax(dim=0))
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


def _quantize_act(x: torch.Tensor, fmt: str = "e4m3", codes_dtype=None):
    """Per-row activation quantization (the W8A8 route's producer): (q, s)
    with s (..., 1) f32, q the codes or (``codes_dtype``) their values.
    One launch of P2 on a CUDA tensor
    (:func:`fp8tpu_torch.kernels.qmatmul.quantize_rows`), its plain version
    on the CPU."""
    return qmatmul.quantize_rows(x, fmt, codes_dtype)


# -- tensor parallelism over a mesh's model group ---------------------------

@dataclasses.dataclass(frozen=True)
class ServeTP:
    """How a serving artifact is split over a mesh's model group (from
    ``SERVE_PARAM_RULES`` on the full shapes), the group and this rank's
    place in it.  ``heads_local``: the group splits whole KV heads, and the
    rank attends with its own heads and caches only those."""

    group: object
    size: int
    index: int
    embed: bool          # vocabulary rows of the table
    q: bool              # q8's columns
    kv: bool             # k8's / v8's columns
    o: bool              # o8's rows
    ffn: bool            # gate8's / up8's columns
    down: bool           # down8's rows
    heads_local: bool

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, group=self.group)
        return t

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return gather_last(t, self.group)

    def block(self, t: torch.Tensor) -> torch.Tensor:
        n = t.shape[-1] // self.size
        return t[..., self.index * n:(self.index + 1) * n]


class ShardedServeParams(dict):
    """A rank's shard of a serving artifact (a dict of its tensors, as the
    artifact is) with its :class:`ServeTP` as ``tp``."""

    def __init__(self, tensors: Dict, tp: ServeTP):
        super().__init__(tensors)
        self.tp = tp


def _tp(params) -> Optional[ServeTP]:
    return getattr(params, "tp", None)


def shard_serve_params(params: Dict, cfg: ServeConfig, mesh
                       ) -> ShardedServeParams:
    """This rank's shard of the serving artifact ``params`` (every rank
    passes the same whole artifact) for tensor-parallel serving over the
    mesh's model group, as ``shard_tree(params, mesh, SERVE_PARAM_RULES)``
    places it; the data axis replicates (the serving rules name none).
    W8A8's ``direct`` linears, int4 payloads and MoE expert stacks are
    not ported under a mesh and raise (ROADMAP §1 item 7f)."""
    from fp8tpu_torch.parallel.sharding import (SERVE_PARAM_RULES,
                                                local_shards, shard_tree)
    _check_cfg(cfg)
    if isinstance(params, ShardedServeParams):
        raise ValueError("params are a shard already")
    for what, bad in (("matmul_impl='direct' (W8A8)",
                       cfg.matmul_impl == "direct"),
                      ("int4 weights", cfg.weight_fmt == "int4"
                       or params["q8"].dtype == torch.uint8),
                      ("MoE expert stacks", "router" in params)):
        if bad:
            raise NotImplementedError(
                f"{what} under a tensor-parallel mesh: ROADMAP §1 item 7f")
    specs = shard_tree(params, mesh, SERVE_PARAM_RULES)

    def split(name, dim):
        return specs[name].spec[dim] == "model"

    m = cfg.model
    T = mesh.shape["model"]
    kv = split("k8", 2)
    tp = ServeTP(mesh.group("model"), T, mesh.index("model"),
                 embed=split("embed", 0), q=split("q8", 2), kv=kv,
                 o=split("o8", 1), ffn=split("gate8", 2),
                 down=split("down8", 1),
                 heads_local=kv and split("q8", 2) and m.n_kv_heads % T == 0)
    return ShardedServeParams(local_shards(params, mesh, SERVE_PARAM_RULES),
                              tp)


def local_heads(params, mcfg: DecoderConfig) -> Tuple[int, int]:
    """(query heads, KV heads) a rank attends with and caches: its own
    under a mesh that splits whole KV heads, else all of them."""
    tp = _tp(params)
    if tp is None or not tp.heads_local:
        return mcfg.n_heads, mcfg.n_kv_heads
    return mcfg.n_heads // tp.size, mcfg.n_kv_heads // tp.size


def _qkv(x, xs, linear, tp: Optional[ServeTP], lead, D: int):
    """q, k, v of the heads this rank attends with: (*lead, heads, D) each;
    column-parallel products gathered where the rank attends with every
    head."""
    q = linear(x, xs["q8"], xs["qs"])
    k = linear(x, xs["k8"], xs["ks"])
    v = linear(x, xs["v8"], xs["vs"])
    if tp is not None and not tp.heads_local:
        q = tp.gather(q) if tp.q else q
        k, v = (tp.gather(k), tp.gather(v)) if tp.kv else (k, v)
    return (q.reshape(*lead, -1, D), k.reshape(*lead, -1, D),
            v.reshape(*lead, -1, D))


@functools.lru_cache(maxsize=None)
def _unit_scales(n: int, device) -> torch.Tensor:
    return torch.ones(n, dtype=torch.float32, device=device)


def _row_linear(x, w8, scale, tp: ServeTP):
    """A row-parallel linear in GSPMD's order: this rank's f32 partial
    ``x @ w8`` (one K3 launch with f32 output and unit scales on a CUDA
    tensor), summed over the group, then the column scale in f32 and one
    rounding to x's dtype (the JAX ``fp8_linear`` on its sharded
    contraction)."""
    lead, n = x.shape[:-1], w8.shape[1]
    x2 = x.reshape(-1, x.shape[-1])
    if w8.dtype == torch.bfloat16:
        part = _dot_f32(x2, w8)
    else:
        part = qmatmul.dequant_matmul(x2, w8, _unit_scales(n, x.device),
                                      torch.float32)
    out = tp.sum(part) * scale.reshape(1, -1)
    return out.to(x.dtype).reshape(*lead, n)


def _out_proj(ctx, xs, linear, tp: Optional[ServeTP]):
    """o_proj of the attention context (the rank's heads, or all of
    them)."""
    if tp is None:
        return linear(ctx, xs["o8"], xs["os"])
    if not tp.o:
        ctx = tp.gather(ctx) if tp.heads_local else ctx
        return linear(ctx, xs["o8"], xs["os"])
    return _row_linear(ctx if tp.heads_local else tp.block(ctx), xs["o8"],
                       xs["os"], tp)


def _embed_lookup(params, toks):
    e = params["embed"]
    tp = _tp(params)
    if tp is None or not tp.embed:
        rows = bits(e)[toks].view(e.dtype).to(torch.bfloat16)
        if "embed_s" in params:
            return rows * params["embed_s"][toks][..., None].to(
                torch.bfloat16)
        return rows
    # the rank's rows of the vocabulary, zero elsewhere, summed over the
    # group in f32 (one nonzero addend: exact)
    n = e.shape[0]
    local = toks - tp.index * n
    mine = (local >= 0) & (local < n)
    rows = bits(e)[torch.where(mine, local, 0)].view(e.dtype).to(
        torch.bfloat16)
    if "embed_s" in params:
        rows = rows * params["embed_s"][toks][..., None].to(torch.bfloat16)
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return tp.sum(rows.to(torch.float32)).to(torch.bfloat16)


def _lm_head(params, h):
    """Tied LM head: contract on the table's feature axis directly; f32
    logits (gathered over the model group from its vocabulary shards)."""
    e = params["embed"]
    if e.dtype != torch.bfloat16:
        e = e.to(torch.bfloat16)
    logits = _dot_f32(h, e.t())
    tp = _tp(params)
    split = tp is not None and tp.embed
    if "embed_s" in params:
        es = params["embed_s"]
        logits = logits * (tp.block(es) if split else es)[None, :]
    return tp.gather(logits) if split else logits


def _rms(x, scale, eps):
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


_ATTN_KEYS = ("attn_norm", "q8", "qs", "k8", "ks", "v8", "vs", "o8", "os")
_DENSE_MLP_KEYS = ("mlp_norm", "gate8", "gates", "up8", "ups",
                   "down8", "downs")
_MOE_KEYS = ("mlp_norm", "router", "eup8", "eups", "edown8", "edowns")
_LINEARS = {"q_proj": ("q8", "qs"), "k_proj": ("k8", "ks"),
            "v_proj": ("v8", "vs"), "o_proj": ("o8", "os")}
_MLP_LINEARS = {"gate_proj": ("gate8", "gates"), "up_proj": ("up8", "ups"),
                "down_proj": ("down8", "downs")}
_EXPERT_STACKS = {"up": ("eup8", "eups"), "down": ("edown8", "edowns")}


def convert_decoder_params(variables: Dict[str, torch.Tensor],
                           cfg: DecoderConfig, fmt: str = "e4m3",
                           embed_fmt: str = "bf16",
                           int4_group: Optional[int] = 128) -> Dict:
    """Quantize trained Decoder parameters into the serving artifact:
    stacked per-layer payloads + scales.  ``variables`` is the state_dict
    of :class:`fp8tpu_torch.models.Decoder` (Dense weights (out, in));
    the artifact's weights are (L, K, N) as in the JAX package.  An MoE
    decoder's layers carry the router as bf16 (L, Dm, E) and the expert
    stacks quantized per expert and output channel: ``eup8`` (L, E, Dm, F)
    with ``eups`` (L, E, F), ``edown8`` (L, E, F, Dm) with ``edowns`` (L,
    E, Dm); int4 stacks are nibble-packed along K with (L, E, G, N)
    grouped scales."""
    moe = any(k.startswith("layer_0.moe.") for k in variables)

    def q(w):  # (K, N)
        if fmt == "bf16":
            return (w.to(torch.bfloat16),
                    torch.ones(w.shape[-1], dtype=torch.float32,
                               device=w.device))
        if fmt == "int4":
            return quantize_weights_int4(w, group_size=int4_group)
        payload, s = quantize_weights(w, fmt, axis=-1)
        return payload, s.reshape(-1)

    layers = {k: [] for k in _ATTN_KEYS
              + (_MOE_KEYS if moe else _DENSE_MLP_KEYS)}
    payload_dtype = None

    def add(tag8, tags, w):
        """Quantize a (K, N) weight, or each expert of an (E, K, N) stack."""
        nonlocal payload_dtype
        qs = [q(we) for we in (w if w.ndim == 3 else w[None])]
        payload_dtype = qs[0][0].dtype
        p8 = torch.stack([bits(p) for p, _ in qs])
        scales = torch.stack([s for _, s in qs])
        layers[tag8].append(p8 if w.ndim == 3 else p8[0])
        layers[tags].append(scales if w.ndim == 3 else scales[0])

    for i in range(cfg.n_layers):
        pre = f"layer_{i}."
        layers["attn_norm"].append(variables[pre + "attn_norm.scale"])
        layers["mlp_norm"].append(variables[pre + "mlp_norm.scale"])
        tables = (("attn", _LINEARS),) if moe else \
            (("attn", _LINEARS), ("mlp", _MLP_LINEARS))
        for block, table in tables:
            for name, (tag8, tags) in table.items():
                w = variables[f"{pre}{block}.{name}.weight"].detach()
                add(tag8, tags, w.t())
        if moe:
            layers["router"].append(
                variables[pre + "moe.router.weight"].detach().t()
                .to(torch.bfloat16))
            for name, (tag8, tags) in _EXPERT_STACKS.items():
                add(tag8, tags, variables[pre + "moe." + name].detach())
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
    cost is value-independent.  An MoE config (``n_experts > 0``) gets a
    bf16 router and expert stacks in which every expert has its own draw
    and its own memory (the JAX function broadcasts one draw over the
    experts; a shared payload would sit in the card's L2 and flatter every
    timing)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, Dm, FF, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    HD, KVD = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    lead = (L, E) if E > 0 else (L,)

    def normal(shape):
        return torch.randn(shape, dtype=torch.bfloat16, device=dev,
                           generator=gen) * 0.02

    def w(k, n, lead=(L,)):
        if fmt == "int4":
            return torch.randint(0, 256, lead + (k // 2, n),
                                 dtype=torch.uint8, device=dev, generator=gen)
        if fmt == "int8":
            return torch.randint(-127, 128, lead + (k, n), dtype=torch.int8,
                                 device=dev, generator=gen)
        dt = torch.bfloat16 if fmt == "bf16" else _FP8_DTYPES[fmt]
        # one (k, n) matrix at a time: the bf16 draw is twice the payload's
        # size
        out = torch.empty(lead + (k, n), dtype=dt, device=dev)
        for mat in out.reshape(-1, k, n):
            bits(mat).copy_(bits(normal((k, n)).to(dt)))
        return out

    def sc(k, n, lead=(L,)):
        # int4 production scales are grouped (G, N) per layer
        if fmt == "int4":
            g = k // 128 if (k % 128 == 0 and k >= 128) else 1
            return torch.ones(lead + (g, n), dtype=torch.float32, device=dev)
        return torch.ones(lead + (n,), dtype=torch.float32, device=dev)

    out = {
        "attn_norm": torch.ones((L, Dm), dtype=torch.float32, device=dev),
        "mlp_norm": torch.ones((L, Dm), dtype=torch.float32, device=dev),
        "q8": w(Dm, HD), "qs": sc(Dm, HD),
        "k8": w(Dm, KVD), "ks": sc(Dm, KVD),
        "v8": w(Dm, KVD), "vs": sc(Dm, KVD),
        "o8": w(HD, Dm), "os": sc(HD, Dm),
    }
    if E > 0:
        out["router"] = torch.randn((L, Dm, E), dtype=torch.bfloat16,
                                    device=dev, generator=gen) * Dm ** -0.5
        out.update({"eup8": w(Dm, FF, lead), "eups": sc(Dm, FF, lead),
                    "edown8": w(FF, Dm, lead), "edowns": sc(FF, Dm, lead)})
    else:
        out.update({"gate8": w(Dm, FF), "gates": sc(Dm, FF),
                    "up8": w(Dm, FF), "ups": sc(Dm, FF),
                    "down8": w(FF, Dm), "downs": sc(FF, Dm)})
    out["embed"] = normal((cfg.vocab_size, Dm))
    out["final_norm"] = torch.ones((Dm,), dtype=torch.float32, device=dev)
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
    ``convert_decoder_params`` returns, dense or MoE, as numpy / ml_dtypes
    arrays) as the port's tensors, leaf for leaf, in the same layout."""
    dev = resolve_device(device)
    return {k: _tensor_from_array(v, dev) for k, v in jparams.items()}


def ring_from_jax(kv8, sc, head, device="cuda") -> RingKVCache:
    """A JAX ``RingKVCache``'s arrays (numpy / ml_dtypes) as a ring."""
    dev = resolve_device(device)
    return RingKVCache(
        kv8=_tensor_from_array(kv8, dev), sc=_tensor_from_array(sc, dev),
        head=torch.as_tensor(int(np.asarray(head)), dtype=torch.int32
                             ).to(dev))


def paged_from_jax(pool, sc, page_table, kv_heads: int,
                   device="cuda") -> PagedKVCache:
    """A JAX ``PagedKVCache``'s arrays (numpy / ml_dtypes) as a paged pool,
    byte for byte."""
    dev = resolve_device(device)
    return PagedKVCache(
        pool=_tensor_from_array(pool, dev), sc=_tensor_from_array(sc, dev),
        page_table=_tensor_from_array(np.asarray(page_table, np.int32), dev),
        kv_heads=int(kv_heads))


def _make_linear(cfg: ServeConfig, params=None):
    if _tp(params) is not None and (cfg.weight_fmt == "int4"
                                    or cfg.matmul_impl == "direct"):
        raise NotImplementedError(
            "int4 weights and matmul_impl='direct' under a tensor-parallel "
            "mesh: ROADMAP §1 item 7f")
    if cfg.weight_fmt == "int4":
        return lambda x, w, s: int4_linear(x, w, s)
    return lambda x, w, s: fp8_linear(x, w, s, cfg.matmul_impl)


def _layer_xs(params, li: int):
    """Layer ``li``'s parameters, views into the stacked artifact: the
    attention keys plus either the dense SwiGLU keys or (an MoE artifact)
    the router and expert keys."""
    keys = _ATTN_KEYS + (_MOE_KEYS if "router" in params
                         else _DENSE_MLP_KEYS)
    return {k: params[k][li] for k in keys}


def _moe_ffn(x, xs, mcfg: DecoderConfig, linear):
    """Serving-form MoE FFN: every expert on every token, combined with the
    exact top-k router probabilities (not renormalised), as the JAX
    package's ``_moe_ffn`` does; at decode batch sizes every expert's
    payload streams from device memory either way.

    Router logits in f32 (IEEE, not TF32: a flipped choice near a tie
    changes a token's whole FFN output), softmax, top-k by a stable
    descending sort (ties go to the lower expert index, as
    ``jax.lax.top_k`` does).  Each expert's up and down linear is one call
    of ``linear`` on the expert's contiguous (K, N) slice: one K3 (K5 for
    int4) launch per expert per stack on a CUDA tensor.  tanh-GELU in f32,
    the combine in f32, one rounding to x's dtype.  x: (..., Dm) bf16."""
    shp = x.shape
    xt = x.reshape(-1, shp[-1])                               # (T, Dm)
    logits = _dot_f32(xt.to(torch.float32), xs["router"])     # (T, E)
    probs = torch.softmax(logits, dim=-1)
    E = probs.shape[-1]
    gv, gi = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = min(mcfg.moe_top_k, E)
    gates = torch.zeros_like(probs).scatter_(-1, gi[:, :k], gv[:, :k])
    y = None
    for e in range(E):
        he = linear(xt, xs["eup8"][e], xs["eups"][e])         # (T, F)
        he = F.gelu(he.to(torch.float32), approximate="tanh").to(xt.dtype)
        ye = linear(he, xs["edown8"][e], xs["edowns"][e]).to(torch.float32)
        part = ye * gates[:, e, None]
        y = part if y is None else y + part
    return y.reshape(shp).to(x.dtype)


def _ffn_block(h, xs, mcfg: DecoderConfig, linear,
               tp: Optional[ServeTP] = None):
    """Post-attention FFN with residual: dense SwiGLU, or MoE when the
    layer carries router / expert payloads.  Under ``tp`` gate / up are
    the rank's columns and down the rank's rows (summed over the
    group)."""
    x = _rms(h, xs["mlp_norm"], mcfg.norm_eps)
    if "router" in xs:
        return h + _moe_ffn(x, xs, mcfg, linear)
    act = F.silu(linear(x, xs["gate8"], xs["gates"]).to(torch.float32)
                 ).to(x.dtype) * linear(x, xs["up8"], xs["ups"])
    if tp is not None and tp.down:
        act = act if tp.ffn else tp.block(act)
        return h + _row_linear(act, xs["down8"], xs["downs"], tp)
    if tp is not None and tp.ffn:
        act = tp.gather(act)
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


def _scaled_query(q: torch.Tensor) -> torch.Tensor:
    """q / sqrt(D), divided in f32 and rounded back to q's dtype."""
    qf32 = q.to(torch.float32)
    return (qf32 / torch.full_like(qf32, math.sqrt(q.shape[-1]))).to(q.dtype)


def _self_scores(qg, kq8, kqs):
    """The fresh token's own score: qg (B,KV,G,D) . kq8 (B,KV,D), scaled;
    (B,KV,G) f32."""
    return (qg.to(torch.float32) * kq8.to(torch.float32)[:, :, None, :]
            ).sum(-1) * kqs[:, :, None]


def _side_scores(qf, sk8, sks, w, B, KV):
    """Scores against the chunk's side buffer: qf (B*KV, G, D); sk8 (W,
    B*KV, D) with scales sks (W, B*KV); rows j >= ``w`` masked.  (B,KV,G,W)
    f32."""
    W = sk8.shape[0]
    G = qf.shape[1]
    sscores = _dot_f32(qf, sk8.to(qf.dtype).permute(1, 2, 0)
                       ).reshape(B, KV, G, W) * sks.t().reshape(B, KV, 1, W)
    live = torch.arange(W, device=qf.device) < w
    return torch.where(live[None, None, None], sscores, _NEG)


def _side_context(spc, sv8, svs, dtype, B, KV):
    """Unnormalised context of the side buffer: spc (B,KV,G,W) f32 exp
    weights, sv8 (W, B*KV, D) with scales svs (W, B*KV).  (B,KV,G,D) f32."""
    W = sv8.shape[0]
    G = spc.shape[2]
    spcs = (spc * svs.t().reshape(B, KV, 1, W)).to(dtype)
    return _dot_f32(spcs.reshape(B * KV, G, W),
                    sv8.to(dtype).permute(1, 0, 2)
                    ).reshape(B, KV, G, sv8.shape[-1])


def _attend_ring(q, kq8, kqs, vq8, vqs, k8, ks, v8, vs, head, lens,
                 cfg: DecoderConfig, sk8=None, sks=None, sv8=None, svs=None,
                 w=None, valid_mask=None):
    """Flash-style decode attention: ring-cached prefix + fresh token.

    q: (B,H,D) bf16 (the 1/sqrt(D) factor is applied here); fresh kq8/vq8:
    (B,KV,D) with scales kqs/vqs (B,KV); ring k8/v8: (S, B*KV, D) with
    scales ks/vs (S, B*KV); head: () int32 next write row; lens: (B,)
    valid RING lengths.  Optional side buffer sk8/sv8 (W, B*KV, D) with
    scales (W, B*KV), rows j < ``w`` valid: tokens decoded in this chunk and
    not yet in the cache, re-read and re-scored every step, which is exact
    (per-token K/V are query-independent).  ``valid_mask`` (B, S) replaces
    the ring's age mask (the paged ring view: row s valid iff s < lens[b]).
    Unnormalised partials of all parts are combined and divided ONCE on the
    (B,KV,G,D) context.  The payload's upcast to bf16 is a copy of the
    layer's rows in device memory."""
    B, H, D = q.shape
    S, BK, _ = k8.shape
    KV = kq8.shape[1]
    G = H // KV
    qg = _scaled_query(q)
    qf = qg.reshape(BK, G, D)

    scores = _dot_f32(qf, k8.to(q.dtype).permute(1, 2, 0)
                      ).reshape(B, KV, G, S) * ks.t().reshape(B, KV, 1, S)
    mask = ring_valid_mask(head, lens, S) if valid_mask is None \
        else valid_mask
    scores = torch.where(mask[:, None, None, :], scores, _NEG)

    score_self = _self_scores(qg.reshape(B, KV, G, D), kq8, kqs)

    m = torch.maximum(scores.amax(dim=-1), score_self)
    if sk8 is not None:
        sscores = _side_scores(qf, sk8, sks, w, B, KV)
        m = torch.maximum(m, sscores.amax(dim=-1))
    pc = torch.exp(scores - m[..., None])
    ps = torch.exp(score_self - m)
    denom = pc.sum(-1) + ps

    pcs = (pc * vs.t().reshape(B, KV, 1, S)).to(q.dtype)
    ctx = _dot_f32(pcs.reshape(BK, G, S), v8.to(q.dtype).permute(1, 0, 2)
                   ).reshape(B, KV, G, D)
    ctx = ctx + ((ps * vqs[:, :, None])[..., None]
                 * vq8.to(torch.float32)[:, :, None, :])
    if sk8 is not None:
        spc = torch.exp(sscores - m[..., None])
        denom = denom + spc.sum(-1)
        ctx = ctx + _side_context(spc, sv8, svs, q.dtype, B, KV)
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
                     slabs: torch.Tensor, rows: int = 1) -> None:
    """One decode step's cache update: the (2, L, B*KV, D) payload slab and
    the (2, L, B*KV) scale slab stored at the ring head, and ``head =
    (head + 1) mod S`` in place: one ring_store launch on a CUDA ring.
    With ``rows`` = W the slabs carry a leading axis of W steps (the side
    buffer of a batched ring write), stored at rows ``head .. head + W -
    1`` and ``head`` advanced by W, still one launch.  Everything that read
    the head (the valid mask) was computed from it before, in stream
    order."""
    inplace.ring_store(ring.kv8, slab8, ring.sc, slabs, ring.head,
                       ring.max_seq, ring.ticket, rows=rows)


def _flush_rows(cfg: ServeConfig, n_steps: int, S: int) -> int:
    """W, the rows of one batched ring write (``ring_flush``), or 1 where
    each step writes its own row; the JAX package's alignment contract:
    the head only advances by W, so chunks and the ring are multiples of
    it.  A one-step call writes its row directly, as in the JAX package."""
    W = cfg.ring_flush
    if not W or W <= 1 or n_steps <= 1:
        return 1
    if n_steps % W != 0:
        raise ValueError(f"ring_flush={W} needs decode chunks divisible by "
                         f"it (got n_steps={n_steps})")
    if S % W != 0:
        raise ValueError(f"ring_flush={W} needs max_seq % W == 0 (got {S})")
    return W


def _steps_impl(params: Dict, ring: RingKVCache, tokens: torch.Tensor,
                positions: torch.Tensor, generator, temperature: torch.Tensor,
                n_steps: int, cfg: ServeConfig, want_logits: bool,
                top_k=None, top_p=None, greedy_only: bool = False):
    """The ring decode loop.  With ``ring_flush`` = W > 1 (the JAX
    package's ``_steps_impl_sideflush``) the steps collect their fresh k/v
    in a (W, 2, L, B*KV, D) side buffer that every later step of the W
    attends to (rows j < w of step w), and every W steps one K6 launch
    flushes the W rows at the head and advances it by W; the ring holds
    ``pos - w`` tokens of each slot meanwhile."""
    _check_cfg(cfg)
    mcfg = cfg.model
    (H, KV), D, L = local_heads(params, mcfg), mcfg.head_dim, mcfg.n_layers
    tp = _tp(params)
    B = tokens.shape[0]
    S = ring.max_seq
    BK = B * KV
    dev = tokens.device
    W = _flush_rows(cfg, n_steps, S)
    linear = _make_linear(cfg, params)
    inv_freq = rope_freqs(mcfg, dev)
    # The fresh k/v of every layer for W steps (one step without batched
    # writes); reused by every W steps of the chunk (launches are ordered
    # on the stream).  Rows not yet written are masked, so their first
    # values only need to be finite.
    side8 = torch.zeros((W, 2, L, BK, D), dtype=ring.kv8.dtype, device=dev)
    side_sc = torch.ones((W, 2, L, BK), dtype=torch.float32, device=dev)
    side_bits = bits(side8)

    toks, pos = tokens.to(torch.int32), positions.to(torch.int32)
    outs = []
    for step in range(n_steps):
        w = step % W                        # this step's side-buffer row
        h = _embed_lookup(params, toks)
        ang = pos[:, None].to(torch.float32) * inv_freq
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        lens = torch.clamp(pos - w, 0, S)   # the ring holds pos - w tokens
        mask = ring_valid_mask(ring.head, lens, S)

        for li in range(L):
            xs = _layer_xs(params, li)
            x = _rms(h, xs["attn_norm"], mcfg.norm_eps)
            q, k, v = _qkv(x, xs, linear, tp, (B,), D)
            q, k = _rope(q, cos, sin), _rope(k, cos, sin)

            kq8, kqs = quantize_kv(k, cfg.kv_fmt)
            vq8, vqs = quantize_kv(v, cfg.kv_fmt)

            # every layer attends to the ring as it was BEFORE this step
            # (and, batching writes, to the side rows before w); the fresh
            # token enters as score_self
            side = {} if W == 1 else dict(
                sk8=side8[:, 0, li], sks=side_sc[:, 0, li],
                sv8=side8[:, 1, li], svs=side_sc[:, 1, li], w=w)
            ctx = _attend_ring(q, kq8, kqs[..., 0], vq8, vqs[..., 0],
                               ring.kv8[:, 0, li], ring.sc[:, 0, li],
                               ring.kv8[:, 1, li], ring.sc[:, 1, li],
                               ring.head, lens, mcfg, valid_mask=mask, **side)
            h = h + _out_proj(ctx, xs, linear, tp)
            h = _ffn_block(h, xs, mcfg, linear, tp)
            side_bits[w, 0, li] = bits(kq8).reshape(BK, D)
            side_bits[w, 1, li] = bits(vq8).reshape(BK, D)
            side_sc[w, 0, li] = kqs.reshape(BK)
            side_sc[w, 1, li] = vqs.reshape(BK)

        if W == 1:
            _ring_write_step(ring, side8[0], side_sc[0])
        elif w == W - 1:
            _ring_write_step(ring, side8, side_sc, rows=W)

        h = _rms(h, params["final_norm"], mcfg.norm_eps)
        logits = _lm_head(params, h)
        nxt = sample_tokens(logits, generator, temperature, top_k, top_p,
                            greedy_only)
        outs.append((logits, nxt) if want_logits
                    else (nxt, _chosen_logprob(logits, nxt)))
        toks, pos = nxt, pos + 1

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
    (logits, _), ring, _, _ = _steps_impl(
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
    _check_cfg(cfg)
    mcfg = cfg.model
    (H, KV), D = local_heads(params, mcfg), mcfg.head_dim
    tp = _tp(params)
    N, Sp = toks.shape
    G = H // KV
    dev = toks.device
    linear = _make_linear(cfg, params)

    h = _embed_lookup(params, toks).to(torch.bfloat16)      # (N, Sp, Dm)
    pos = torch.arange(Sp, device=dev)
    ang = pos[:, None].to(torch.float32) * rope_freqs(mcfg, dev)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    causal = pos[None, :] <= pos[:, None]                   # (Sp, Sp)

    pk8, pks, pv8, pvs = [], [], [], []
    for li in range(mcfg.n_layers):
        xs = _layer_xs(params, li)
        x = _rms(h, xs["attn_norm"], mcfg.norm_eps)
        q, k, v = _qkv(x, xs, linear, tp, (N, Sp), D)
        q, k = _rope(q, cos, sin), _rope(k, cos, sin)

        kq8, kqs = quantize_kv(k, cfg.kv_fmt)
        vq8, vqs = quantize_kv(v, cfg.kv_fmt)

        # Dense causal attention on the fresh (bf16) K/V; the cache writes
        # happen in the caller.
        ctx = _causal_attention(
            q.reshape(N, Sp, KV, G, D).to(torch.float32),
            k.to(torch.float32), v.to(torch.float32), causal)
        ctx = ctx.reshape(N, Sp, H * D).to(torch.bfloat16)
        h = h + _out_proj(ctx, xs, linear, tp)
        h = _ffn_block(h, xs, mcfg, linear, tp)
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
    _check_cfg(cfg)
    mcfg = cfg.model
    (H, KV), D = local_heads(params, mcfg), mcfg.head_dim
    tp = _tp(params)
    Sp = tokens.shape[0]
    G = H // KV
    dev = tokens.device
    linear = _make_linear(cfg, params)

    h = _embed_lookup(params, tokens).to(torch.bfloat16)
    pos = torch.arange(Sp, device=dev)
    ang = pos[:, None].to(torch.float32) * rope_freqs(mcfg, dev)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    causal = pos[None, :] <= pos[:, None]

    for li in range(mcfg.n_layers):
        xs = _layer_xs(params, li)
        x = _rms(h, xs["attn_norm"], mcfg.norm_eps)
        q, k, v = _qkv(x, xs, linear, tp, (Sp,), D)
        q, k = _rope(q, cos, sin), _rope(k, cos, sin)

        kq8, kqs = quantize_kv(k, cfg.kv_fmt)
        vq8, vqs = quantize_kv(v, cfg.kv_fmt)
        kd = kq8.to(torch.float32) * kqs
        vd = vq8.to(torch.float32) * vqs

        ctx = _causal_attention(
            q.reshape(Sp, KV, G, D).to(torch.float32), kd, vd, causal)
        ctx = ctx.reshape(Sp, H * D).to(torch.bfloat16)
        h = h + _out_proj(ctx, xs, linear, tp)
        h = _ffn_block(h, xs, mcfg, linear, tp)

    h = _rms(h, params["final_norm"], mcfg.norm_eps)
    return _lm_head(params, h)


# ---------------------------------------------------------------------------
# Paged decode (long-context serving: context bounded by page pool, not ring)
# ---------------------------------------------------------------------------

def _attend_paged(q, kq8, kqs, vq8, vqs, kp8, kps, vp8, vps, lens,
                  page_size: int, cfg: DecoderConfig,
                  sk8=None, sks=None, sv8=None, svs=None, w=None):
    """Decode attention over a (chunk-frozen) page snapshot, the chunk's
    own tokens in a small side buffer, and the fresh token.

    q: (B,H,D); fresh kq8/vq8 (B,KV,D) with scales (B,KV); snapshot
    kp8/vp8: (B, MP, page*KV, D) with scales (B, MP, page*KV); lens: (B,)
    tokens in the snapshot (positions < lens are valid: pages are logically
    ordered, no ring aging); side sk8/sv8: (W, B*KV, D) chunk-token payloads
    with scales (W, B*KV), rows j < ``w`` valid."""
    B, H, D = q.shape
    KV = kq8.shape[1]
    G = H // KV
    MP = kp8.shape[1]
    S = MP * page_size
    BK = B * KV
    qg = _scaled_query(q)
    qf = qg.reshape(BK, G, D)

    # (B, MP, page*KV, D) is (B, S, KV, D) with the token-major rows split
    kp = kp8.to(q.dtype).reshape(B, S, KV, D)
    vp = vp8.to(q.dtype).reshape(B, S, KV, D)
    kss = kps.reshape(B, S, KV).permute(0, 2, 1)[:, :, None]    # (B,KV,1,S)
    vss = vps.reshape(B, S, KV).permute(0, 2, 1)[:, :, None]

    scores = _dot_f32(qf, kp.permute(0, 2, 3, 1).reshape(BK, D, S)
                      ).reshape(B, KV, G, S) * kss
    mask = torch.arange(S, device=q.device)[None] < lens[:, None]  # (B, S)
    scores = torch.where(mask[:, None, None, :], scores, _NEG)

    score_self = _self_scores(qg.reshape(B, KV, G, D), kq8, kqs)

    m = torch.maximum(scores.amax(dim=-1), score_self)
    if sk8 is not None:
        sscores = _side_scores(qf, sk8, sks, w, B, KV)
        m = torch.maximum(m, sscores.amax(dim=-1))
    pc = torch.exp(scores - m[..., None])
    ps = torch.exp(score_self - m)
    denom = pc.sum(-1) + ps

    pcs = (pc * vss).to(q.dtype)
    ctx = _dot_f32(pcs.reshape(BK, G, S),
                   vp.permute(0, 2, 1, 3).reshape(BK, S, D)
                   ).reshape(B, KV, G, D)
    ctx = ctx + ((ps * vqs[:, :, None])[..., None]
                 * vq8.to(torch.float32)[:, :, None, :])
    if sk8 is not None:
        spc = torch.exp(sscores - m[..., None])
        denom = denom + spc.sum(-1)
        ctx = ctx + _side_context(spc, sv8, svs, q.dtype, B, KV)
    ctx = ctx / denom[..., None]
    return ctx.reshape(B, H * D).to(q.dtype)


def _attend_paged_kernel(q, kq8, kqs, vq8, vqs, paged: PagedKVCache,
                         li: int, lens, cfg: DecoderConfig,
                         sk8=None, sks=None, sv8=None, svs=None, w=None):
    """Decode attention with the page-walk kernel (K4) for the pooled
    prefix: no snapshot is ever materialised and the pool's payload is
    never copied to bf16; the fresh token and the chunk's side buffer are
    computed here.  The three parts give unnormalised flash partials over
    DISJOINT key sets, so merging them (rescale by exp(m_part - m_tot),
    then one divide) is exact.  An empty slot's partial has m = -1e30,
    l = 0, and exp(m_p - m) is 0 or 1, never inf."""
    B, H, D = q.shape
    KV = kq8.shape[1]
    G = H // KV
    BK = B * KV
    qg = _scaled_query(q)
    qh = qg.reshape(B, KV, G, D)

    # (B, KVG = KV*G, D): the kernel's query order is kv-major, h = kv*G + g,
    # which the (B, KV, G, D) reshape of the heads already is
    acc_p, m_p, l_p = paged_kernel.paged_decode_attention(
        qh.reshape(B, KV * G, D), paged.pool, paged.sc, paged.page_table,
        lens, li, page_size=paged.page_size, kv_heads=KV)
    acc_p = acc_p.reshape(B, KV, G, D)
    m_p = m_p.reshape(B, KV, G)
    l_p = l_p.reshape(B, KV, G)

    score_self = _self_scores(qh, kq8, kqs)
    m = torch.maximum(m_p, score_self)
    if sk8 is not None:
        sscores = _side_scores(qh.reshape(BK, G, D), sk8, sks, w, B, KV)
        m = torch.maximum(m, sscores.amax(dim=-1))

    corr = torch.exp(m_p - m)                                   # (B,KV,G)
    ps = torch.exp(score_self - m)
    denom = l_p * corr + ps
    ctx = acc_p * corr[..., None]
    ctx = ctx + ((ps * vqs[:, :, None])[..., None]
                 * vq8.to(torch.float32)[:, :, None, :])
    if sk8 is not None:
        spc = torch.exp(sscores - m[..., None])
        denom = denom + spc.sum(-1)
        ctx = ctx + _side_context(spc, sv8, svs, q.dtype, B, KV)
    ctx = ctx / denom[..., None]
    return ctx.reshape(B, H * D).to(q.dtype)


def _snap_write(kvp, scp, slab8, slabs, pos, page: int, KV: int):
    """Write one fresh K/V row per slot into the snapshot (B, MP, 2, L,
    page*KV, D) at logical position ``pos``; a position past the snapshot
    lands in its last page (the slot's own copy, masked by lens).  slab8
    (2, L, B*KV, D), slabs (2, L, B*KV)."""
    B, MP = kvp.shape[:2]
    L, D = slab8.shape[1], slab8.shape[3]
    dev = kvp.device
    pos = pos.to(torch.int64)
    bi = torch.arange(B, device=dev)[:, None]
    mpi = torch.clamp(pos // page, max=MP - 1)[:, None]
    rows = (pos % page)[:, None] * KV + torch.arange(KV, device=dev)[None]
    # updates indexed (B, KV, 2, L, D) / (B, KV, 2, L)
    bits(kvp)[bi, mpi, :, :, rows, :] = \
        bits(slab8).reshape(2, L, B, KV, D).permute(2, 3, 0, 1, 4)
    scp[bi, mpi, :, :, rows] = slabs.reshape(2, L, B, KV).permute(2, 3, 0, 1)


def _steps_impl_paged(params: Dict, paged: PagedKVCache, tokens: torch.Tensor,
                      positions: torch.Tensor, generator,
                      temperature: torch.Tensor, n_steps: int,
                      cfg: ServeConfig, want_logits: bool,
                      top_k=None, top_p=None, greedy_only: bool = False):
    """Chunked decode over the paged pool.

    Except in "kernel" mode the mapped pages are gathered into a
    contiguous snapshot ONCE per chunk; each step attends over that
    snapshot (or, in "kernel" mode, over the pool itself through K4) plus a
    small side buffer holding the chunk's own fresh tokens, re-read and
    re-scored against each step's new query, plus the fresh token.  "side",
    "ringview" and "kernel" DEFER the pool writes to one batched scatter at
    the chunk's end: within the chunk every step's attention covers the
    fresh tokens through the side buffer, so the pool only has to be current
    for the NEXT chunk.  "side-eager" writes the pool every step; "scatter"
    writes the pool and the snapshot every step and carries no side
    buffer."""
    _check_cfg(cfg)
    mcfg = cfg.model
    (H, KV), D, L = local_heads(params, mcfg), mcfg.head_dim, mcfg.n_layers
    tp = _tp(params)
    B = tokens.shape[0]
    BK = B * KV
    dev = tokens.device
    linear = _make_linear(cfg, params)
    inv_freq = rope_freqs(mcfg, dev)
    page = paged.page_size
    W = n_steps
    impl = cfg.paged_decode_impl
    scatter = impl == "scatter"
    use_kernel = impl == "kernel"
    ringview = impl == "ringview"
    defer_writes = impl in ("side", "kernel", "ringview")
    dt = paged.pool.dtype

    kvp = scp = None
    if ringview:
        # (B, MP, 2, L, page*KV, D) -> (MP*page, 2, L, B*KV, D): one gather
        # and transpose per chunk, after which every per-layer slice and
        # product is the ring code path
        g8, gs = paged.gather()
        MP = g8.shape[1]
        SV = MP * page
        kvp = (bits(g8).reshape(B, MP, 2, L, page, KV, D)
               .permute(1, 4, 2, 3, 0, 5, 6).reshape(SV, 2, L, BK, D)
               .view(dt))
        scp = (gs.reshape(B, MP, 2, L, page, KV)
               .permute(1, 4, 2, 3, 0, 5).reshape(SV, 2, L, BK))
        rows_sv = torch.arange(SV, device=dev)[None]
    elif not use_kernel:
        kvp, scp = paged.gather()
    if scatter:
        # one step's fresh k/v of every layer, reused by every step
        side8 = torch.empty((1, 2, L, BK, D), dtype=dt, device=dev)
        side_sc = torch.empty((1, 2, L, BK), dtype=torch.float32, device=dev)
    else:
        side8 = torch.zeros((W, 2, L, BK, D), dtype=dt, device=dev)
        side_sc = torch.ones((W, 2, L, BK), dtype=torch.float32, device=dev)
    side_bits = bits(side8)

    toks, pos = tokens.to(torch.int32), positions.to(torch.int32)
    outs = []
    for w in range(n_steps):
        h = _embed_lookup(params, toks)
        ang = pos[:, None].to(torch.float32) * inv_freq
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        # tokens in the pooled prefix / snapshot (live in scatter mode)
        lens0 = torch.clamp(pos if scatter else pos - w, max=paged.max_seq)
        if ringview:
            vmask = rows_sv < lens0[:, None]
        row = 0 if scatter else w          # this step's row of the buffer

        for li in range(L):
            xs = _layer_xs(params, li)
            x = _rms(h, xs["attn_norm"], mcfg.norm_eps)
            q, k, v = _qkv(x, xs, linear, tp, (B,), D)
            q, k = _rope(q, cos, sin), _rope(k, cos, sin)

            kq8, kqs = quantize_kv(k, cfg.kv_fmt)
            vq8, vqs = quantize_kv(v, cfg.kv_fmt)

            side = {} if scatter else dict(
                sk8=side8[:, 0, li], sks=side_sc[:, 0, li],
                sv8=side8[:, 1, li], svs=side_sc[:, 1, li], w=w)
            fresh = (q, kq8, kqs[..., 0], vq8, vqs[..., 0])
            if use_kernel:
                ctx = _attend_paged_kernel(*fresh, paged, li, lens0, mcfg,
                                           **side)
            elif ringview:
                ctx = _attend_ring(*fresh, kvp[:, 0, li], scp[:, 0, li],
                                   kvp[:, 1, li], scp[:, 1, li], None, lens0,
                                   mcfg, valid_mask=vmask, **side)
            else:
                ctx = _attend_paged(*fresh, kvp[:, :, 0, li], scp[:, :, 0, li],
                                    kvp[:, :, 1, li], scp[:, :, 1, li],
                                    lens0, page, mcfg, **side)
            h = h + _out_proj(ctx, xs, linear, tp)
            h = _ffn_block(h, xs, mcfg, linear, tp)
            # the step's own row of the side buffer is masked (j < w) while
            # the step runs, so it can be filled layer by layer
            side_bits[row, 0, li] = bits(kq8).reshape(BK, D)
            side_bits[row, 1, li] = bits(vq8).reshape(BK, D)
            side_sc[row, 0, li] = kqs.reshape(BK)
            side_sc[row, 1, li] = vqs.reshape(BK)

        if not defer_writes:
            paged = paged.write_step(
                side8[row, 0].reshape(L, B, KV, D),
                side_sc[row, 0].reshape(L, B, KV),
                side8[row, 1].reshape(L, B, KV, D),
                side_sc[row, 1].reshape(L, B, KV), pos)
        if scatter:
            _snap_write(kvp, scp, side8[0], side_sc[0], pos, page, KV)

        h = _rms(h, params["final_norm"], mcfg.norm_eps)
        logits = _lm_head(params, h)
        nxt = sample_tokens(logits, generator, temperature, top_k, top_p,
                            greedy_only)
        outs.append((logits, nxt) if want_logits
                    else (nxt, _chosen_logprob(logits, nxt)))
        toks, pos = nxt, pos + 1

    if defer_writes:
        # One batched scatter of the whole chunk's fresh K/V (the side
        # buffer holds exactly the W steps' quantized rows).
        from .speculative import _paged_write_block
        blk8 = side_bits.reshape(W, 2, L, B, KV, D)
        blks = side_sc.reshape(W, 2, L, B, KV)
        valid = torch.full((B,), W, dtype=torch.int32, device=dev)
        paged = _paged_write_block(
            paged,
            blk8[:, 0].permute(1, 2, 0, 3, 4),     # (L, B, W, KV, D)
            blks[:, 0].permute(1, 2, 0, 3),        # (L, B, W, KV)
            blk8[:, 1].permute(1, 2, 0, 3, 4),
            blks[:, 1].permute(1, 2, 0, 3),
            positions.to(torch.int32), valid)

    stacked = (torch.stack([o[0] for o in outs]),
               torch.stack([o[1] for o in outs]))
    return stacked, paged, toks, pos


@torch.no_grad()
def decode_steps_paged(params: Dict, paged: PagedKVCache,
                       tokens: torch.Tensor, positions: torch.Tensor,
                       generator, temperature: torch.Tensor, n_steps: int,
                       cfg: ServeConfig, top_k=None, top_p=None,
                       greedy_only: bool = False
                       ) -> Tuple[torch.Tensor, PagedKVCache]:
    """``n_steps`` decode steps over the paged KV pool (long-context twin of
    :func:`decode_steps`).  The pool is updated in place.  Returns (tokens
    (B, n_steps), pool)."""
    (toks, _), paged, _, _ = _steps_impl_paged(
        params, paged, tokens, positions, generator, temperature, n_steps,
        cfg, want_logits=False, top_k=top_k, top_p=top_p,
        greedy_only=greedy_only)
    return toks.t(), paged


@torch.no_grad()
def decode_chunk_paged(params: Dict, paged: PagedKVCache,
                       tokens: torch.Tensor, positions: torch.Tensor,
                       generator, temperature: torch.Tensor, n_steps: int,
                       cfg: ServeConfig, top_k=None, top_p=None,
                       greedy_only: bool = False):
    """Paged twin of :func:`decode_chunk`: returns (tokens (B, n_steps),
    logprobs (B, n_steps), pool, last_tokens (B,), positions (B,))."""
    (toks, lps), paged, ftoks, fpos = _steps_impl_paged(
        params, paged, tokens, positions, generator, temperature, n_steps,
        cfg, want_logits=False, top_k=top_k, top_p=top_p,
        greedy_only=greedy_only)
    return toks.t(), lps.t(), paged, ftoks, fpos


@torch.no_grad()
def decode_step_paged(params: Dict, paged: PagedKVCache,
                      tokens: torch.Tensor, positions: torch.Tensor,
                      cfg: ServeConfig) -> Tuple[torch.Tensor, PagedKVCache]:
    """One paged decode step; returns (logits (B, V) f32, pool)."""
    temperature = torch.zeros(tokens.shape, dtype=torch.float32,
                              device=tokens.device)
    (logits, _), paged, _, _ = _steps_impl_paged(
        params, paged, tokens, positions, None, temperature, 1, cfg,
        want_logits=True, greedy_only=True)
    return logits[0], paged


def _paged_write_prompts(paged: PagedKVCache, pk8, pks, pv8, pvs,
                         slots: torch.Tensor, lengths: torch.Tensor,
                         starts: Optional[torch.Tensor] = None
                         ) -> PagedKVCache:
    """Scatter N prompts' quantized k/v into the page pool in place.  Prompt
    n's token i lands in slot n's logical page ``i // page_size`` at offset
    ``i % page_size``; padding rows / slots and unmapped pages DROP (to the
    pool's scratch page, without a host synchronisation).  ``starts`` (N,)
    masks writes below it: positions already present in SHARED prefix pages
    must never be rewritten (a differently shaped admission batch may
    recompute K/V in another summation order, and a flipped payload bit
    would perturb the pages' other holders)."""
    L, N, Sp, KV, D = pk8.shape
    page = paged.page_size
    dev = paged.pool.device
    tpos = torch.arange(Sp, device=dev)
    lp = torch.clamp(tpos // page, max=paged.max_pages - 1)     # (Sp,)
    slots = slots.to(torch.int64)
    sl = torch.clamp(slots, 0, paged.n_slots - 1)
    pg = paged.page_table.to(torch.int64)[sl][:, lp]            # (N, Sp)
    valid = ((tpos[None] < torch.clamp(lengths[:, None], max=paged.max_seq))
             & (pg >= 0) & (slots[:, None] < paged.n_slots)
             & (slots[:, None] >= 0))
    if starts is not None:
        valid = valid & (tpos[None] >= starts[:, None])
    pg = torch.where(valid, pg, paged.n_pages)                  # drops
    rows = (tpos % page)[:, None] * KV \
        + torch.arange(KV, device=dev)[None]                    # (Sp, KV)
    return _paged_scatter(paged, pg[:, :, None], rows[None], pk8, pks, pv8,
                          pvs)


def _paged_scatter(paged: PagedKVCache, pgi, ri, pk8, pks, pv8, pvs
                   ) -> PagedKVCache:
    """Shared page-pool scatter core: payloads (L, N, T, KV, D) and scales
    (L, N, T, KV) land at (page pgi (N, T, 1), row ri (N|1, T, KV)); a page
    id equal to ``n_pages`` DROPS the row.  Callers (_paged_write_prompts,
    speculative._paged_write_block) differ only in how they compute pgi, ri
    and validity."""
    u8 = torch.stack([bits(pk8), bits(pv8)]).permute(2, 3, 4, 0, 1, 5)
    us = torch.stack([pks, pvs]).permute(2, 3, 4, 0, 1)         # (N,T,KV,2,L)
    return paged.scatter(pgi, ri, u8, us)


@torch.no_grad()
def prefill_paged(params: Dict, paged: PagedKVCache, tokens: torch.Tensor,
                  slot, length, cfg: ServeConfig
                  ) -> Tuple[torch.Tensor, PagedKVCache]:
    """Prefill one slot's prompt into its mapped pages.

    Same dense causal forward as :func:`prefill`; token i lands in the
    slot's logical page ``i // page_size`` at offset ``i % page_size``.
    Padding rows (i >= length) are dropped."""
    dev = tokens.device
    h, pk8, pks, pv8, pvs = _dense_forward(params, tokens[None], cfg)
    slots = torch.as_tensor(slot, device=dev).reshape(1).to(torch.int32)
    lengths = torch.as_tensor(length, device=dev).reshape(1).to(torch.int32)
    paged = _paged_write_prompts(paged, pk8, pks, pv8, pvs, slots, lengths)
    logits = _first_token_logits(params, h, lengths, cfg.model)
    return logits[0], paged


@torch.no_grad()
def prefill_batch_paged(params: Dict, paged: PagedKVCache,
                        prompts: torch.Tensor, slots: torch.Tensor,
                        lengths: torch.Tensor, generator,
                        temperature: torch.Tensor, top_k, top_p,
                        tokens: torch.Tensor, positions: torch.Tensor,
                        cfg: ServeConfig,
                        write_starts: Optional[torch.Tensor] = None):
    """Paged twin of :func:`prefill_batch` (batched admission in one call).
    ``write_starts`` (N,) skips cache writes below it (the positions covered
    by shared prefix pages).  Returns (first_tokens (N,), paged, tokens,
    positions)."""
    h, pk8, pks, pv8, pvs = _dense_forward(params, prompts, cfg)
    paged = _paged_write_prompts(paged, pk8, pks, pv8, pvs, slots, lengths,
                                 starts=write_starts)
    logits = _first_token_logits(params, h, lengths, cfg.model)
    first = sample_tokens(logits, generator, temperature, top_k, top_p)
    tokens = _scatter_slots(tokens, slots, first)
    positions = _scatter_slots(positions, slots, lengths)
    return first, paged, tokens, positions
