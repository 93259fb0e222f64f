"""K4, decode attention over the paged KV pool (``csrc/paged_attention.cu``):
its wrapper, launch count and plain version.

Replaces ``fp8tpu/kernels/paged_attention.py::_kernel``.  Shapes:

  q          (B, KVG, D)      bf16 query heads, KVG = KV*G in kv-major order
                              (h = kv*G + g), pre-scaled by 1/sqrt(D)
  pool       (P, 2, L, R, D)  int8 / e4m3 / e5m2 / bf16 payloads, R =
                              page_size*KV, row r = t*KV + kv, k at index 0,
                              v at 1 (``PagedKVCache.pool``)
  sc         (P, 2, L, R)     f32 per-(token, kv-head) scales
  page_table (B, MP)          int32 physical page ids, -1 = unmapped
  lens       (B,)             int32 valid tokens per slot
  layer                       Python int, the layer index into the pool

Returns UNNORMALISED flash partials over the pooled prefix only, ``(acc (B,
KVG, D) f32, m (B, KVG) f32, l (B, KVG) f32)``, which the caller merges with
the fresh token and the chunk's side buffer (softmax partials over disjoint
key sets merge exactly).  An empty slot gives m = -1e30, l = 0, acc = 0.

On a CUDA pool this is one launch of the kernel: the page table and the
lengths are read on the device (no host synchronisation, capturable in a
CUDA graph), ids below 0 read page 0 and no id reads outside the pool, and
pages at or past ``lens`` are not read at all.  On the CPU the plain version
runs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fp8tpu_torch._device import full_fp32

from . import _build
from .qmatmul import sm_count

_NEG = -1e30
_PAYLOAD_IDS = {torch.float8_e4m3fn: 0, torch.float8_e5m2: 1, torch.int8: 2,
                torch.bfloat16: 3}
_GROUPS = (1, 2, 4, 8)
CHUNK = 16                      # tokens a warp takes at a time (one m tile)
WARPS = 4                       # warps of a block, each its own recurrence
BLOCKS_PER_SM = 2               # blocks an SM for the split plan
MAX_SPLITS = 16

# Launches of the kernel since the last reset_launches().
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _check(q, pool, sc, page_table, lens, layer, page_size, kv_heads):
    if q.ndim != 3 or pool.ndim != 5 or pool.shape[1] != 2:
        raise ValueError(f"paged_decode_attention needs q (B, KVG, D) and "
                         f"pool (P, 2, L, R, D), got {tuple(q.shape)} and "
                         f"{tuple(pool.shape)}")
    B, KVG, D = q.shape
    P, _, L, R, Dp = pool.shape
    if Dp != D or R != page_size * kv_heads or KVG % kv_heads:
        raise ValueError(f"paged_decode_attention: pool {tuple(pool.shape)} "
                         f"does not hold page_size={page_size} x "
                         f"kv_heads={kv_heads} rows of q's {D} features "
                         f"(q {tuple(q.shape)})")
    if tuple(sc.shape) != (P, 2, L, R) or sc.dtype != torch.float32:
        raise ValueError(f"paged_decode_attention: scales must be f32 "
                         f"{(P, 2, L, R)}, got {sc.dtype} {tuple(sc.shape)}")
    if page_table.ndim != 2 or page_table.shape[0] != B \
            or tuple(lens.shape) != (B,):
        raise ValueError(f"paged_decode_attention: page_table (B, MP) and "
                         f"lens (B,) for B={B}, got "
                         f"{tuple(page_table.shape)} and {tuple(lens.shape)}")
    if pool.dtype not in _PAYLOAD_IDS:
        raise ValueError(f"paged_decode_attention: pool must be int8, e4m3, "
                         f"e5m2 or bf16, got {pool.dtype}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"paged_decode_attention: layer {layer} outside the "
                         f"pool's {L} layers")


def _bits(t: torch.Tensor) -> torch.Tensor:
    # integer view: gathers of payload bytes are defined for every integer
    return t.view(torch.int16 if t.element_size() == 2 else torch.uint8)


def paged_decode_attention_plain(q, pool, sc, page_table, lens, layer, *,
                                 page_size: int, kv_heads: int):
    """The plain version of K4 (any device): the kernel's recurrence page
    by page in torch.  Per page: the page's K rows upcast (exact), dotted
    with q in f32, THEN multiplied by the rows' scales; positions at or past
    ``lens`` masked; running max, ``alpha = exp(m_old - m_new)``; ``p`` with
    an explicit 0 for masked entries; ``p * vs`` rounded to bf16 before the
    context dot; f32 accumulation."""
    _check(q, pool, sc, page_table, lens, layer, page_size, kv_heads)
    B, KVG, D = q.shape
    KV, G = kv_heads, KVG // kv_heads
    MP = page_table.shape[1]
    dev = q.device
    qh = q.to(torch.bfloat16).to(torch.float32).reshape(B, KV, G, D)
    safe = torch.clamp(page_table, min=0).to(torch.int64)
    lens = lens.to(torch.int64)
    m = torch.full((B, KV, G), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, D), dtype=torch.float32, device=dev)
    t = torch.arange(page_size, device=dev)
    pool_bits = _bits(pool)
    with full_fp32():
        for mp in range(MP):
            pg = safe[:, mp]
            kv = pool_bits[pg, :, layer].view(pool.dtype).to(torch.float32)
            kv = kv.reshape(B, 2, page_size, KV, D)
            scs = sc[pg, :, layer].reshape(B, 2, page_size, KV)
            ks = scs[:, 0].permute(0, 2, 1)[:, :, None]      # (B, KV, 1, T)
            vs = scs[:, 1].permute(0, 2, 1)[:, :, None]
            mask = ((mp * page_size + t)[None] < lens[:, None]
                    )[:, None, None, :]                      # (B, 1, 1, T)
            s = torch.einsum("bkgd,btkd->bkgt", qh, kv[:, 0]) * ks
            s = torch.where(mask, s, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            pv = (p * vs).to(torch.bfloat16).to(torch.float32)
            ctx = torch.einsum("bkgt,btkd->bkgd", pv, kv[:, 1])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + ctx
            m = m_new
    return acc.reshape(B, KVG, D), m.reshape(B, KVG), l.reshape(B, KVG)


def n_splits(batch: int, kv_heads: int, max_tokens: int, sms: int) -> int:
    """Blocks that share one (slot, kv head)'s tokens: as many as keep the
    grid within one wave of BLOCKS_PER_SM blocks an SM, no more than the
    slot has rounds of WARPS chunks, at most 16.  Decided from shapes
    alone: the lengths stay on the device."""
    pairs = batch * kv_heads
    rounds = -(-max_tokens // (WARPS * CHUNK))
    return max(1, min(MAX_SPLITS, rounds, BLOCKS_PER_SM * sms // pairs))


def token_ranges(length: int, splits: int):
    """The kernel's plan for one (slot, kv head) of ``length`` tokens:
    [(split, warp, first token, end)] for every chunk it reads.  The chunks
    (CHUNK tokens, the last cut at ``length``) are dealt to the splits in
    contiguous runs, and within a split to its warps in turn."""
    nchunks = -(-length // CHUNK)
    per = -(-nchunks // splits)
    out = []
    for z in range(splits):
        for ch in range(z * per, min(nchunks, (z + 1) * per)):
            out.append((z, (ch - z * per) % WARPS, ch * CHUNK,
                        min(length, (ch + 1) * CHUNK)))
    return out


_COUNTERS = {}


def _counters(device, pairs: int) -> torch.Tensor:
    """One int per (slot, kv head), zero between launches (the kernel resets
    them), so one tensor per device serves every launch on its stream."""
    c = _COUNTERS.get(device)
    if c is None or c.numel() < pairs:
        c = _COUNTERS[device] = torch.zeros(max(pairs, 4096),
                                            dtype=torch.int32, device=device)
    return c


@functools.cache
def _fn():
    fn = _build.load("paged_attention").fp8_paged_attention
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11 \
        + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    return fn


def paged_decode_attention(q: torch.Tensor, pool: torch.Tensor,
                           sc: torch.Tensor, page_table: torch.Tensor,
                           lens: torch.Tensor, layer: int, *, page_size: int,
                           kv_heads: int):
    """Flash partials of decode attention over the paged pool prefix; see
    the module docstring for shapes.  K4 on a CUDA pool, the plain version
    on the CPU."""
    global launches
    if not pool.is_cuda:
        return paged_decode_attention_plain(
            q, pool, sc, page_table, lens, layer, page_size=page_size,
            kv_heads=kv_heads)
    _check(q, pool, sc, page_table, lens, layer, page_size, kv_heads)
    B, KVG, D = q.shape
    P, _, L, _, _ = pool.shape
    MP = page_table.shape[1]
    G = KVG // kv_heads
    if G not in _GROUPS or D % 16 or not 16 <= D <= 128:
        raise ValueError(f"paged_decode_attention kernel takes {_GROUPS} "
                         f"query heads per kv head and head_dim a multiple "
                         f"of 16 up to 128, got G={G}, D={D}")
    if not (pool.is_contiguous() and sc.is_contiguous()):
        raise ValueError("paged_decode_attention: pool and scales must be "
                         "contiguous")
    dev = pool.device
    qb = q.to(device=dev, dtype=torch.bfloat16).contiguous()
    table = page_table.to(device=dev, dtype=torch.int32).contiguous()
    lens32 = lens.to(device=dev, dtype=torch.int32).contiguous()
    acc = torch.empty((B, KVG, D), dtype=torch.float32, device=dev)
    m = torch.empty((B, KVG), dtype=torch.float32, device=dev)
    l = torch.empty((B, KVG), dtype=torch.float32, device=dev)
    splits = n_splits(B, kv_heads, MP * page_size, sm_count(dev.index or 0))
    ws_acc = ws_m = ws_l = counters = None
    if splits > 1:
        pairs = B * kv_heads
        ws_acc = torch.empty((pairs, splits, G, D), dtype=torch.float32,
                             device=dev)
        ws_m = torch.empty((pairs, splits, G), dtype=torch.float32,
                           device=dev)
        ws_l = torch.empty((pairs, splits, G), dtype=torch.float32,
                           device=dev)
        counters = _counters(dev, pairs)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    err = _fn()(qb.data_ptr(), pool.data_ptr(), sc.data_ptr(),
                table.data_ptr(), lens32.data_ptr(), acc.data_ptr(),
                m.data_ptr(), l.data_ptr(), B, kv_heads, G, D, P, L, MP,
                page_size, int(layer), _PAYLOAD_IDS[pool.dtype], splits,
                ptr(ws_acc), ptr(ws_m), ptr(ws_l), ptr(counters),
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "paged_attention kernel")
    launches += 1
    return acc, m, l
