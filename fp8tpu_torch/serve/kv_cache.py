"""Quantized KV caches (ring, contiguous-slot and paged; fp8 / int8 / bf16
payloads).

Keys and values are stored as real fp8 or int8 payloads with one f32 scale
per (token, kv-head): the scale factors out of the attention dots
(q.(k.s) = (q.k).s).  The caches are preallocated and updated in place.

Under tensor-parallel serving a rank's caches hold the KV heads it attends
with (``serve.model.local_heads``: its own where the mesh's model group
splits whole KV heads, else all of them); the page table and the engine's
page allocator are the same on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from fp8tpu_torch._device import resolve_device
from fp8tpu_torch.kernels.qmatmul import (div_exact, flush_amax,
                                          fp8_payload)
from fp8tpu_torch.numerics.formats import FORMATS

KV_DTYPES = {
    "e4m3": torch.float8_e4m3fn,
    "e5m2": torch.float8_e5m2,
    # int8: the same bytes as fp8 but 7 value bits after the per-vector scale
    "int8": torch.int8,
    # bf16 "payload": the unquantized baseline with the same cache code
    "bf16": torch.bfloat16,
}
_FMT_OF = {v: k for k, v in KV_DTYPES.items()}


def quantize_kv(x: torch.Tensor, fmt: str = "e4m3"):
    """Quantize (..., kv_heads, head_dim) vectors to fp8/int8 with one scale
    per head vector.  Returns (payload, f32 scales with trailing dim 1).
    The clips keep the converts inside the payload's range; the amax and
    NaN payloads are XLA's (``qmatmul.flush_amax``, ``fp8_payload``)."""
    if fmt == "bf16":
        scale = torch.ones(x.shape[:-1] + (1,), dtype=torch.float32,
                           device=x.device)
        return x.to(torch.bfloat16), scale
    xf = x.to(torch.float32)
    amax = flush_amax(xf.abs().amax(dim=-1, keepdim=True))
    one = torch.ones_like(amax)
    if fmt == "int8":
        scale = torch.where(amax > 0, div_exact(amax, 127.0), one)
        payload = torch.clip(torch.round(xf / scale), -127, 127)
        return payload.to(torch.int8), scale
    top = FORMATS[fmt].max_normal
    scale = torch.where(amax > 0, div_exact(amax, top), one)
    return fp8_payload(torch.clip(xf / scale, -top, top), fmt), scale


def bits(t: torch.Tensor) -> torch.Tensor:
    """An integer view of ``t`` of the same width: gathers, scatters and
    copies of payload bytes are defined for every integer type."""
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()]
    return t if t.dtype == width else t.view(width)


@dataclasses.dataclass
class RingKVCache:
    """Ring-buffer KV cache, the serving decode's primary cache.

    One globally shared write head: decode step g writes EVERY slot's fresh
    k/v at physical row ``g mod S``, so a step's cache update is one
    contiguous slab store for the payload and one for the scales, made
    with the head's advance in one launch (``kernels.inplace.ring_store``).
    A slot keeps its most recent S tokens.  Validity per slot is
    ``(head - 1 - row) mod S < min(position, S)``.

      kv8 (S, 2, L, B*KV, D)  payloads, k at index 0, v at 1
      sc  (S, 2, L, B*KV)     f32 per-head-vector scales
      head ()                 int32 next write row, on the cache's device
      ticket (1,)             int32, 0 between launches: ring_store's count
                              of its blocks (made here when not given)

    ``kv8``, ``sc`` and ``head`` are updated in place by the decode and
    prefill functions, which return this same object.  A caller that keeps
    a head across a decode step keeps a clone of it.
    """

    kv8: torch.Tensor
    sc: torch.Tensor
    head: torch.Tensor
    ticket: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.ticket is None:
            self.ticket = torch.zeros(1, dtype=torch.int32,
                                      device=self.head.device)

    @staticmethod
    def create(n_layers: int, n_slots: int, max_seq: int, kv_heads: int,
               head_dim: int, fmt: str = "e4m3",
               device="cuda") -> "RingKVCache":
        dev = resolve_device(device)
        bk = n_slots * kv_heads
        return RingKVCache(
            kv8=torch.zeros((max_seq, 2, n_layers, bk, head_dim),
                            dtype=KV_DTYPES[fmt], device=dev),
            sc=torch.ones((max_seq, 2, n_layers, bk), dtype=torch.float32,
                          device=dev),
            head=torch.zeros((), dtype=torch.int32, device=dev),
        )

    @property
    def fmt(self) -> str:
        return _FMT_OF[self.kv8.dtype]

    @property
    def max_seq(self) -> int:
        return self.kv8.shape[0]


@dataclasses.dataclass
class KVCache:
    """Contiguous-slot KV cache in the attention-native layout.

    k8/v8: (L, B, KV, S, D) payloads; k_scale/v_scale: (L, B, KV, S) f32.
    ``update`` and ``update_slot`` write in place and return the cache.
    """

    k8: torch.Tensor
    v8: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor

    @staticmethod
    def create(n_layers: int, n_slots: int, max_seq: int, kv_heads: int,
               head_dim: int, fmt: str = "e4m3", device="cuda") -> "KVCache":
        dev = resolve_device(device)
        shape = (n_layers, n_slots, kv_heads, max_seq, head_dim)
        return KVCache(
            k8=torch.zeros(shape, dtype=KV_DTYPES[fmt], device=dev),
            v8=torch.zeros(shape, dtype=KV_DTYPES[fmt], device=dev),
            k_scale=torch.ones(shape[:-1], dtype=torch.float32, device=dev),
            v_scale=torch.ones(shape[:-1], dtype=torch.float32, device=dev),
        )

    @property
    def fmt(self) -> str:
        return _FMT_OF[self.k8.dtype]

    @property
    def max_seq(self) -> int:
        return self.k8.shape[3]

    def update(self, layer: int, k: torch.Tensor, v: torch.Tensor,
               start_pos: int) -> "KVCache":
        """Write (B, S_new, KV, D) keys/values at ``start_pos`` for every
        slot (the same position across slots)."""
        k8, ks = quantize_kv(k, self.fmt)
        v8, vs = quantize_kv(v, self.fmt)
        end = start_pos + k.shape[1]
        bits(self.k8)[layer, :, :, start_pos:end] = bits(k8).permute(0, 2, 1, 3)
        bits(self.v8)[layer, :, :, start_pos:end] = bits(v8).permute(0, 2, 1, 3)
        self.k_scale[layer, :, :, start_pos:end] = ks[..., 0].permute(0, 2, 1)
        self.v_scale[layer, :, :, start_pos:end] = vs[..., 0].permute(0, 2, 1)
        return self

    def update_slot(self, layer: int, slot: int, k: torch.Tensor,
                    v: torch.Tensor, start_pos: int) -> "KVCache":
        """Write (S_new, KV, D) for one slot (prefill of a new request)."""
        k8, ks = quantize_kv(k, self.fmt)
        v8, vs = quantize_kv(v, self.fmt)
        end = start_pos + k.shape[0]
        bits(self.k8)[layer, slot, :, start_pos:end] = bits(k8).permute(1, 0, 2)
        bits(self.v8)[layer, slot, :, start_pos:end] = bits(v8).permute(1, 0, 2)
        self.k_scale[layer, slot, :, start_pos:end] = ks[..., 0].permute(1, 0)
        self.v_scale[layer, slot, :, start_pos:end] = vs[..., 0].permute(1, 0)
        return self

    def layer(self, i: int):
        """(k8, v8, k_scale, v_scale) views for layer i."""
        return self.k8[i], self.v8[i], self.k_scale[i], self.v_scale[i]


def _with_scratch(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` with one more leading row (left as it is)."""
    store = torch.empty((t.shape[0] + 1,) + tuple(t.shape[1:]), dtype=t.dtype,
                        device=t.device)
    bits(store)[:-1] = bits(t)
    return store


@dataclasses.dataclass
class PagedKVCache:
    """Paged KV pool, the long-context serving cache.

    Pages of ``page_size`` tokens live in one physical pool shared by all
    slots; each slot owns a row of the page table mapping logical page ->
    physical page.  Unlike the ring cache (a per-slot sliding window of S),
    a slot's context grows to ``max_pages * page_size`` tokens, bounded by
    pool capacity, and pages are reclaimed on retirement.

      pool (P, 2, L, page_size*KV, D)   payloads, k at index 0, v at 1
      sc   (P, 2, L, page_size*KV)      f32 per-head-vector scales
      page_table (B, max_pages)         int32 physical ids, -1 = unmapped

    ``pool`` and ``sc`` are updated in place by the decode and prefill
    functions, which return this same object.

    **Dropped writes.**  A write to an unmapped page, past ``max_seq`` or
    from a padding row must change nothing (a slot overrunning its pages
    must never touch another slot's page).  An out-of-range scatter index is
    a device fault on CUDA, and selecting the kept rows would read their
    count back to the host, so the pool's storage is one page longer than
    the pool: ``pool`` and ``sc`` are views of its first P pages, and every
    scatter (:meth:`write_step`, the prompt and block writes of
    ``serve.model``) redirects its dropped rows to that scratch page P,
    which is never read.  Tensors handed to the constructor are copied into
    such storage; :meth:`create` allocates it directly.
    """

    pool: torch.Tensor
    sc: torch.Tensor
    page_table: torch.Tensor
    kv_heads: int
    store8: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                       repr=False)
    store_sc: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                         repr=False)

    def __post_init__(self):
        if self.store8 is None:
            self.store8 = _with_scratch(self.pool)
            self.store_sc = _with_scratch(self.sc)
            self.pool, self.sc = self.store8[:-1], self.store_sc[:-1]

    @staticmethod
    def create(n_pages: int, page_size: int, n_layers: int, n_slots: int,
               max_pages: int, kv_heads: int, head_dim: int,
               fmt: str = "e4m3", device="cuda") -> "PagedKVCache":
        dev = resolve_device(device)
        r = page_size * kv_heads
        store8 = torch.zeros((n_pages + 1, 2, n_layers, r, head_dim),
                             dtype=KV_DTYPES[fmt], device=dev)
        store_sc = torch.ones((n_pages + 1, 2, n_layers, r),
                              dtype=torch.float32, device=dev)
        return PagedKVCache(
            pool=store8[:-1], sc=store_sc[:-1],
            page_table=torch.full((n_slots, max_pages), -1,
                                  dtype=torch.int32, device=dev),
            kv_heads=kv_heads, store8=store8, store_sc=store_sc)

    @property
    def fmt(self) -> str:
        return _FMT_OF[self.pool.dtype]

    @property
    def n_pages(self) -> int:
        return self.pool.shape[0]

    @property
    def page_size(self) -> int:
        return self.pool.shape[3] // self.kv_heads

    @property
    def max_pages(self) -> int:
        return self.page_table.shape[1]

    @property
    def max_seq(self) -> int:
        return self.max_pages * self.page_size

    @property
    def n_slots(self) -> int:
        return self.page_table.shape[0]

    def assign_pages(self, slot, logical_pages, physical_pages
                     ) -> "PagedKVCache":
        """Map physical pages into a slot's table (host-side admission).
        The table is replaced, not written in place: launches already queued
        go on reading the one they were given."""
        table = self.page_table.clone()
        dev = table.device
        table[slot, torch.as_tensor(logical_pages, device=dev
                                    ).to(torch.int64)] = \
            torch.as_tensor(physical_pages, device=dev).to(torch.int32)
        return dataclasses.replace(self, page_table=table)

    def free_slot(self, slot) -> "PagedKVCache":
        table = self.page_table.clone()
        table[slot] = -1
        return dataclasses.replace(self, page_table=table)

    def scatter(self, pgi: torch.Tensor, ri: torch.Tensor, u8: torch.Tensor,
                us: torch.Tensor) -> "PagedKVCache":
        """The pool's one scatter: payload rows ``u8`` (..., 2, L, D) and
        scales ``us`` (..., 2, L) land at page ``pgi`` and row ``ri`` (int64,
        broadcast against each other to the leading dims); a page id equal
        to ``n_pages`` is the scratch page, where dropped rows go."""
        bits(self.store8)[pgi, :, :, ri, :] = bits(u8)
        self.store_sc[pgi, :, :, ri] = us
        return self

    def write_step(self, fk8: torch.Tensor, fks: torch.Tensor,
                   fv8: torch.Tensor, fvs: torch.Tensor, pos: torch.Tensor
                   ) -> "PagedKVCache":
        """Scatter one decode step's fresh k/v for every slot, in place.

        fk8/fv8: (L, B, KV, D) quantized payloads; fks/fvs: (L, B, KV);
        pos: (B,) each slot's write position.  Slot b's token lands in page
        ``page_table[b, pos_b // page]`` at row offset ``(pos_b % page) *
        KV``.  Writes to unmapped pages or beyond max_seq are DROPPED (they
        go to the scratch page), never redirected onto a live page."""
        KV = self.kv_heads
        dev = self.pool.device
        pos = pos.to(torch.int64)
        lp = torch.clamp(pos // self.page_size, max=self.max_pages - 1)
        pg = self.page_table.to(torch.int64).gather(1, lp[:, None])[:, 0]
        pg = torch.where((pg >= 0) & (pos < self.max_seq), pg, self.n_pages)
        rows = (pos % self.page_size)[:, None] * KV \
            + torch.arange(KV, device=dev)[None]            # (B, KV)
        # updates indexed (B, KV, 2, L, D) / (B, KV, 2, L)
        u8 = torch.stack([bits(fk8), bits(fv8)]).permute(2, 3, 0, 1, 4)
        us = torch.stack([fks, fvs]).permute(2, 3, 0, 1)
        return self.scatter(pg[:, None], rows, u8, us)

    def gather(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Materialise every slot's mapped pages as a contiguous copy:
        returns (kv8 (B, MP, 2, L, page*KV, D), sc (B, MP, 2, L, page*KV));
        an unmapped entry reads page 0."""
        safe = torch.clamp(self.page_table, min=0).to(torch.int64)
        return bits(self.pool)[safe].view(self.pool.dtype), self.sc[safe]
