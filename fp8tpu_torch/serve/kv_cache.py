"""Quantized KV caches (ring and contiguous-slot; fp8 / int8 / bf16
payloads).

Keys and values are stored as real fp8 or int8 payloads with one f32 scale
per (token, kv-head): the scale factors out of the attention dots
(q.(k.s) = (q.k).s).  The caches are preallocated and updated in place.
The paged pool (``PagedKVCache``) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from fp8tpu_torch._device import resolve_device
from fp8tpu_torch.kernels.qmatmul import div_exact
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
    The clips keep the converts inside the payload's range."""
    if fmt == "bf16":
        scale = torch.ones(x.shape[:-1] + (1,), dtype=torch.float32,
                           device=x.device)
        return x.to(torch.bfloat16), scale
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    one = torch.ones_like(amax)
    if fmt == "int8":
        scale = torch.where(amax > 0, div_exact(amax, 127.0), one)
        payload = torch.clip(torch.round(xf / scale), -127, 127)
        return payload.to(torch.int8), scale
    top = FORMATS[fmt].max_normal
    scale = torch.where(amax > 0, div_exact(amax, top), one)
    payload = torch.clip(xf / scale, -top, top)
    return payload.to(KV_DTYPES[fmt]), scale


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
    contiguous slab store (``kernels.inplace.dyn_store``) for the payload
    and one for the scales.  A slot keeps its most recent S tokens.
    Validity per slot is ``(head - 1 - row) mod S < min(position, S)``.

      kv8 (S, 2, L, B*KV, D)  payloads, k at index 0, v at 1
      sc  (S, 2, L, B*KV)     f32 per-head-vector scales
      head ()                 int32 next write row, on the cache's device

    ``kv8`` and ``sc`` are updated in place by the decode and prefill
    functions, which return this same object with a new ``head``.
    """

    kv8: torch.Tensor
    sc: torch.Tensor
    head: torch.Tensor

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
