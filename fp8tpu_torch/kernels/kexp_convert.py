"""T1, the fp8 -> bf16 convert and decode-attention dot study
(``csrc/kexp_convert.cu``): its wrapper, launch count, plain version and
the e4m3 converts that T1 and T2 compare.

Replaces ``tools/kexp_convert.py::stream``.  q is (BKV, 1, 8, 128) bf16
and k (BKV, 1, 512, 128) e4m3 (``torch.float8_e4m3fn`` or its bytes as
uint8) or bf16; the study's data set is R of each, as a leading rep
dimension.  ``out`` (8, 128) f32 is the sum over every rep and tile of the
mode's slice (the tile's converted 8 x 128 corner, ``scores[:, :128]`` of
q . k^T, or the full flash block's unnormalised ctx with V = K), and
``fold`` (R, BKV) one checksum per tile over everything the mode computed
(every converted element, or every score), which keeps the kernel's
measured work real.  The tool's kernel never stores its output (ROADMAP
§3); the port writes the sum.

The converts: "astype" is the hardware e4m3 convert (``.to`` here,
``cvt`` to f16x2 in the kernel), "bits" the tool's integer pipeline
(:func:`e4m3_bits_to_bf16`), "magic" the T2 tool's select plus table
(:func:`e4m3_magic_to_bf16`).  All three give the same values; bits and
magic turn the NaN bytes into ``0x7FC0 | sign``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from fp8tpu_torch._device import full_fp32

from . import _build
from .qmatmul import sm_count

# The tool's seven modes, then the full block with the hardware convert
# (the port's own: the form a tensor-core K4 would take).
TOOL_MODES = ("conv-bf16", "conv-astype", "conv-bits", "dot-bf16",
              "dot-fp8-astype", "dot-fp8-bits", "full-fp8-bits")
MODES = TOOL_MODES + ("full-fp8-astype",)
BF16_MODES = ("conv-bf16", "dot-bf16")
S, D, G = 512, 128, 8          # tokens a tile, head width, q rows

# Kernel launches since the last reset_launches(), in all and by mode: a
# call of stream() makes two, the stream kernel and the merge of its
# per-block partials.
launches = 0
mode_launches = {m: 0 for m in MODES}


def reset_launches() -> None:
    global launches
    launches = 0
    for m in mode_launches:
        mode_launches[m] = 0


# -- the converts --------------------------------------------------------------

def e4m3_bits_to_bf16(u8: torch.Tensor) -> torch.Tensor:
    """bf16 bit patterns (int32, 0..65535) of e4m3 bytes by the tool's
    integer pipeline (``tools/kexp_convert.py::e4m3_bits_to_bf16``)."""
    x = u8.to(torch.int32)
    sign = (x & 0x80) << 8
    mag = x & 0x7F
    normal = (mag << 4) + (120 << 7)
    sub_f = (mag & 7).to(torch.float32) * 2.0 ** -9
    sub = (sub_f.view(torch.int32) >> 16) & 0xFFFF
    bits = torch.where((mag >> 3) == 0, sub, normal)
    bits = torch.where(mag == 0x7F, torch.full_like(bits, 0x7FC0), bits)
    return sign | bits


def _prmt(a: torch.Tensor, b: int, sel: int) -> torch.Tensor:
    """``__byte_perm(a, b, sel)`` on 32-bit values held in int64: output
    byte i is byte ``sel >> 4i & 7`` of (a, b)."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] \
        + [torch.full_like(a, (b >> (8 * i)) & 0xFF) for i in range(4)]
    out = torch.zeros_like(a)
    for i in range(4):
        out = out | (src[(sel >> (4 * i)) & 7] << (8 * i))
    return out


def _mul_bf16x2(a: torch.Tensor, c: int) -> torch.Tensor:
    """``mul.rn.bf16x2`` on 32-bit values held in int64, through f32: the
    product of two bf16 values is exact in f32 (subnormals kept, as torch
    keeps them on the CPU), then rounded to bf16 to nearest even."""
    out = torch.zeros_like(a)
    for sh in (0, 16):
        x = ((((a >> sh) & 0xFFFF) << 16).to(torch.int32)).view(
            torch.float32)
        y = torch.tensor(((c >> sh) & 0xFFFF) << 16, dtype=torch.int64
                         ).to(torch.int32).view(torch.float32)
        u = (x * y).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        r = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
        out = out | ((r & 0xFFFF) << sh)
    return out


def _ge_bf16x2(a: torch.Tensor, c: int) -> torch.Tensor:
    """``set.ge.u32.bf16x2``: 0xFFFF in each half where a's bf16 value is
    at least c's (both non-negative here), else 0."""
    out = torch.zeros_like(a)
    for sh in (0, 16):
        x = ((((a >> sh) & 0xFFFF) << 16).to(torch.int32)).view(
            torch.float32)
        y = torch.tensor(((c >> sh) & 0xFFFF) << 16, dtype=torch.int64
                         ).to(torch.int32).view(torch.float32)
        out = out | (torch.where(x >= y, 0xFFFF, 0) << sh)
    return out


def bits_pair_twin(w: torch.Tensor, lo: int = 0, hi: int = 1) -> torch.Tensor:
    """The kernel's packed bits convert (``csrc/e4m3_convert.cuh::
    bits_pair<lo, hi>``) step for step on 32-bit words held in int64:
    bytes ``lo`` and ``hi`` of each word -> a bf16x2 word (byte ``lo`` in
    the low half) as int64."""
    m32 = 0xFFFFFFFF
    x = _prmt(w.to(torch.int64), 0, 0x4040 | (hi << 8) | lo)
    m4 = (x << 4) & 0x07F007F0
    normal = m4 + 0x3C003C00
    sub = _mul_bf16x2(m4, 0x7B807B80)
    ge8 = _ge_bf16x2(m4, 0x00800080)
    nan = _ge_bf16x2(m4, 0x07F007F0)
    b = (normal & ge8) | (sub & ~ge8 & m32)
    return ((b & ~nan & m32) | (0x7FC07FC0 & nan)) | ((x << 8) & 0x80008000)


_SUB_TABLE = (0x0000, 0x3B00, 0x3B80, 0x3BC0, 0x3C00, 0x3C20, 0x3C40, 0x3C60)


def e4m3_magic_to_bf16(u8: torch.Tensor) -> torch.Tensor:
    """bf16 bit patterns (int32) of e4m3 bytes by the magic-bias convert
    (``tools/bench_pallas_linear.py::conv_magic``): normals where mag >= 8,
    subnormals m * 2^-9 from an eight-entry table."""
    x = u8.to(torch.int32)
    mag = x & 0x7F
    normal = (mag << 4) + (120 << 7)
    table = torch.tensor(_SUB_TABLE, dtype=torch.int32, device=x.device)
    bits = torch.where(mag >= 8, normal, table[mag & 7])
    bits = torch.where(mag == 0x7F, torch.full_like(bits, 0x7FC0), bits)
    return ((x & 0x80) << 8) | bits


def bf16_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """bf16 values of 16-bit patterns held in int32."""
    wrapped = torch.where(bits >= 0x8000, bits - 0x10000, bits)
    return wrapped.to(torch.int16).view(torch.bfloat16)


def e4m3_bytes(k: torch.Tensor) -> torch.Tensor:
    if k.dtype == torch.float8_e4m3fn:
        return k.view(torch.uint8)
    if k.dtype != torch.uint8:
        raise ValueError(f"an e4m3 payload is float8_e4m3fn or uint8, got "
                         f"{k.dtype}")
    return k


def convert(k: torch.Tensor, how: str) -> torch.Tensor:
    """e4m3 (float8_e4m3fn or bytes) -> bf16 by ``how``: "astype", "bits"
    or "magic"."""
    u8 = e4m3_bytes(k)
    if how == "astype":
        return u8.view(torch.float8_e4m3fn).to(torch.bfloat16)
    if how == "bits":
        return bf16_from_bits(e4m3_bits_to_bf16(u8))
    if how == "magic":
        return bf16_from_bits(e4m3_magic_to_bf16(u8))
    raise ValueError(f"unknown convert {how!r}")


def tile_values(k: torch.Tensor, mode: str) -> torch.Tensor:
    """The mode's converted tile values as f32."""
    if mode in BF16_MODES:
        return k.to(torch.float32)
    return convert(k, "astype" if mode.endswith("astype") else "bits"
                   ).to(torch.float32)


# -- the data set --------------------------------------------------------------

def _check(q: torch.Tensor, k: torch.Tensor, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    bkv = k.shape[-4] if k.ndim >= 4 else -1
    if (k.ndim not in (4, 5) or q.ndim != k.ndim
            or tuple(k.shape[-3:]) != (1, S, D)
            or tuple(q.shape[-4:]) != (bkv, 1, G, D)
            or q.shape[:-4] != k.shape[:-4]):
        raise ValueError(f"stream needs q ([R,] BKV, 1, {G}, {D}) and k ([R,] "
                         f"BKV, 1, {S}, {D}), got {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"q must be bf16, got {q.dtype}")
    if mode in BF16_MODES:
        if k.dtype != torch.bfloat16:
            raise ValueError(f"{mode} needs a bf16 k, got {k.dtype}")
    else:
        e4m3_bytes(k)


def rep_inputs(q: torch.Tensor, k: torch.Tensor, reps: int, cold: bool):
    """(q, k) with a leading rep dimension of ``reps``: an expanded view with
    stride 0 (warm: the same copy re-read, from L2 where it fits), or, with
    ``cold``, ``reps`` real copies read once each."""
    qr = q.unsqueeze(0).expand(reps, *q.shape)
    kr = k.unsqueeze(0).expand(reps, *k.shape)
    if cold:
        return qr.contiguous(), kr.contiguous()
    return qr, kr


def stream_plain(q: torch.Tensor, k: torch.Tensor, mode: str, reps: int = 8
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`stream` (any device): the same converts,
    f32 dots of exact bf16 products, sums over tiles and reps in f64."""
    _check(q, k, mode)
    if k.ndim == 4:
        q, k = rep_inputs(q, k, reps, False)
    outs, folds = [], []
    for r in range(k.shape[0]):
        if r > 0 and k.stride(0) == 0 and q.stride(0) == 0:
            outs.append(outs[-1])
            folds.append(folds[-1])
            continue
        kf = tile_values(k[r, :, 0], mode)               # (BKV, S, D)
        qf = q[r, :, 0].to(torch.float32)                 # (BKV, G, D)
        if mode.startswith("conv"):
            part = kf[:, :G, :]
            fold = kf.double().sum((1, 2))
        else:
            with full_fp32():
                sc = torch.matmul(qf, kf.transpose(1, 2))  # (BKV, G, S)
                if mode.startswith("full"):
                    p = torch.exp(sc - sc.amax(-1, keepdim=True))
                    part = torch.matmul(p.to(torch.bfloat16).to(torch.float32),
                                        kf)
                else:
                    part = sc[..., :D]
            fold = sc.double().sum((1, 2))
        outs.append(part.double().sum(0))
        folds.append(fold)
    out = torch.stack(outs).sum(0).to(torch.float32)
    return out, torch.stack(folds).to(torch.float32)


# -- the error bound ---------------------------------------------------------------

ORDER_C = 16.0      # as K2's: 4x the worst f32 sum seen on the card

# The kernel's layout (csrc/kexp_convert.cu): 8 warps of 32 threads walk
# a tile in 64 KB chunks.
_WARPS, _LANES, _CHUNK = 8, 32, 65536


def _fold_walk(vals: torch.Tensor, mode: str) -> torch.Tensor:
    """Sum of the squared partial sums, per tile, of the kernel's fold of
    ``vals`` (f64; (BKV, S, D) tile values for conv, (BKV, G, S) scores
    otherwise): each thread's running sum over its elements, the warp's
    butterfly, the block's sum over warps in order, then over chunks."""
    bf16 = mode in BF16_MODES
    rows = _CHUNK // ((2 if bf16 else 1) * D)             # tokens a chunk
    chunks = S // rows
    bkv = vals.shape[0]
    if mode.startswith("conv"):
        # thread t's j-th 16-byte piece is piece t + 256 j of the chunk
        per = 8 if bf16 else 16
        seq = vals.reshape(bkv, chunks, -1, _WARPS * _LANES, per)
        seq = seq.transpose(2, 3).reshape(bkv, chunks, _WARPS, _LANES, -1)
    else:
        # lane 4g + c of warp w holds, mt-major, the m16n8 accumulator
        # element e of token (chunk, w, mt, hi = e / 2, g) by q row
        # (c, lo = e % 2)
        seq = vals.reshape(bkv, 4, 2, chunks, _WARPS, -1, 2, 8)
        seq = seq.permute(0, 3, 4, 7, 1, 5, 6, 2).reshape(
            bkv, chunks, _WARPS, _LANES, -1)
    part = torch.cumsum(seq, -1)
    walk = (part ** 2).sum((1, 2, 3, 4))
    v = part[..., -1]                                     # (BKV, chunks, 8, 32)
    for k in range(1, 6):                                 # the butterfly
        walk += (v.reshape(bkv, chunks, _WARPS, 2 ** k, -1).sum(3) ** 2
                 ).sum((1, 2, 3))
    warp = torch.cumsum(v.sum(-1), -1)                    # red[] in warp order
    walk += (warp ** 2).sum((1, 2))
    return walk + (torch.cumsum(warp[..., -1], -1) ** 2).sum(1)


def error_bound(q: torch.Tensor, k: torch.Tensor, mode: str, reps: int,
                c: float = ORDER_C):
    """(exact, tol, fold_exact, fold_tol) of ``mode`` over ``reps`` reps of
    one copy of (q, k): the f64 out and fold, and the largest |f32 out -
    exact| and |f32 fold - fold_exact| allowed, elementwise and per tile.

    Roundings of a long f32 sum add like a random walk, so both bounds are
    ``c * 2^-24 * sqrt(sum of squared partial sums)``; a worst-case bound
    would pass a dropped tile, or a dropped warp's share of one.  out is a
    sum of n = reps * BKV tile terms c_j, each itself an f32 sum (D
    products for a score, S for ctx), in any order of the items: the
    partial sums are taken as n (2 max|S_j| + max|c_j|)^2 over the prefix
    sums S_j, plus each term's own terms_j * mag_j^2 (mag_j the sum of
    |products|).  The full mode also rounds p = exp(s - m) to bf16: the
    score's own rounding (taken as 4 sqrt(D) 2^-24 sum|q k|) moves p
    continuously, and where it or expf's carries p across a bf16 rounding
    boundary p moves by one bf16 step (2^-8 p); both add over the tiles as
    a random walk, taken 4 times.  The fold follows the kernel's own
    summation of each tile (:func:`_fold_walk`), plus D * mag^2 for each
    score's dot."""
    kf = tile_values(k[:, 0], mode).double()              # (BKV, S, D)
    qf = q[:, 0].double()
    bkv = kf.shape[0]
    flips = torch.zeros(G, D, dtype=torch.float64, device=kf.device)
    if mode.startswith("conv"):
        cterm = kf[:, :G, :]
        inner = torch.zeros_like(cterm)
        fold = kf.sum((1, 2))
        fold_walk = _fold_walk(kf, mode)
    else:
        sc = qf @ kf.transpose(1, 2)                      # (BKV, G, S)
        sc_abs = qf.abs() @ kf.abs().transpose(1, 2)
        fold = sc.sum((1, 2))
        fold_walk = _fold_walk(sc, mode) + D * (sc_abs ** 2).sum((1, 2))
        if mode.startswith("full"):
            p = torch.exp(sc - sc.amax(-1, keepdim=True))
            pb = p.float().to(torch.bfloat16).double()
            cterm = pb @ kf
            inner = S * (pb @ kf.abs()) ** 2
            # the score's order error and the max's move p continuously ...
            ds = 4.0 * D ** 0.5 * 2.0 ** -24 * sc_abs
            dm = ds.amax(-1, keepdim=True)
            cont = (p * (ds + dm)) @ kf.abs()
            # ... and may carry it across a bf16 rounding boundary
            rho = (2.0 ** 8 * (ds + dm + 2.0 ** -21)).clamp(max=1.0)
            flips = 4.0 * ((reps * (cont ** 2).sum(0)).sqrt()
                           + 2.0 ** -8 * (reps * ((rho * p * p) @ (kf * kf)
                                                  ).sum(0)).sqrt())
        else:
            cterm = sc[..., :D]
            inner = D * sc_abs[..., :D] ** 2
    n = reps * bkv
    smax = torch.cumsum(cterm, 0).abs().amax(0) + reps * cterm.sum(0).abs()
    walk = n * (2 * smax + cterm.abs().amax(0)) ** 2 + reps * inner.sum(0)
    tol = c * 2.0 ** -24 * walk.sqrt() + flips + n * 2.0 ** -149
    fold_tol = c * 2.0 ** -24 * fold_walk.sqrt() + 2.0 ** -149
    return reps * cterm.sum(0), tol, fold, fold_tol


# -- the kernel ------------------------------------------------------------------

@functools.cache
def _fn():
    fn = _build.load("kexp_convert").fp8_kexp_stream
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 \
        + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def stream(q: torch.Tensor, k: torch.Tensor, mode: str, reps: int = 8,
           cold: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (8, 128) f32, fold (R, BKV) f32) of ``mode`` over R reps of
    (q, k).  q and k are one copy (made into R by :func:`rep_inputs` with
    ``reps`` and ``cold``) or already carry the rep dimension, whose stride
    the kernel follows.  The kernel on CUDA tensors, the plain version on
    the CPU."""
    global launches
    _check(q, k, mode)
    if k.ndim == 4:
        q, k = rep_inputs(q, k, reps, cold)
    if not k.is_cuda:
        return stream_plain(q, k, mode)
    if not (q[0].is_contiguous() and k[0].is_contiguous()):
        raise ValueError("stream needs each rep of q and k contiguous")
    reps, bkv = k.shape[0], k.shape[1]
    if reps * bkv >= 2 ** 31:
        raise ValueError("stream: too many (rep, tile) items")
    dev = k.device
    blocks = min(sm_count(dev.index or 0), reps * bkv)
    out = torch.empty((G, D), dtype=torch.float32, device=dev)
    fold = torch.empty((reps, bkv), dtype=torch.float32, device=dev)
    partial = torch.empty((blocks, G, D), dtype=torch.float32, device=dev)
    kd = k if mode in BF16_MODES else e4m3_bytes(k)
    err = _fn()(q.data_ptr(), kd.data_ptr(), out.data_ptr(), fold.data_ptr(),
                partial.data_ptr(), bkv, reps, q.stride(0) * q.element_size(),
                kd.stride(0) * kd.element_size(), MODES.index(mode), blocks,
                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"kexp_convert kernel ({mode})")
    launches += 2
    mode_launches[mode] += 2
    return out, fold
