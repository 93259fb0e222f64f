"""K2, the fused fake-quant GEMM (``csrc/qmatmul.cu``), K3, the serving
dequant-GEMM (``csrc/dequant_matmul.cu``), and the W8A8 serving linear's
P1 and P2 (``csrc/w8a8.cu``): wrappers, launch counts and plain
versions.

K2 replaces ``fp8tpu/kernels/qmatmul.py::_qdq_matmul_kernel``:
``qdq(x; sx) @ qdq(w; sw[N])`` with f32-accurate sums, each operand cast
by the bit pipeline (``impl="bitexact"``) or the hardware-convert route
(``impl="hw"``: ``hw_qdq`` / ``hw_sr`` for e4m3, e5m2 and bfloat16, the
bit pipeline for every other format, float16 included), rounding to
nearest or stochastically.  Stochastic operands take the bits of the JAX
package's CPU route (``_qdq_matmul_jnp``): the counter hash salted by
``fold_in(fold_in(key(0), seed), tag)``, tag 1 for x and 2 for w, over
the operand's row-major index, or, for an operand that is a rank's block
of a split tensor (``block_x`` / ``block_w``, a ``parallel.data.Block``),
over each element's index in the whole tensor, as the single-process
call draws it.

On a CUDA tensor a K2 call is a cast pre-pass over each operand
(:func:`grid_operand` is its plain version: the cast without its last
descale, then :func:`split_bf16` into bf16 planes) and one GEMM on the
tensor cores that applies the descale in its epilogue
(:func:`descale`).  :func:`conv` is the engine conv as an implicit GEMM
over the activation's grid values.  The plain version, :func:`plain`,
casts both operands with the plain casts and multiplies with
``torch.matmul`` in full f32; the wrappers use it only for tensors on the
CPU.

With ``impl="hw"`` and both operands on formats of at most 7 mantissa
bits the JAX package leaves Pallas (``_hw_xla_ok``): each operand is cast
once onto its scaled grid, exact in bf16, the two are contracted with
f32 accumulation and the product is descaled.  :func:`qdq_matmul` does
the same with plain casts and a full-f32 ``torch.matmul`` on every
device: that route has no kernel to port.

K3 replaces ``fp8tpu/kernels/qmatmul.py::_dequant_matmul_kernel``:
``(x @ upcast(w8)) * s[N]`` with the payload upcast to bf16 in registers,
f32 accumulation, the per-output-channel scale in the epilogue and one
rounding to ``out_dtype``.  Every serving linear on a CUDA tensor is one
launch of it (W8A8's int8 route passes a per-row scale too).
:func:`quantize_weights` makes its payloads.  Operands that
TMA can read run the streaming loop (``csrc/w_stream.cuh``), which K5 and
T2 share: its decode form at M <= 64 (:func:`streams`, planned by
:func:`stream_plan`), its prefill route above (:func:`prefills`,
:func:`prefill_plan`); other shapes run the general kernel
(``csrc/w_gemm.cuh``).  :func:`weight_gemm_plan` decides, before the
launch.

P1 and P2 have no TPU counterpart (the JAX package's
``matmul_impl="direct"`` is XLA ops): :func:`quantize_rows` quantizes an
activation per row to e4m3, :func:`w8a8_matmul` contracts the codes with
an e4m3 / e5m2 weight on the fp8 tensor cores.  For int8 weights P2
writes the codes' exact f16 values and K3 contracts them on its int8
route (f16 tensor cores, no convert launch between the two).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from fp8tpu_torch._device import full_fp32
from fp8tpu_torch.numerics import prng
from fp8tpu_torch.numerics.cast import (_flush, _mul, _recip, cast_array,
                                        hw_qdq, hw_sr, require_hash_stream,
                                        sr_bits)
from fp8tpu_torch.numerics.formats import FORMATS, RoundMode

from . import _build
from .cast_kernel import FMT_IDS, block_args, variant_code

# Launches of K2's GEMM and of K3 since the last reset_launches(); K2's
# GEMMs also by variant ("bitexact" and "hw" casts, or "uncast": neither
# operand cast), and K2's cast pre-passes ("prepass": one for each operand
# that the GEMM does not read as it is; of them "prepass_block" those that
# hash a block's global indices); K3's also by route (the streaming loop's
# decode form "stream", its "prefill" route, the "general" kernel).
launches = 0
k2_launches = {"bitexact": 0, "hw": 0, "uncast": 0, "prepass": 0,
               "prepass_block": 0}
dequant_launches = 0
dequant_routes = {"stream": 0, "prefill": 0, "general": 0}

_MAX_ROWS = 65535 * 64  # the pre-pass's grid.y limit times its 64-row tile
IMPLS = ("bitexact", "hw")
# Formats that K2's "hw" route converts natively; others take the bit
# pipeline (``fp8tpu/kernels/qmatmul.py::_HW_KERNEL_FMTS``).
HW_KERNEL_FMTS = ("e4m3", "e5m2", "bfloat16")
# Formats whose bit-pipeline cast takes no scale (cast.cuh::cast_elem).
_UNSCALED_FMTS = ("bfloat16", "float16", "e5m2_flex")
K2_BK = 32       # K slab of the GEMM (csrc/qmatmul.cu::BK)
# K slabs a tensor-core chunk sums before it is added into the f32
# accumulator (chip_smoke.py's k2_probe phase measures the choice).
K2_PROMOTE = 4


def reset_launches() -> None:
    global launches, dequant_launches, quantize_launches, w8a8_launches
    launches = dequant_launches = quantize_launches = w8a8_launches = 0
    for counts in (k2_launches, dequant_routes, w8a8_routes):
        for key in counts:
            counts[key] = 0


def _scale_vector(scale, n: int, device) -> torch.Tensor:
    """``scale`` (a number, or a tensor that broadcasts to (n,)) as n f32
    values on ``device``; a number is filled there (no host copy, so a
    launch can be captured in a CUDA graph)."""
    if not isinstance(scale, torch.Tensor):
        return torch.full((n,), float(scale), dtype=torch.float32,
                          device=device)
    s = scale.to(device=device, dtype=torch.float32).reshape(-1)
    return s.expand(n).contiguous() if s.numel() == 1 else s.contiguous()


def _scales(x, w, scale_x, scale_w):
    """(sx (1,), sw (N,)): the per-tensor and per-column scales, f32 on
    x's device."""
    sx = _scale_vector(scale_x.reshape(-1)[:1] if isinstance(
        scale_x, torch.Tensor) else scale_x, 1, x.device)
    return sx, _scale_vector(scale_w, w.shape[1], x.device)


def _check(x, w, impl):
    if impl not in IMPLS:
        raise ValueError(f"qdq_matmul impl must be one of {IMPLS}, got "
                         f"{impl!r}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"qdq_matmul needs (M, K) @ (K, N), got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")


def _hw_xla_ok(fmt_x, fmt_w) -> bool:
    """Whether ``impl="hw"`` takes the route outside the kernel: both
    operands quantized to formats with at most 7 mantissa bits, whose
    scaled grid values are exact in bf16."""
    return (fmt_x is not None and fmt_w is not None
            and FORMATS[fmt_x].mant_bits <= 7
            and FORMATS[fmt_w].mant_bits <= 7)


def sr_key(seed: int, tag: int, fmt: Optional[str],
           mode: RoundMode) -> Optional[prng.PRNGKey]:
    """The SR key of a stochastic operand (tag 1 for x, 2 for w), as the
    JAX package folds it; None when the operand is uncast or rounds to
    nearest."""
    if fmt is None or mode != RoundMode.STOCHASTIC:
        return None
    return prng.fold_in(prng.fold_in(prng.key(0), seed), tag)


def sr_salt(seed: int, tag: int, fmt: Optional[str],
            mode: RoundMode) -> Optional[int]:
    """The salt of :func:`sr_key`'s stream, which the kernel hashes; None
    when the operand is uncast or rounds to nearest."""
    k = sr_key(seed, tag, fmt, mode)
    return None if k is None else prng.salt_of(k)


def _hw_native(fmt, impl) -> bool:
    return impl == "hw" and fmt in HW_KERNEL_FMTS


def cast_operand(v, fmt, mode, scale, impl, key, descale=True, block=None):
    """One operand through the plain casts: K2's cast (``descale=False``
    gives the scaled grid values, see :func:`grid_operand`).  ``key`` is
    the operand's SR key (:func:`sr_key`: the stream ``sr_bits`` draws
    under ``SR_BITS_IMPL``) or None; ``block`` (a ``parallel.data.Block``
    or None) places ``v`` in the tensor whose bits it draws."""
    rb = None if key is None else sr_bits(key, v.shape, v.device,
                                          block=block)
    if _hw_native(fmt, impl):
        if mode == RoundMode.STOCHASTIC:
            return hw_sr(v, fmt, scale, rb, descale)
        return hw_qdq(v, fmt, scale, descale)
    return cast_array(v, scale, rb, fmt, mode, descale=descale)


def grid_operand(v, fmt, mode, scale, impl, key, block=None):
    """The plain version of K2's cast pre-pass: the operand's scaled grid
    values, the cast with its last descale left out (uncast: ``v``)."""
    v = v.to(torch.float32)
    return v if fmt is None else cast_operand(v, fmt, mode, scale, impl,
                                              key, descale=False, block=block)


def descale_kind(fmt, impl) -> int:
    """The cast's last operation, which K2's epilogue applies to the sum:
    0 none (uncast, or a format whose cast takes no scale), 1 ``mul_ftz``
    by the reciprocal (the bit pipeline), 2 ``div_ftz`` by the scale
    (hw)."""
    if fmt is None:
        return 0
    if _hw_native(fmt, impl):
        return 2
    return 0 if fmt in _UNSCALED_FMTS else 1


def descale(acc, kind: int, scale):
    """The plain version of K2's epilogue descale (one operand)."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=acc.device)
    if kind == 1:
        return _mul(acc, _recip(scale))
    if kind == 2:
        return _flush(acc / _flush(scale))
    return acc


def planes_of(fmt) -> int:
    """bf16 planes of an operand's grid values: 1 where the format has at
    most 7 mantissa bits (exact in bf16), else 3 (:func:`split_bf16`)."""
    return 3 if fmt is None or fmt == "float16" else 1


def _bits(v: torch.Tensor) -> torch.Tensor:
    return v.contiguous().view(torch.int32)


def split_bf16(v: torch.Tensor):
    """The pre-pass's exact split of f32 values into bf16 planes (hi, mid,
    lo), by truncation: hi = the top 16 bits, mid = the top 16 of the
    exact remainder, lo = the rest rounded to bf16.  hi + mid + lo == v
    for every finite |v| >= 2^-110 and for 0 (below, lo keeps what bf16's
    least subnormal 2^-133 allows); inf and NaN (quieted) go to hi whole."""
    v = v.to(torch.float32)

    def top(t):        # the top 16 bits as bf16
        return (_bits(t) >> 16).to(torch.int16).view(torch.bfloat16)

    def low_cleared(t):
        return (_bits(t) & -65536).view(torch.float32)

    special = ~torch.isfinite(v)
    nan_quiet = torch.where(torch.isnan(v), 0x00400000, 0).to(torch.int32)
    hi = top((_bits(v) | nan_quiet).view(torch.float32))
    r = torch.where(special, 0.0, v - low_cleared(v))
    mid = low_cleared(r)
    return hi, top(mid), (r - mid).to(torch.bfloat16)


def plain(x, w, fmt_x: Optional[str] = "e4m3",
          mode_x: RoundMode = RoundMode.RNE, fmt_w: Optional[str] = "e4m3",
          mode_w: RoundMode = RoundMode.RNE, scale_x=1.0, scale_w=1.0,
          seed: int = 0, impl: str = "bitexact", block_x=None, block_w=None):
    """The plain version of K2 (any device): plain casts, then a full-f32
    ``torch.matmul``."""
    sx, sw = _scales(x, w, scale_x, scale_w)
    xq = x.to(torch.float32)
    wq = w.to(torch.float32)
    if fmt_x is not None:
        xq = cast_operand(xq, fmt_x, mode_x, sx[0], impl,
                          sr_key(seed, 1, fmt_x, mode_x), block=block_x)
    if fmt_w is not None:
        wq = cast_operand(wq, fmt_w, mode_w, sw.reshape(1, -1), impl,
                          sr_key(seed, 2, fmt_w, mode_w), block=block_w)
    with full_fp32():
        return torch.matmul(xq, wq)


def _hw_grid_matmul(x, w, fmt_x, mode_x, fmt_w, mode_w, scale_x, scale_w,
                    seed, block_x=None, block_w=None):
    """The "hw" route outside the kernel: each operand cast once onto its
    scaled grid and rounded to bf16 (exact), an f32 contraction of the
    bf16 values (``torch.matmul`` on bf16 tensors would round its result
    to bf16), the descale last.  Formats without a hardware dtype are
    cast, then multiplied by the scale, as the JAX package does."""
    sx, sw = _scales(x, w, scale_x, scale_w)
    sw = sw.reshape(1, -1)

    def grid(v, fmt, mode, scale, tag, block):
        v = v.to(device=x.device, dtype=torch.float32)
        key = sr_key(seed, tag, fmt, mode)
        if _hw_native(fmt, "hw"):
            return cast_operand(v, fmt, mode, scale, "hw", key,
                                descale=False, block=block)
        return _mul(cast_operand(v, fmt, mode, scale, "hw", key,
                                 block=block), scale)

    xg = grid(x, fmt_x, mode_x, sx[0], 1, block_x)
    wg = grid(w, fmt_w, mode_w, sw, 2, block_w)
    with full_fp32():
        out = torch.matmul(xg.to(torch.bfloat16).to(torch.float32),
                           wg.to(torch.bfloat16).to(torch.float32))
    return _flush(out / _flush(_mul(sx[0], sw)))


@functools.cache
def _fns():
    lib = _build.load("qmatmul")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    prep = lib.fp8_k2_prepass
    prep.argtypes = [vp] + [i64] * 10 + [vp, i64, i32, i32, vp, i32, i64, vp,
                                         vp]
    prep.restype = i32
    gemm = lib.fp8_k2_gemm
    gemm.argtypes = [vp, i64, i32, i32, vp, i32, vp, i64, i32, i32, vp, i32,
                     i32, i32, vp, i32, i32, vp, vp, i32, i32, vp, vp, i32,
                     vp]
    gemm.restype = i32
    return prep, gemm


def _operand_code(fmt, mode, impl) -> int:
    """The kernel's cast variant for an operand: -1 uncast; the hw route's
    codes (``cast.cuh::hw_code``) for its formats under ``impl="hw"``,
    where every mode but SR rounds to nearest, as the JAX kernel does;
    the bit pipeline's (``variant_code``) otherwise."""
    if fmt is None:
        return -1
    if _hw_native(fmt, impl):
        return 0x100 | (FMT_IDS[fmt] << 4) \
            | (2 if mode == RoundMode.STOCHASTIC else 0)
    return variant_code(fmt, mode)


def _round_up(v: int, to: int) -> int:
    return -(-v // to) * to


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _prepass(src, rows, cols, ld, view, sr_index, planes, code, scale,
             per_row, salt, block=None):
    """One K2 pre-pass launch: ``planes`` bf16 planes (planes, rows, ld)
    of ``src``'s grid values, element (r, c) read at ``view`` = (rg, r0,
    r1, cg, c0, c1): (r // rg) * r1 + (r % rg) * r0 plus the same of c
    (a group of 0: r * r0); SR index r * ir + c * ic, ``sr_index`` = (ir,
    ic), the row-major index in ``src``, which with ``block`` (a
    ``parallel.data.Block`` of ``src``'s shape, for a salted operand) the
    kernel maps to the global one."""
    if rows > _MAX_ROWS:
        raise ValueError(f"K2 pre-pass: {rows} rows exceed the kernel's grid")
    if salt is not None:
        require_hash_stream("K2 cast pre-pass")
    runs = None
    if block is not None and salt is not None:
        runs = (ctypes.c_longlong * 7)(*block_args(block, src.shape))
    out = torch.empty((planes, rows, ld), dtype=torch.bfloat16,
                      device=src.device)
    err = _fns()[0](src.data_ptr(), rows, cols, *view, *sr_index,
                    out.data_ptr(), ld, planes, code, scale.data_ptr(),
                    int(per_row), -1 if salt is None else salt,
                    None if runs is None else ctypes.addressof(runs),
                    _stream(src))
    _build.check(err, "K2 cast pre-pass")
    k2_launches["prepass"] += 1
    if runs is not None:
        k2_launches["prepass_block"] += 1
    return out


def _matrix_view(t, transpose=False):
    """(view, sr_index) of a 2-D tensor read as (rows, cols) = t's (dims)
    or, transposed, t's (dim 1, dim 0); SR indices row-major in t."""
    s0, s1 = t.stride()
    if transpose:
        return (0, s1, 0, 0, s0, 0), (1, t.shape[1])
    return (0, s0, 0, 0, s1, 0), (t.shape[1], 1)


def _gemm(a, pa, b, pb, out, m, n, k_tiles, kinds, scales, conv=None,
          unsplit=False, promote=None, a32=None):
    """One launch of K2's GEMM over pre-passed planes, or with ``a32`` an
    uncast f32 A read in place (see fp8_k2_gemm)."""
    global launches
    splits, kper = k2_split(m, n, k_tiles * K2_BK,
                            sm_count(out.device.index or 0), unsplit)
    ws, counters = split_workspace(out.device, splits, m, n)
    conv_args = None if conv is None else (ctypes.c_int * len(conv))(*conv)
    sx, sw = scales
    err = _fns()[1](
        None if a is None else a.data_ptr(), 0 if a is None else a[0].numel(),
        a32.stride(1) if a is None else a.shape[-1], pa,
        None if a32 is None else a32.data_ptr(),
        0 if a32 is None else a32.shape[1],
        b.data_ptr(), b[0].numel(), b.shape[-1], pb,
        out.data_ptr(), m, n, k_tiles,
        None if conv_args is None else ctypes.addressof(conv_args),
        kinds[0], kinds[1], sx.data_ptr(),
        sw.data_ptr(), splits, kper // K2_BK,
        ws.data_ptr() if ws is not None else None, counters.data_ptr(),
        K2_PROMOTE if promote is None else promote, _stream(out))
    _build.check(err, "qdq_matmul kernel")
    launches += 1


def _m_contiguous(x) -> bool:
    """Whether the GEMM can read an f32 (M, K) operand in place: M
    contiguous, in 16-byte pieces."""
    return (x.dtype == torch.float32 and x.stride(0) == 1
            and x.stride(1) % 4 == 0 and x.shape[0] % 4 == 0
            and x.data_ptr() % 16 == 0)


def _variant(fmt_x, fmt_w, impl) -> str:
    return "uncast" if fmt_x is None and fmt_w is None else impl


def _launch(x, w, fmt_x, mode_x, fmt_w, mode_w, scale_x, scale_w, seed=0,
            impl="bitexact", unsplit: bool = False, promote=None,
            block_x=None, block_w=None):
    """One K2 call on CUDA tensors: a pre-pass over each operand, read in
    place through its strides (a transposed view is not copied), then the
    GEMM; an uncast x with M contiguous goes to the GEMM as it is.
    ``unsplit`` keeps K whole where :func:`k2_split` would split it,
    ``promote`` overrides :data:`K2_PROMOTE` (measurements of the
    kernel)."""
    m, k = x.shape
    n = w.shape[1]
    if max(m, n, k) >= 2 ** 31:
        raise ValueError(f"qdq_matmul shape ({m}, {k}) @ ({k}, {n}) exceeds "
                         "the kernel's grid")
    xf = x if x.dtype == torch.float32 else x.to(torch.float32)
    wf = w.to(device=x.device, dtype=torch.float32)
    sx, sw = _scales(xf, wf, scale_x, scale_w)
    salts = [sr_salt(seed, 1, fmt_x, mode_x), sr_salt(seed, 2, fmt_w, mode_w)]
    k_tiles = -(-k // K2_BK)
    ld = k_tiles * K2_BK
    pa, pb = planes_of(fmt_x), planes_of(fmt_w)
    # An uncast x stored with M contiguous (the backward's transposed
    # im2col) is split by the GEMM as it loads it: no pre-pass, no planes.
    a32 = xf if fmt_x is None and _m_contiguous(xf) else None
    a = None if a32 is not None else _prepass(
        xf, m, k, ld, *_matrix_view(xf), pa,
        _operand_code(fmt_x, mode_x, impl), sx, False, salts[0], block_x)
    b = _prepass(wf, n, k, ld, *_matrix_view(wf, transpose=True), pb,
                 _operand_code(fmt_w, mode_w, impl), sw, True, salts[1],
                 block_w)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _gemm(a, pa, b, pb, out, m, n, k_tiles,
          (descale_kind(fmt_x, impl), descale_kind(fmt_w, impl)), (sx, sw),
          unsplit=unsplit, promote=promote, a32=a32)
    k2_launches[_variant(fmt_x, fmt_w, impl)] += 1
    return out


def qdq_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    fmt_x: Optional[str] = "e4m3",
    mode_x: RoundMode = RoundMode.RNE,
    fmt_w: Optional[str] = "e4m3",
    mode_w: RoundMode = RoundMode.RNE,
    scale_x=1.0,
    scale_w=1.0,
    seed: int = 0,
    out_dtype=torch.float32,
    impl: str = "bitexact",
    block_x=None,
    block_w=None,
) -> torch.Tensor:
    """Fused fake-quant matmul ``qdq(x) @ qdq(w)``.  ``scale_x`` is one
    per-tensor scale, ``scale_w`` a scalar or one scale per output column
    (N,); scales may be CUDA tensors (no host sync).  A ``fmt`` of None
    leaves that operand uncast.  ``seed`` keys stochastic operands;
    ``block_x`` / ``block_w`` (a ``parallel.data.Block`` or None) place a
    stochastic operand in the tensor it is a rank's block of, whose bits
    it draws at each element's global index.  K2 on a CUDA tensor, the
    plain version on the CPU; ``impl="hw"`` with two operands of at most 7
    mantissa bits takes the route outside the kernel (see the module
    docstring)."""
    _check(x, w, impl)
    args = (x, w, fmt_x, mode_x, fmt_w, mode_w, scale_x, scale_w, seed)
    # blocks are named only where given: a call without them reaches each
    # route with the arguments it always had
    blocks = {k: b for k, b in (("block_x", block_x), ("block_w", block_w))
              if b is not None}
    if impl == "hw" and _hw_xla_ok(fmt_x, fmt_w):
        out = _hw_grid_matmul(*args, **blocks)
    elif x.is_cuda:
        out = _launch(*args, impl=impl, **blocks)
    else:
        out = plain(*args, impl=impl, **blocks)
    return out.to(out_dtype)


# -- K2 as the engine conv ----------------------------------------------------

def im2col(x, ksize, strides, pads):
    """The engine's im2col of an NCHW tensor in f32: (B*OH*OW, Cin*KH*KW),
    rows (b, oh, ow) and features (c, kh, kw), as the JAX package orders
    them (one strided copy); returns (col, oh, ow)."""
    kh, kw = ksize
    (pt, pb), (pl, pr) = pads
    xp = x.to(torch.float32)
    if pt or pb or pl or pr:
        xp = F.pad(xp, (pl, pr, pt, pb))
    patches = xp.unfold(2, kh, strides[0]).unfold(3, kw, strides[1])
    oh, ow = patches.shape[2], patches.shape[3]
    col = patches.permute(0, 2, 3, 1, 4, 5).reshape(-1, x.shape[1] * kh * kw)
    return col, oh, ow


@functools.lru_cache(maxsize=None)
def _gathered_positions(size: int, k: int, stride: int, lo: int, hi: int):
    """The positions along one axis of ``size`` that an im2col with
    ``k`` taps, ``stride`` and pads (lo, hi) reads; None if all."""
    n_out = (size + lo + hi - k) // stride + 1
    pos = sorted({o * stride - lo + i for o in range(n_out) for i in range(k)
                  if 0 <= o * stride - lo + i < size})
    return None if len(pos) == size else tuple(pos)


_INDEX_TENSORS = {}


def gathered(x, ksize, strides, pads):
    """The elements of NCHW ``x`` that the im2col gathers, as a tensor
    (``x`` itself where every position is gathered; a 1x1 stride-2 conv
    gathers every other row and column).  A max over it equals the max
    over the im2col with its zero pads (amax is at least 0)."""
    for axis, k, s, (lo, hi) in zip((2, 3), ksize, strides, pads):
        pos = _gathered_positions(x.shape[axis], k, s, lo, hi)
        if pos is not None:
            index = _INDEX_TENSORS.get((pos, x.device))
            if index is None:
                index = _INDEX_TENSORS[pos, x.device] = torch.tensor(
                    pos, device=x.device)
            x = x.index_select(axis, index)
    return x


def conv_plain(x, weight, strides, pads, fmt_x, mode_x, scale_x, seed=0,
               impl="bitexact"):
    """The plain version of :func:`conv`: im2col, then K2's plain version
    against the (Cin*KH*KW, Cout) weight; NCHW out."""
    cout, _, kh, kw = weight.shape
    col, oh, ow = im2col(x, (kh, kw), strides, pads)
    w2d = weight.to(torch.float32).reshape(cout, -1).t()
    out = plain(col, w2d, fmt_x, mode_x, None, RoundMode.RNE, scale_x, 1.0,
                seed, impl)
    return out.reshape(x.shape[0], oh, ow, cout).permute(0, 3, 1, 2)


def conv_prepass(x, fmt, mode, scale, impl="bitexact"):
    """K2's pre-pass over an NCHW CUDA activation: its grid values as bf16
    planes (planes, B*H*W, C rounded up to 8), pixels in rows, channels
    contiguous (NHWC), one launch.  ``scale`` is a (1,) f32 tensor."""
    bsz, cin, h, w = x.shape
    xf = (x if x.dtype == torch.float32 else x.to(torch.float32)).contiguous()
    hw = h * w
    return _prepass(xf, bsz * hw, cin, _round_up(cin, 8),
                    (hw, 1, cin * hw, 0, hw, 0), (0, 0), planes_of(fmt),
                    _operand_code(fmt, mode, impl), scale, False, None)


def conv(x, weight, strides, pads, fmt_x, mode_x, scale_x, seed=0,
         impl="bitexact"):
    """The engine conv ``qdq(x) (*) weight`` with a per-tensor activation
    scale, as one K2 launch: on a CUDA tensor the pre-pass casts the NCHW
    activation once into an NHWC grid (channels padded to 8) and the GEMM
    gathers the im2col tile from it (K ordered (kh, kw, c), the weight's
    columns permuted to match: only the order of the sums changes), with
    the NCHW output written by its epilogue.  Sound for a per-tensor scale
    because the cast of im2col(x) is the im2col of the cast of x (the zero
    pads cast to +0); stochastic rounding, whose bits are keyed by the
    im2col's index, takes :func:`qdq_matmul` on the explicit im2col.  The
    plain version on the CPU."""
    if not x.is_cuda:
        return conv_plain(x, weight, strides, pads, fmt_x, mode_x, scale_x,
                          seed, impl)
    if fmt_x is not None and mode_x == RoundMode.STOCHASTIC:
        raise ValueError("the implicit conv rounds to nearest; stochastic "
                         "rounding takes qdq_matmul on the im2col")
    bsz, cin, h, w_ = x.shape
    cout, _, kh, kw = weight.shape
    (pt, pb), (pl, pr) = pads
    oh = (h + pt + pb - kh) // strides[0] + 1
    ow = (w_ + pl + pr - kw) // strides[1] + 1
    wf = weight.to(device=x.device, dtype=torch.float32)
    sx = _scale_vector(scale_x.reshape(-1)[:1] if isinstance(
        scale_x, torch.Tensor) else scale_x, 1, x.device)
    cp = _round_up(cin, 8)
    pa = planes_of(fmt_x)
    act = conv_prepass(x, fmt_x, mode_x, sx, impl)
    k_tiles = -(-(kh * kw * cp) // K2_BK)
    if cp == cin:   # column k of the weight operand: tap k // cin, channel
        wv = wf.contiguous()           # k % cin of the OIHW weight
        view = (0, cin * kh * kw, 0, cin, kh * kw, 1)
    else:
        wv = F.pad(wf.permute(0, 2, 3, 1), (0, cp - cin)).reshape(
            cout, -1).contiguous()
        view = (0, kh * kw * cp, 0, 0, 1, 0)
    # (the weight is uncast: no scale is read; sx stands in for one)
    wpl = _prepass(wv, cout, kh * kw * cp, k_tiles * K2_BK, view, (0, 0), 3,
                   -1, sx, True, None)
    out = torch.empty((bsz, cout, oh, ow), dtype=torch.float32,
                      device=x.device)
    _gemm(act, pa, wpl, 3, out, bsz * oh * ow, cout, k_tiles,
          (descale_kind(fmt_x, impl), 0), (sx, sx),
          conv=(h, w_, cp, kh, kw, strides[0], strides[1], pt, pl, oh, ow))
    k2_launches[_variant(fmt_x, None, impl)] += 1
    return out


# -- K3: serving dequant-GEMM ---------------------------------------------------

FP8_DTYPES = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}
_PAYLOAD_IDS = {torch.float8_e4m3fn: 0, torch.float8_e5m2: 1, torch.int8: 2}
# csrc/dequant_matmul.cu's payload code of int8 weights against f16 x (the
# int8 route of W8A8: x holds P2's f16 codes)
_INT8_F16_ID = 3


def div_exact(a: torch.Tensor, c: float) -> torch.Tensor:
    """``a / c`` as one correctly rounded division on every device (with a
    Python scalar divisor torch multiplies by the reciprocal on CUDA)."""
    return a / torch.full_like(a, c)


def flush_amax(amax: torch.Tensor) -> torch.Tensor:
    """A quantizer's amax as XLA computes it: a subnormal max reads 0 (its
    DAZ), so that slice takes scale 1 and quantizes to zeros, as in the
    JAX package.  The scale derived from a normal amax is not flushed:
    where XLA flushes a subnormal ``amax / max`` to 0, the JAX package
    divides by that 0 and stores ±max or NaN payloads (a fault of its
    own); the port keeps the finite scale."""
    return _flush(amax)


def fp8_payload(v: torch.Tensor, fmt: str) -> torch.Tensor:
    """Clipped f32 values to fp8 storage, a NaN with the bits XLA's
    convert gives it: e5m2 keeps the sign and the quiet bit (0x7E, 0xFE),
    where torch's convert writes 0x7F / 0xFF (e4m3 has one NaN code)."""
    payload = v.to(FP8_DTYPES[fmt])
    if fmt != "e5m2":
        return payload
    nan_bits = torch.where(torch.signbit(v), 0xFE, 0x7E).to(torch.uint8)
    return torch.where(torch.isnan(v), nan_bits, payload.view(
        torch.uint8)).view(FP8_DTYPES[fmt])


def quantize_weights(w: torch.Tensor, fmt: str = "e4m3", axis: int = -1):
    """Quantize a weight matrix to real fp8 (or int8) storage: ``(payload,
    scales)`` with f32 ``scales`` per slice of ``axis`` (kept as a size-1
    broadcastable shape), such that ``w ~ payload.float() * scales``.
    Clamp, then IEEE RNE convert: the clip keeps the convert from
    saturating or overflowing."""
    wf = w.to(torch.float32)
    ax = axis % w.ndim
    reduce_axes = [i for i in range(w.ndim) if i != ax]
    amax = wf.abs().amax(dim=reduce_axes, keepdim=True) if reduce_axes \
        else wf.abs()
    amax = flush_amax(amax)
    one = torch.ones_like(amax)
    if fmt == "int8":
        scales = torch.where(amax > 0, div_exact(amax, 127.0), one)
        q = torch.clip(torch.round(wf / scales), -127, 127)
        return q.to(torch.int8), scales
    if fmt not in FP8_DTYPES:
        raise ValueError(f"no hardware dtype for {fmt!r}; serve with e4m3, "
                         "e5m2 or int8 (e3m4/fp4 use the emulation path)")
    top = FORMATS[fmt].max_normal
    scales = torch.where(amax > 0, div_exact(amax, top), one)
    return fp8_payload(torch.clip(wf / scales, -top, top), fmt), scales


def _check_dequant(x, w8, scales, out_dtype):
    if x.ndim != 2 or w8.ndim != 2 or x.shape[1] != w8.shape[0]:
        raise ValueError(f"dequant_matmul needs (M, K) @ (K, N), got "
                         f"{tuple(x.shape)} @ {tuple(w8.shape)}")
    if x.dtype == torch.float16 and w8.dtype != torch.int8:
        raise ValueError(f"dequant_matmul takes f16 x (W8A8's codes) with "
                         f"int8 weights only, got {w8.dtype}")
    if w8.dtype not in _PAYLOAD_IDS:
        raise ValueError(f"dequant_matmul payload must be e4m3, e5m2 or "
                         f"int8, got {w8.dtype}")
    if scales.numel() != w8.shape[1]:
        raise ValueError(f"dequant_matmul needs one scale per output column "
                         f"({w8.shape[1]}), got {tuple(scales.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dequant_matmul out_dtype must be bf16 or f32, got "
                         f"{out_dtype}")


def _check_row_scale(x, row_scale):
    if row_scale is not None and row_scale.numel() != x.shape[0]:
        raise ValueError(f"dequant_matmul needs one row scale per row of x "
                         f"({x.shape[0]}), got {tuple(row_scale.shape)}")


def dequant_matmul_plain(x, w8, scales, out_dtype=torch.bfloat16,
                         row_scale=None):
    """The plain version of K3 (any device): x rounded to bf16 (f16 x, W8A8's
    codes, taken as it is), an f32 contraction against the upcast payload,
    the scale in f32, one rounding to ``out_dtype``.  With ``row_scale``
    (M,) the product is scaled by ``row_scale[m] * scales[n]``, in that
    order (W8A8's int8 route)."""
    _check_dequant(x, w8, scales, out_dtype)
    _check_row_scale(x, row_scale)
    xb = (x if x.dtype == torch.float16 else x.to(torch.bfloat16)).to(
        torch.float32)
    with full_fp32():
        out = torch.matmul(xb, w8.to(torch.float32))
    s = scales.reshape(1, -1).to(torch.float32)
    if row_scale is not None:
        s = row_scale.reshape(-1, 1).to(torch.float32) * s
    return (out * s).to(out_dtype)


@functools.cache
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# The streaming loop: K rows a stage by payload kind (e4m3 / e5m2 / int8
# bytes, packed int4, bf16), and the K rows its tensor cores sum before
# the chunk is added into the f32 sum (the tensor cores' own sum
# truncates, PERF.md's trap 27; the JAX kernel's tk).
STREAM_BK = {"w8": 128, "int4": 128, "bf16": 64}
STREAM_PROMOTE = 512


# The streaming loop's prefill route (M > 64): blocks of PREFILL_COLS
# output columns (two warpgroups of 64) x PREFILL_NP tokens, one an SM
# (``csrc/w_stream.cuh::launch_prefill``), and the C entry points' code
# for it (1 and 2 are the decode form's m64 tiles a block, 0 the general
# kernel).
PREFILL_NP = 128
PREFILL_COLS = 128
PREFILL_ROUTE = 3


def _tma_ok(n: int, k: int, tensors, group: Optional[int]) -> bool:
    """Every operand readable by the streaming loop's TMA (K % 8 == 0,
    N % 16 == 0, 16-byte aligned), and grouped int4 scales whose group is
    a multiple of 16 that divides, or is divided by, its 128-row stage."""
    group_ok = not group or (group % 16 == 0 and (
        STREAM_BK["int4"] % group == 0 or group % STREAM_BK["int4"] == 0))
    return (k % 8 == 0 and n % 16 == 0 and group_ok
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def streams(m: int, n: int, k: int, *tensors: torch.Tensor,
            group: Optional[int] = None) -> bool:
    """Whether a weight GEMM takes the streaming loop's decode form
    (``csrc/w_stream.cuh``: a TMA ring, wgmma with the converted weight as
    A): at most 64 rows and operands TMA can read (``_tma_ok``)."""
    return m <= 64 and _tma_ok(n, k, tensors, group)


def prefills(m: int, n: int, k: int, *tensors: torch.Tensor,
             group: Optional[int] = None) -> bool:
    """Whether a weight GEMM takes the streaming loop's prefill route: more
    than 64 rows and operands TMA can read.  What takes neither form takes
    the general kernel (``csrc/w_gemm.cuh``)."""
    return m > 64 and _tma_ok(n, k, tensors, group)


class StreamPlan(NamedTuple):
    mt: int        # m64 tiles a block: 64 * mt output columns
    bk: int        # K rows a stage
    splits: int    # blocks sharing a column tile's K range
    kper: int      # K rows a split, a whole number of stages


def stream_mt(n: int, sms: int) -> int:
    """m64 tiles a block of the streaming loop: two (128 columns) where
    those column tiles, split at most 8 ways, fill the card; else one, so
    that N = 1024 gives 16 tiles x 8 splits."""
    return 2 if -(-n // 128) * 8 >= sms else 1


def stream_plan(m: int, n: int, k: int, sms: int,
                kind: str = "w8") -> StreamPlan:
    """The streaming loop's launch for (M, K) @ (K, N) on ``sms`` SMs;
    ``kind`` is "w8", "int4" or "bf16" (``STREAM_BK``)."""
    bk = STREAM_BK[kind]
    splits, kper = split_k(m, n, k, sms, True, bk)
    return StreamPlan(stream_mt(n, sms), bk, splits, kper)


class PrefillPlan(NamedTuple):
    np: int        # tokens a block
    bk: int        # K rows a stage
    splits: int    # blocks sharing an output tile's K range
    kper: int      # K rows a split, a whole number of stages


def prefill_plan(m: int, n: int, k: int, sms: int,
                 kind: str = "w8") -> PrefillPlan:
    """The prefill route's launch for (M, K) @ (K, N) on ``sms`` SMs, one
    block an SM.  An output of at least ``sms`` 128 x 128 tiles is not
    split: its partials would cost more than the last wave's idle SMs.
    Fewer tiles split K into the fewest ways (at most 8, at least one
    512-row chunk each) that minimise the waves a split's share of K
    takes: k/v at M = 512 (32 tiles) 4 ways, gate at M = 128 (86) 3."""
    bk = STREAM_BK[kind]
    tiles = -(-m // PREFILL_NP) * -(-n // PREFILL_COLS)
    splits = 1
    if tiles < sms:
        ways = [s for s in range(1, 9) if s == 1 or k // s >= STREAM_PROMOTE]
        splits = min(ways, key=lambda s: (-(-tiles * s // sms) / s, s))
    kper = max(bk, -(-k // (splits * bk)) * bk)
    return PrefillPlan(PREFILL_NP, bk, -(-k // kper), kper)


class GemmPlan(NamedTuple):
    route: str     # "stream", "prefill" or "general"
    code: int      # the C entry points' route argument
    splits: int
    kper: int


def weight_gemm_plan(m: int, n: int, k: int, sms: int, kind: str,
                     *tensors: torch.Tensor,
                     group: Optional[int] = None) -> GemmPlan:
    """Which kernel K3 / K5 launch for these operands, decided up front
    from the shape and the pointers: the streaming loop's decode form
    (M <= 64), its prefill route (M > 64), or, where TMA cannot read an
    operand, the general kernel; and its split of K."""
    if streams(m, n, k, *tensors, group=group):
        plan = stream_plan(m, n, k, sms, kind)
        return GemmPlan("stream", plan.mt, plan.splits, plan.kper)
    if prefills(m, n, k, *tensors, group=group):
        plan = prefill_plan(m, n, k, sms, kind)
        return GemmPlan("prefill", PREFILL_ROUTE, plan.splits, plan.kper)
    return GemmPlan("general", 0, *split_k(m, n, k, sms))


def promotion_edges(k: int, kper: int,
                    promote: int = STREAM_PROMOTE) -> List[int]:
    """The K rows at which the streaming loop adds a tensor-core chunk into
    its f32 sum: each split's range [z kper, (z + 1) kper) cut every
    ``promote`` rows from its start.  Sorted, from 0 to k."""
    edges = [0]
    for kb in range(0, k, kper):
        ke = min(k, kb + kper)
        edges += list(range(kb + promote, ke, promote)) + [ke]
    return edges


def plan_splits(tiles: int, k: int, sms: int, cap: int, min_rows: int,
                slab: int, per_sm: int = 2):
    """(splits, K rows per split) for a launch of ``tiles`` output tiles
    whose blocks may share a tile's K range (``split_k.cuh``): split when
    the tiles alone give fewer than about ``per_sm`` blocks per SM, at
    most ``cap`` ways, at least ``min_rows`` rows a split, rows a multiple
    of the kernel's K slab.  Never more tiles than tile counters."""
    splits = 1 if not 0 < tiles <= _N_COUNTERS else max(
        1, min(cap, (per_sm * sms + tiles // 2) // tiles, k // min_rows))
    kper = max(slab, -(-k // (splits * slab)) * slab)
    return max(1, -(-k // kper)), kper


def k2_split(m: int, n: int, k: int, sms: int, unsplit: bool = False):
    """K2's split of K over its 128 x 64 tiles: up to 64 ways, at least
    512 rows a split, rows a multiple of its 32-row slab, as the
    backward's weight gradient needs (576 x 64 outputs over K = 100352 at
    ResNet-50's first stage)."""
    tiles = -(-m // 128) * -(-n // 64)
    return plan_splits(tiles, k, sms, 1 if unsplit else 64, 512, K2_BK)


def split_k(m: int, n: int, k: int, sms: int, stream: bool = False,
            bk: int = 64):
    """(splits, K rows per split) for the weight-GEMM kernels (K3, K5, T2):
    at most 8 ways, at least 256 rows a split, rows a multiple of ``bk``
    (the kernel's K slab or stage).  The streaming loop's tiles are
    64 * stream_mt columns wide, the general kernel's 64."""
    if stream:
        tiles = -(-n // (64 * stream_mt(n, sms)))
        if m > 16 and sms // tiles >= 2:
            # M x N f32 partials a split cost more than a second block on
            # an SM gains (PERF.md §6): one block an SM
            return plan_splits(tiles, k, sms, 8, 256, bk, 1)
    else:
        bm = 16 if m <= 16 else 64 if m <= 64 else 128
        tiles = -(-n // 64) * -(-m // bm)
    return plan_splits(tiles, k, sms, 8, 256, bk)


_COUNTERS = {}
_N_COUNTERS = 4096


def split_workspace(device, splits: int, m: int, n: int):
    """(partials, tile counters) for a split-K launch on ``device``.  The
    counters are zero between launches (the kernel resets them), so one
    tensor per device serves every launch on its stream."""
    counters = _COUNTERS.get(device)
    if counters is None:
        counters = _COUNTERS[device] = torch.zeros(
            _N_COUNTERS, dtype=torch.int32, device=device)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=device) \
        if splits > 1 else None
    return ws, counters


@functools.cache
def _dequant_fn():
    fn = _build.load("dequant_matmul").fp8_dequant_matmul
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


def check_gemm_shape(what: str, m: int, n: int, k: int) -> None:
    if m > 65535 * 128 or max(m, n, k) >= 2 ** 31 or min(m, n, k) < 1:
        raise ValueError(f"{what} shape ({m}, {k}) @ ({k}, {n}) is outside "
                         "the kernel's grid")


def dequant_matmul(x: torch.Tensor, w8: torch.Tensor, scales: torch.Tensor,
                   out_dtype=torch.bfloat16,
                   row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ dequant(w8)``: x (M, K) bf16 or f32 (rounded to bf16), w8 (K, N)
    e4m3 / e5m2 / int8 from :func:`quantize_weights`, ``scales`` one f32
    per output column; ``row_scale`` (M,) f32 or None multiplies into the
    column scale first.  f16 x is reserved for W8A8's int8 route and taken
    as it is, not rounded: it holds the e4m3 codes' f16 values from
    ``quantize_rows(..., codes_dtype=torch.float16)``, w8 must be int8
    (f16 x with e4m3 / e5m2 weights raises), and the two are contracted on
    the f16 tensor cores (every code, byte and product exact).  K3 on a CUDA tensor, the plain version on the CPU."""
    global dequant_launches
    if not x.is_cuda:
        return dequant_matmul_plain(x, w8, scales, out_dtype, row_scale)
    _check_dequant(x, w8, scales, out_dtype)
    _check_row_scale(x, row_scale)
    rs = None if row_scale is None else row_scale.to(
        device=x.device, dtype=torch.float32).reshape(-1).contiguous()
    m, k = x.shape
    n = w8.shape[1]
    check_gemm_shape("dequant_matmul", m, n, k)
    f16 = x.dtype == torch.float16
    xb = (x if f16 else x.to(torch.bfloat16)).contiguous()
    w8 = w8.contiguous()
    s = scales.to(device=x.device, dtype=torch.float32).reshape(-1).contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    plan = weight_gemm_plan(m, n, k, sm_count(x.device.index or 0), "w8",
                            xb, w8)
    ws, counters = split_workspace(x.device, plan.splits, m, n)
    err = _dequant_fn()(
        xb.data_ptr(), w8.data_ptr(), s.data_ptr(), out.data_ptr(), m, n, k,
        _INT8_F16_ID if f16 else _PAYLOAD_IDS[w8.dtype],
        int(out_dtype == torch.float32), plan.splits,
        plan.kper, plan.code, ws.data_ptr() if ws is not None else None,
        counters.data_ptr(), rs.data_ptr() if rs is not None else None,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "dequant_matmul kernel")
    dequant_launches += 1
    dequant_routes[plan.route] += 1
    return out


# -- P1 / P2: the W8A8 serving linear (no TPU counterpart) --------------------
#
# The JAX package's matmul_impl="direct" (fp8tpu/serve/model.py::fp8_linear,
# ::_quantize_act) is XLA ops: a per-row e4m3 quantizer of the activation and
# an fp8 x fp8 dot with f32 accumulation, scaled by xs * s.  The port's
# kernels (``csrc/w8a8.cu``): P2 ``quantize_rows``, one pass over each row
# held in registers, and P1 ``w8a8_matmul``, the streaming loop's FP8 kind
# (``csrc/w_stream.cuh``: wgmma.m64nNk32 on the fp8 tensor cores, the weight
# bytes as the register A operand, xq as the K-major B from the TMA stage).
# int8 weights have no fp8 partner on the tensor cores: P2 writes the
# codes' exact f16 values (``codes_dtype=torch.float16``) and K3's int8
# route (``dequant_matmul(..., row_scale=)``) contracts them on the f16
# tensor cores, every product exact.

W8A8_FMTS = {torch.float8_e4m3fn: 0, torch.float8_e5m2: 1}
# k32 steps the fp8 tensor cores sum before P1 adds the chunk into its f32
# sum (their own sum keeps 13 bits below a step's largest addend;
# chip_smoke.py's w8a8_probe and w8a8_p1probe measure the choice): a
# multiple of 4 (whole stages of 128 K rows) or, for the probes, 1 or 2
# with e4m3 weights (the w8a8_probe library, built at first use).
W8A8_PROMOTE = 4
W8A8_STAGE_STEPS = STREAM_BK["w8"] // 32

# Launches of P2 and of P1 since the last reset_launches(); P1's also by
# form: "decode" (M <= 64, the streaming loop's decode form) and "prefill"
# (its prefill route).
quantize_launches = 0
w8a8_launches = 0
w8a8_routes = {"decode": 0, "prefill": 0}


# What P2 writes a code as: its byte (the fp8 dtype), or its exact value
# as f16 (the int8 route's GEMM reads it); the C entry's code
CODES_DTYPES = {None: 0, torch.float16: 1}
# A NaN code's f16 value as XLA's convert writes it: the sign on the quiet
# NaN (as int16 bits: positive, negative)
_NAN_BITS = (0x7E00, 0xFE00 - 0x10000)


def codes_as(q: torch.Tensor, codes_dtype) -> torch.Tensor:
    """The fp8 codes ``q`` as their exact values in ``codes_dtype`` (f16),
    a NaN code as the JAX package's convert gives it (its sign on the quiet
    NaN); ``q`` itself for None."""
    if codes_dtype is None:
        return q
    v = q.to(torch.float32).to(codes_dtype)
    pos, neg = _NAN_BITS
    nan = torch.where(q.view(torch.uint8) >= 0x80,
                      torch.tensor(neg, dtype=torch.int16, device=q.device),
                      torch.tensor(pos, dtype=torch.int16, device=q.device))
    return torch.where(torch.isnan(v), nan.view(codes_dtype), v)


def _check_codes(codes_dtype):
    if codes_dtype not in CODES_DTYPES:
        raise ValueError(f"quantize_rows writes codes as fp8 bytes (None) "
                         f"or float16, got {codes_dtype}")


def quantize_rows_plain(x: torch.Tensor, fmt: str = "e4m3",
                        codes_dtype=None):
    """The plain version of P2 (any device): ``(q, s)`` with one f32 scale a
    row of x (..., K), ``s = amax / max_normal`` (1 for an all-zero row)
    and ``q = fmt(clip(x / s))``, or its values in ``codes_dtype``
    (``codes_as``).  XLA's rules: the amax flushed (a row of f32
    subnormals takes scale 1), x flushed before the divide, a correctly
    rounded divide.  One rule is the port's own: a row whose amax lies in
    (0, max_normal 2^-126) keeps its subnormal scale (``flush_amax``), where
    XLA flushes the quotient to 0 and stores +-max and NaN codes."""
    _check_codes(codes_dtype)
    top = FORMATS[fmt].max_normal
    xf = x.to(torch.float32)
    amax = flush_amax(xf.abs().amax(dim=-1, keepdim=True))
    s = torch.where(amax > 0, div_exact(amax, top), torch.ones_like(amax))
    q = fp8_payload(torch.clip(_flush(xf) / s, -top, top), fmt)
    return codes_as(q, codes_dtype), s


@functools.cache
def _quantize_fn():
    fn = _build.load("w8a8").fp8_quantize_rows
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quantize_rows(x: torch.Tensor, fmt: str = "e4m3", codes_dtype=None):
    """Per-row activation quantization, the W8A8 route's producer: x (..., K)
    -> (q (..., K), s (..., 1) f32), q the fp8 codes, or with
    ``codes_dtype=torch.float16`` their exact f16 values, written in the
    same pass (what the int8 route's GEMM reads).  P2 on a CUDA tensor (bf16 x, one launch), the plain version on
    the CPU."""
    global quantize_launches
    _check_codes(codes_dtype)
    if not x.is_cuda:
        return quantize_rows_plain(x, fmt, codes_dtype)
    if fmt not in ("e4m3", "e5m2"):
        raise ValueError(f"quantize_rows writes e4m3 or e5m2, got {fmt!r}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"quantize_rows takes bf16 on the card, got "
                         f"{x.dtype}")
    k = x.shape[-1]
    m = x.numel() // max(k, 1)
    if m < 1 or k < 1 or m >= 2 ** 31:
        raise ValueError(f"quantize_rows shape {tuple(x.shape)} is outside "
                         "the kernel's grid")
    xc = x.contiguous()
    q = torch.empty(x.shape, dtype=codes_dtype or FP8_DTYPES[fmt],
                    device=x.device)
    s = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    err = _quantize_fn()(xc.data_ptr(), q.data_ptr(), s.data_ptr(), m, k,
                         0 if fmt == "e4m3" else 1, CODES_DTYPES[codes_dtype],
                         torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "quantize_rows kernel")
    quantize_launches += 1
    return q, s


def quot_probe(divisors, a_exp: int):
    """P2's fast divide (``csrc/w8a8.cu::quot_fast``) on the card against
    the correctly rounded divide, for every f32 significand of a dividend
    of exponent ``a_exp`` and each of ``divisors`` (normal f32).  Also the
    e4m3 codes of
    the quotients on the fast path's rules against cast.cuh's.  Returns
    (quotients that differ, codes that differ, up to 16 differing (a, s)
    as f32 bit patterns)."""
    fn = _build.load("w8a8").fp8_quot_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    div = torch.tensor(divisors, dtype=torch.float32,
                       device="cuda").reshape(-1)
    counts = torch.zeros(3, dtype=torch.int64, device="cuda")
    pairs = torch.zeros(32, dtype=torch.int32, device="cuda")
    err = fn(div.data_ptr(), div.numel(), a_exp, counts.data_ptr(),
             pairs.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "quot_probe kernel")
    quot, code, found = (int(c) for c in counts.cpu())
    bits = pairs.cpu().tolist()
    return quot, code, [(bits[2 * i] & 0xFFFFFFFF, bits[2 * i + 1]
                         & 0xFFFFFFFF) for i in range(min(found, 16))]


def _check_w8a8(xq, xs, w8, s, out_dtype):
    if xq.ndim != 2 or w8.ndim != 2 or xq.shape[1] != w8.shape[0]:
        raise ValueError(f"w8a8_matmul needs (M, K) @ (K, N), got "
                         f"{tuple(xq.shape)} @ {tuple(w8.shape)}")
    if xs.numel() != xq.shape[0] or s.numel() != w8.shape[1]:
        raise ValueError(f"w8a8_matmul needs one scale a row ({xq.shape[0]}) "
                         f"and a column ({w8.shape[1]}), got "
                         f"{tuple(xs.shape)} and {tuple(s.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"w8a8_matmul out_dtype must be bf16 or f32, got "
                         f"{out_dtype}")


def w8a8_matmul_plain(xq, xs, w8, s, out_dtype=torch.bfloat16):
    """The plain version of P1 (any device): the codes as f32, an IEEE f32
    contraction (never TF32), ``acc * (xs * s)`` in that order, one
    rounding to ``out_dtype``.  Takes any payload the JAX dot takes (e4m3,
    e5m2, int8, bf16): every product of two codes is exact in f32."""
    _check_w8a8(xq, xs, w8, s, out_dtype)
    with full_fp32():
        acc = torch.matmul(xq.to(torch.float32), w8.to(torch.float32))
    scale = xs.reshape(-1, 1).to(torch.float32) \
        * s.reshape(1, -1).to(torch.float32)
    return (acc * scale).to(out_dtype)


def w8a8_plan(m: int, n: int, k: int, sms: int) -> GemmPlan:
    """P1's launch, the streaming loop's plans at K3's e4m3 stage (128 K
    rows): the decode form at M <= 64 (``stream_plan``: code = m64 tiles a
    block), the prefill route above (``prefill_plan``); no general
    kernel (``w8a8_matmul`` raises on what TMA cannot read)."""
    if m <= 64:
        plan = stream_plan(m, n, k, sms, "w8")
        return GemmPlan("stream", plan.mt, plan.splits, plan.kper)
    plan = prefill_plan(m, n, k, sms, "w8")
    return GemmPlan("prefill", PREFILL_ROUTE, plan.splits, plan.kper)


def w8a8_edges(k: int, kper: int,
               promote: Optional[int] = None) -> List[int]:
    """The K rows at which P1 adds a tensor-core chunk of ``promote`` k32
    steps (default W8A8_PROMOTE) into its f32 sum."""
    return promotion_edges(k, kper, 32 * (promote or W8A8_PROMOTE))


@functools.cache
def _w8a8_fn(probe: bool = False):
    fn = _build.load("w8a8_probe" if probe else "w8a8").fp8_w8a8_gemm
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 \
        + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def w8a8_matmul(xq: torch.Tensor, xs: torch.Tensor, w8: torch.Tensor,
                s: torch.Tensor, out_dtype=torch.bfloat16,
                promote: Optional[int] = None) -> torch.Tensor:
    """``(xq @ w8) * (xs * s)``: xq (M, K) e4m3 codes with xs (M,) f32 row
    scales from :func:`quantize_rows`, w8 (K, N) e4m3 / e5m2 payload (the
    serving artifact's layout) with s (N,) f32 column scales.  P1 on a
    CUDA tensor: K % 32 == 0, N % 16 == 0 and 16-byte aligned operands, or
    it raises; ``promote`` (k32 steps a tensor-core chunk, default
    W8A8_PROMOTE: a multiple of 4, or 1 or 2 with e4m3 weights from the
    probes' build) is there for the accumulation probes.  The plain version
    on the CPU."""
    global w8a8_launches
    if not xq.is_cuda:
        return w8a8_matmul_plain(xq, xs, w8, s, out_dtype)
    _check_w8a8(xq, xs, w8, s, out_dtype)
    if xq.dtype != torch.float8_e4m3fn or w8.dtype not in W8A8_FMTS:
        raise ValueError(f"w8a8_matmul takes e4m3 activations and e4m3 / "
                         f"e5m2 weights, got {xq.dtype} x {w8.dtype}")
    m, k = xq.shape
    n = w8.shape[1]
    check_gemm_shape("w8a8_matmul", m, n, k)
    if k % 32 or n % 16:
        raise ValueError(f"w8a8_matmul needs K % 32 == 0 and N % 16 == 0, "
                         f"got K = {k}, N = {n}")
    xq, w8 = xq.contiguous(), w8.contiguous()
    if xq.data_ptr() % 16 or w8.data_ptr() % 16:
        raise ValueError("w8a8_matmul needs 16-byte aligned operands")
    promote = W8A8_PROMOTE if promote is None else int(promote)
    probe = promote in (1, 2)
    if promote < 1 or (promote % W8A8_STAGE_STEPS and not (
            probe and w8.dtype == torch.float8_e4m3fn)):
        raise ValueError(f"w8a8_matmul promotes whole stages ({promote} k32 "
                         "steps); chunks of 1 or 2 steps only with e4m3 "
                         "weights")
    xs = xs.to(device=xq.device, dtype=torch.float32).reshape(-1).contiguous()
    s = s.to(device=xq.device, dtype=torch.float32).reshape(-1).contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    plan = w8a8_plan(m, n, k, sm_count(xq.device.index or 0))
    ws, counters = split_workspace(xq.device, plan.splits, m, n)
    err = _w8a8_fn(probe)(
        xq.data_ptr(), w8.data_ptr(), xs.data_ptr(), s.data_ptr(),
        out.data_ptr(), m, n, k, W8A8_FMTS[w8.dtype],
        int(out_dtype == torch.float32), plan.code, plan.splits, plan.kper,
        promote, ws.data_ptr() if ws is not None else None,
        counters.data_ptr(), torch.cuda.current_stream(xq.device).cuda_stream)
    _build.check(err, "w8a8_matmul kernel")
    w8a8_launches += 1
    w8a8_routes["decode" if plan.route == "stream" else "prefill"] += 1
    return out
