"""P3: the whole 8-bit AdamW update of a parameter leaf, or of every leaf
of a step in one launch (``csrc/adam8.cu``).

P3 has no TPU counterpart.  In the JAX package the 8-bit optimizer
(``fp8tpu/training/opt8.py``) is XLA ops that fuse into the jitted train
step: dequantize the int8 first and e4m3 second moments, the Adam update
in f32, requantize per block of 256 (``numerics/blockquant.py``), then
optax's ``add_decayed_weights``, ``scale_by_learning_rate`` and
``apply_updates``.  Run eagerly that is about 20 elementwise launches a
leaf, each a pass over the state; P3 is one pass over all leaves.

On a leaf of n elements, with its moments ``(nblocks, block)`` payloads
and ``(nblocks,)`` f32 scales (flat in the leaf's order, zero-padded):

    m   = b1 * deq(m) + (1 - b1) * g
    v   = b2 * deq(v) + (1 - b2) * g * g
    upd = (m / bc1) / (sqrt(v / bc2) + eps)
    m, v = quant_blocks(m, "int8"), quant_blocks(v, "e4m3")
    mode "apply":  p = p + (-lr) * (upd [+ wd * p])     (in place)
    mode "store":  out = upd                            (scale_by_adam_8bit)

All in f32 with XLA's rounding: no fused multiply-adds, correctly rounded
divides and square roots, f32 subnormals flushed on every input and
result (DAZ/FTZ), the bias corrections ``bc1 = 1 - b1**count`` and
``bc2`` computed on the host and passed in.  On CPU tensors the wrappers
run the plain version below; on CUDA tensors they launch the kernel or
raise.

A leaf may be given as a 2-D strided view (a Dense weight stored (out,
in) and updated in the JAX package's (in, out) order, so that its blocks
hold the same elements as the JAX package's): the kernel reads and
writes ``p`` and ``g`` through the view.  How it walks a leaf
(:func:`walk_of`): "vector" (an aligned contiguous leaf), "tile" (a
transposed view with a multiple of 32 rows of a multiple of 256 elements:
staged through shared memory so that every load reads whole 128-byte
pieces of the storage's rows) or "strided" (anything else).  Each block of 256 takes the kernel's fast route or its slow one by
its data; both give the plain version's bits.

:func:`adam8_update` is one leaf a launch (the functional
``scale_by_adam_8bit``); :func:`adam8_update_many` every leaf of a
:func:`leaf_table` in one launch (``Adam8W.step``).

The split-block route (:func:`adam8_split_amax`, :func:`adam8_split_apply`)
takes a tensor-parallel rank's block of a leaf whose moment blocks cross
ranks (a column shard of a Dense kernel: the blocks are 256 elements of
the global flat leaf in the JAX package's layout).  The rank stores its
own elements' codes and every block's scale; a block's new scale is the
MAX over the ranks of their partial absmax, so the update is two
launches with one all-reduce between them: the partial absmax of the
updated moments (as magnitude bits, whose integer max is the plain
version's amax), then the quantization by the reduced blocks' scales and
the update itself.  The padding of a last block belongs to no rank and
adds nothing to its absmax.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch

from fp8tpu_torch.numerics.blockquant import (block_scale, dequant_blocks,
                                              quant_blocks, quant_given)
from fp8tpu_torch.numerics.cast import _flush

from . import _build

BLOCK = 256                 # elements a block; one warp a block in P3
UNIT = 32                   # blocks a CTA takes
TILE_COLS = 32              # storage columns of a staged tile
MODES = {"apply": 0, "apply_decay": 1, "store": 2}
WALKS = {"vector": 0, "strided": 1, "tile": 2}

# Launches of P3 since the last reset_launches(), and the leaves they
# covered; the split-block route's launches apart.
launches = 0
leaves_covered = 0
split_launches = 0


def reset_launches() -> None:
    global launches, leaves_covered, split_launches
    launches = 0
    leaves_covered = 0
    split_launches = 0


class Adam8Args(NamedTuple):
    """The scalars of one update, each rounded to f32 as the JAX package
    rounds it: ``b1``, ``b2``, ``eps`` and the weight decay as Python
    floats (weak-typed), ``one_minus_b1`` / ``one_minus_b2`` computed in
    f64 then rounded, ``bc1`` / ``bc2`` in f32 from the count, ``neg_lr``
    the negated learning rate."""

    b1: float
    b2: float
    eps: float
    bc1: float
    bc2: float
    weight_decay: float = 0.0
    neg_lr: float = 0.0

    def f32(self):
        """(b1, 1 - b1, b2, 1 - b2, eps, bc1, bc2, wd, -lr) as f32."""
        vals = (self.b1, 1.0 - self.b1, self.b2, 1.0 - self.b2, self.eps,
                self.bc1, self.bc2, self.weight_decay, self.neg_lr)
        return tuple(float(torch.tensor(v, dtype=torch.float32))
                     for v in vals)


def bias_corrections(b1: float, b2: float, count: int):
    """``(1 - b1**count, 1 - b2**count)`` in f32, as XLA's CPU computes
    them (torch's CPU pow gives the same bits for counts 1-2000 at 0.9 and
    0.999); on the host, never with the card's pow."""
    c = torch.tensor(float(count), dtype=torch.float32)
    one = torch.ones((), dtype=torch.float32)

    def bc(b):
        return float(one - torch.pow(torch.tensor(b, dtype=torch.float32),
                                     c))

    return bc(b1), bc(b2)


# -- the plain version ----------------------------------------------------------

def _f(a):
    """DAZ on an input (a Python float here is an f32 constant, normal)."""
    return a if isinstance(a, float) else _flush(a)


def _mul(a, b):
    return _flush(_f(a) * _f(b))


def _add(a, b):
    return _flush(_f(a) + _f(b))


def _div(a, b):
    return _flush(_flush(a) / _flush(b))


def _round_root(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root of f32 ``x``, given ``r``
    within one f32 step of it.  The midpoints between ``r`` and its
    neighbours have 25 significant bits, so their squares (at most 50
    bits) are exact in f64 and can never equal ``x`` (24 bits): two
    compares pick the neighbour whose half-step interval holds the root.
    NaNs and infinities pass as they are."""
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    down = torch.nextafter(r, torch.zeros_like(r))
    xd, rd = x.double(), r.double()
    hi = (rd + up.double()) * 0.5
    lo = (rd + down.double()) * 0.5
    r = torch.where(hi * hi < xd, up, r)
    return torch.where(lo * lo > xd, down, r)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, by construction: the f64 root
    rounded to f32 (within one f32 step whatever the f64 root's own last
    bit), then :func:`_round_root`.  torch's f32 ``sqrt`` is not correctly
    rounded, neither on the card nor in the CPU's vectorised loop, and its
    f64 ``sqrt`` on the CPU is not always either."""
    x = _flush(x)
    return _flush(_round_root(x, torch.sqrt(x.double()).float()))


def adam_moments(gf: torch.Tensor, mq, ms, vq, vs, args: Adam8Args):
    """One leaf's Adam step on flat, padded f32 gradients ``gf`` (nblocks *
    block): ``(upd, mq, ms, vq, vs)``, the update over the padded length
    and the requantized moments.  ``fp8tpu/training/opt8.py``'s leaf,
    op by op."""
    b1, omb1, b2, omb2, eps, bc1, bc2, _, _ = args.f32()
    block = mq.shape[-1]
    m = _add(_mul(b1, dequant_blocks(mq, ms).reshape(-1)), _mul(omb1, gf))
    v = _add(_mul(b2, dequant_blocks(vq, vs).reshape(-1)),
             _mul(_mul(omb2, gf), gf))
    upd = _div(_div(m, torch.full_like(m, bc1)),
               _add(_sqrt(_div(v, torch.full_like(v, bc2))), eps))
    mq, ms = quant_blocks(m.reshape(-1, block), "int8")
    vq, vs = quant_blocks(v.reshape(-1, block), "e4m3")
    return upd, mq, ms, vq, vs


def _padded(g: torch.Tensor, nblocks: int, block: int) -> torch.Tensor:
    gf = g.to(torch.float32).reshape(-1)
    return torch.nn.functional.pad(gf, (0, nblocks * block - gf.numel()))


def adam8_update_plain(p: torch.Tensor, g: torch.Tensor, mq, ms, vq, vs,
                       args: Adam8Args, mode: str = "apply") -> None:
    """The plain version of P3, in place: the moments always; ``p`` by
    ``mode`` ("apply": ``p += -lr * upd``; "apply_decay": ``p += -lr *
    (upd + wd * p)``; "store": ``p = upd``).  ``p`` and ``g`` may be views
    (written through)."""
    upd, mq2, ms2, vq2, vs2 = adam_moments(
        _padded(g, mq.shape[0], mq.shape[1]), mq, ms, vq, vs, args)
    u = upd[:g.numel()].reshape(g.shape).to(g.dtype)
    if mode == "store":
        p.copy_(u)
    else:
        _, _, _, _, _, _, _, wd, neg_lr = args.f32()
        if mode == "apply_decay":
            u = _add(u, _mul(wd, p))
        p.copy_(_add(p, _mul(neg_lr, u)).to(p.dtype))
    for dst, src in ((mq, mq2), (ms, ms2), (vq, vq2), (vs, vs2)):
        dst.copy_(src)


# -- the kernel -----------------------------------------------------------------

class Leaf(NamedTuple):
    """One leaf of an update: ``p`` and ``g`` (views allowed), its moments'
    payloads and scales, and its mode (a key of :data:`MODES`)."""

    p: torch.Tensor
    g: torch.Tensor
    mq: torch.Tensor
    ms: torch.Tensor
    vq: torch.Tensor
    vs: torch.Tensor
    mode: str = "apply"


@functools.cache
def _lib():
    lib = _build.load("adam8")
    lib.adam8_update.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_int] + [ctypes.c_float] * 9 \
        + [ctypes.c_void_p, ctypes.c_void_p]
    lib.adam8_probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_void_p, ctypes.c_void_p]
    lib.adam8_split.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 \
        + [ctypes.c_longlong] * 8 + [ctypes.c_int] \
        + [ctypes.c_float] * 9 + [ctypes.c_void_p]
    for fn in (lib.adam8_update, lib.adam8_probe, lib.adam8_split):
        fn.restype = ctypes.c_int
    return lib


def _on_cpu(leaves: Sequence[Leaf]) -> bool:
    """True if every tensor of ``leaves`` lies on the CPU, False if every
    one lies on one CUDA device; anything else raises, so that a CUDA
    tensor never reaches the plain version."""
    devices = {t.device for lf in leaves for t in lf[:6]}
    if len(devices) == 1:
        (device,) = devices
        if device.type in ("cpu", "cuda"):
            return device.type == "cpu"
    raise ValueError(f"P3 needs every tensor of its leaves on the CPU or on "
                     f"one CUDA device, got {sorted(map(str, devices))}")


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _geometry(leaf: Leaf):
    """(walk, cols, s0, s1) of the element order P3 walks (see the module
    docstring): element i of the leaf at ``(i // cols) * s0 + (i % cols)
    * s1``."""
    p, g = leaf.p, leaf.g
    n = max(p.numel(), 1)
    if p.is_contiguous():
        if _aligned(p, g, leaf.mq, leaf.vq):
            return WALKS["vector"], n, 0, 1
        return WALKS["strided"], n, n, 1        # unaligned: one row
    if p.ndim != 2:
        raise ValueError(f"adam8_update takes a contiguous leaf or a 2-D "
                         f"view, got shape {tuple(p.shape)} strides "
                         f"{p.stride()}")
    (rows, cols), (s0, s1) = p.shape, p.stride()
    if (s0 == 1 and cols % BLOCK == 0 and rows % TILE_COLS == 0
            and s1 % 4 == 0 and _aligned(p, g, leaf.mq, leaf.vq)):
        return WALKS["tile"], cols, s0, s1
    return WALKS["strided"], cols, s0, s1


def walk_of(p: torch.Tensor, g: Optional[torch.Tensor] = None) -> str:
    """The walk P3 takes over a leaf ``p`` (with gradient ``g`` of its
    layout; aligned moments assumed)."""
    g = p if g is None else g
    code = _geometry(Leaf(p, g, p, p, p, p))[0]
    return next(k for k, v in WALKS.items() if v == code)


def _units(n: int, walk: int, cols: int) -> int:
    if walk == WALKS["tile"]:
        return (n // cols // TILE_COLS) * (cols // BLOCK)
    return -(-(-(-n // BLOCK)) // UNIT)


def _check(leaf: Leaf) -> None:
    p, g, mq, ms, vq, vs, mode = leaf
    n = p.numel()
    nb = -(-n // BLOCK)
    if p.dtype != torch.float32 or g.dtype != torch.float32:
        raise ValueError(f"adam8_update takes f32 p and g on the card, got "
                         f"{p.dtype} and {g.dtype}")
    if g.shape != p.shape or g.stride() != p.stride():
        raise ValueError("adam8_update needs g in p's shape and strides")
    if (mq.dtype != torch.int8 or vq.dtype != torch.float8_e4m3fn
            or tuple(mq.shape) != (nb, BLOCK) or vq.shape != mq.shape
            or ms.dtype != torch.float32 or vs.dtype != torch.float32
            or tuple(ms.shape) != (nb,) or vs.shape != ms.shape
            or not all(t.is_contiguous() for t in (mq, ms, vq, vs))):
        raise ValueError(f"adam8_update needs int8 / e4m3 ({nb}, {BLOCK}) "
                         "payloads and f32 scales, contiguous")
    if mode not in MODES:
        raise ValueError(f"adam8_update: unknown mode {mode!r}")


def _row(leaf: Leaf, first_unit: int):
    """(the kernel's Leaf as 12 int64, the leaf's units, takes the tile?)
    of a checked leaf of at least one element."""
    _check(leaf)
    n = leaf.p.numel()
    walk, cols, s0, s1 = _geometry(leaf)
    row = [t.data_ptr() for t in leaf[:6]] + [
        n, cols, s0, s1, first_unit, walk | (MODES[leaf.mode] << 32)]
    return row, _units(n, walk, cols), walk == WALKS["tile"]


def _routes_ptr(routes: Optional[torch.Tensor]) -> Optional[int]:
    """``routes``: None, or a (2,) int64 CUDA tensor to which the launch
    adds its blocks of the fast and of the slow route."""
    if routes is None:
        return None
    if (routes.dtype != torch.int64 or tuple(routes.shape) != (2,)
            or not routes.is_cuda or not routes.is_contiguous()):
        raise ValueError("routes must be a contiguous (2,) int64 CUDA tensor")
    return routes.data_ptr()


def _launch(device: torch.device, table: Optional[int], nleaves: int,
            one, units: int, tiles: bool, args: Adam8Args,
            routes: Optional[torch.Tensor]) -> None:
    """One launch of P3 over a device ``table`` of ``nleaves`` leaves, or
    (``table`` None, ``nleaves`` 1) over the leaf ``one`` (12 int64 on the
    host)."""
    global launches, leaves_covered
    err = _lib().adam8_update(
        table, nleaves, None if one is None else (ctypes.c_longlong * 12)(
            *one), units, int(tiles), *args.f32(), _routes_ptr(routes),
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "adam8_update kernel")
    launches += 1
    leaves_covered += nleaves


def adam8_update(p: torch.Tensor, g: torch.Tensor, mq: torch.Tensor,
                 ms: torch.Tensor, vq: torch.Tensor, vs: torch.Tensor,
                 args: Adam8Args, mode: str = "apply",
                 routes: Optional[torch.Tensor] = None) -> None:
    """One leaf's 8-bit AdamW update in place (see the module docstring):
    P3 on CUDA tensors (f32 ``p`` and ``g`` of one shape and strides,
    ``mq`` int8 and ``vq`` e4m3 (nblocks, 256) contiguous, f32 scales),
    the plain version on CPU tensors."""
    leaf = Leaf(p, g, mq, ms, vq, vs, mode)
    if _on_cpu([leaf]):
        adam8_update_plain(p, g, mq, ms, vq, vs, args, mode)
        return
    if p.numel() == 0:
        _check(leaf)
        return
    row, units, tiles = _row(leaf, 0)
    _launch(p.device, None, 1, row, units, tiles, args, routes)


class LeafTable(NamedTuple):
    """The kernel's table of a list of leaves (12 int64 a leaf: the six
    pointers, n, cols, s0, s1, the leaf's first CTA unit, walk | mode <<
    32), on the leaves' device; ``key`` is what it was built from, so that
    :func:`leaf_table` rebuilds it only when a pointer or a shape
    changes."""

    key: tuple
    table: Optional[torch.Tensor]    # (nleaves, 12) int64, the leaves' device
    units: int
    tiles: bool


def _key(leaves: Sequence[Leaf]) -> tuple:
    return tuple((lf.p.data_ptr(), lf.g.data_ptr(), lf.mq.data_ptr(),
                  lf.ms.data_ptr(), lf.vq.data_ptr(), lf.vs.data_ptr(),
                  tuple(lf.p.shape), lf.p.stride(), lf.mode)
                 for lf in leaves if lf.p.numel())


def leaf_table(leaves: Sequence[Leaf],
               old: Optional[LeafTable] = None) -> LeafTable:
    """The table of ``leaves`` (checked), or ``old`` if it was
    built from the same pointers, shapes, strides and modes.  A new table
    goes to the card by an asynchronous copy from pinned memory on the
    current stream."""
    key = _key(leaves)
    if old is not None and old.key == key:
        return old
    on_cpu = _on_cpu(leaves) if leaves else True
    rows, units, tiles = [], 0, False
    for lf in leaves:
        if lf.p.numel() == 0:
            _check(lf)
            continue
        row, n_units, tile = _row(lf, units)
        rows.append(row)
        units += n_units
        tiles = tiles or tile
    table = None
    if rows:
        table = torch.tensor(rows, dtype=torch.int64)
        if not on_cpu:
            table = table.pin_memory().to(leaves[0].p.device,
                                          non_blocking=True)
    return LeafTable(key, table, units, tiles)


def adam8_update_many(leaves: Sequence[Leaf], args: Adam8Args,
                      table: Optional[LeafTable] = None,
                      routes: Optional[torch.Tensor] = None) -> Optional[
                          LeafTable]:
    """Every leaf's update (each a :class:`Leaf`, its own mode) with one
    set of scalars: one launch of P3 over all of them on CUDA tensors
    (``table``, from :func:`leaf_table`, is rebuilt if it does not match
    the leaves; the table used is returned), the plain version leaf by
    leaf on CPU tensors (None is returned).  Every tensor of every leaf
    must lie on the CPU, or all on one CUDA device."""
    if not leaves:
        return table
    if _on_cpu(leaves):
        for lf in leaves:
            adam8_update_plain(*lf[:6], args, lf.mode)
        return None
    table = leaf_table(leaves, table)
    if table.table is not None:
        _launch(leaves[0].p.device, table.table.data_ptr(),
                table.table.shape[0], None, table.units, table.tiles, args,
                routes)
    return table


# -- the split-block route ----------------------------------------------------

class SplitLeaf(NamedTuple):
    """A rank's block of a leaf whose moment blocks cross ranks: ``p`` and
    ``g`` the local 2-D view (f32, views allowed, one shape and strides),
    ``mq`` / ``vq`` the codes of its elements (the view's row-major order,
    int8 / e4m3), ``ms`` / ``vs`` every block's scale of the global leaf;
    element (r, c) of the view is global flat index (r0 + r) N + c0 + c of
    a leaf N wide."""

    p: torch.Tensor
    g: torch.Tensor
    mq: torch.Tensor
    ms: torch.Tensor
    vq: torch.Tensor
    vs: torch.Tensor
    r0: int
    c0: int
    N: int
    mode: str = "apply"


def split_blocks(leaf: SplitLeaf) -> torch.Tensor:
    """The global block of each local element (int64, the view's order)."""
    rows, cols = leaf.p.shape
    r = torch.arange(rows, device=leaf.p.device)[:, None] + leaf.r0
    c = torch.arange(cols, device=leaf.p.device)[None, :] + leaf.c0
    return ((r * leaf.N + c) // BLOCK).reshape(-1)


def _split_moments(leaf: SplitLeaf, args: Adam8Args):
    """(m, v, block of each element) of a split leaf's step, as f32 (the
    plain version: :func:`adam_moments`' arithmetic element by element,
    each with its block's old scale)."""
    b1, omb1, b2, omb2, _, _, _, _, _ = args.f32()
    blk = split_blocks(leaf)
    gf = leaf.g.to(torch.float32).reshape(-1)
    dm = dequant_blocks(leaf.mq.reshape(-1, 1), leaf.ms[blk]).reshape(-1)
    dv = dequant_blocks(leaf.vq.reshape(-1, 1), leaf.vs[blk]).reshape(-1)
    m = _add(_mul(b1, dm), _mul(omb1, gf))
    v = _add(_mul(b2, dv), _mul(_mul(omb2, gf), gf))
    return m, v, blk


def _bits_amax(x: torch.Tensor, blk: torch.Tensor, nb: int) -> torch.Tensor:
    bits = (x.contiguous().view(torch.int32) & 0x7FFFFFFF).to(torch.int64)
    out = torch.zeros(nb, dtype=torch.int64, device=x.device)
    return out.scatter_reduce_(0, blk, bits, "amax").to(torch.int32)


def _split_check(leaf: SplitLeaf, amax: torch.Tensor) -> int:
    p, g, mq, ms, vq, vs = leaf[:6]
    nb = ms.numel()
    if (p.ndim != 2 or g.shape != p.shape or g.stride() != p.stride()
            or mq.numel() != p.numel() or vq.numel() != p.numel()
            or vs.numel() != nb or tuple(amax.shape) != (2, nb)
            or amax.dtype != torch.int32 or not amax.is_contiguous()
            or not all(t.is_contiguous() for t in (mq, ms, vq, vs))):
        raise ValueError("a split leaf needs a 2-D view p / g, one code a "
                         "local element, every block's scale, and an "
                         "int32 (2, nblocks) contiguous amax")
    if leaf.mode not in MODES:
        raise ValueError(f"adam8_split: unknown mode {leaf.mode!r}")
    return nb


def _split_launch(which: int, leaf: SplitLeaf, amax: torch.Tensor,
                  args: Adam8Args, ms_old, vs_old) -> None:
    global split_launches
    p = leaf.p
    if p.dtype != torch.float32 or leaf.g.dtype != torch.float32:
        raise ValueError("adam8_split takes f32 p and g on the card")
    err = _lib().adam8_split(
        which, p.data_ptr(), leaf.g.data_ptr(), leaf.mq.data_ptr(),
        leaf.vq.data_ptr(), leaf.ms.data_ptr(), leaf.vs.data_ptr(),
        ms_old.data_ptr(), vs_old.data_ptr(), amax.data_ptr(), p.numel(),
        p.shape[1], p.stride(0), p.stride(1), leaf.N, leaf.r0, leaf.c0,
        leaf.ms.numel(), MODES[leaf.mode], *args.f32(),
        torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(err, "adam8_split kernel")
    split_launches += 1


def adam8_split_amax_plain(leaf: SplitLeaf, args: Adam8Args,
                           amax: torch.Tensor) -> None:
    """The plain version of the split-block route's first pass (any
    device): ``amax`` (int32 (2, nblocks)) takes the max of itself and of
    the magnitude bits of each block's local updated moments (m's row,
    then v's)."""
    m, v, blk = _split_moments(leaf, args)
    nb = leaf.ms.numel()
    amax[0] = torch.maximum(amax[0], _bits_amax(m, blk, nb))
    amax[1] = torch.maximum(amax[1], _bits_amax(v, blk, nb))


def adam8_split_apply_plain(leaf: SplitLeaf, args: Adam8Args,
                            amax: torch.Tensor) -> None:
    """The plain version of the second pass (any device): every block's
    new scales from the reduced ``amax`` (``max(amax, 1e-30) / 127`` and
    ``/ 448``), the local codes by them, and the update of ``p`` by
    ``leaf.mode``, in place."""
    m, v, blk = _split_moments(leaf, args)
    _, _, _, _, eps, bc1, bc2, wd, neg_lr = args.f32()
    sm = block_scale(amax[0].view(torch.float32), "int8")
    sv = block_scale(amax[1].view(torch.float32), "e4m3")
    upd = _div(_div(m, torch.full_like(m, bc1)),
               _add(_sqrt(_div(v, torch.full_like(v, bc2))), eps))
    leaf.mq.copy_(quant_given(m, sm[blk], "int8").reshape(leaf.mq.shape))
    leaf.vq.copy_(quant_given(v, sv[blk], "e4m3").reshape(leaf.vq.shape))
    leaf.ms.copy_(sm)
    leaf.vs.copy_(sv)
    p = leaf.p
    u = upd.reshape(p.shape)
    if leaf.mode == "store":
        p.copy_(u)
    else:
        if leaf.mode == "apply_decay":
            u = _add(u, _mul(wd, p))
        p.copy_(_add(p, _mul(neg_lr, u)).to(p.dtype))


def adam8_split_amax(leaf: SplitLeaf, args: Adam8Args,
                     amax: torch.Tensor) -> None:
    """The first pass of the split-block route: ``amax`` (int32 (2,
    nblocks), zeros) takes the max of the magnitude bits of each block's
    local updated moments (m's row, then v's).  P3's route on CUDA
    tensors, :func:`adam8_split_amax_plain` on CPU tensors."""
    _split_check(leaf, amax)
    if leaf.p.numel() == 0:
        return
    if not leaf.p.is_cuda:
        adam8_split_amax_plain(leaf, args, amax)
        return
    _split_launch(0, leaf, amax, args, leaf.ms, leaf.vs)


def adam8_split_apply(leaf: SplitLeaf, args: Adam8Args,
                      amax: torch.Tensor) -> None:
    """The second pass: the blocks' scales from the reduced ``amax``, the
    local codes by them and the update of ``p``, in place.  P3's route on
    CUDA tensors, :func:`adam8_split_apply_plain` on CPU tensors."""
    _split_check(leaf, amax)
    if leaf.p.numel() == 0:
        return
    if not leaf.p.is_cuda:
        adam8_split_apply_plain(leaf, args, amax)
        return
    _split_launch(1, leaf, amax, args, leaf.ms.clone(), leaf.vs.clone())


# -- probes of the fast route ---------------------------------------------------

PROBES = {"quot_bc": 0, "int8_code": 1, "e4m3_code": 2, "e4m3_convert": 3,
          "flush": 4, "quot_bc_significands": 5}


def probe(kind: str, divisors=1.0):
    """One probe of the kernel's fast route against its slow route's
    functions (``csrc/adam8.cu::probe_kernel``), for each of ``divisors``
    (a float or a sequence of floats) over every f32 bit pattern:
    "quot_bc" the divide by a bias correction bit for bit, "int8_code" /
    "e4m3_code" the codes of a quotient by a block scale, "e4m3_convert"
    the convert, "flush" the one-instruction flush;
    "quot_bc_significands" the divide by a bias correction over every f32
    of magnitude in [1, 2), which stands for every dividend it takes.
    Returns (inputs taken, inputs that differ, the first that differs as
    (divisor index, bit pattern), or None)."""
    divs = torch.tensor(divisors, dtype=torch.float32,
                        device="cuda").reshape(-1)
    out = torch.tensor([0, 0, 1 << 62], dtype=torch.int64, device="cuda")
    err = _lib().adam8_probe(PROBES[kind], divs.data_ptr(), divs.numel(),
                             out.data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "adam8_probe kernel")
    taken, bad, first = (int(x) for x in out.cpu())
    return taken, bad, None if first == 1 << 62 else (first >> 32,
                                                       first & 0xFFFFFFFF)
