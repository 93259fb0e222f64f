"""Single-entry fake-quantization with a straight-through gradient.

``fake_quant`` computes the scale its config asks for and casts, in one
call; on a CUDA tensor the cast is one launch of the cast kernel (K1).
The backward pass is straight-through: gradient-stream quantization is
applied explicitly per the igrad/ograd/wtgrad role configs.

``shard`` (a ``parallel.data.BatchShard``) marks ``x`` as one rank's rows
of a data-parallel batch: a per-tensor scale is then the global tensor's
and SR draws the global tensor's bits at the rank's offset, so the cast
is the rank's share of the unsharded cast.  A ``parallel.data.
TensorShard`` marks a block split over any of the data, seq and model
groups (tensor and sequence parallelism): per-tensor and per-channel
scales reduce over the groups that split the reduced dimensions, and SR
hashes each element's global row-major index (the shard's ``block``).
Fine-grained and integer scaling of a model-split tensor raise
``NotImplementedError``, as does per-block scaling of a block that is not
whole blocks of one contiguous range.
"""

from __future__ import annotations

from typing import Optional

import torch

from fp8tpu_torch.numerics import cast as _cast
from fp8tpu_torch.numerics import integer as _integer
from fp8tpu_torch.numerics import scaling as _scaling
from fp8tpu_torch.numerics.formats import FORMATS
from fp8tpu_torch.numerics.prng import PRNGKey

from .config import TensorQuantConfig


def _hw_eligible(cfg: TensorQuantConfig) -> bool:
    return (cfg.cast_impl == "hw" and cfg.dtype in _cast.HW_DTYPES
            and cfg.scheme in ("rne", "stochastic")
            and cfg.scaling != "per-block")


def _scale(x: torch.Tensor, cfg: TensorQuantConfig, shard=None):
    fmt = FORMATS[cfg.dtype]
    if cfg.scaling == "none":
        return 1.0
    if cfg.scaling == "per-tensor":
        return _scaling.per_tensor(x, fmt, cfg.method, shard)
    if cfg.scaling == "per-channel":
        return _scaling.per_channel(x, fmt, cfg.method, cfg.channel_axis,
                                    shard)
    if cfg.scaling == "fine-grained":
        # its groups lie inside dimension 0's slices: a block of rows
        # holds whole groups
        _local_rows_only(shard, "fine-grained scaling")
        return _scaling.fine_grained(x, fmt, cfg.group_size, cfg.method)
    raise ValueError(f"unknown scaling {cfg.scaling!r}")


def _model_split(shard) -> bool:
    return getattr(shard, "model", None) is not None


def _local_rows_only(shard, what: str) -> None:
    """``what`` is computed on a rank's block as it is only where the block
    is whole rows (a data shard); a model-split tensor raises."""
    if _model_split(shard):
        raise NotImplementedError(
            f"{what} of a tensor split over the model group (tensor "
            "parallelism takes none, per-tensor or per-channel scales)")


def _quantize_impl(x: torch.Tensor, cfg: TensorQuantConfig,
                   key: Optional[PRNGKey], shard=None) -> torch.Tensor:
    if cfg.is_int:
        if shard is None:
            return _integer.qdq_int(x, bits=cfg.bits)
        _local_rows_only(shard, "integer quantization")
        return _integer.qdq_int(x, bits=cfg.bits, shard=shard)
    if cfg.is_stochastic and key is None:
        raise ValueError(f"{cfg.mode_string()} needs a PRNG key for "
                         "stochastic rounding")
    block = None
    if shard is not None and (cfg.is_stochastic
                              or cfg.scaling == "per-block"):
        block = shard.block(x.shape)
    offset = 0
    if cfg.scaling == "per-block" and block is not None:
        # blocks over the flattened tensor: a rank's block holds whole
        # blocks of the global tensor only as one range from a block edge
        offset = block.contiguous_offset(x.shape)
        if offset is None or offset % cfg.block_size or \
                x.numel() % cfg.block_size:
            raise NotImplementedError(
                f"per-block scaling of a shard of {tuple(x.shape)} at "
                f"{block.start} of {block.shape}: not whole blocks of "
                f"{cfg.block_size} in one range")
    if _hw_eligible(cfg):
        scale = _scale(x, cfg, shard)
        if cfg.scheme == "stochastic":
            return _cast.hw_sr(x, cfg.dtype, scale,
                               _cast.sr_bits(key, x.shape, x.device,
                                             block=block))
        return _cast.hw_qdq(x, cfg.dtype, scale)
    fmt = FORMATS[cfg.dtype]
    key = key if cfg.is_stochastic else None
    if cfg.scaling == "per-block":
        return _cast.qdq_blocked(x, fmt, cfg.round_mode, cfg.block_size,
                                 cfg.daz, key=key, offset=offset)
    return _cast.qdq(x, fmt, cfg.round_mode, _scale(x, cfg, shard), cfg.daz,
                     key=key, block=block if cfg.is_stochastic else None)


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cfg, key, shard):
        return _quantize_impl(x, cfg, key, shard).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def fake_quant(x: torch.Tensor, cfg: TensorQuantConfig,
               key: Optional[PRNGKey] = None, shard=None) -> torch.Tensor:
    """Fake-quantize ``x`` per ``cfg``; straight-through gradient.  Output
    dtype equals input dtype (fp8-grid values are exact in bf16 and f32
    alike).  ``shard``: ``x`` is a rank's rows of a data-parallel batch
    (module docstring)."""
    return _FakeQuant.apply(x, cfg, key, shard)


class _FixedScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cfg, scale, key):
        if cfg.is_int:
            s, zp = scale
            return _integer.qdq_int_with_qparams(x, s, zp,
                                                 bits=cfg.bits).to(x.dtype)
        return _cast.qdq(x, FORMATS[cfg.dtype], cfg.round_mode, scale,
                         cfg.daz, key=key if cfg.is_stochastic else None
                         ).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def fake_quant_with_scale(x: torch.Tensor, cfg: TensorQuantConfig, scale,
                          key: Optional[PRNGKey] = None) -> torch.Tensor:
    """Fake-quantize with an externally calibrated scale (for int configs,
    ``scale`` is the (scale, zero_point) pair).  Straight-through
    gradient."""
    return _FixedScale.apply(x, cfg, scale, key)


def quantize_grad(g: torch.Tensor, cfg: Optional[TensorQuantConfig],
                  key: Optional[PRNGKey] = None, shard=None) -> torch.Tensor:
    """Quantize a gradient stream; no-op when ``cfg`` is None."""
    if cfg is None:
        return g
    return _quantize_impl(g, cfg, key, shard)


def fake_quant_sparse(x: torch.Tensor, cfg: TensorQuantConfig,
                      key: Optional[PRNGKey] = None) -> torch.Tensor:
    """Fake-quantize a sparse tensor by casting its stored values only.

    The reference's FPEmuOp special-cases torch sparse COO tensors by
    quantizing ``tensor._values()`` and rebuilding the sparse tensor
    (pytquant/cpp/fpemu.py:46-58).  Here a COO tensor is coalesced (its
    values in row-major order of their indices, as a BCOO array's ``data``
    in the JAX package), its values go through :func:`fake_quant` (one K1
    launch on a CUDA tensor) with none or per-tensor scaling (the values
    carry no channel structure), and the result has the same indices and
    shape.  Dense tensors fall through to :func:`fake_quant`.
    """
    if x.layout != torch.sparse_coo:
        return fake_quant(x, cfg, key)
    if cfg.scaling not in ("none", "per-tensor"):
        raise ValueError(
            f"sparse fake-quant supports none/per-tensor scaling, "
            f"got {cfg.scaling!r} (matching the reference, which "
            "applies one scale to the COO values)")
    x = x.coalesce()
    return torch.sparse_coo_tensor(x.indices(),
                                   fake_quant(x.values(), cfg, key),
                                   x.shape, is_coalesced=True,
                                   check_invariants=False)
