"""The process world and named meshes over it, the counterpart of
``make_mesh`` (``fp8tpu/parallel/sharding.py``) and ``make_pp_mesh``
(``fp8tpu/parallel/pipeline.py``).

A JAX mesh is an array of devices with named axes, and GSPMD inserts the
collectives.  Here a :class:`Mesh` is an array of process ranks with named
axes over a ``torch.distributed`` world (NCCL on the card, gloo when the
caller asks for the CPU), and the port's parallel functions issue their
collectives over the mesh's axis groups themselves.  Ranks ``0..n-1`` fill
the mesh in row-major order, as ``devices[:n].reshape(...)`` does.

Without a process group a mesh is shape only (``.shape[axis]`` and no
groups), which is all the sharding rules need.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from fp8tpu_torch._device import resolve_device

AXES = ("host", "data", "seq", "model")
PP_AXES = ("stage", "data")

# The flat (dim-0 concatenated) gather and reduce-scatter; torch 2.13 names
# them ``*_single`` and deprecates the ``*_tensor`` names older builds have.
_all_gather_flat = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
reduce_scatter_flat = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated along dimension 0, in
    rank order."""
    n = dist.get_world_size(group)
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    _all_gather_flat(out, t.contiguous(), group=group)
    return out


def gather_last(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated along the last
    dimension, in rank order (the column blocks of a column-parallel
    product put back together)."""
    n = dist.get_world_size(group)
    out = gather_rows(t.movedim(-1, 0), group)
    out = out.reshape((n,) + (t.shape[-1],) + tuple(t.shape[:-1]))
    return out.movedim(0, -1).movedim(0, -1).reshape(
        tuple(t.shape[:-1]) + (n * t.shape[-1],))


def init_world(device=None, rank: Optional[int] = None,
               world_size: Optional[int] = None,
               init_method: Optional[str] = None,
               timeout: Optional[float] = None) -> torch.device:
    """Join (or create) the default process group and return this rank's
    device.

    ``device`` is "cuda" unless the caller asks for "cpu": NCCL on the card
    (one card a rank, by ``LOCAL_RANK`` or the rank), gloo on the CPU;
    nothing falls back from one to the other.  ``rank`` / ``world_size`` /
    ``init_method`` default to torchrun's ``RANK`` / ``WORLD_SIZE`` and
    ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``); a process started
    without them is a world of one on ``tcp://localhost:<free port>``.
    ``timeout`` (seconds) bounds every collective of the world, so that a
    rank that waits on a peer that never comes fails instead of hanging.
    """
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if init_method is None:
        init_method = ("env://" if "MASTER_ADDR" in os.environ
                       else f"tcp://localhost:{free_port()}")
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    if timeout is not None:
        import datetime
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    return dev


def free_port() -> int:
    """A free TCP port on localhost (for a world's rendezvous)."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Mesh:
    """Named axes over ranks ``0..n-1`` in row-major order.

    ``shape`` maps each axis to its size, in axis order.  With a process
    group, ``device_mesh`` is the ``torch.distributed`` DeviceMesh (what
    DTensors are placed on), ``group(axis)`` the process group along an
    axis, and ``index(axis)`` this rank's coordinate."""

    def __init__(self, shape: Dict[str, int], device_mesh=None):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.device_mesh = device_mesh
        self._groups: Dict[Tuple[str, ...], object] = {}

    def _require_group(self):
        if self.device_mesh is None:
            raise RuntimeError("this mesh is shape only: call init_world "
                               "before make_mesh to get its process groups")

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        self._require_group()
        return self.device_mesh.get_coordinate()[self.axis_names.index(axis)]

    def split(self, axes) -> Tuple[int, int]:
        """(this rank's index, the count) of the blocks that the axes
        ``axes`` (one name, a tuple of names, or None) split a dimension
        into, row-major over the axes as a ``PartitionSpec`` entry does."""
        if axes is None:
            return 0, 1
        index, count = 0, 1
        for a in ((axes,) if isinstance(axes, str) else axes):
            index = index * self.shape[a] + self.index(a)
            count *= self.shape[a]
        return index, count

    def group(self, *axes: str):
        """The process group of the ranks that differ from this one only
        along ``axes`` (one axis, or several: their product, as the
        gradient sums over data x seq need).  A product group is made at
        its first request, which every rank of the world must reach in the
        same order (``dist.new_group`` is collective)."""
        self._require_group()
        axes = tuple(a for a in self.axis_names if a in axes)
        if len(axes) > 1:           # a size-one axis adds no rank
            axes = tuple(a for a in axes if self.shape[a] > 1) or axes[-1:]
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if axes not in self._groups:
            mine = None
            for ranks in self._product_ranks(axes):
                g = dist.new_group(ranks)
                if dist.get_rank() in ranks:
                    mine = g
            self._groups[axes] = mine
        return self._groups[axes]

    def _product_ranks(self, axes: Tuple[str, ...]) -> List[List[int]]:
        """The rank lists of the groups along ``axes``, one for each
        coordinate of the other axes, in row-major order."""
        ranks = torch.arange(math.prod(self.shape.values())).reshape(
            tuple(self.shape.values()))
        keep = [self.axis_names.index(a) for a in axes]
        rest = [d for d in range(ranks.ndim) if d not in keep]
        ranks = ranks.permute(*rest, *keep).reshape(
            -1, math.prod(self.shape[a] for a in axes))
        return [r.tolist() for r in ranks]

    def __repr__(self):
        return f"Mesh({self.shape})"


def _mesh(shape: Dict[str, int], device=None) -> Mesh:
    n = math.prod(shape.values())
    if not dist.is_initialized():
        return Mesh(shape)
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"need {n} ranks, have {world}")
    if device is None:
        device_type = "cpu" if dist.get_backend() == "gloo" else "cuda"
    else:
        device_type = resolve_device(device).type
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(n).reshape(tuple(shape.values()))
    return Mesh(shape, DeviceMesh(device_type, ranks,
                                  mesh_dim_names=tuple(shape)))


def make_mesh(data: int = 1, model: int = 1, seq: int = 1, hosts: int = 1,
              device=None) -> Mesh:
    """A (host, data, seq, model) mesh over the world's first ``hosts *
    data * seq * model`` ranks.  ``host`` is outermost (the slowest links:
    only data-parallel reductions should cross it), ``model`` innermost
    (tensor-parallel collectives on the fastest).  Raises ``ValueError``
    when the world has fewer ranks; shape only without a process group."""
    return _mesh(dict(zip(AXES, (hosts, data, seq, model))), device)


def make_pp_mesh(stages: int, data: int = 1, device=None) -> Mesh:
    """A (stage, data) mesh: ``stage`` outermost (one activation hop a
    tick tolerates slow links), ``data`` innermost (gradient reductions
    within a stage)."""
    return _mesh(dict(zip(PP_AXES, (stages, data))), device)
