"""The device mesh of the port's multi-device renderers, on ``torch.distributed``.

The JAX package runs one process over a ``jax.sharding.Mesh`` and reduces
with ``jax.lax.psum``/``pmin``/``pmax``/``pmean`` over named axes inside
``shard_map``. The port runs one process per rank: a :class:`Mesh` holds a
``torch.distributed`` process group per named axis (``dp``, ``sp``, ``gp``),
and ``axis_index``, ``psum``, ``pmin``, ``pmax`` and ``pmean`` take an
:class:`Axis` where JAX takes an axis name (``psum_``, ``pmin_`` and
``pmax_`` reduce in place). Ranks are
laid out as the JAX package lays out devices, row-major over the axes
(``make_mesh``'s ``(n // sp, sp)``, the combined geometry mesh
``(dp, n_gp)``), so rank r of a (dp, sp) mesh has ``dp = r // sp`` and
``sp = r % sp``.

Every collective is a ``dist.all_reduce`` (SUM, MIN, MAX) or a
``dist.broadcast``: gloo takes CUDA tensors for these two and for nothing
else, so one code path runs on nccl, on gloo over the CPU, and on gloo over
CUDA tensors (which gloo stages through the host). An axis of size 1
reduces to the identity without a collective, so a world of one rank needs
no process group at all.

The caller sets ``torch.distributed`` up (``torchrun``, or
``dist/launch.py``'s launcher) and runs each rank on
:func:`rank_device`. NCCL refuses two ranks on one GPU, so a mesh over
more ranks than cards runs on gloo; a mesh over nccl with two ranks on one
card raises.
"""

from __future__ import annotations

import itertools
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve as resolve_device


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


# the device type ("cuda" or "cpu") that dist/launch.py started this rank on
RANK_DEVICE_ENV = "MRT_RANK_DEVICE"


def rank_device(device=None) -> torch.device:
    """This rank's device: by default the launcher's device type
    (``RANK_DEVICE_ENV``), else the card; on the card
    ``cuda:{local_rank % device_count}`` (``LOCAL_RANK`` as ``torchrun``
    sets it, else the global rank) unless ``device`` names its index.
    Raises when a CUDA device is asked for and none is available, and when
    ``device`` contradicts the device the launcher started this rank on."""
    launched = os.environ.get(RANK_DEVICE_ENV)
    if device is None:
        device = launched
    elif launched is not None and torch.device(device).type != launched:
        raise ValueError(f"this rank was launched on {launched!r}; a mesh on {device!r} "
                         "cannot join its world")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", world()[0]))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def check_backend(backend: str, ranks_per_host: int) -> None:
    """Raise for a world NCCL cannot run: more than one rank on one GPU
    ("Duplicate GPU detected"). Such a world runs on gloo; the port never
    switches backends on its own."""
    if backend == "nccl" and ranks_per_host > torch.cuda.device_count():
        raise ValueError(f"nccl cannot run {ranks_per_host} ranks on {torch.cuda.device_count()} "
                         "GPU(s): it refuses two ranks on one GPU; use the gloo backend")


class Axis:
    """One named mesh axis as seen from this rank: its size, this rank's
    ``index`` along it and the process group of the ranks that share this
    rank's other coordinates (None for an axis of size 1)."""

    def __init__(self, name: str, size: int, index: int, group):
        self.name = name
        self.size = size
        self.index = index
        self.group = group


def _reduce(x: torch.Tensor, axis: Axis, op) -> torch.Tensor:
    if axis.size == 1:
        return x
    if x.dtype == torch.bool:
        raise TypeError("reduce a bool tensor as int32: gloo has no bool reductions")
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=axis.group)
    return y


def axis_index(axis: Axis) -> int:
    """This rank's coordinate along ``axis`` (``jax.lax.axis_index``)."""
    return axis.index


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (``jax.lax.psum``)."""
    return _reduce(x, axis, dist.ReduceOp.SUM)


def _reduce_(x: torch.Tensor, axis: Axis, op, name: str) -> torch.Tensor:
    """``x`` (contiguous) reduced by ``op`` over ``axis`` in place, and
    returned. Every rank must pass as many elements; on the CPU (the tests'
    worlds) that is checked first, by a reduction of two int64 that every
    rank can join, and a mismatch raises on every rank where the reduction
    itself would hang or fail."""
    if axis.size == 1:
        return x
    if not x.is_contiguous():
        raise ValueError(f"{name}: the tensor must be contiguous")
    if x.device.type == "cpu":
        n = x.numel()
        most = torch.tensor([n, -n], dtype=torch.int64)
        dist.all_reduce(most, op=dist.ReduceOp.MAX, group=axis.group)
        if int(most[0]) != n or -int(most[1]) != n:
            raise ValueError(f"{name}: {n} elements on this rank, between {-int(most[1])} and "
                             f"{int(most[0])} over the axis {axis.name!r}")
    dist.all_reduce(x, op=op, group=axis.group)
    return x


def psum_(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``psum`` in place (``_reduce_``): for buffers made once whose address
    a kernel was given (the gp step's payload and rows,
    ``kernels/wavefront.gp_combine``, whose sizes follow the live lanes): no
    copy of tens of MB per reduction."""
    return _reduce_(x, axis, dist.ReduceOp.SUM, "psum_")


def pmin_(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``pmin`` in place (``_reduce_``; the gp step's hit keys)."""
    return _reduce_(x, axis, dist.ReduceOp.MIN, "pmin_")


def pmax_(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``pmax`` in place (``_reduce_``; the gp step's occlusion of its live
    lanes, as uint8)."""
    return _reduce_(x, axis, dist.ReduceOp.MAX, "pmax_")


def pmin(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _reduce(x, axis, dist.ReduceOp.MIN)


def pmax(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _reduce(x, axis, dist.ReduceOp.MAX)


def pmean(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``psum(x) / size``, as ``jax.lax.pmean`` computes it."""
    return x if axis.size == 1 else psum(x, axis) / axis.size


class Mesh:
    """Named axes over the world's ranks, row-major: ``shape`` maps each
    axis name to its size, in order (``{"dp": 2, "sp": 2}``), and their
    product is the world size. Every rank builds the same meshes in the
    same order (process groups are created collectively). ``device``: this
    rank's device (``rank_device``'s default when None)."""

    def __init__(self, shape: dict, device=None):
        self.shape = dict(shape)
        self.rank, size = world()
        sizes = tuple(self.shape.values())
        if math.prod(sizes) != size:
            raise ValueError(f"mesh {self.shape} needs {math.prod(sizes)} ranks, "
                             f"the world has {size}")
        if size > 1:
            check_backend(dist.get_backend(), int(os.environ.get("LOCAL_WORLD_SIZE", size)))
        self.device = rank_device(device)
        # devices laid out as the JAX package's Mesh lays them out
        self.ranks = np.arange(size).reshape(sizes)
        coords = np.unravel_index(self.rank, sizes)
        self._axes = {}
        for i, (name, n) in enumerate(self.shape.items()):
            group = None
            if n > 1:
                # every rank creates every group of this axis, in one order
                others = [range(m) for j, m in enumerate(sizes) if j != i]
                for rest in itertools.product(*others):
                    idx = list(rest)
                    idx.insert(i, slice(None))
                    members = [int(r) for r in self.ranks[tuple(idx)]]
                    g = dist.new_group(members)
                    if self.rank in members:
                        group = g
            self._axes[name] = Axis(name, n, int(coords[i]), group)

    def axis(self, name: str) -> Axis:
        """The axis ``name``; an axis the mesh lacks has size 1, and every
        reduction over it is the identity."""
        return self._axes.get(name) or Axis(name, 1, 0, None)

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``x`` from rank ``src`` on every rank of the world (in place)."""
        if self.size > 1:
            dist.broadcast(x, src=src)
        return x


def gather_rows(axis: Axis, block: torch.Tensor, y0: int, height: int) -> torch.Tensor:
    """The full (height, ...) image on every rank of ``axis`` from each
    rank's row block starting at row ``y0``: a sum over the axis of
    zero-filled images, exact because each rank writes only its own rows
    (-0.0 comes back as +0.0)."""
    if axis.size == 1:
        return block
    full = torch.zeros((height,) + tuple(block.shape[1:]), dtype=block.dtype, device=block.device)
    full[y0 : y0 + block.shape[0]] = block
    return psum(full, axis)
