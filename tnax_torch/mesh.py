"""The device mesh of the port on ``torch.distributed``: tnax's two mesh
axes, 'data' over instances and 'beam' over the M branches of one search,
and the collectives tnax calls along them.

Counterpart of ``make_mesh`` (tnax/parallel.py:1780-1792) and of the
collectives inside tnax's ``shard_map`` bodies: :func:`pmax`,
:func:`psum` and :func:`pmin` are ``lax.pmax``/``psum``/``pmin``, and
:func:`all_gather` is ``lax.all_gather(tiled=True)``. Each does nothing
on an axis of size 1.

tnax has one controller over many devices. The port is SPMD: one process
per rank, the default process group already initialized, world size =
n_data * n_beam, rank r at (data r // n_beam, beam r % n_beam), as tnax's
row-major reshape of its devices. Every rank calls the same functions
with the same arguments; each works on its block of the instances and of
the branches, and the collectives make the replicated values equal on
every rank.

Start the ranks with ``torchrun`` or ``torch.multiprocessing.spawn``,
then in each::

    torch.distributed.init_process_group("nccl", init_method=
        "tcp://localhost:29500", world_size=n_data * n_beam, rank=r)
    mesh = tnax_torch.parallel.make_mesh(n_data, n_beam)

NCCL takes one rank per card. gloo takes any number of ranks on the CPU,
or on one card when the caller passes CUDA ``devices``: gloo has no
transport on the card, so every collective of a gloo group on CUDA
tensors is staged through host memory here, openly (:func:`_staged`).
NCCL never stages.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

AXES = ("data", "beam")

_START = ("start one process per rank (torchrun, or "
          "torch.multiprocessing.spawn) and call "
          "torch.distributed.init_process_group(backend, init_method="
          "'tcp://localhost:<port>', world_size=n_data * n_beam, rank=r) "
          "in each before make_mesh")


class MeshAxis:
    """One axis of a mesh as this rank sees it: the process group of the
    ranks along it, its size, this rank's index on it, and the global
    ranks along it in axis order."""

    def __init__(self, name, group, ranks, index, staged):
        self.name, self.group, self.ranks = name, group, ranks
        self.size, self.index, self.staged = len(ranks), index, staged

    def block(self, n):
        """This rank's slice of n items split evenly along the axis."""
        if n % self.size:
            raise ValueError(f"{n} does not tile the {self.name} axis "
                             f"({self.size} shards)")
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)


class Mesh:
    """A ('data', 'beam') mesh of n_data * n_beam ranks (see the module
    docstring); made by :func:`make_mesh`. ``shape`` maps each axis name
    to its size, as tnax's ``mesh.shape``; ``device`` is this rank's
    device, ``device_mesh`` the ``torch.distributed`` DeviceMesh."""

    def __init__(self, device_mesh, devices, backend):
        self.device_mesh = device_mesh
        self.rank = dist.get_rank()
        self.device = devices[self.rank]
        n_data, n_beam = device_mesh.shape
        self.shape = {"data": n_data, "beam": n_beam}
        staged = "nccl" not in backend
        coord = divmod(self.rank, n_beam)
        self.axes = {}
        for i, name in enumerate(AXES):
            group = device_mesh.get_group(name)
            self.axes[name] = MeshAxis(name, group,
                                       dist.get_process_group_ranks(group),
                                       coord[i], staged)

    def axis(self, name):
        return self.axes[name]

    def index(self, name):
        """This rank's index on the axis ``name``."""
        return self.axes[name].index

    def block(self, n, name):
        """This rank's slice of n items split along the axis ``name``
        (ValueError unless they tile it)."""
        return self.axes[name].block(n)


def check_mesh(mesh):
    """``mesh`` itself if it is a :class:`Mesh`; TypeError otherwise (a
    mesh comes from :func:`make_mesh`)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must come from make_mesh, got "
                        f"{type(mesh).__name__}")
    return mesh


def make_mesh(n_data, n_beam, devices=None):
    """The ('data', 'beam') mesh of the ranks of the default process
    group (tnax's ``make_mesh``), built on
    ``torch.distributed.device_mesh.init_device_mesh``.

    The group must be initialized with world size n_data * n_beam
    (ValueError otherwise, saying how to start ranks). ``devices`` is one
    torch.device per rank; by default ``cuda:(r % device_count)`` under
    NCCL and ``cpu`` under gloo (pass CUDA devices for gloo ranks on a
    card). Under NCCL the rank's card becomes the current device.
    """
    from torch.distributed.device_mesh import init_device_mesh
    n = n_data * n_beam
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"make_mesh needs {n_data}x{n_beam}={n} ranks of "
                         f"an initialized torch.distributed group: "
                         f"{_START}")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"make_mesh needs {n_data}x{n_beam}={n} ranks, "
                         f"the process group has {world}: {_START}")
    backend = str(dist.get_backend())
    nccl = "nccl" in backend
    if devices is None:
        devices = ([torch.device("cuda", r % torch.cuda.device_count())
                    for r in range(n)] if nccl
                   else [torch.device("cpu")] * n)
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"make_mesh needs one device per rank ({n}), got "
                         f"{len(devices)}")
    mine = devices[dist.get_rank()]
    if nccl and mine.type == "cuda":
        torch.cuda.set_device(mine)
    dm = init_device_mesh("cuda" if nccl else "cpu", (n_data, n_beam),
                          mesh_dim_names=AXES)
    return Mesh(dm, devices, backend)


def _staged(x, axis):
    """True where a collective of ``x`` goes through host memory: a CUDA
    tensor in a gloo group."""
    return axis.staged and x.is_cuda


def _reduce(x, axis, op):
    if axis is None or axis.size == 1:
        return x
    y = x.cpu() if _staged(x, axis) else x.clone()
    dist.all_reduce(y, op=op, group=axis.group)
    return y.to(x.device)


def pmax(x, axis):
    """The elementwise maximum of ``x`` over the ranks of ``axis``
    (``lax.pmax``); x itself on an axis of size 1 or None."""
    return _reduce(x, axis, dist.ReduceOp.MAX)


def pmin(x, axis):
    """The elementwise minimum over the ranks of ``axis`` (``lax.pmin``)."""
    return _reduce(x, axis, dist.ReduceOp.MIN)


def psum(x, axis):
    """The elementwise sum over the ranks of ``axis`` (``lax.psum``)."""
    return _reduce(x, axis, dist.ReduceOp.SUM)


def all_gather(x, axis, dim=0):
    """Every rank's ``x`` of ``axis`` concatenated along ``dim`` in axis
    order (``lax.all_gather(tiled=True)``); x itself on an axis of size 1
    or None. Bool tensors travel as uint8."""
    if axis is None or axis.size == 1:
        return x
    if x.dtype == torch.bool:
        return all_gather(x.to(torch.uint8), axis, dim).bool()
    y = (x.cpu() if _staged(x, axis) else x).contiguous()
    parts = [torch.empty_like(y) for _ in range(axis.size)]
    dist.all_gather(parts, y, group=axis.group)
    return torch.cat(parts, dim=dim).to(x.device)


def broadcast(x, axis):
    """The axis's first rank's ``x`` on every rank of ``axis`` (x must
    have the same shape and dtype everywhere); x itself on an axis of size
    1 or None."""
    if axis is None or axis.size == 1:
        return x
    y = x.cpu() if _staged(x, axis) else x.contiguous()
    dist.broadcast(y, src=axis.ranks[0], group=axis.group)
    return y.to(x.device)


def gather_data(local, mesh):
    """The list of per-instance results of every data shard, in instance
    order, on every rank: each rank passes the list of its block's results
    (or None where the block's first beam rank computes it), and the
    result of each data group's first beam rank is taken."""
    if dist.get_world_size() == 1:
        return list(local)
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, local)
    n_beam = mesh.shape["beam"]
    return [r for d in range(mesh.shape["data"]) for r in out[d * n_beam]]
