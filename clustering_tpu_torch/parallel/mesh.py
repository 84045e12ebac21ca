"""Meshes of devices: one process driving several devices, or one rank of
a process group on ``torch.distributed``.

Counterpart of ``clustering_tpu/parallel/mesh.py``. The JAX package
meshes every chip it sees from one process into one SPMD program; the
density stages deal every tile list round-robin over the mesh's devices
(``ops.pruning.split_tiles_balanced``), each device sweeps its share
into full-size partial results, and the partials merge: SUM for counts,
MIN for the packed (d2, id) NN keys and for labels -- the counterparts of
the JAX package's ``psum`` and ``pmin``. Two kinds of mesh serve that
one interface (``shares``, ``copies``, ``sum``, ``min``):

- :class:`LocalMesh`, the single controller: this process plans each
  list once on its primary device (``devices[0]``), launches every
  device's share on that device, and merges the partials there by peer
  copies and a reduction. :func:`make_mesh` builds it in a plain
  process, over every visible card by default, as the JAX CLI does.
- :class:`Mesh`, one rank of an initialised process group, one device
  per rank (for runs across nodes): every rank plans the same lists,
  sweeps its own share and merges by ``all_reduce`` (:func:`psum_`,
  :func:`pmin_`), from one thread, in the same order on every rank.

Either way the caller holds the whole result afterwards, so the JAX
helpers ``replicated`` and ``fetch`` have no counterpart here.

A process joins a group through :func:`initialize`, from the JAX
package's switches (``CLUSTERING_TPU_DISTRIBUTED``, with
``CLUSTERING_TPU_COORDINATOR``, ``CLUSTERING_TPU_NUM_PROCESSES`` and
``CLUSTERING_TPU_PROCESS_ID``) or from torch's own ``env://`` variables,
which ``torchrun`` sets. A rank's device is ``cuda:LOCAL_RANK %
device_count`` (``ops.engine.resolve_device``) unless the caller asks
for the CPU.
"""

import dataclasses
import os

import torch
import torch.distributed as dist

DISTRIBUTED_ENV = "CLUSTERING_TPU_DISTRIBUTED"
COORDINATOR_ENV = "CLUSTERING_TPU_COORDINATOR"
NUM_PROCESSES_ENV = "CLUSTERING_TPU_NUM_PROCESSES"
PROCESS_ID_ENV = "CLUSTERING_TPU_PROCESS_ID"
# what env:// reads, as torchrun sets it
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _deal(tiles, index, size):
    # the engines import this module: import theirs at call time
    from ..ops.pruning import split_tiles_balanced
    return split_tiles_balanced(tiles, index, size)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a process group, seen from one of them: its ``rank``
    of ``size`` and the ``device`` it computes on."""
    group: object
    rank: int
    size: int
    device: torch.device

    @property
    def devices(self):
        """The devices this process sweeps on: its own."""
        return (self.device,)

    def shares(self, tiles):
        """[(device, this rank's share of ``tiles``)]: one entry."""
        return [(self.device, _deal(tiles, self.rank, self.size))]

    def copies(self, t):
        """[``t``]: a rank sweeps on one device."""
        return [t]

    def sum(self, parts):
        """The one part summed over the ranks, in place."""
        (part,) = parts
        return psum_(part, self)

    def min(self, parts):
        """The one part's elementwise minimum over the ranks, in place."""
        (part,) = parts
        return pmin_(part, self)


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """Several devices driven from this process (the JAX package's single
    controller): ``devices[0]`` is the primary ``device``, where the
    caller plans and where the partial results merge.

    A device may appear more than once: a mesh over ``["cpu"] * 3`` or
    ``[cuda:0] * 2`` deals and merges as a mesh over as many devices
    would, so that it can be held on the CPU and on one card. Each entry
    still gets buffers of its own (:meth:`copies` copies even onto the
    device it copies from)."""
    devices: tuple

    @property
    def size(self):
        return len(self.devices)

    @property
    def device(self):
        return self.devices[0]

    def shares(self, tiles):
        """[(device, its share of the per-tile tensors ``tiles``)], one
        entry per device of the mesh, dealt round-robin; each share on its
        device."""
        return [(dev, tuple(t.to(dev) for t in _deal(tiles, k, self.size)))
                for k, dev in enumerate(self.devices)]

    def copies(self, t):
        """``t`` (on the primary device) for the first device, and a copy of
        its own for each other one."""
        return [t] + [t.to(dev, copy=True) for dev in self.devices[1:]]

    def sum(self, parts):
        """The parts (one per device) summed into the first, on the primary
        device; returns it."""
        out = parts[0]
        for part in parts[1:]:
            out.add_(part.to(out.device))
        return out

    def min(self, parts):
        """The parts' elementwise minimum, into the first, on the primary
        device; returns it."""
        out = parts[0]
        for part in parts[1:]:
            torch.minimum(out, part.to(out.device), out=out)
        return out


def requested():
    """Whether the environment asks for a distributed run: the JAX
    package's ``CLUSTERING_TPU_DISTRIBUTED``, or torch's launcher."""
    return (bool(os.environ.get(DISTRIBUTED_ENV))
            or all(k in os.environ for k in LAUNCHER_ENV))


def initialize(device="cuda", backend=None, init_method=None,
               world_size=None, rank=None):
    """Join the process group: NCCL when ``device`` is a CUDA device, gloo
    on the CPU.

    Without ``init_method`` the environment says where: the coordinator
    ``host:port`` of ``CLUSTERING_TPU_COORDINATOR`` with the world size and
    rank of ``CLUSTERING_TPU_NUM_PROCESSES`` and
    ``CLUSTERING_TPU_PROCESS_ID``, else torch's ``env://``.

    ``backend`` exists only so that several ranks can share one card:
    NCCL refuses two ranks on one GPU, while gloo stages a CUDA tensor's
    ``all_reduce`` through the host. The CLI never sets it."""
    if init_method is None:
        coordinator = os.environ.get(COORDINATOR_ENV)
        if coordinator:
            init_method = "tcp://" + coordinator
            world_size = int(os.environ[NUM_PROCESSES_ENV])
            rank = int(os.environ[PROCESS_ID_ENV])
        else:
            init_method = "env://"
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if world_size is None else int(world_size),
        rank=-1 if rank is None else int(rank))


def visible_devices(device="cuda"):
    """The devices a run on ``device`` meshes from this process: every
    visible CUDA card for a bare "cuda" (none without a card), else
    ``device`` alone (a numbered card, the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def make_mesh(n_devices=None, devices=None):
    """The mesh of the density stages, with the JAX package's signature.

    In a plain process: a :class:`LocalMesh` over ``devices``, else over
    the first ``n_devices`` visible CUDA cards (default: all of them,
    :func:`visible_devices`); without a card and without ``devices`` it
    raises RuntimeError rather than mesh the CPU. ``devices`` may name a
    device more than once (``["cpu"] * 4``, ``["cuda:0"] * 2``).

    Inside an initialised process group: the :class:`Mesh` over its ranks,
    on this rank's device, ``devices[0]`` if given (e.g. ``["cpu"]`` under
    gloo), else "cuda" (:func:`~..ops.engine.resolve_device`). A rank
    drives one device, and ``n_devices``, if given, must be the group's
    size."""
    # the engines import this module: import theirs at call time
    from ..ops.engine import resolve_device
    if dist.is_available() and dist.is_initialized():
        if devices is not None and len(devices) != 1:
            raise ValueError("in a process group each rank meshes one"
                             f" device, not {len(devices)}")
        size = dist.get_world_size()
        if n_devices is not None and n_devices != size:
            raise ValueError(f"n_devices={n_devices}, but the process"
                             f" group has {size} ranks")
        device = resolve_device(devices[0] if devices else "cuda")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        return Mesh(dist.group.WORLD, dist.get_rank(), size, device)
    if devices is None:
        devices = visible_devices()
        if not devices:
            raise RuntimeError("make_mesh: no CUDA card is visible; name the"
                               " devices to mesh (devices=[...])")
        if n_devices is not None:
            devices = devices[:n_devices]
    devices = tuple(resolve_device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"a mesh's devices are of one type: {devices}")
    # a bare "cuda" is the current card
    devices = tuple(torch.device("cuda", torch.cuda.current_device())
                    if d.type == "cuda" and d.index is None else d
                    for d in devices)
    return LocalMesh(devices)


def mesh_size(mesh) -> int:
    return mesh.size


def psum_(t, mesh):
    """Sum ``t`` over the mesh's ranks, in place; returns ``t``."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def pmin_(t, mesh):
    """Elementwise minimum of ``t`` over the mesh's ranks, in place;
    returns ``t``."""
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.group)
    return t
