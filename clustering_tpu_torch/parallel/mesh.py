"""Meshes of devices: one process driving several devices, or the ranks of
a process group on ``torch.distributed``, each driving one or several.

Counterpart of ``clustering_tpu/parallel/mesh.py``. The JAX package
meshes every chip it sees, of every process, into one SPMD program. Here
the density stages deal the row blocks of every tile grid over the
mesh's devices, as moldyn/Clustering's multi-GPU backend gives each GPU
a range of rows: the device of global index g of S owns the row blocks
g, g + S, g + 2S, ... (:meth:`LocalMesh.row_deals`), plans the bounds,
planes and tile list of those rows against every column block on its
own copy of the frames, and sweeps that list into full-size partial
results; the partials merge: SUM for counts, MIN for the packed (d2, id)
NN keys and for labels -- the counterparts of the JAX package's ``psum``
and ``pmin``. Every device sweeps the tiles of its rows that one device
would sweep, so the results are one device's bit for bit, and no device
holds more than ``ceil(nrb / S)`` rows of any block-pair matrix. Two
kinds of mesh serve that one interface (``row_deals``, ``copies``,
``sum``, ``min``, ``all_counts``, ``sum_ranks``, ``device``, ``devices``,
``size``):

- :class:`LocalMesh`, the single controller: this process plans each
  device's rows on that device, launches its sweep there, and merges
  the partials on the primary device (``devices[0]``) by peer copies
  and a reduction. :func:`make_mesh` builds it in a plain process, over
  every visible card by default, as the JAX CLI does.
- :class:`Mesh`, one rank of an initialised process group with its own
  devices, one or several: device ``k`` of a rank owns the rows of
  global device index ``offset + k`` of ``size`` (all ranks' devices),
  so that the deals are a :class:`LocalMesh`'s of ``size`` devices
  whatever the split over ranks. A merge folds the rank's parts into
  its primary device's, as a local mesh does, then runs one
  ``all_reduce`` over the ranks (:func:`psum_`, :func:`pmin_`) on that
  tensor, from one thread, in the same order on every rank.

Spans (``utils.timer``): the engines open ``mesh.plan`` around each
stage's per-device planning (:func:`planning`; counters ``rows_max``
and ``matrix_bytes_max``, the most row blocks and the largest block-pair
matrix that one device planned), and each merge of more than one part is
a ``mesh.merge`` span whose counter ``bytes`` counts the partials copied
to the primary device and, on a group's mesh, the tensor reduced over
the ranks. Neither opens without a mesh.

Either way the caller holds the whole result afterwards, so the JAX
helpers ``replicated`` and ``fetch`` have no counterpart here.

A process joins a group through :func:`initialize`, from the JAX
package's switches (``CLUSTERING_TPU_DISTRIBUTED``, with
``CLUSTERING_TPU_COORDINATOR``, ``CLUSTERING_TPU_NUM_PROCESSES`` and
``CLUSTERING_TPU_PROCESS_ID``) or from torch's own ``env://`` variables,
which ``torchrun`` sets. By default a rank takes its devices by the host
rule (:func:`host_devices`): every visible card when it is the only rank
on its host (the JAX layout, one process per host), else one card of its
own, ``cuda:local_index % device_count`` (one process per card, as under
``torchrun --nproc-per-node K``).
"""

import contextlib
import dataclasses
import os
import socket

import torch
import torch.distributed as dist

from ..utils.timer import span

DISTRIBUTED_ENV = "CLUSTERING_TPU_DISTRIBUTED"
COORDINATOR_ENV = "CLUSTERING_TPU_COORDINATOR"
NUM_PROCESSES_ENV = "CLUSTERING_TPU_NUM_PROCESSES"
PROCESS_ID_ENV = "CLUSTERING_TPU_PROCESS_ID"
# what env:// reads, as torchrun sets it
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
# a rank's place on its host, as torchrun sets it
LOCAL_ENV = ("LOCAL_RANK", "LOCAL_WORLD_SIZE")


def _row_deals(devices, offset, size):
    """[(device, (start, step))]: ``devices``, the global indices
    ``offset``, ``offset + 1``, ... of ``size``, each with the row blocks
    ``start, start + step, ...`` that it owns."""
    return [(dev, (offset + k, size)) for k, dev in enumerate(devices)]


def _copies(t, devices):
    """``t`` (on the primary device) for the first of ``devices``, and a
    copy of its own for each other one, even on the same device
    (``t.to(dev)`` would return ``t`` there)."""
    return [t] + [t.to(dev, copy=True) for dev in devices[1:]]


def _nbytes(t):
    return t.numel() * t.element_size()


def _local_sum(parts):
    out = parts[0]
    for part in parts[1:]:
        out.add_(part.to(out.device))
    return out


def _local_min(parts):
    out = parts[0]
    for part in parts[1:]:
        torch.minimum(out, part.to(out.device), out=out)
    return out


def _merge(fold, parts, reduce=None):
    """``fold`` of the parts into the first, then ``reduce`` of it over the
    ranks if given, in a ``mesh.merge`` span counting the ``bytes``
    copied; a single part on one process is returned as it is."""
    if len(parts) == 1 and reduce is None:
        return parts[0]
    moved = sum(_nbytes(p) for p in parts[1:])
    if reduce is not None:
        moved += _nbytes(parts[0])
    with span("mesh.merge", bytes=moved):
        out = fold(parts)
        return out if reduce is None else reduce(out)


def planning(mesh):
    """The ``mesh.plan`` span of a stage's per-device planning on
    ``mesh``; nothing (a null context) without a mesh. The planners of
    ``ops.pruning`` count on it the most rows and the largest block-pair
    matrix one device allocated."""
    return contextlib.nullcontext() if mesh is None else span("mesh.plan")


def skew(counts):
    """The most tiles one device sweeps over the mean of ``counts`` (one
    per device), or None for a single device or no tiles."""
    total = sum(counts)
    if len(counts) < 2 or total == 0:
        return None
    return max(counts) * len(counts) / total


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of a process group's ranks, seen from one of them: the
    ``group``, this ``rank``, its ``devices`` (a tuple, the first one
    primary: the ``device`` where it merges), ``offset``, the
    global index of its first device, and ``size``, the global device
    count (the JAX package's ``mesh_size``; the world size with one
    device per rank). A device may repeat, as in a :class:`LocalMesh`."""
    group: object
    rank: int
    devices: tuple
    offset: int
    size: int

    @property
    def device(self):
        return self.devices[0]

    def row_deals(self):
        """[(device, (start, step))], one entry per device of this rank:
        the row blocks it owns, by global device index."""
        return _row_deals(self.devices, self.offset, self.size)

    def all_counts(self, counts):
        """The per-device ``counts`` (ints, one per device of this rank) of
        every rank, by global device index: one ``all_reduce``, so that
        every rank decides alike."""
        t = torch.zeros(self.size, dtype=torch.int64, device=self.device)
        t[self.offset:self.offset + len(counts)] = torch.tensor(
            counts, dtype=torch.int64)
        return psum_(t, self).tolist()

    def sum_ranks(self, t):
        """``t`` (on the primary device) summed over the ranks, in place."""
        return psum_(t, self)

    def copies(self, t):
        """As :meth:`LocalMesh.copies`, over this rank's devices."""
        return _copies(t, self.devices)

    def sum(self, parts):
        """The parts (one per device of this rank) summed into the first,
        then over the ranks, in place; returns it."""
        return _merge(_local_sum, parts, lambda t: psum_(t, self))

    def min(self, parts):
        """The parts' elementwise minimum, into the first, then over the
        ranks, in place; returns it."""
        return _merge(_local_min, parts, lambda t: pmin_(t, self))


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """Several devices driven from this process (the JAX package's single
    controller): ``devices[0]`` is the primary ``device``, where the
    partial results merge; each device plans its own row blocks.

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

    def row_deals(self):
        """[(device, (start, step))], one entry per device of the mesh: the
        row blocks it owns, ``k, k + size, ...`` for device ``k``."""
        return _row_deals(self.devices, 0, self.size)

    def all_counts(self, counts):
        """``counts`` (ints, one per device), as :meth:`Mesh.all_counts`
        gathers them over the ranks."""
        return list(counts)

    def sum_ranks(self, t):
        """``t`` itself: there are no other ranks."""
        return t

    def copies(self, t):
        """``t`` (on the primary device) for the first device, and a copy of
        its own for each other one."""
        return _copies(t, self.devices)

    def sum(self, parts):
        """The parts (one per device) summed into the first, on the primary
        device; returns it."""
        return _merge(_local_sum, parts)

    def min(self, parts):
        """The parts' elementwise minimum, into the first, on the primary
        device; returns it."""
        return _merge(_local_min, parts)


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


def host_devices(visible, rank, hosts=None, env=None):
    """The devices rank ``rank`` of a process group takes by default (the
    host rule), from the ``visible`` devices of its host: every one when
    it is the only rank on its host (the JAX package's layout, one
    process per host), else one of its own, ``visible[local_index %
    len(visible)]`` (one process per card). A rank's local index and the
    number of ranks on its host come from ``env``'s ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` when both are set (torchrun sets them), else
    from ``hosts``, the host name of every rank: its order among its
    host's ranks. More ranks on a host than its CUDA cards raises
    RuntimeError (two ranks would share a card); ranks on the CPU share
    it."""
    env = {} if env is None else env
    if all(k in env for k in LOCAL_ENV):
        index, count = (int(env[k]) for k in LOCAL_ENV)
    else:
        mine = hosts[rank]
        index, count = hosts[:rank].count(mine), hosts.count(mine)
    visible = list(visible)
    if not visible:
        raise RuntimeError("no CUDA card is visible to this rank; name its"
                           " devices (make_mesh(devices=[...]))")
    if count == 1:
        return visible
    if count > len(visible) and visible[0].type == "cuda":
        raise RuntimeError(f"{count} ranks on this host, but"
                           f" {len(visible)} visible cards")
    return [visible[index % len(visible)]]


def _all_gather(obj):
    """``obj`` of every rank of the default group, in rank order: one
    ``all_gather_object``, through a gloo group of its own (torn down
    after) where the group's backend is another, so that it needs no
    device."""
    out = [None] * dist.get_world_size()
    if len(out) == 1:
        return [obj]
    if dist.get_backend() == "gloo":
        dist.all_gather_object(out, obj)
        return out
    group = dist.new_group(backend="gloo")
    try:
        dist.all_gather_object(out, obj, group=group)
    finally:
        dist.destroy_process_group(group)
    return out


def rank_devices(device="cuda"):
    """This rank's devices by the host rule (:func:`host_devices`) over the
    visible devices of ``device``'s type (:func:`visible_devices`: every
    card for CUDA), in an initialised process group. A collective (one
    gather of the host names) unless the launcher set ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE``: every rank calls it, in the same order."""
    env = os.environ
    hosts = (None if all(k in env for k in LOCAL_ENV)
             else _all_gather(socket.gethostname()))
    visible = visible_devices(torch.device(device).type)
    return host_devices(visible, dist.get_rank(), hosts, env)


def _mesh_devices(devices):
    """``devices`` as a tuple of torch.devices: at least one, all of one
    type (else ValueError). A CUDA device needs a card; a bare "cuda" is
    :func:`~..ops.engine.resolve_device`'s card (in a process group the
    host rule's, else the current one)."""
    # the engines import this module: import theirs at call time
    from ..ops.engine import resolve_device
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"a mesh's devices are of one type: {devices}")
    if devices[0].type != "cuda":
        return tuple(devices)
    bare = None
    if any(d.index is None for d in devices):
        bare = resolve_device("cuda")
        if bare.index is None:
            bare = torch.device("cuda", torch.cuda.current_device())
    return tuple(bare if d.index is None else resolve_device(d)
                 for d in devices)


def make_mesh(n_devices=None, devices=None):
    """The mesh of the density stages, with the JAX package's signature.

    In a plain process: a :class:`LocalMesh` over ``devices``, else over
    the first ``n_devices`` visible CUDA cards (default: all of them,
    :func:`visible_devices`); without a card and without ``devices`` it
    raises RuntimeError rather than mesh the CPU. ``devices`` may name a
    device more than once (``["cpu"] * 4``, ``["cuda:0"] * 2``).

    Inside an initialised process group: the :class:`Mesh` over every
    rank's devices. ``devices`` names this rank's (e.g. ``["cpu"] * 2``
    under gloo; an empty or mixed-type list raises ValueError); without
    it the rank takes the host rule's cards (:func:`rank_devices`). The
    first is made the current CUDA device before any collective.
    ``n_devices``, if given, must be the global device count (else
    ValueError on every rank). In a group ``make_mesh`` is a collective:
    one gather of the ranks' device counts (and one of the host names
    where the host rule decides: without ``devices``, or for a bare
    "cuda"), so every rank calls it, in the same order."""
    if dist.is_available() and dist.is_initialized():
        devices = _mesh_devices(rank_devices() if devices is None
                                else devices)
        if devices[0].type == "cuda":
            torch.cuda.set_device(devices[0])
        rank = dist.get_rank()
        counts = _all_gather(len(devices))
        size = sum(counts)
        if n_devices is not None and n_devices != size:
            raise ValueError(f"n_devices={n_devices}, but the process"
                             f" group's ranks have {size} devices")
        return Mesh(dist.group.WORLD, rank, devices, sum(counts[:rank]),
                    size)
    if devices is None:
        devices = visible_devices()
        if not devices:
            raise RuntimeError("make_mesh: no CUDA card is visible; name the"
                               " devices to mesh (devices=[...])")
        if n_devices is not None:
            devices = devices[:n_devices]
    return LocalMesh(_mesh_devices(devices))


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
