"""Process groups and meshes of ranks on ``torch.distributed``.

Counterpart of ``clustering_tpu/parallel/mesh.py``. The JAX package
meshes every chip of its processes into one SPMD program; here each rank
is one process with one device, and the density stages deal every tile
list round-robin over the ranks (``ops.pruning.split_tiles_balanced``).
Each rank sweeps its share into full-size partial results, which merge
in place by ``all_reduce``: :func:`psum_` (SUM) for counts, :func:`pmin_`
(MIN) for the packed (d2, id) NN keys and for labels -- the counterparts
of the JAX package's ``psum`` and ``pmin``. Every rank then holds the
whole result, so the JAX helpers ``replicated`` and ``fetch`` have no
counterpart here. Planning is deterministic and runs on every rank, and
collectives are issued in the same order on every rank, from one thread.

A process joins its group through :func:`initialize`, from the JAX
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


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a process group, seen from one of them: its ``rank``
    of ``size`` and the ``device`` it computes on."""
    group: object
    rank: int
    size: int
    device: torch.device


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


def make_mesh(device="cuda"):
    """The :class:`Mesh` over every rank of the initialised process group,
    on this rank's ``device`` (:func:`~..ops.engine.resolve_device`)."""
    # the engines import this module: import theirs at call time
    from ..ops.engine import resolve_device
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised torch.distributed"
                           " process group (parallel.mesh.initialize)")
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(),
                device)


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
