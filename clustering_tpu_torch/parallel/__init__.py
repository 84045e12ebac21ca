"""Meshes of devices (counterpart of ``clustering_tpu.parallel``): several
devices driven from one process, or one rank per process on
torch.distributed, each rank driving one device or several.
``sharded`` loads lazily: the engines import ``mesh``, and ``sharded``
imports the engines."""

from .mesh import (LocalMesh, Mesh, host_devices,  # noqa: F401
                   initialize, make_mesh, mesh_size, pmin_, psum_,
                   rank_devices, visible_devices)


def __getattr__(name):
    if name == "sharded":
        import importlib
        return importlib.import_module(".sharded", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
