"""Several ranks, one process each, on torch.distributed (counterpart of
``clustering_tpu.parallel``). ``sharded`` loads lazily: the engines import
``mesh``, and ``sharded`` imports the engines."""

from .mesh import (Mesh, initialize, make_mesh, mesh_size,  # noqa: F401
                   pmin_, psum_)


def __getattr__(name):
    if name == "sharded":
        import importlib
        return importlib.import_module(".sharded", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
