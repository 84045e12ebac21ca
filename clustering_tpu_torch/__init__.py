"""clustering_tpu_torch -- the density pipeline of clustering_tpu on
PyTorch, with its O(N^2) tile sweeps as hand-written CUDA kernels for the
NVIDIA H100 (sm_90a).

The JAX package ``clustering_tpu`` is the reference; this package never
imports it, nor jax. It keeps its own copies of the reference's host code
(the CLI parser, file formats, the native text and xtc codecs and the six
numpy-only modes) under the same module names:

  cli        -- mode dispatcher (density on the device, six host modes)
  models/    -- per-mode drivers
  ops/       -- planning (pruning), kernels (wrappers, plain versions,
                launch counts), engines (populations, neighbours,
                screening)
  parallel/  -- several ranks on torch.distributed (mesh, sharded)
  csrc/      -- CUDA C++ sources of the kernels, built by ops/_build.py
  native/    -- C++ text and xtc codecs, built by make at first use
  utils/     -- file formats, logging, stage timer
"""

# the JAX package's version, so that both write the same file headers
__version__ = "0.1.0"

VERSION_STRING = "v" + __version__

# the API surface loads lazily (PEP 562), as in the JAX package: importing
# the package for a host mode loads no torch through api -> ops
_API_NAMES = (
    "populations", "free_energies", "nearest_neighbors",
    "screening_series", "fill_landscape", "mpp_lump", "core_trajectory",
    "assign_noise", "waiting_time_distribution", "Neighborhoods",
    "MppResult", "api", "ops", "parallel", "models", "utils")


def __getattr__(name):
    if name in _API_NAMES:
        if name in ("api", "ops", "parallel", "models", "utils"):
            import importlib
            return importlib.import_module("." + name, __name__)
        from . import api
        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_API_NAMES))
