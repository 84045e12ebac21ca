"""clustering_tpu_torch -- the density pipeline of clustering_tpu on
PyTorch, with its three O(N^2) tile sweeps as hand-written CUDA kernels
for the NVIDIA H100 (sm_90a).

The JAX package ``clustering_tpu`` is the reference; this package never
imports jax. It reuses the reference's jax-free host code (the CLI parser,
file formats and the six numpy-only modes) and keeps its module names:

  cli        -- mode dispatcher (density here, the host modes reused)
  models/    -- the density driver
  ops/       -- planning (pruning), kernels (wrappers, plain versions,
                launch counts), engines (populations, neighbours,
                screening)
  csrc/      -- CUDA C++ sources of the kernels, built by ops/_build.py
  utils/     -- stage timer
"""

_API_NAMES = ("populations", "free_energies", "nearest_neighbors",
              "screening_series", "Neighborhoods")


def __getattr__(name):
    if name in _API_NAMES:
        from . import api
        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
