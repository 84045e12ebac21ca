"""Density stages over a mesh.

Counterpart of the public functions of ``clustering_tpu/parallel/
sharded.py``: ``populations``, ``nearest_neighbors`` and
``screening_labels``, with the JAX functions' keywords and a mesh of
either kind from :func:`~.mesh.make_mesh` (several devices of this
process, or the ranks of a process group, each with one device or
several). ``backend`` follows the port's ops functions: "auto" (the
default here) and "pallas" take the tile-sweep route; "xla", the JAX
functions' default, selects the dense programs that are not ported
(below) and raises ValueError, as does anything else. Each function runs
the single-device engine with ``mesh``: each device plans and sweeps the
tiles of the row blocks dealt to it (by global device index on a group's
mesh), and the partial results merge; the caller gets the whole,
bit-identical to one device's.
``ThresholdSeriesScreener(..., mesh=mesh)`` distributes a screening
series the same way.

Not ported from the JAX package:

- the dense row-ownership programs ``_pops_sharded``, ``_nn_sharded`` and
  ``_screening_sharded``: they serve its XLA backend, and the port has
  none;
- the column-window variants (``_pops_sharded_bidir_window``,
  ``_nn_sharded_bidir_window``): windows bound the Pallas kernels' VMEM
  accumulators, while the CUDA kernels fold through global atomics over
  one flat list;
- the grouped fixpoint for runtime watchdogs (``_sweep_group_sharded``,
  ``_sparse_fixpoint_host_mesh``): it bounds one TPU program's run time,
  and the port's fixpoint is host-driven already, one launch per sweep.
"""

from ..ops import kernels
from ..ops.engine import DensityEngine, NN_BAND_BLOCKS, resolve_backend
from ..ops.screening import ScreeningEngine

DEFAULT_ROW_BLOCK = kernels.DEFAULT_ROW_BLOCK
DEFAULT_COL_BLOCK = kernels.DEFAULT_COL_BLOCK


def populations(coords, radii, mesh, row_block=DEFAULT_ROW_BLOCK,
                col_block=DEFAULT_COL_BLOCK, backend="auto", prune=True):
    """Mesh-distributed multi-radius populations; same results as
    ``ops.density.populations``: dict radius -> (N,) int64. ``prune=False``
    sweeps every tile."""
    resolve_backend(backend, dense=True, mesh=mesh)
    engine = DensityEngine(coords, row_block, col_block, mesh=mesh)
    return engine.populations(radii, prune=prune)


def nearest_neighbors(coords, free_energy, mesh, row_block=DEFAULT_ROW_BLOCK,
                      col_block=DEFAULT_COL_BLOCK, backend="auto",
                      prune=True, band_blocks=NN_BAND_BLOCKS):
    """Mesh-distributed joint NN / lower-fe NN search; same results as
    ``ops.neighbors.nearest_neighbors``: (nh_idx, nh_d2, nhhd_idx,
    nhhd_d2). ``prune`` and ``band_blocks`` are the engine's."""
    resolve_backend(backend, dense=True, mesh=mesh)
    engine = DensityEngine(coords, row_block, col_block, mesh=mesh)
    return engine.nearest_neighbors(free_energy, prune=prune,
                                    band_blocks=band_blocks)


def screening_labels(coords_sorted, initial_labels, n_below, max_dist2, mesh,
                     row_block=DEFAULT_ROW_BLOCK, col_block=DEFAULT_COL_BLOCK,
                     backend="auto"):
    """Mesh-distributed screening fixpoint; same results as
    ``ops.screening.screening_labels``."""
    resolve_backend(backend, dense=True, mesh=mesh)
    engine = ScreeningEngine(coords_sorted, row_block, col_block, mesh=mesh)
    return engine.run(initial_labels, n_below, max_dist2)
