"""Density stages over a mesh of ranks.

Counterpart of the public functions of ``clustering_tpu/parallel/
sharded.py``: ``populations``, ``nearest_neighbors`` and
``screening_labels``, on the tile-sweep route, without the JAX
functions' ``backend`` and ``prune`` (their default there, "xla", selects
the dense programs that are not ported, below), with a
:class:`~.mesh.Mesh` from :func:`~.mesh.make_mesh`.
Each runs the single-device engine with ``mesh``: every rank plans the
whole tile list, sweeps its round-robin share on its device, and the
partial results merge by ``all_reduce``; every rank returns the whole,
bit-identical to a single rank's. ``ThresholdSeriesScreener(...,
mesh=mesh)`` distributes a screening series the same way.

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
from ..ops.engine import DensityEngine
from ..ops.screening import ScreeningEngine

DEFAULT_ROW_BLOCK = kernels.DEFAULT_ROW_BLOCK
DEFAULT_COL_BLOCK = kernels.DEFAULT_COL_BLOCK


def populations(coords, radii, mesh, row_block=DEFAULT_ROW_BLOCK,
                col_block=DEFAULT_COL_BLOCK):
    """Mesh-distributed multi-radius populations; same results as
    ``ops.density.populations``: dict radius -> (N,) int64."""
    engine = DensityEngine(coords, row_block=row_block, col_block=col_block,
                           device=mesh.device, mesh=mesh)
    return engine.populations(radii)


def nearest_neighbors(coords, free_energy, mesh, row_block=DEFAULT_ROW_BLOCK,
                      col_block=DEFAULT_COL_BLOCK):
    """Mesh-distributed joint NN / lower-fe NN search; same results as
    ``ops.neighbors.nearest_neighbors``: (nh_idx, nh_d2, nhhd_idx,
    nhhd_d2)."""
    engine = DensityEngine(coords, row_block=row_block, col_block=col_block,
                           device=mesh.device, mesh=mesh)
    return engine.nearest_neighbors(free_energy)


def screening_labels(coords_sorted, initial_labels, n_below, max_dist2, mesh,
                     row_block=DEFAULT_ROW_BLOCK, col_block=DEFAULT_COL_BLOCK):
    """Mesh-distributed screening fixpoint; same results as
    ``ops.screening.screening_labels``."""
    engine = ScreeningEngine(coords_sorted, row_block=row_block,
                             col_block=col_block, device=mesh.device,
                             mesh=mesh)
    return engine.run(initial_labels, n_below, max_dist2)
