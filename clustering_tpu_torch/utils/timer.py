"""Verbose-gated wall-clock scope for pipeline stages.

Counterpart of the JAX package's ``utils.logger.stage_timer``. Device work
inside a stage ends in a host readback (every stage returns numpy arrays),
so the wall includes it. While a ``torch.profiler`` profile is active (the
CLI's ``CLUSTERING_TPU_PROFILE``) the scope is also a
``torch.profiler.record_function`` annotation named by the label, so that
the stage shows in the trace; otherwise it costs one check.
"""

import sys
import time

from .logger import logger


def _profiling():
    """Whether a torch profiler is recording (never without torch
    loaded: the host modes do not load it)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


class stage_timer:
    def __init__(self, label):
        self.label = label

    def __enter__(self):
        self._scope = None
        if _profiling():
            import torch
            self._scope = torch.profiler.record_function(self.label)
            self._scope.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        wall = time.perf_counter() - self._t0
        if self._scope is not None:
            self._scope.__exit__(*exc)
        logger("    [%s: %.3fs]" % (self.label, wall))
        return False
