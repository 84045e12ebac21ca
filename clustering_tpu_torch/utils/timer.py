"""Verbose-gated wall-clock scope for pipeline stages.

Counterpart of the JAX package's ``utils.logger.stage_timer`` without its
profiler annotation. Device work inside a stage ends in a host readback
(every stage returns numpy arrays), so the wall includes it.
"""

import time

from .logger import logger


class stage_timer:
    def __init__(self, label):
        self.label = label

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        logger("    [%s: %.3fs]" % (self.label,
                                    time.perf_counter() - self._t0))
        return False
