"""Verbose-gated logging.

Equivalent of the reference's ``Clustering::logger`` / global ``verbose`` flag
(reference: src/logger.hpp:40-44, src/logger.cpp:28-38): when verbose mode is
off, log output is swallowed; when on, it goes to stdout. The stage timer
is :class:`clustering_tpu_torch.utils.timer.stage_timer`.
"""

import sys

_VERBOSE = False


def set_verbose(flag: bool) -> None:
    global _VERBOSE
    _VERBOSE = bool(flag)


def is_verbose() -> bool:
    return _VERBOSE


def logger(*parts, sep="", end="\n", file=None) -> None:
    """Print ``parts`` when verbose mode is active (else swallow)."""
    if _VERBOSE:
        print(*parts, sep=sep, end=end, file=file or sys.stdout)
        (file or sys.stdout).flush()

