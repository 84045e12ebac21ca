"""Spans: the port's one recorder of times and counters, on the clock of
the device trace.

``span(name, **counters)`` times a block of one thread; ``count(name,
value)`` adds to a counter of the innermost span open on the calling
thread (nothing when none is open); ``count_pending(name, tensor)`` adds
the sum of a device tensor that queued work writes, read when the span's
owner calls :meth:`Span.settle` after a download has drained the stream
(or at the export, at the latest), so that counting waits on nothing.
``count_max(name, value, within)`` raises a counter of the innermost
open span of that name to ``value`` (the planners' largest matrix on a
mesh's ``mesh.plan``). ``stage_timer(label)`` is a span that also
writes the ``-v`` line ``    [label: 1.234s]``, the JAX package's
``utils.logger.stage_timer``.
Every layer of the port opens its spans here: ``cli``,
``models.density``, ``utils.io``, ``ops.engine``, ``ops.screening`` and
``ops.kernels`` (its launches and tiles, and the step counts of
``pops_bidir`` at several radii, as counters).

A finished span holds its name; its parent (the innermost span open on
its thread when it opened; work handed to another thread names its
parent explicitly, through :func:`adopt` or :func:`carried`, and may end
after it); its thread's name and native id; its start and end in Unix
epoch nanoseconds (``time.time_ns()``); the CPU nanoseconds of its
thread inside it (``time.thread_time_ns()``), so that wall less CPU is
time spent waiting on the interpreter lock, on I/O or on the card; its
counters; and its string arguments (``args``; ``error``: the exception
that left it). A root span (no parent) on a process with a CUDA context
also records ``peak_device_bytes``, the largest
``torch.cuda.max_memory_allocated`` over the visible cards as it ends;
the statistic is never reset, so the first root span whose value reaches
the job's peak is the one that set it.

The clock: ``torch.profiler``'s Chrome export places an event at
``baseTimeNanoseconds + 1000 * ts``, on the epoch clock of
``time.time_ns()``, so the spans and the trace's kernels need no
conversion. While a profile records, each span is also a
``torch.profiler.record_function`` annotation of its name on its own
thread (the CLI's profile records every thread); otherwise a span costs
two clock reads of each kind and a check.

The last ``LIMIT`` finished spans are kept in memory, so a long-lived
library process stays bounded; :func:`reset` empties the buffer (the CLI
does as it starts).

:func:`line` is the operator's export, ``[spans] {json}``, whose JSON is::

    {"clock": "unix_ns", "pid": int, "dropped": int,
     "spans": [{"id": int, "parent": int or null, "name": str,
                "thread": str, "tid": int, "start_ns": int, "end_ns": int,
                "cpu_ns": int, "counters": {str: number},
                "args": {str: str}}, ...]}

``dropped`` counts the spans the buffer let go; spans are listed in the
order they ended, so a parent follows its children.
"""

import collections
import contextlib
import functools
import itertools
import json
import os
import sys
import threading
import time

from .logger import logger

LIMIT = 4096

_finished = collections.deque(maxlen=LIMIT)
_n_finished = 0
_lock = threading.Lock()  # the buffer and its count, across threads
_ids = itertools.count(1)
_local = threading.local()


def _profiling():
    """Whether a torch profiler is recording, on any thread (never without
    torch loaded: the host modes do not load it). The process-wide flag
    of ``torch.autograd.profiler``, since a profile of every thread leaves
    the thread-local one off; a torch without the flag: the thread's."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    flag = getattr(torch.autograd.profiler, "_is_profiler_enabled", None)
    return flag if flag is not None \
        else torch._C._autograd._profiler_enabled()


def _peak_device_bytes():
    """The largest ``max_memory_allocated`` over the visible cards, or
    None without a CUDA context (never creates one)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return max(torch.cuda.max_memory_allocated(d)
               for d in range(torch.cuda.device_count()))


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One timed block of one thread (:func:`span`). A context manager,
    or ``open()`` and ``close()`` where the block spans functions."""

    def __init__(self, name, counters=None, args=None, start_ns=None):
        self.id = next(_ids)
        self.name = name
        self.counters = dict(counters or {})
        self.args = dict(args or {})
        self.parent = None
        self.thread = None
        self.tid = None
        self.start_ns = start_ns
        self.end_ns = None
        self.cpu_ns = None
        self._cpu0 = None
        self._scope = None
        self._pending = []

    def open(self):
        stack = _stack()
        parent = stack[-1] if stack else getattr(_local, "base", None)
        self.parent = None if parent is None else parent.id
        thread = threading.current_thread()
        self.thread, self.tid = thread.name, threading.get_native_id()
        if _profiling():
            import torch
            if not getattr(_local, "annotated", False):
                # a thread's first annotation sets the profiler up for the
                # thread before its time stamp: paid here, off the clock
                with torch.profiler.record_function("timer.thread"):
                    pass
                _local.annotated = True
            self._scope = torch.profiler.record_function(self.name)
        # backdated to the thread's creation, its CPU counts from 0
        self._cpu0 = 0 if self.start_ns is not None \
            else time.thread_time_ns()
        if self.start_ns is None:
            self.start_ns = time.time_ns()
        if self._scope is not None:
            # right after the clock: the annotation's time stamp comes
            # before the set-up of its first entry on a thread
            self._scope.__enter__()
        stack.append(self)
        return self

    def close(self):
        """End the span (again: nothing)."""
        global _n_finished
        if self.end_ns is not None:
            return
        self.end_ns = time.time_ns()
        self.cpu_ns = time.thread_time_ns() - self._cpu0
        stack = _stack()
        if self in stack:
            stack.remove(self)
        if self._scope is not None:
            self._scope.__exit__(None, None, None)
            self._scope = None
        if self.parent is None:
            peak = _peak_device_bytes()
            if peak is not None:
                self.counters["peak_device_bytes"] = peak
        with _lock:
            _finished.append(self)
            _n_finished += 1

    def __enter__(self):
        return self.open()

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        self.close()
        return False

    def settle(self):
        """Add the sums of the pending device tensors to their counters
        (:func:`count_pending`); each ``int`` waits for its tensor."""
        while self._pending:
            name, tensor = self._pending.pop(0)
            self.counters[name] = (self.counters.get(name, 0)
                                   + int(tensor.cpu().sum()))

    @property
    def seconds(self):
        """The span's wall in seconds (so far, while it is open)."""
        end = time.time_ns() if self.end_ns is None else self.end_ns
        return (end - self.start_ns) / 1e9

    def as_dict(self):
        self.settle()
        return {"id": self.id, "parent": self.parent, "name": self.name,
                "thread": self.thread, "tid": self.tid,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "cpu_ns": self.cpu_ns, "counters": self.counters,
                "args": self.args}


def span(name, *, args=None, start_ns=None, **counters):
    """A :class:`Span` of ``name`` with initial ``counters``; ``args``
    are string arguments; ``start_ns`` backdates the start to an epoch
    time before the span opens (the process's creation, for the main
    thread)."""
    return Span(name, counters, args, start_ns)


class stage_timer(Span):
    """A span that writes the ``-v`` line ``    [label: 1.234s]`` as it
    closes. Device work inside a stage ends in a host readback (every
    stage returns numpy arrays), so the wall includes it."""

    def __init__(self, label):
        super().__init__(label)

    def close(self):
        if self.end_ns is not None:
            return
        super().close()
        logger("    [%s: %.3fs]" % (self.name, self.seconds))


def count(name, value=1):
    """Add ``value`` to counter ``name`` of the innermost span open on the
    calling thread; nothing when none is open."""
    stack = _stack()
    if stack:
        counters = stack[-1].counters
        counters[name] = counters.get(name, 0) + value


def count_max(name, value, within):
    """Raise counter ``name`` of the innermost span named ``within`` open
    on the calling thread to ``value``, if it is lower; nothing when no
    such span is open."""
    for s in reversed(_stack()):
        if s.name == within:
            s.counters[name] = max(s.counters.get(name, value), value)
            return


def count_pending(name, tensor):
    """Add the sum of ``tensor``, which work still queued on its device
    may write, to counter ``name`` of the innermost span open on the
    calling thread when that span is settled (:meth:`Span.settle`);
    nothing when none is open."""
    stack = _stack()
    if stack:
        stack[-1]._pending.append((name, tensor))


def current():
    """The innermost span open on the calling thread, else the parent
    that the thread adopted, else None."""
    stack = _stack()
    return stack[-1] if stack else getattr(_local, "base", None)


@contextlib.contextmanager
def adopt(parent):
    """Inside: the calling thread's spans opened with no span of its own
    open take ``parent`` (a :class:`Span` of another thread, or None) as
    their parent."""
    old = getattr(_local, "base", None)
    _local.base = parent
    try:
        yield
    finally:
        _local.base = old


def carried(fn, parent=None):
    """``fn`` wrapped to run, on whatever thread calls it, under
    ``parent`` (default: the span open here now)."""
    parent = current() if parent is None else parent

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with adopt(parent):
            return fn(*args, **kwargs)
    return run


def reset():
    """Forget every finished span, and the spans left open on the calling
    thread by an earlier exit."""
    global _n_finished
    with _lock:
        _finished.clear()
        _n_finished = 0
    _stack().clear()
    _local.base = None


def finished(name=None):
    """The finished spans in the buffer (of ``name``), oldest first."""
    return [s for s in list(_finished) if name is None or s.name == name]


def last(name):
    """The span of ``name`` that ended last without an error, or None."""
    for s in reversed(list(_finished)):
        if s.name == name and "error" not in s.args:
            return s
    return None


def line():
    """The operator's export: ``[spans] `` and the JSON of the module
    docstring, on one line."""
    with _lock:
        spans, dropped = list(_finished), _n_finished - len(_finished)
    return "[spans] " + json.dumps(
        {"clock": "unix_ns", "pid": os.getpid(), "dropped": dropped,
         "spans": [s.as_dict() for s in spans]}, separators=(",", ":"))


def process_start_ns():
    """This process's creation on the epoch clock (``/proc/self/stat``
    field 22 against ``CLOCK_BOOTTIME``, at the kernel's tick, 10 ms), or
    None where ``/proc`` does not tell."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        boot_ns = time.clock_gettime_ns(time.CLOCK_BOOTTIME)
        now = time.time_ns()
        tick_ns = 1_000_000_000 // os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return None
    start = now - (boot_ns - ticks * tick_ns)
    return start if start <= now else None
