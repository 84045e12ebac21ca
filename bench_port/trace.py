"""Reduction of a ``torch.profiler`` Chrome trace to the device's busy
time, its idle gaps and its top operations.

The window is the traced job's span from the first to the last stage
annotation (``user_annotation`` events on the host; the CLI's stage
timers, the library entry's own spans). Device work is every ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` event; busy time is the length of the
union of their intervals inside the window, so overlapping streams count
once. An idle gap is a stretch of the window with no device event, named
by the innermost host annotation open at its middle.
"""

import json
from collections import Counter

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def load(path):
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _clip(merged, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in merged
            if min(b, hi) > max(a, lo)]


def union_s(intervals, lo=float("-inf"), hi=float("inf")):
    """Seconds covered by the union of (start, end) intervals in us,
    inside [lo, hi]."""
    return sum(b - a for a, b in _clip(_merged(intervals), lo, hi)) / 1e6


def _span(e):
    return e["ts"], e["ts"] + e["dur"]


def summarize(events, stages):
    """The trace's numbers inside the window spanned by the host
    annotations named in ``stages``: a dict with ``window_s``, ``busy_s``
    (kernels, copies and sets), ``kernel_busy_s``, ``device_ops`` and
    ``idle_gaps`` (each at most ``TOP`` [name, seconds] pairs, largest
    first), ``kernels`` (each kernel event's name and (start, end)); None
    when no such annotation or no device event is in the trace."""
    notes = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("ph") == "X"]
    marks = [e for e in notes if e["name"] in stages]
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and e.get("ph") == "X"]
    if not marks or not device:
        return None
    lo = min(e["ts"] for e in marks)
    hi = max(e["ts"] + e["dur"] for e in marks)
    busy = _clip(_merged([_span(e) for e in device]), lo, hi)
    ops = Counter()
    for e in device:
        a, b = _span(e)
        if min(b, hi) > max(a, lo):
            ops[e["name"]] += (min(b, hi) - max(a, lo)) / 1e6
    gaps, reach = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > reach:
            gaps.append((reach, a))
        reach = max(reach, b)
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        open_ = [e for e in notes if e["ts"] <= mid < e["ts"] + e["dur"]]
        label = (min(open_, key=lambda e: e["dur"])["name"] if open_
                 else "no annotation")
        named.append([f"{label} @{(a - lo) / 1e6:.3f}s", (b - a) / 1e6])
    named.sort(key=lambda g: -g[1])
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernel_busy_s": union_s([_span(e) for e in device
                                  if e["cat"] == "kernel"], lo, hi),
        "device_ops": [[name, s] for name, s in ops.most_common(TOP)],
        "idle_gaps": named[:TOP],
        "kernels": [(e["name"], _span(e)) for e in device
                    if e["cat"] == "kernel"],
    }
