"""Reading the density CLI's ``[spans]`` line: the program's own spans
and counters of a job, which ``CLUSTERING_TPU_PROFILE_SUBSTAGES`` makes
the CLI print as the last line of its ``-v`` log. Each span has its
``name``, ``parent``, ``thread``, ``start_ns`` and ``end_ns`` on the
epoch clock, ``cpu_ns`` and ``counters`` (the schema is in the program's
``utils/timer.py``). A log without the line, as a program without the
recorder writes, gives None, never 0."""

import json

PREFIX = "[spans] "
MAIN = "MainThread"


def of_log(log):
    """The spans of a job's log, or None without a spans line."""
    for line in reversed(log.splitlines()):
        if line.startswith(PREFIX):
            return json.loads(line[len(PREFIX):])["spans"]
    return None


def wall_s(spans, name):
    """Seconds of the spans named ``name``, summed; None without one."""
    walls = [(s["end_ns"] - s["start_ns"]) / 1e9 for s in spans
             if s["name"] == name]
    return sum(walls) if walls else None


def counter(spans, name, thread=MAIN):
    """Counter ``name`` summed over the spans of ``thread``; None where no
    span has it."""
    vals = [s["counters"][name] for s in spans
            if s["thread"] == thread and name in s["counters"]]
    return sum(vals) if vals else None


def covered_s(spans, thread=MAIN):
    """Seconds covered by the union of the spans of ``thread``."""
    total, reach = 0, None
    for a, b in sorted((s["start_ns"], s["end_ns"]) for s in spans
                       if s["thread"] == thread):
        if reach is None or a > reach:
            total += b - a
            reach = b
        elif b > reach:
            total += b - reach
            reach = b
    return total / 1e9


def job_mean(jobs, read):
    """Mean over the jobs of ``read(spans, job)``; None where a job's log
    has no spans line or ``read`` gives None."""
    vals = []
    for job in jobs:
        spans = of_log(job.get("log", ""))
        val = None if spans is None else read(spans, job)
        if val is None:
            return None
        vals.append(val)
    return sum(vals) / len(vals) if vals else None
