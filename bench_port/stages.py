"""Reading the density CLI's ``-v`` log: its stage timers
(``[populations: 1.234s]``), the sub-stage lines that
``CLUSTERING_TPU_PROFILE_SUBSTAGES`` adds (``[populations substages:
t_best_sort=0.5, ...]``) and the engines' tile lines (``[nn: 480 tiles
computed ...]``)."""

import re

_WALL = re.compile(r"\[([a-z][a-z .0-9]*): ([0-9.]+)s\]")
_SUB = re.compile(r"\[(\w+) substages: ([^\]]*)\]")
_TILES = re.compile(r"\[(\w+): (\d+) tiles computed")

SCREENING = "screening "


def walls(log):
    """{stage: seconds} of the stage timer lines."""
    return {m.group(1): float(m.group(2)) for m in _WALL.finditer(log)}


def substages(log):
    """{stage: {name: seconds}} of the sub-stage lines."""
    out = {}
    for stage, text in _SUB.findall(log):
        out[stage] = {k: float(v) for k, v in
                      (part.split("=") for part in text.split(", "))}
    return out


def tiles(log):
    """{stage: tiles computed} of the engines' tile lines."""
    return {stage: int(n) for stage, n in _TILES.findall(log)}


def stage_names(log):
    """The stage timers' names, in the order of the log."""
    return [m.group(1) for m in _WALL.finditer(log)]


def measured(log, wall):
    """The quantities of a CLI job that the metrics read (``measured`` in
    an entry's job record), from its log and wall; None where the log has
    none."""
    w = walls(log)
    screening = [s for name, s in w.items() if name.startswith(SCREENING)]
    return {
        "populations": w.get("populations"),
        "nearest_neighbors": w.get("nearest neighbors"),
        "screening": sum(screening) if screening else None,
        "screening_setup": w.get("screening setup"),
        "best_sort": substages(log).get("populations", {}).get(
            "t_best_sort"),
        "nn_tiles": tiles(log).get("nn"),
        "outside_stages": wall - sum(w.values()),
    }


def _values(jobs, key):
    vals = [job["measured"].get(key) for job in jobs]
    return None if not vals or any(v is None for v in vals) else vals


def job_mean(jobs, key):
    """Mean over the jobs of their measured ``key``; None where a job has
    none."""
    vals = _values(jobs, key)
    return None if vals is None else sum(vals) / len(vals)


def job_max(jobs, key):
    """Largest of the jobs' measured ``key``; None where a job has none."""
    vals = _values(jobs, key)
    return None if vals is None else max(vals)
