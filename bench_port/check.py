"""What the harness and the comparisons of ``checks/`` share.

A comparison is a module ``checks/<name>.py`` with ``judge(run, jobs)``,
which returns (numbers, limits): each number it compared, under a short
name, and the limit of each, as a rule the traffic's ``limits``. It reads
a job's outputs from the job's record: the entry's own (``rec["out"]``)
or the files in the job's directory (``rec["dir"]``, ``table``). It may
leave the populations it parsed in ``rec["out"]["pops"]`` (one per frame,
for one radius), which ``kernels.pops_roofline`` counts its pairs from.
"""

import os

import numpy as np
import torch

from bench_port import fel, textfiles


def device(run):
    """Where the comparison computes: the card where the run has one."""
    return "cuda" if run.device == "cuda" and torch.cuda.is_available() \
        else "cpu"


def sample_rows(seed, n, size, extra=()):
    """``size`` distinct frames drawn from the seed, plus ``extra``."""
    rng = np.random.default_rng(fel.seed_words(seed, 1))
    rows = rng.choice(n, size=min(size, n), replace=False)
    return np.unique(np.concatenate([rows, np.asarray(extra, np.int64)]))


def table(run, rec, name, n_cols=1):
    """(rows, n_cols) float64 table of the job's file ``name``."""
    return textfiles.read_table(os.path.join(rec["dir"], name), n_cols,
                                device(run))


def worst(readings):
    """The largest reading of each number over several jobs (NaN, which
    no limit passes, wins)."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = v if k not in out else np.maximum(out[k], v).item()
    return out


def verdict(numbers, limits):
    """(every number within its limit, [(name, number, limit)])."""
    rows = [(k, numbers[k], limits[k]) for k in limits if k in numbers]
    missing = [k for k in limits if k not in numbers]
    ok = not missing and all(v <= lim for _, v, lim in rows)
    return ok, rows
