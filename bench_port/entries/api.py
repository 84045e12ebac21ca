"""The ``api`` entry: one job is the library path in this process.

``clustering_tpu_torch.api.populations`` -> ``free_energies`` ->
``nearest_neighbors`` -> ``screening_series(..., hd_neighbors=...)``, then
``torch.cuda.synchronize()``, each call inside a ``record_function`` span
of the benchmark's own (``SPANS``) and timed on the host's clock. Each
job's input is a fresh permutation of the run's frames drawn from the
seed, so that nothing a call leaves behind serves the next one, and its
outputs are taken back to the frames' original order before they are
judged (the first and the last, and two others drawn from the seed); the
reference is worked out once per run. Set-up runs one whole
job on a permutation of its own, untimed, so that the window finds every
kernel loaded and every allocation made once. The traced job runs under
``torch.profiler``.
"""

import os
import time
from contextlib import contextmanager

import numpy as np

from .. import fel
from .. import trace as traces

SPANS = ("populations", "free_energies", "nearest_neighbors",
         "screening_series")
WARM = -1
TRACED = 10 ** 6
JUDGED = 4


def thresholds(run):
    return [np.float32(t) for t in run.traffic["thresholds"]]


def _perm(run, k):
    return np.random.default_rng(
        fel.seed_words(run.seed, 2, k + 2)).permutation(len(run.coords))


@contextmanager
def _span(torch, spans, name):
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    spans[name] = time.perf_counter() - t0


def _sync(torch, run):
    if run.device == "cuda":
        torch.cuda.synchronize()


def job(run, k):
    """Run job ``k``; its record: ``wall``, ``rc``, ``spans``,
    ``measured`` (the stages' seconds by the spans: populations with the
    free energies, nearest neighbours, screening), ``peak_allocated``,
    ``peak_reserved`` and ``out`` (the outputs in the original frame
    order, with ``rank``: each frame's input position)."""
    import torch
    from clustering_tpu_torch import api
    perm = _perm(run, k)
    x = run.coords[perm]
    cuda = run.device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    spans = {}
    t0 = time.perf_counter()
    with _span(torch, spans, "populations"):
        pops = api.populations(x, run.config["radius"], device=run.device)
    with _span(torch, spans, "free_energies"):
        fe = api.free_energies(pops)
    with _span(torch, spans, "nearest_neighbors"):
        nn = api.nearest_neighbors(x, fe, device=run.device)
    with _span(torch, spans, "screening_series"):
        clust = api.screening_series(
            x, fe, nn.nh_dist, thresholds(run), device=run.device,
            hd_neighbors=(nn.nhhd_idx, nn.nhhd_dist))
        _sync(torch, run)
    wall = time.perf_counter() - t0
    rec = {"wall": wall, "rc": 0, "spans": spans,
           "measured": {
               "populations": spans["populations"] + spans["free_energies"],
               "nearest_neighbors": spans["nearest_neighbors"],
               "screening": spans["screening_series"]},
           "peak_allocated": torch.cuda.max_memory_allocated() if cuda else 0,
           "peak_reserved": torch.cuda.max_memory_reserved() if cuda else 0}

    def back(a, dtype):
        out = np.empty(len(perm), dtype=dtype)
        out[perm] = a
        return out
    rank = np.empty(len(perm), dtype=np.int64)
    rank[perm] = np.arange(len(perm))
    rec["out"] = {
        "pops": back(pops, np.int32), "fe": back(fe, np.float32),
        "nh_id": back(perm[nn.nh_idx], np.int32),
        "nh_d2": back(nn.nh_dist, np.float32),
        "hd_id": back(perm[nn.nhhd_idx], np.int32),
        "hd_d2": back(nn.nhhd_dist, np.float32),
        "clust": [back(c, np.int32) for c in clust], "rank": rank}
    return rec


def prepare(run):
    t0 = time.perf_counter()
    job(run, WARM)
    run.setup_parts["warm_job"] = time.perf_counter() - t0


def finish(run, rec, first):
    """Nothing: the outputs stay in memory until the check."""


def traced_job(run):
    """The job under ``torch.profiler``: (its record, the trace's
    summary)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if run.device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        rec = job(run, TRACED)
    path = os.path.join(run.dir, "trace.json")
    prof.export_chrome_trace(path)
    summary = traces.summarize(traces.load(path), set(SPANS))
    os.remove(path)
    return rec, summary


def release(run):
    """Free the program's cached device memory before the reference."""
    import torch
    if run.device == "cuda":
        torch.cuda.empty_cache()


def judged(run, jobs):
    """The first and last job and ``JUDGED - 2`` others drawn from the
    seed (each had an input of its own; judging all of a window's jobs
    would take longer than the window)."""
    if len(jobs) <= JUDGED:
        return jobs
    rng = np.random.default_rng(fel.seed_words(run.seed, 3))
    middle = rng.choice(np.arange(1, len(jobs) - 1), JUDGED - 2,
                        replace=False)
    return [jobs[0]] + [jobs[k] for k in sorted(middle)] + [jobs[-1]]


def agreement(run, jobs):
    return {}
