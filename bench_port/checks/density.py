"""The comparison ``density``: the jobs of ``density -r R -p -d -b -o -T``.

It judges the cells whose traffic names no ``check`` (``run.judge``). A
job's outputs (populations, free energies, both neighbour pairs and one
clustering per threshold, as full arrays in the frames' original order:
the entry's own, ``rec["out"]``, else the job's files ``pop``, ``fe``,
``nn`` and ``clust.<t>``, see ``outputs``) are judged against the plain
reference (``Reference``): its answers for a sample of frames drawn from
the seed (``reference.density.sweep``), the populations of those frames'
higher-density neighbours (``reference.density.populations``), the
clusterings of every threshold (``reference.merge``), and the rules that
tie the outputs to each other. The entry says which jobs are parsed
(``judged``) and how their files agree (``agreement``); each number
below is the worst over the judged jobs and has the limit that the
traffic's file gives it (``limits``):

- ``pops_wrong``: sampled frames whose population differs, and frames
  named as a sampled frame's higher-density neighbour, by the reference or
  by the outputs, whose population differs (exact);
- ``fe_gap``: the widest |fe - (-ln(pop_ref / max pop))| over the sample;
- ``nn_wrong``: sampled (frame, pair) whose neighbour is not admissible
  or lies farther than the reference's nearest by more than ``NN_TIE``
  (ties and one-ulp differences of d2 may pick another frame at the same
  distance), or that reports a neighbour where none exists (exact);
- ``nn_d2_gap``: the widest relative gap of the reported d2 to the
  reference's nearest;
- ``clust_wrong``: violations of the screening's rules (exact): per
  threshold t, (a) a frame clustered iff fe <= t; (b) the clusters named
  1..K in the order of their first frame by (fe, input position); (c)
  each cluster of the previous threshold inside one cluster of this one;
  all over every frame;
- ``clust_split``, ``clust_joined``: per threshold, over the frames the
  outputs cluster, the components of the graph d2 < 4 sigma^2 that the
  outputs split (counted as the extra clusters they make of them), and
  the clusters of the outputs that join frames of different components
  (counted as the components they join beyond one); sigma^2 is the mean
  squared nearest-neighbour distance of the outputs, whose sampled
  frames ``nn_d2_gap`` holds to the reference (exact);
- ``jobs_differ``: jobs whose files differ from the first job's (CLI
  cells, exact).

Frames whose free energy lies within ``FE_SLACK`` of a threshold are not
judged by (a). Pairs whose d2 lies within ``reference.merge.EDGE_SLACK``
of 4 sigma^2 may join components or not: a split counts only across the
sure edges, a join only across none at all (the outputs' sigma^2 reaches
the reference through ``%g`` text).
"""

import numpy as np
import torch

from bench_port import check, spec as specs

NN_TIE = 1e-6
FE_SLACK = 1e-6


def free_energy32(pops):
    """fe = -ln(pop / max pop), in float32 as the configuration states."""
    pops = np.asarray(pops)
    ratio = pops.astype(np.float32) / np.float32(pops.max())
    return (-np.log(ratio.astype(np.float32))).astype(np.float32)


def sigma2(nh_d2):
    """Mean squared nearest-neighbour distance, in float64."""
    return float(np.mean(np.asarray(nh_d2, dtype=np.float64)))


def link2_of(nh_d2):
    """The screening's linking distance 4 sigma^2, in float32."""
    return float(np.float32(4.0 * sigma2(nh_d2)))


def _nn_numbers(out, ref, rows, pair_d2):
    n = len(out["pops"])
    wrong, gap = 0, 0.0
    for kind in ("nh", "hd"):
        best = ref[kind + "_d2"].astype(np.float64)
        got_id = np.asarray(out[kind + "_id"])[rows].astype(np.int64)
        got_d2 = np.asarray(out[kind + "_d2"])[rows].astype(np.float64)
        none = ~np.isfinite(best)
        wrong += int((none & (got_d2 != 0)).sum())
        has = ~none & (got_id >= 0) & (got_id < n)
        wrong += int((~none & ~has).sum())
        d = pair_d2(rows[has], got_id[has]).astype(np.float64)
        ok = (d > 0) & (d <= best[has] * (1.0 + NN_TIE))
        if kind == "hd":
            ok &= out["pops"][got_id[has]] > out["pops"][rows[has]]
        wrong += int((~ok).sum())
        if has.any():
            gap = max(gap, float(np.max(np.abs(got_d2[has] - best[has])
                                        / best[has])))
    return wrong, gap


def _first_seen(seq, n_labels):
    """Position of each label's first occurrence in ``seq``."""
    first = np.full(n_labels + 1, len(seq), dtype=np.int64)
    np.minimum.at(first, seq, np.arange(len(seq)))
    return first


def clust_violations(out, thresholds, rank=None):
    """Violations of (a)-(c) in the module's docstring, summed over the
    thresholds."""
    pops = out["pops"]
    n = len(pops)
    fe = free_energy32(pops)
    rank = np.arange(n) if rank is None else np.asarray(rank)
    order = np.lexsort((rank, fe))
    bad, prev = 0, None
    for t, lab in zip(thresholds, out["clust"]):
        lab = np.asarray(lab, dtype=np.int64)
        t = np.float32(t)
        below = fe <= t
        clear = np.abs(fe.astype(np.float64) - float(t)) > FE_SLACK
        bad += int((((lab > 0) != below) & clear).sum())
        out_of_range = (lab < 0) | (lab > n)
        if out_of_range.any():
            bad += int(out_of_range.sum())
            lab = np.where(out_of_range, 0, lab)
        seq = lab[order]
        seq = seq[seq > 0]
        n_labels = int(lab.max()) if n else 0
        first = _first_seen(seq, n_labels)[1:]
        # labels 1..K all present, each first seen after the one before
        bad += int((first >= len(seq)).sum())
        bad += int((np.diff(first) <= 0).sum())
        if prev is not None:
            was = prev > 0
            bad += int((was & (lab == 0)).sum())
            onto = np.zeros(int(prev.max()) + 1, dtype=np.int64)
            onto[prev[was]] = lab[was]
            bad += int((lab[was] != onto[prev[was]]).sum())
        prev = lab
    return bad


def levels(clust):
    """Each frame's first threshold at which the outputs cluster it
    (``len(clust)`` for none)."""
    out = np.full(len(clust[0]) if clust else 0, len(clust), np.int64)
    for k in reversed(range(len(clust))):
        out[np.asarray(clust[k]) > 0] = k
    return out


def _distinct(*cols):
    key = cols[0]
    for col in cols[1:]:
        key = key * (int(col.max()) + 1) + col
    return int(torch.unique(key).numel())


def merge_numbers(clust, components):
    """(clust_split, clust_joined) of the outputs' clusterings ``clust``
    against ``components``: per threshold, the reference's (sure, maybe)
    component of each frame (``reference.merge.clusterings``)."""
    split = joined = 0
    for lab, (sure, maybe) in zip(clust, components):
        lab = torch.as_tensor(np.asarray(lab, dtype=np.int64),
                              device=sure.device)
        mine = lab > 0
        lab, sure, maybe = lab[mine].clamp(max=len(mine)), sure[mine], \
            maybe[mine]
        if not len(lab):
            continue
        split += _distinct(sure, lab) - _distinct(sure)
        joined += _distinct(maybe, lab) - _distinct(lab)
    return split, joined


def compare(out, ref, thresholds, rank=None):
    """The numbers of one job's outputs ``out`` (``pops``, ``fe``,
    ``nh_id``, ``nh_d2``, ``hd_id``, ``hd_d2``, ``clust``: arrays over the
    frames in their original order) against the reference ``ref`` (a
    ``Reference``); ``rank`` is each frame's position in the job's input
    (None: the original order)."""
    pops = np.asarray(out["pops"], dtype=np.int64)
    out = dict(out, pops=pops)
    rows, ans = ref.rows, ref.answers
    fe_ref = -np.log(ans["pop"] / float(pops.max()))
    nn_wrong, nn_gap = _nn_numbers(out, ans, rows, ref.pair_d2)
    hd = np.asarray(out["hd_id"])[rows].astype(np.int64)
    named = np.union1d(ans["hd_id"][np.isfinite(ans["hd_d2"])],
                       hd[(hd >= 0) & (hd < len(pops))])
    named = np.setdiff1d(named, rows)
    split, joined = merge_numbers(
        out["clust"], ref.clusterings(levels(out["clust"]),
                                      len(out["clust"]),
                                      link2_of(out["nh_d2"])))
    return {
        "pops_wrong": int((pops[rows] != ans["pop"]).sum())
        + int((pops[named] != ref.pops_of(named)).sum()),
        "fe_gap": float(np.max(np.abs(np.asarray(out["fe"])[rows]
                                      - fe_ref))),
        "nn_wrong": nn_wrong,
        "nn_d2_gap": nn_gap,
        "clust_wrong": clust_violations(out, thresholds, rank),
        "clust_split": split,
        "clust_joined": joined,
    }


class Reference:
    """The plain reference of a run, worked out from its frames alone.

    ``answers`` are the sweep's for ``rows``, a sample of frames drawn
    from the seed with the frame of the largest population of the first
    job's outputs ``out0``; those outputs' populations decide which
    neighbours count as of higher density (``pops_of`` holds the ones the
    comparison relies on to the reference's own). ``pair_d2`` gives the
    d2 of frame pairs, ``pops_of`` the populations of frames, and
    ``clusterings`` the components of each threshold's frames, each
    worked out once."""

    def __init__(self, run, out0, control=False):
        dev = check.device(run)
        self.mod = specs.reference(run.config["reference"])
        self.merge = specs.reference("merge")
        self.radius = run.config["radius"]
        self.coords = torch.as_tensor(run.coords, device=dev)
        self.rows = check.sample_rows(run.seed, len(run.coords),
                                      run.config["sample_frames"],
                                      extra=[int(np.argmax(out0["pops"]))])
        self.answers = self.mod.sweep(
            self.coords, torch.as_tensor(self.rows, device=dev),
            self.radius,
            torch.as_tensor(np.asarray(out0["pops"], np.int64)),
            control=control)
        self._pops = dict(zip(self.rows.tolist(),
                              self.answers["pop"].tolist()))
        self._components = {}

    def _ids(self, ids):
        return torch.as_tensor(np.asarray(ids, np.int64),
                               device=self.coords.device)

    def pair_d2(self, i, j):
        return self.mod.pair_sq_dists(self.coords, self._ids(i),
                                      self._ids(j)).cpu().numpy()

    def pops_of(self, frames):
        frames = np.asarray(frames, np.int64)
        new = np.asarray(sorted({int(f) for f in frames} - set(self._pops)),
                         np.int64)
        if len(new):
            got = self.mod.populations(self.coords, self._ids(new),
                                       self.radius)
            self._pops.update(zip(new.tolist(), got.tolist()))
        return np.asarray([self._pops[int(f)] for f in frames], np.int64)

    def clusterings(self, levels, n_levels, link2):
        key = (levels.tobytes(), n_levels, link2)
        if key not in self._components:
            self._components = {key: self.merge.clusterings(
                self.coords, self._ids(levels), n_levels, link2)}
        return self._components[key]


def outputs(run, rec):
    """The job's outputs: the entry's own (``rec["out"]``), else its files
    ``pop``, ``fe``, ``nn`` and one ``clust.<t>`` a threshold (the entry's
    ``files`` after the first three) as arrays, parsed once into
    ``rec["out"]``."""
    if "out" not in rec:
        def col(name):
            return check.table(run, rec, name)[:, 0]
        nn = check.table(run, rec, "nn", 4)
        rec["out"] = {
            "pops": col("pop").astype("int64"), "fe": col("fe"),
            "nh_id": nn[:, 0].astype("int64"), "nh_d2": nn[:, 1],
            "hd_id": nn[:, 2].astype("int64"), "hd_d2": nn[:, 3],
            "clust": [col(name).astype("int64")
                      for name in run.entry.files(run)[3:]],
        }
    return rec["out"]


def judge(run, jobs):
    """(numbers, limits) of the run's jobs: each judged job's numbers
    against one reference, the worst of each, and the entry's
    agreement."""
    ref = Reference(run, outputs(run, jobs[0]))
    thresholds = run.entry.thresholds(run)
    numbers = check.worst(
        compare(out, ref, thresholds, rank=out.get("rank"))
        for out in (outputs(run, rec) for rec in run.entry.judged(run, jobs)))
    numbers.update(run.entry.agreement(run, jobs))
    return numbers, dict(run.traffic["limits"])
